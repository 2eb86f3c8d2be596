"""Falcon-Mamba-7B — pure Mamba-1 SSM, attention-free.
TRIM-KV is inapplicable (no KV cache): the arch is served without the
technique. [arXiv:2410.05355]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,              # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                   # no FFN: the mamba block replaces attn+mlp
    vocab_size=65024,
    attn_pattern=("mamba",),
    ssm_state=16,
    d_inner=8192,             # 2 * d_model
    conv_width=4,
    dt_rank=256,              # ceil(d_model / 16)
    trimkv=False,             # inapplicable: no KV cache exists
    source="arXiv:2410.05355",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-smoke",
        family="ssm",
        num_layers=2,
        d_model=128,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=512,
        attn_pattern=("mamba",),
        ssm_state=8,
        d_inner=256,
        conv_width=4,
        dt_rank=8,
        trimkv=False,
        dtype="float32",
        source="reduced falcon-mamba",
    )
