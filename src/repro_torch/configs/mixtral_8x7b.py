"""Mixtral-8x7B — sparse MoE, 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,           # GQA kv=8
    head_dim=128,
    d_ff=14336,               # per-expert FFN dim
    vocab_size=32000,
    attn_pattern=("local",),  # SWA in every layer [arXiv:2401.04088]
    window=4096,
    num_experts=8,
    experts_per_token=2,
    rope_theta=1000000.0,
    source="arXiv:2401.04088",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        attn_pattern=("local",),
        window=16,
        num_experts=4,
        experts_per_token=2,
        dtype="float32",
        gate_hidden=32,
        source="reduced mixtral-8x7b",
    )
