"""Qwen2.5-14B — dense GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B card,
14B scale per assignment]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,           # GQA kv=8
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    attn_pattern=("global",),
    qkv_bias=True,            # Qwen2.5 uses QKV bias
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen2.5-0.5B",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        attn_pattern=("global",),
        qkv_bias=True,
        dtype="float32",
        gate_hidden=32,
        source="reduced qwen2.5-14b",
    )
