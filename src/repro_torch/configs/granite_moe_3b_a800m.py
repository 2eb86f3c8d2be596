"""Granite-MoE-3B-A800M — fine-grained MoE, 40 experts top-8, small
per-expert FFN. [hf:ibm-granite/granite-3.0-1b-a400m-base card, 3b scale
per assignment]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,           # GQA kv=8
    head_dim=64,
    d_ff=512,                 # per-expert FFN dim (fine-grained experts)
    vocab_size=49155,         # padded to 49408 for 16-way TP (base.padded_vocab)
    attn_pattern=("global",),
    num_experts=40,
    experts_per_token=8,
    rope_theta=10000.0,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=64,
        vocab_size=515,       # deliberately non-/256 to test vocab padding
        attn_pattern=("global",),
        num_experts=4,
        experts_per_token=2,
        dtype="float32",
        gate_hidden=32,
        source="reduced granite-moe",
    )
