"""Gemma-3-12B — dense GQA with 5:1 local:global attention interleave,
128k context. [hf:google/gemma-3-1b-pt model card, scaled per assignment]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,           # GQA kv=8
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    attn_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,              # gemma3 local window
    rope_theta=1000000.0,     # global layers use 1M theta
    source="hf:google/gemma-3-1b-pt",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        attn_pattern=("local", "global"),
        window=16,
        dtype="float32",
        gate_hidden=32,
        source="reduced gemma3-12b",
    )
