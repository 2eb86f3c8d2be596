"""Minitron-8B — width/depth-pruned Nemotron-4, dense GQA.
[arXiv:2407.14679]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,           # GQA kv=8
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    attn_pattern=("global",),
    rope_theta=10000.0,
    source="arXiv:2407.14679",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minitron-smoke",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        attn_pattern=("global",),
        dtype="float32",
        gate_hidden=32,
        source="reduced minitron-8b",
    )
