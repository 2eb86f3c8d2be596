"""TRIM-KV paper's primary base model scale — Qwen3-4B-like dense GQA
(36L, d_model 2560, 32H/8KV, d_ff 9728). Used for the paper-faithful
experiments in Sec. 5. [arXiv:2505.09388 (Qwen3); paper Sec 5.1]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="trimkv-paper-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    attn_pattern=("global",),
    rope_theta=1000000.0,
    gate_hidden=512,          # paper: single-hidden-layer MLP width 512
    gate_bias_init=18.0,      # paper: b = 18.0
    source="arXiv:2505.09388 / TRIM-KV Sec 5.1",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="trimkv-paper-smoke",
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
        source="reduced trimkv-paper-4b",
    )
