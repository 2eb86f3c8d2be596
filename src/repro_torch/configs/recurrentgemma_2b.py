"""RecurrentGemma-2B — Griffin-style hybrid: RG-LRU recurrent blocks with
1 local-attention layer per 3 (pattern recurrent,recurrent,local).
[arXiv:2402.19427 (Griffin / RecurrentGemma)]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,           # MQA (GQA kv=1)
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    attn_pattern=("recurrent", "recurrent", "local"),
    window=2048,              # local attention window [arXiv:2402.19427]
    lru_width=2560,
    rope_theta=10000.0,
    source="arXiv:2402.19427",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke",
        family="hybrid",
        num_layers=3,
        d_model=128,
        num_heads=4,
        num_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        attn_pattern=("recurrent", "recurrent", "local"),
        window=16,
        lru_width=128,
        dtype="float32",
        gate_hidden=32,
        source="reduced recurrentgemma-2b",
    )
