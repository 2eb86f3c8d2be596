"""CodeQwen1.5-7B — dense MHA (kv heads == q heads), QKV bias.
[hf:Qwen/CodeQwen1.5-7B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,          # full MHA (GQA kv=32)
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    attn_pattern=("global",),
    qkv_bias=True,
    rope_theta=1000000.0,
    source="hf:Qwen/CodeQwen1.5-7B",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="codeqwen-smoke",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        attn_pattern=("global",),
        qkv_bias=True,
        dtype="float32",
        gate_hidden=32,
        source="reduced codeqwen1.5-7b",
    )
