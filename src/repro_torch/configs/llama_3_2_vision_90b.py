"""Llama-3.2-Vision-90B — dense decoder with gated cross-attention layers
to vision embeddings every 5th layer (20 of 100). Vision tower is a STUB:
input_specs() supplies precomputed patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision model card, 90B scale per assignment]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,           # GQA kv=8
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    attn_pattern=("global", "global", "global", "global", "cross"),
    vision_dim=1280,          # ViT-H embedding width (stubbed frontend)
    num_image_tokens=1601,    # one tile of patch embeddings (+CLS)
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama-vision-smoke",
        family="vlm",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        attn_pattern=("global", "cross"),
        vision_dim=64,
        num_image_tokens=17,
        dtype="float32",
        gate_hidden=32,
        source="reduced llama-3.2-vision",
    )
