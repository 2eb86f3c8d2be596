"""SeamlessM4T-Large-v2 — encoder-decoder, multimodal. The speech
frontend (mel + conformer feature extractor) is a STUB: input_specs()
provides precomputed frame embeddings for the encoder. TRIM-KV applies
to the decoder self-attention cache. [arXiv:2308.11596]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,            # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,          # MHA (GQA kv=16)
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,        # padded to 256256 for 16-way TP
    attn_pattern=("cross",),  # decoder layer = self-attn + cross-attn
    source_len=4096,          # stub audio frame-embedding length
    rope_theta=10000.0,
    source="arXiv:2308.11596",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke",
        family="encdec",
        num_layers=2,
        encoder_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=515,       # non-/256 to exercise vocab padding
        attn_pattern=("cross",),
        source_len=24,
        dtype="float32",
        gate_hidden=32,
        source="reduced seamless-m4t",
    )
