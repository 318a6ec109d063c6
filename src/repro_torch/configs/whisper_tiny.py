"""whisper-tiny [audio] — 4L enc + 4L dec, d_model=384 6H d_ff=1536
vocab=51865 — encoder-decoder; conv frontend stubbed (input_specs provides
precomputed frame embeddings).  [arXiv:2212.04356]
"""
from .base import ModelConfig

ARCH = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    encoder_layers=4,
    encoder_seq=1500,
    is_encoder_decoder=True,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    rope_type="sinusoidal",
)
