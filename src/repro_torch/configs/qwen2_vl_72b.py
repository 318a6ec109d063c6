"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution (patch embeds stubbed).
[arXiv:2409.12191]
"""
from .base import ModelConfig

ARCH = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_type="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    vision_seq=256,             # stub: precomputed patch embeddings
    act="swiglu",
    norm="rmsnorm",
)
