"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000 — parallel attn+FFN block, LayerNorm, no bias, tied embeddings.
[hf:CohereForAI/c4ai-command-r-v01]
"""
from .base import ModelConfig

ARCH = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    parallel_block=True,
    tie_embeddings=True,
    norm="layernorm",
    act="swiglu",
    rope_theta=8e6,
)
