"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from .base import ModelConfig

ARCH = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    d_expert=512,
    vocab_size=49155,
    moe=True,
    n_experts=32,
    top_k=8,
    moe_renorm=True,
    tie_embeddings=True,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1e4,
)
