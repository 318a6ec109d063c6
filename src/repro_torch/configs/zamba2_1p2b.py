"""zamba2-1.2b [hybrid] — 38 Mamba2 blocks d_model=2048, shared attention
block (32H MHA + d_ff=8192 MLP) every 6 blocks, vocab=32000, ssm_state=64.
[arXiv:2411.15242]
"""
from .base import ModelConfig

ARCH = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_d_inner=4096,
    ssm_state=64,
    ssm_heads=64,               # headdim 64
    ssm_d_conv=4,
    attn_every=6,
    tie_embeddings=True,
    act="gelu",                 # zamba2 shared MLP uses gelu
    norm="rmsnorm",
    rope_theta=1e4,
)
