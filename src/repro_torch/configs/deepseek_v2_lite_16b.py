"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408 vocab=102400,
MLA kv_lora=512, 2 shared + 64 routed experts top-6, first layer dense.
[arXiv:2405.04434]
"""
from .base import ModelConfig

ARCH = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,               # nope 128 + rope 64
    d_ff=1408,
    d_expert=1408,
    vocab_size=102400,
    moe=True,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    first_dense=1,
    first_dense_ff=10944,
    moe_renorm=False,           # deepseek scales, does not renormalize
    mla=True,
    kv_lora_rank=512,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1e4,
)
