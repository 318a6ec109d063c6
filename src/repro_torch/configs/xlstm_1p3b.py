"""xlstm-1.3b [ssm] — 48 blocks d_model=2048 4H vocab=50304 — mLSTM with
projection factor 2 plus sLSTM every 8th block (7:1).  [arXiv:2405.04517]
"""
from .base import ModelConfig

ARCH = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                     # blocks are self-contained
    vocab_size=50304,
    xlstm_d_inner=4096,
    xlstm_d_conv=4,
    slstm_every=8,
    tie_embeddings=True,
    norm="rmsnorm",
    rope_type="none",
)
