"""Model zoo, every family of ``configs.ARCH_IDS``: the dense decoder-only
family (Mistral-NeMo-12B, Qwen1.5-4B, Nemotron-4-15B, Command-R-35B),
the MoE family (DeepSeek-V2-Lite with MLA attention,
Granite-3.0-1B-A400M; ``moe.py``, ``mla.py``), the VLM family
(Qwen2-VL-72B: the dense stack with M-RoPE, its patch embeddings a
precomputed stub spliced over the first positions), the hybrid family
(Zamba2-1.2B: Mamba2 blocks, ``mamba.py``, and one shared attention
block) and the ``ssm`` family (xLSTM-1.3B: mLSTM and sLSTM blocks,
``xlstm.py``) and the encoder-decoder family (whisper-tiny: a
non-causal encoder over precomputed frame embeddings, the conv front
end's stub, and a causal decoder with cross-attention).

Parameters live in an ``nn.Module`` tree (``transformer.Decoder``) whose
block weights are stacked on a leading layer axis; the functions take
them as nested dicts of tensors, as the reference's take pytrees.
Prefill attention runs through the chunked online-softmax path or the
hand-written flash kernel (``attn_impl="pallas"``); decode uses plain
einsums over the KV cache, as the reference's does.  The Mamba2 and
xLSTM scans are torch ops, as the reference's are jnp: no kernel of
their own.  Training
(``loss_fn``, ``launch.train``) differentiates the chunked path, the
config default, under remat; the flash kernel has no backward.
"""
from .api import (count_params, decode_step, forward_logits, init_cache,
                  init_params, loss_fn, pad_caches, prefill_step, prepare)

__all__ = ["init_params", "count_params", "prepare", "loss_fn",
           "forward_logits", "prefill_step", "decode_step", "init_cache",
           "pad_caches"]
