"""How far the recurrent families' two decoding paths part with depth, in
the JAX package and in its PyTorch port, on the CPU.

For Zamba2-1.2B and xLSTM-1.3B at a reduced width (d 512) and random
weights, in f32, at each depth: the teacher-forcing gap (the decode step
at position S after prefill against the full forward over S + 1 tokens,
max |difference| of the logits) in both packages, beside the logits'
std.  Both paths compute the same function and differ only where they
round, so the gap measures how much the stack amplifies rounding.
Zamba2's Mamba2 blocks have no residual and xLSTM's blocks no input
norm (the reference's design, kept by the port), so the gap grows with
depth in both packages alike: for Zamba2 about ninefold every 6
layers, for xLSTM about twofold every 8 and then faster as its residual
stream grows.  ``chip_smoke.py`` holds the recurrent families'
exactness at 8 layers for this reason::

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/recurrent_drift.py
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as ref_configs
from repro.models import api as ref_api
from repro_torch import configs
from repro_torch.interop import params_from_reference
from repro_torch.models import api

WIDTHS = {
    "zamba2-1.2b": dict(d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
                        d_ff=1024, ssm_d_inner=1024, ssm_state=64,
                        ssm_heads=16, ssm_chunk=64, vocab_size=2048,
                        attn_q_chunk=64, attn_k_chunk=64),
    "xlstm-1.3b": dict(d_model=512, n_heads=4, n_kv_heads=4, head_dim=128,
                       xlstm_d_inner=1024, xlstm_chunk=64, vocab_size=2048,
                       slstm_every=8),
}
DEPTHS = {"zamba2-1.2b": (8, 14, 20, 26, 38),
          "xlstm-1.3b": (8, 16, 24, 32, 40, 48)}
B, S = 2, 64


def drift(arch: str, n_layers: int) -> dict:
    kw = dict(WIDTHS[arch], n_layers=n_layers, compute_dtype="float32")
    cfg = configs.get_config(arch).reduced(**kw)
    ref_cfg = ref_configs.get_config(arch).reduced(**kw)
    w = jax.jit(ref_api.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), ref_cfg)
    tok = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)

    full = jax.jit(ref_api.forward_logits, static_argnums=1)(
        w, ref_cfg, {"tokens": jnp.asarray(tok)})
    _, c = jax.jit(ref_api.prefill_step, static_argnums=1)(
        w, ref_cfg, {"tokens": jnp.asarray(tok[:, :S])})
    dec, _ = jax.jit(ref_api.decode_step, static_argnums=1)(
        w, ref_cfg, jnp.asarray(tok[:, S:]), ref_api.pad_caches(c, S + 8),
        jnp.int32(S))
    ref_gap = float(jnp.abs(dec[:, 0] - full[:, S]).max())

    params = params_from_reference(jax.tree_util.tree_map(np.asarray, w),
                                   cfg, device="cpu")
    t = torch.from_numpy(tok)
    with torch.inference_mode():
        p_full = api.forward_logits(params, cfg, {"tokens": t})
        _, c = api.prefill_step(params, cfg, {"tokens": t[:, :S]})
        p_dec, _ = api.decode_step(params, cfg, t[:, S:],
                                   api.pad_caches(c, S + 8), S)
    port_gap = float((p_dec[:, 0] - p_full[:, S]).abs().max())
    return dict(arch=arch, n_layers=n_layers, logits_std=float(full.std()),
                reference_teacher_forcing=ref_gap,
                port_teacher_forcing=port_gap,
                port_vs_reference=float(np.abs(
                    p_full.numpy() - np.asarray(full)).max()))


def main() -> None:
    for arch, depths in DEPTHS.items():
        for n_layers in depths:
            print(drift(arch, n_layers), flush=True)


if __name__ == "__main__":
    main()
