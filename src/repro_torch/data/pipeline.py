"""Deterministic synthetic token pipeline with O(1) skip-ahead (the JAX
package's ``data/pipeline.py``).

Every batch is a pure function of (seed, step, host index): drawn from a
``torch.Generator`` seeded from the three, with no state files and no
epochs.  After a restart at step k the pipeline resumes at step k by
construction, with no replayed or skipped samples (the deterministic
data skip-ahead of the checkpoint/restart design).  Each host draws only
its slice of the global batch.

The stream is Zipf-ish over the vocabulary (the reference's inverse-CDF
formula) with the reference's injected bigram structure, so losses fall
during example training runs.  The reference draws with threefry and
this pipeline with torch's generator: the same distribution, other
tokens.  Tokens are drawn on the CPU, whatever device trains on them.
``make_batch_specs`` gives one training batch's inputs as ``meta``
tensors (shapes and dtypes only), the reference's dry-run stand-ins.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["SyntheticTokens", "make_batch_specs"]


@dataclass(frozen=True)
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2

    def _generator(self, step: int, host_index: int) -> torch.Generator:
        # SeedSequence mixes the three into one 63-bit seed
        seq = np.random.SeedSequence([self.seed, step, host_index])
        return torch.Generator().manual_seed(
            int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1)))

    def batch_at(self, step: int, *, host_index: int = 0,
                 host_count: int = 1) -> dict:
        """{"tokens": (global_batch // host_count, seq_len) int32} on the
        CPU: this host's slice of the global batch at ``step``."""
        per_host = self.global_batch // host_count
        gen = self._generator(step, host_index)
        # Zipf via inverse-CDF on uniform in [1e-6, 1), in f32
        u = torch.rand((per_host, self.seq_len), generator=gen) * \
            (1.0 - 1e-6) + 1e-6
        a = 1 - self.zipf_a
        ranks = torch.floor((self.vocab_size ** a +
                             u * (1 - self.vocab_size ** a)) ** (1 / a))
        tokens = torch.clamp(ranks.to(torch.int32) - 1, 0,
                             self.vocab_size - 1)
        # inject learnable bigram structure: even positions predict odd
        shift = torch.randint(1, 17, (per_host, 1), generator=gen,
                              dtype=torch.int32)
        predictable = (tokens[:, ::2] + shift) % self.vocab_size
        n_odd = tokens[:, 1::2].shape[1]
        tokens[:, 1::2] = predictable[:, :n_odd]
        return {"tokens": tokens}

    def stream(self, start_step: int = 0, **kw):
        step = start_step
        while True:
            yield self.batch_at(step, **kw)
            step += 1


def make_batch_specs(cfg, seq_len: int, global_batch: int) -> dict:
    """One training batch's inputs as tensors on the ``meta`` device:
    ``tokens`` (global_batch, seq_len) int32, and in the compute dtype the
    VLM family's ``vision_embeds`` (global_batch, vision_seq, d_model) and
    the audio family's ``enc_frames`` (global_batch, encoder_seq,
    d_model)."""
    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out = {"tokens": spec((global_batch, seq_len), torch.int32)}
    cd = getattr(torch, cfg.compute_dtype)
    if cfg.vision_seq:
        out["vision_embeds"] = spec(
            (global_batch, cfg.vision_seq, cfg.d_model), cd)
    if cfg.family == "audio":
        out["enc_frames"] = spec(
            (global_batch, cfg.encoder_seq, cfg.d_model), cd)
    return out
