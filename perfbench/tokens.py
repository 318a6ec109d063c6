"""The training traffic's token stream: a frozen copy of the program's
``SyntheticTokens`` (``repro_torch/data/pipeline.py``), so that a change
to the program never changes the yardstick's data.

Every batch is a pure function of (seed, step): Zipf-distributed ids by
the inverse CDF, with a learnable bigram structure injected (each odd
position is its even neighbour shifted by a per-row offset), drawn on the
CPU from a ``torch.Generator`` seeded by ``numpy.random.SeedSequence``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["SyntheticTokens"]


@dataclass(frozen=True)
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2

    def _generator(self, step: int) -> torch.Generator:
        seq = np.random.SeedSequence([self.seed, step, 0])
        return torch.Generator().manual_seed(
            int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1)))

    def batch_at(self, step: int) -> torch.Tensor:
        """(global_batch, seq_len) int32 token ids on the CPU."""
        gen = self._generator(step)
        u = torch.rand((self.global_batch, self.seq_len), generator=gen) * \
            (1.0 - 1e-6) + 1e-6
        a = 1 - self.zipf_a
        ranks = torch.floor((self.vocab_size ** a +
                             u * (1 - self.vocab_size ** a)) ** (1 / a))
        tokens = torch.clamp(ranks.to(torch.int32) - 1, 0,
                             self.vocab_size - 1)
        shift = torch.randint(1, 17, (self.global_batch, 1), generator=gen,
                              dtype=torch.int32)
        predictable = (tokens[:, ::2] + shift) % self.vocab_size
        n_odd = tokens[:, 1::2].shape[1]
        tokens[:, 1::2] = predictable[:, :n_odd]
        return tokens
