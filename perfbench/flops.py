"""The yardstick's arithmetic: a model's operations for a training step
and a prefill, the flash attention kernel's operations and bytes, and
the peaks of the card.  Counted from a configuration file's keys, never
from the program.

A configuration's model operations are its reference module's
(``perfbench.common.reference``): its ``train_step_flops(conf, batch,
seq)`` and ``prefill_flops(conf, batch, seq)``; those of GQA decoders
are in ``perfbench/reference/model.py``.  :func:`flash_work`, the flash
kernel's count, reads the GQA keys: it covers GQA configurations only.
"""
from __future__ import annotations

import pathlib

from . import common

PEAKS = common.load_json(pathlib.Path(__file__).with_name("peaks.json"))


def peak(kind: str) -> dict | None:
    """The peak rates of the card named ``kind`` (the first entry whose
    key is part of the name), or None."""
    for key, row in PEAKS.items():
        if key in kind:
            return row
    return None


def train_step_flops(conf: dict, batch: int, seq: int) -> float:
    """The model's operations a training step of (batch, seq), by the
    configuration's reference module."""
    return common.reference(conf).train_step_flops(conf, batch, seq)


def prefill_flops(conf: dict, batch: int, seq: int) -> float:
    """The model's operations a prefill of (batch, seq), by the
    configuration's reference module."""
    return common.reference(conf).prefill_flops(conf, batch, seq)


def flash_work(conf: dict, batch: int, seq: int,
               elem_bytes: int = 2) -> tuple[float, float]:
    """One causal flash attention launch over (batch, seq): operations
    4 B Hq Dh L(L+1)/2, and bytes of Q, K, V and O read or written once.
    It reads the GQA keys, so it counts GQA configurations only."""
    hq, hkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    dh = conf.get("head_dim") or conf["hidden_size"] // hq
    flops = 4.0 * batch * hq * dh * seq * (seq + 1) / 2
    nbytes = elem_bytes * batch * seq * dh * (2 * hq + 2 * hkv)
    return flops, nbytes


def bound_s(flops: float, nbytes: float, pk: dict) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 tensor-core peak and the bytes over HBM's."""
    return max(flops / pk["bf16_flops_per_s"], nbytes / pk["hbm_bytes_per_s"])
