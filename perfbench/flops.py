"""The yardstick's arithmetic: a model's operations for a training step
and a prefill, the flash attention kernel's operations and bytes, and
the peaks of the card.  Counted from a configuration file's keys, never
from the program.

Model operations count the products a token needs once (no recompute):
2 per active parameter a token forward, 6 forward and backward, plus
attention's two products over the causal half.  The active parameters
are those a token multiplies by: every layer's attention and FFN
weights, of a MoE layer only its top-k experts and its router, and the
output projection (the embedding table when it is tied); the embedding
lookup is no product and norms are left out.
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


def head_params(conf: dict) -> int:
    """The output projection's parameters (the tied table's too)."""
    return conf["hidden_size"] * conf.get("padded_vocab_size",
                                          conf["vocab_size"])


def active_params(conf: dict) -> int:
    d = conf["hidden_size"]
    hq, hkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    dh = conf.get("head_dim") or d // hq
    f = conf["intermediate_size"]
    attn = d * hq * dh * 2 + d * hkv * dh * 2
    if conf.get("num_local_experts"):
        ffn = conf["num_experts_per_tok"] * 3 * d * f + \
            d * conf["num_local_experts"]
    else:
        ffn = 3 * d * f
    return conf["num_hidden_layers"] * (attn + ffn) + head_params(conf)


def attn_dims(conf: dict) -> tuple[int, int, int]:
    hq = conf["num_attention_heads"]
    dh = conf.get("head_dim") or conf["hidden_size"] // hq
    return conf["num_hidden_layers"], hq, dh


def train_step_flops(conf: dict, batch: int, seq: int) -> float:
    """6 N_active T + 6 L B Hq S^2 Dh (T = B S; causal attention)."""
    layers, hq, dh = attn_dims(conf)
    return 6.0 * active_params(conf) * batch * seq + \
        6.0 * layers * batch * hq * seq * seq * dh


def prefill_flops(conf: dict, batch: int, seq: int) -> float:
    """2 N_active B L + 2 L_layers B Hq Dh L^2 (causal attention), the
    output projection taken for the last position of each row only, as
    a prefill takes it."""
    layers, hq, dh = attn_dims(conf)
    body = active_params(conf) - head_params(conf)
    return 2.0 * body * batch * seq + 2.0 * head_params(conf) * batch + \
        2.0 * layers * batch * hq * dh * seq * seq


def flash_work(conf: dict, batch: int, seq: int,
               elem_bytes: int = 2) -> tuple[float, float]:
    """One causal flash attention launch over (batch, seq): operations
    4 B Hq Dh L(L+1)/2, and bytes of Q, K, V and O read or written once."""
    _, hq, dh = attn_dims(conf)
    hkv = conf["num_key_value_heads"]
    flops = 4.0 * batch * hq * dh * seq * (seq + 1) / 2
    nbytes = elem_bytes * batch * seq * dh * (2 * hq + 2 * hkv)
    return flops, nbytes


def bound_s(flops: float, nbytes: float, pk: dict) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 tensor-core peak and the bytes over HBM's."""
    return max(flops / pk["bf16_flops_per_s"], nbytes / pk["hbm_bytes_per_s"])
