"""Flash-decode over one KV shard: hand-written CUDA for Hopper.

Replaces ``flash_decode_pallas`` of the JAX package
(``src/repro/kernels/flash_decode/kernel.py``): one new token's
attention over a KV shard, returning the shard-normalised output and the
log-sum-exp that ``ref.combine_partials`` merges shards with
(``csrc/flash_decode.cu``).

Bound on an H100: memory — K and V stream past once, against 4 flops an
element.  The TPU kernel carries its online-softmax state across a
sequential grid axis; Hopper has none, so one block owns one (batch row,
KV head) and its warps take interleaved chunks of the sequence, each
with its own running max, sum and accumulator in registers, merged at
the end through shared memory by the exact log-sum-exp rule.  Known gap:
only B x Hkv blocks run (32 of 132 SMs at Mistral-NeMo-12B's decode
width); a split over S with a second combine pass is later work.

The wrapper runs the plain version (``ref.decode_partial``) for tensors
on the CPU and launches the kernel for tensors on a CUDA device, and
counts the launches in ``flash_decode.launches``.
"""
import ctypes
import functools

import torch

from .. import _build
from . import ref

__all__ = ["flash_decode", "flash_decode_plain", "SUPPORTED_HEAD_DIMS",
           "MAX_GROUP"]

SUPPORTED_HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8                       # query heads per KV head


@functools.cache
def _lib():
    """The built library, its entry's C signature set once."""
    lib = _build.load("flash_decode")
    lib.bddt_flash_decode.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 +
        [ctypes.c_float, ctypes.c_void_p])
    lib.bddt_flash_decode.restype = ctypes.c_int
    return lib


def flash_decode_plain(q, k, v, scale: float):
    """``(o, lse)`` of ``ref.decode_partial`` in plain PyTorch."""
    return ref.decode_partial(q, k, v, scale=scale)


def _check_shapes(q, k, v, bk: int) -> None:
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"expected q (B, Hq, D) and k, v (B, Hkv, S, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    if tuple(k.shape) != (b, hkv, s, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be ({b}, Hkv, S, {d})")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{hq} query heads do not split over {hkv} KV "
                         "heads")
    if s < 1:
        raise ValueError("the KV shard is empty")
    bk = min(bk, s)
    if s % bk:
        raise ValueError(f"kv length {s} not divisible by block {bk}")


def flash_decode(q, k, v, scale: float | None = None, bk: int = 512):
    """One-token attention of q (B, Hq, D) over k, v (B, Hkv, S, D):
    ``(o (B, Hq, D) f32, lse (B, Hq) f32)``.  The plain version on the
    CPU, one kernel launch on CUDA (float32, contiguous, 16-byte aligned,
    D in :data:`SUPPORTED_HEAD_DIMS`, at most :data:`MAX_GROUP` query
    heads per KV head).  ``bk = min(bk, S)`` must divide S, the
    reference's block contract; the kernel itself splits S by warps."""
    _check_shapes(q, k, v, bk)
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    scale = float(d) ** -0.5 if scale is None else float(scale)
    kinds = {x.device.type for x in (q, k, v)}
    if kinds == {"cpu"}:
        return flash_decode_plain(q, k, v, scale)
    if kinds != {"cuda"}:
        raise ValueError(f"operands on mixed or unsupported devices: "
                         f"{sorted(str(x.device) for x in (q, k, v))}")
    _build.require(q, "q", (b, hq, d))
    _build.require(k, "k", (b, hkv, s, d), device=q.device)
    _build.require(v, "v", (b, hkv, s, d), device=q.device)
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"{hq // hkv} query heads per KV head, the kernel "
                         f"takes at most {MAX_GROUP}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    o = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    rc = _lib().bddt_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, hq, hkv, s, d, scale,
        _build.stream_handle(q.device))
    _build.check(rc, "flash_decode")
    flash_decode.launches += 1
    return o, lse


flash_decode.launches = 0
