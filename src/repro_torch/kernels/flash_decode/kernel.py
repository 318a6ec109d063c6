"""Flash-decode over one KV shard: hand-written CUDA for Hopper.

Replaces ``flash_decode_pallas`` of the JAX package
(``src/repro/kernels/flash_decode/kernel.py``): one new token's
attention over a KV shard, returning the shard-normalised output and the
log-sum-exp that ``ref.combine_partials`` merges shards with
(``csrc/flash_decode.cu``).

Bound on an H100: memory — K and V stream past once, against 4 flops an
element.  The TPU kernel carries its online-softmax state across a
sequential grid axis; Hopper has none, so the kernel splits S across a
thread-block cluster of :data:`CLUSTER_SIZE` blocks per (batch row, KV
head), each on a contiguous range of keys (:func:`split`).  A block's
warps stream their keys through rings of shared-memory stages, each warp
with its own running max, sum and accumulator; the warps' partials merge
in shared memory and the blocks' on the cluster's first block through
distributed shared memory, by the exact log-sum-exp rule, in one launch.

K and V may be float32 or bfloat16 (both the same), as on the TPU,
whose kernel casts each K/V block to f32: the bf16 instantiation keeps
bf16 in its shared-memory rings and converts each element to f32 where
it is used, so every sum is f32.  q, o and lse are f32.

The wrapper runs the plain version (``ref.decode_partial``) for tensors
on the CPU and launches the kernel for tensors on a CUDA device, and
counts the launches in ``flash_decode.launches``.  On ``meta`` tensors
(a dry run) it checks what the card's path checks, launches nothing and
returns the outputs the kernel would write; a flop counter counts the
plain version (``metatrace.account``).
"""
import ctypes
import functools

import torch

from ... import metatrace
from .. import _build
from . import ref

__all__ = ["flash_decode", "flash_decode_plain", "SUPPORTED_HEAD_DIMS",
           "MAX_GROUP", "KV_DTYPES", "CLUSTER_SIZE", "KEYS_PER_STAGE",
           "WARP_KEYS", "split", "occupancy"]

SUPPORTED_HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8                       # query heads per KV head
KV_DTYPES = (torch.float32, torch.bfloat16)   # K and V on the card
CLUSTER_SIZE = 16                   # blocks per (batch row, KV head)
KEYS_PER_STAGE = 32                 # keys of one block stage
WARP_KEYS = 8                       # ... of which each of 4 warps takes 8


def split(s: int) -> tuple[int, int]:
    """``(cluster size, keys per block)`` of a call over ``s`` keys: block
    r of a cluster takes keys ``[r R, min(s, (r + 1) R))``, ``R =
    ceil(s / CLUSTER_SIZE)`` rounded up to a whole stage, so a block's
    range may be short or empty.  The wrapper passes R to the kernel."""
    r = -(-s // CLUSTER_SIZE)
    return CLUSTER_SIZE, -(-r // KEYS_PER_STAGE) * KEYS_PER_STAGE


@functools.cache
def _lib():
    """The built library, its entries' C signatures set once."""
    lib = _build.load("flash_decode")
    for entry in (lib.bddt_flash_decode, lib.bddt_flash_decode_bf16):
        entry.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 +
                          [ctypes.c_float, ctypes.c_void_p])
        entry.restype = ctypes.c_int
    lib.bddt_flash_decode_describe.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2)
    lib.bddt_flash_decode_describe.restype = ctypes.c_int
    return lib


def occupancy(g: int, d: int,
              kv_dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """``(dynamic shared-memory bytes of a block, clusters the card holds
    at once)`` of the built kernel with ``g`` query heads per KV head at
    head dim ``d`` and K/V in ``kv_dtype``."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"K/V dtype {kv_dtype} not in {KV_DTYPES}")
    smem, resident = ctypes.c_int(), ctypes.c_int()
    _build.check(_lib().bddt_flash_decode_describe(
        g, d, torch.finfo(kv_dtype).bits // 8, ctypes.byref(smem),
        ctypes.byref(resident)), "flash_decode occupancy")
    return smem.value, resident.value


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
    CPU, one kernel launch on CUDA (q float32, k and v both float32 or
    both bfloat16, contiguous, 16-byte aligned, D in
    :data:`SUPPORTED_HEAD_DIMS`, at most :data:`MAX_GROUP` query heads per
    KV head).  ``bk = min(bk, S)`` must divide S, the
    reference's block contract; the kernel splits S across the blocks of
    a cluster as :func:`split` says."""
    _check_shapes(q, k, v, bk)
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    scale = float(d) ** -0.5 if scale is None else float(scale)
    kinds = {x.device.type for x in (q, k, v)}
    if kinds == {"cpu"}:
        return flash_decode_plain(q, k, v, scale)
    if kinds not in ({"cuda"}, {"meta"}):
        raise ValueError(f"operands on mixed or unsupported devices: "
                         f"{sorted(str(x.device) for x in (q, k, v))}")
    if k.dtype not in KV_DTYPES:
        raise ValueError(f"k: expected one of {KV_DTYPES}, got {k.dtype}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"{hq // hkv} query heads per KV head, the kernel "
                         f"takes at most {MAX_GROUP}")
    if kinds == {"meta"}:
        _build.require_pointerless(q, dtype=torch.float32)
        _build.require_pointerless(k, v, dtype=k.dtype)
        metatrace.account(flash_decode_plain, q, k, v, scale)
        return (torch.empty((b, hq, d), dtype=torch.float32, device="meta"),
                torch.empty((b, hq), dtype=torch.float32, device="meta"))
    _build.require(q, "q", (b, hq, d))
    _build.require(k, "k", (b, hkv, s, d), dtype=k.dtype, device=q.device)
    _build.require(v, "v", (b, hkv, s, d), dtype=k.dtype, device=q.device)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    o = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    entry = (_lib().bddt_flash_decode if k.dtype == torch.float32
             else _lib().bddt_flash_decode_bf16)
    rc = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, hq, hkv, s, d, split(s)[1], scale,
        _build.stream_handle(q.device))
    _build.check(rc, "flash_decode")
    flash_decode.launches += 1
    return o, lse


flash_decode.launches = 0
