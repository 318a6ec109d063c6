"""Blocked causal attention with an online softmax: hand-written CUDA for
Hopper.

Replaces ``flash_attention_pallas`` of the JAX package
(``src/repro/kernels/flash_attention/kernel.py``): attention of q
(B, Hq, Sq, D) over k, v (B, Hkv, Skv, D), bf16 or f32, with GQA (query
head h reads KV head h // (Hq / Hkv)), the causal mask aligned to the KV
end (``kv_offset = Skv - Sq``) and max, sum and accumulator in f32
(``csrc/flash_attention.cu``).

Bound on an H100 (SXM, 700 W): operations at the prefill shapes — 4 D
flops per visible (query, key) pair against the tensor cores' 989
TFLOP/s for bf16 operands (67 TFLOP/s FP32 for f32 ones).  The TPU
kernel carries its online-softmax state across a sequential grid axis
over key blocks; on Hopper one block owns a (batch, KV head, query tile)
with all G query heads of that KV head, loops over the key tiles and
skips those no row of the block reaches.  The kernel is chosen by dtype,
with no fallback between them:

* bf16 — ``bddt_flash_attention_bf16``: K and V tiles stream through a
  two-stage shared-memory ring by TMA, both products are ``wgmma`` on the
  tensor cores (P rounded to bf16 for P.V), the softmax runs on the
  accumulator fragments.
* f32 — ``bddt_flash_attention_f32``: FP32 FFMA products on tiles staged
  by the threads; TF32 would miss the f32 tolerance of 2e-5.

The TPU kernel skips whole (query block, key block) pairs, so a query
row that sees no key (causal, Sq > Skv) averages V over the key blocks
its query block ran, or gives 0 when its block ran none.  The caller's
``bq``/``bk`` decide only that; the kernels tile as they like.

The wrapper runs the plain version (:func:`flash_attention_plain`) for
tensors on the CPU and launches a kernel for tensors on a CUDA device.
On ``meta`` tensors (a dry run) it checks what the card's path checks,
launches nothing and returns the output the kernel would write; a flop
counter counts the plain version (``metatrace.account``).  It counts
the launches in ``flash_attention.launches`` and, by kernel, in
``flash_attention.launches_by_kernel``.  Neither has a backward, as the
TPU kernel has none: an input that requires grad while grad mode is on
is refused.
"""
import ctypes
import functools

import torch

from ... import metatrace
from .. import _build

__all__ = ["flash_attention", "flash_attention_plain", "SUPPORTED_HEAD_DIMS"]

SUPPORTED_HEAD_DIMS = (32, 64, 128)
_NEG_INF = -1e30            # the TPU kernel's finite mask value
# the kernel (its name in ``launches_by_kernel``) and C entry of each dtype
KERNELS = {torch.bfloat16: ("bf16_wgmma", "bddt_flash_attention_bf16"),
           torch.float32: ("f32_ffma", "bddt_flash_attention_f32")}


@functools.cache
def _lib():
    """The built library, its entries' C signatures set once."""
    lib = _build.load("flash_attention")
    for _, entry in KERNELS.values():
        fn = getattr(lib, entry)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 +
                       [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _blocks(sq: int, skv: int, bq: int, bk: int) -> tuple[int, int]:
    """The TPU kernel's block sizes and their divisibility contract."""
    bq, bk = min(bq, sq), min(bk, skv)
    if sq % bq or skv % bk:
        raise ValueError(f"seq lens {(sq, skv)} not divisible by {(bq, bk)}")
    return bq, bk


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: float | None = None, bq: int = 256,
                          bk: int = 256):
    """What ``flash_attention_pallas`` computes, in plain PyTorch over the
    full score matrix.  A visible key enters the softmax; a key of a block
    the row's query block ran but the mask hides scores -1e30 (it counts
    1 where the row sees no key at all); any other key is left out."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    bq, bk = _blocks(sq, skv, bq, bk)
    scale = float(d) ** -0.5 if scale is None else float(scale)
    if hq != hkv:
        k = torch.repeat_interleave(k, hq // hkv, dim=1)
        v = torch.repeat_interleave(v, hq // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        kv_off = skv - sq
        rows = torch.arange(sq, device=q.device)
        kpos = torch.arange(skv, device=q.device)[None, :]
        visible = kpos <= rows[:, None] + kv_off
        last_q = (rows // bq) * bq + bq - 1 + kv_off
        ran_to = torch.where(
            last_q >= 0,
            torch.clamp((last_q.clamp(min=0) // bk + 1) * bk, max=skv),
            torch.zeros_like(last_q))
        ran = kpos < ran_to[:, None]
        s.masked_fill_(ran & ~visible, _NEG_INF)
        s.masked_fill_(~ran, -torch.inf)
    m = s.amax(-1, keepdim=True).clamp(min=_NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / \
        torch.where(l == 0.0, torch.ones_like(l), l)
    return out.to(q.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected q (B, Hq, Sq, D) and k, v "
                         f"(B, Hkv, Skv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    b, hq, _, d = q.shape
    _, hkv, skv, _ = k.shape
    if tuple(k.shape) != (b, hkv, skv, d) or tuple(v.shape) != \
            tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be ({b}, Hkv, Skv, {d})")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{hq} query heads do not split over {hkv} KV "
                         "heads")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError("flash_attention has no backward (nor has the "
                           "TPU kernel it replaces); call it under "
                           "torch.no_grad() or on tensors that do not "
                           "require grad")


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, bq: int = 256,
                    bk: int = 256):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's
    dtype.  The plain version on the CPU, one kernel launch on CUDA
    (bf16 or f32, one dtype, contiguous, 16-byte aligned, D in
    :data:`SUPPORTED_HEAD_DIMS`): the ``wgmma`` kernel for bf16, the FFMA
    kernel for f32 (:data:`KERNELS`); on ``meta`` no launch, an empty
    output.  ``min(bq, Sq)`` and ``min(bk, Skv)``
    must divide Sq and Skv, the TPU kernel's block contract."""
    _check(q, k, v)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    bq, bk = _blocks(sq, skv, bq, bk)
    scale = float(d) ** -0.5 if scale is None else float(scale)
    kinds = {x.device.type for x in (q, k, v)}
    if kinds == {"cpu"}:
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     bq=bq, bk=bk)
    if kinds not in ({"cuda"}, {"meta"}):
        raise ValueError(f"operands on mixed or unsupported devices: "
                         f"{sorted(str(x.device) for x in (q, k, v))}")
    if q.dtype not in KERNELS:
        raise ValueError(f"expected bfloat16 or float32, got {q.dtype}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if kinds == {"meta"}:
        _build.require_pointerless(q, k, v, dtype=q.dtype)
        metatrace.account(flash_attention_plain, q, k, v, causal=causal,
                          scale=scale, bq=bq, bk=bk)
        return torch.empty_like(q)
    _build.require(q, "q", (b, hq, sq, d), dtype=q.dtype)
    _build.require(k, "k", (b, hkv, skv, d), dtype=q.dtype, device=q.device)
    _build.require(v, "v", (b, hkv, skv, d), dtype=q.dtype, device=q.device)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    kernel, entry = KERNELS[q.dtype]
    o = torch.empty_like(q)
    rc = getattr(_lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, hkv,
        sq, skv, d, int(causal), bq, bk, scale,
        _build.stream_handle(q.device))
    _build.check(rc, f"flash_attention ({kernel})")
    flash_attention.launches += 1
    flash_attention.launches_by_kernel[kernel] += 1
    return o


flash_attention.launches = 0
flash_attention.launches_by_kernel = {name: 0 for name, _ in KERNELS.values()}
