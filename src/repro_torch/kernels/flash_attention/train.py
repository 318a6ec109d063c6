"""Training attention on Hopper: a hand-written forward and backward
(``csrc/flash_attention_train.cu``) for what ``chunked`` computes.

Replaces no TPU kernel: the JAX package trains through ``chunked_attention``
(``src/repro/kernels/flash_attention/ops.py``), a ``lax.scan`` that XLA
fuses, and the port ran the same loop in torch (:func:`ops.chunked_attention`),
f32 FFMA products and elementwise passes over every f32 score block, three
times under its nested checkpoints.  Here one ``torch.autograd.Function``
does the same online-softmax mathematics in four kernels: a forward that
writes o, each row's log-sum-exp and, for the backward, o in f32, and a
deterministic backward (a rowsum prepass, dQ, and dK with dV; no atomics).
Bound on an H100: operations, 14 B Hq D S^2 flops a causal layer under
remat ``full`` (the forward's 3 twice, the backward's 8), against 989
TFLOP/s; the backward runs 10, S and dP in both of its kernels so as to
need no atomics.  The kernel source says how its design meets the bound.

Precision is the chunked path's: scores and products summed in f32, and
P and dS, which the chunked path holds in f32, enter every product as a
hi + lo pair of bf16 values.  :func:`forward_plain` and
:func:`backward_plain` spell the kernels' mathematics in plain PyTorch with
explicit backward formulas (``lse``, ``delta``, ``dS``, the split); the
autograd function runs them for tensors on the CPU, the kernels for tensors
on a CUDA device.

Which calls take the kernels is :func:`takes_kernels`, a pure function of
the operands' device type, dtype and shapes and of ``causal``:
``ops.attention(impl="chunked")`` sends a call there when it holds and to
the chunked torch path otherwise (the CPU, f32, MLA's asymmetric heads,
causal Sq > Skv).  Launches are counted by kernel in
``flash_attention_train.launches_by_kernel`` (:data:`KERNELS`).

On ``meta`` tensors (the dry run, ``launch.dryrun``) a call the card would
send to the kernels goes to :func:`attention_on_meta`: it allocates what
the kernels allocate and save (o, o32, lse; delta, dq, dk, dv), and the
flop counter counts it as the chunked path, whose loop runs under
``metatrace.unseen``: counted, and held by no one.
"""
import ctypes
import functools

import torch

from ... import metatrace
from .. import _build
from .kernel import SUPPORTED_HEAD_DIMS

__all__ = ["takes_kernels", "flash_attention_train", "attention_on_meta",
           "forward_plain", "backward_plain", "KERNELS"]

LOG2E = 1.4426950408889634
# the kernels' names in ``flash_attention_train.launches_by_kernel``: the
# forward, then the backward's rowsum prepass, dQ and dK/dV
KERNELS = ("train_fwd", "train_delta", "train_dq", "train_dkdv")
_MAX_GROUP = 64         # query heads a KV head: the rows of one tile
_MAX_GRID = 65535       # batch and KV heads: the grid's y and z


def takes_kernels(device_type: str, dtype, q_shape, k_shape, v_shape,
                  causal: bool) -> bool:
    """Whether attention of q over k, v (all on ``device_type``, all of
    ``dtype``) runs the training kernels: CUDA, bf16, q (B, Hq, Sq, D) and
    k, v (B, Hkv, Skv, D) with D in :data:`SUPPORTED_HEAD_DIMS`, Hq a
    multiple of Hkv by at most 64, and Sq <= Skv when causal (every row sees
    a key)."""
    if device_type != "cuda" or dtype != torch.bfloat16:
        return False
    if len(q_shape) != 4 or len(k_shape) != 4:
        return False
    b, hq, sq, d = q_shape
    _, hkv, skv, _ = k_shape
    return (d in SUPPORTED_HEAD_DIMS and
            tuple(k_shape) == (b, hkv, skv, d) and
            tuple(v_shape) == tuple(k_shape) and
            1 <= hkv <= _MAX_GRID and b <= _MAX_GRID and hq % hkv == 0 and
            hq // hkv <= _MAX_GROUP and sq >= 1 and skv >= 1 and
            (not causal or sq <= skv))


def flash_attention_train(q, k, v, *, causal: bool = True,
                          scale: float | None = None):
    """q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's
    dtype, differentiable.  The kernels for CUDA tensors (what
    :func:`takes_kernels` admits; anything else raises), the plain version
    for CPU tensors."""
    scale = float(q.shape[-1]) ** -0.5 if scale is None else float(scale)
    return _Attention.apply(q, k, v, bool(causal), scale)


flash_attention_train.launches_by_kernel = dict.fromkeys(KERNELS, 0)


def attention_on_meta(q, k, v, *, causal: bool = True,
                      scale: float | None = None, q_chunk: int = 512,
                      k_chunk: int = 1024):
    """What :func:`flash_attention_train` does on the card, on ``meta``
    tensors: its allocations (the contiguous operands it saves, o, o32,
    lse; then delta, dq, dk, dv), and the flops and bytes of
    ``ops.chunked_attention`` forward and backward, which it runs under
    ``metatrace.unseen``."""
    scale = float(q.shape[-1]) ** -0.5 if scale is None else float(scale)
    return _OnMeta.apply(q, k, v, bool(causal), scale, q_chunk, k_chunk)


class _Attention(torch.autograd.Function):
    """Saves q, k, v, the output in f32 and the f32 log-sum-exp; the
    backward makes the three gradients in one pass of kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if _on_cpu(q, k, v):
            o, o32, lse = forward_plain(q, k, v, causal=causal, scale=scale)
        else:
            o, o32, lse = _forward_kernel(
                q, k, v, causal, scale, f32=any(ctx.needs_input_grad[:3]))
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o32, lse = ctx.saved_tensors
        do = do.contiguous()
        if _on_cpu(q, k, v):
            dq, dk, dv = backward_plain(q, k, v, o32, lse, do,
                                        causal=ctx.causal, scale=ctx.scale)
        else:
            dq, dk, dv = _backward_kernel(q, k, v, o32, lse, do, ctx.causal,
                                          ctx.scale)
        return dq, dk, dv, None, None


def _on_cpu(*xs) -> bool:
    return all(x.device.type == "cpu" for x in xs)


class _OnMeta(torch.autograd.Function):
    """The card's allocations, the chunked path's count.  The chunked
    path's graph is built in the forward (its saved tensors kept by hooks
    of its own, out of an enclosing checkpoint's reach) and differentiated
    in the backward, so that each of its ops runs as often as it would
    inline: the forward once per call (and again in a remat recompute),
    its own recomputes and backward ops once."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_chunk, k_chunk):
        from .ops import chunked_attention
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        grad = any(ctx.needs_input_grad[:3])
        o = torch.empty_like(q)
        o32 = torch.empty(q.shape, dtype=torch.float32, device=q.device) \
            if grad else None
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        with metatrace.unseen(), torch.set_grad_enabled(grad), \
                torch.autograd.graph.saved_tensors_hooks(lambda x: x,
                                                         lambda x: x):
            # copies made unseen: an alias would keep the operands' storage
            # alive after a remat forward, as the card does not
            leaves = [x.detach().clone().requires_grad_(grad)
                      for x in (q, k, v)]
            out = chunked_attention(*leaves, causal=causal, scale=scale,
                                    q_chunk=q_chunk, k_chunk=k_chunk)
        ctx.chunked = (out, leaves) if grad else None
        ctx.save_for_backward(q, k, v, o32, lse)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o32, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = torch.empty_like(lse)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
            torch.empty_like(v)
        out, leaves = ctx.chunked
        ctx.chunked = None
        with metatrace.unseen():
            torch.autograd.grad(out, leaves, do)
        del delta               # the card frees it once the kernels ran
        return dq, dk, dv, None, None, None, None


# --------------------------------------------------------------- plain
def _grouped(x, g: int):
    """k or v (B, Hkv, S, D) in f32, each KV head repeated for its G query
    heads."""
    x = x.float()
    return x if g == 1 else torch.repeat_interleave(x, g, dim=1)


def _ungrouped(x, g: int):
    """(B, Hq, S, D) summed over each KV head's G query heads."""
    b, hq, s, d = x.shape
    return x if g == 1 else x.view(b, hq // g, g, s, d).sum(2)


def _split_mm(x, y):
    """x @ y with x (f32) taken as hi + lo, hi = bf16(x) and
    lo = bf16(x - hi): two products of bf16 values summed in f32."""
    hi = x.to(torch.bfloat16).float()
    lo = (x - hi).to(torch.bfloat16).float()
    return hi @ y + lo @ y


def _scores(q, k, g: int, causal: bool, scale: float):
    """x = scale log2(e) q k^T in f32, -inf on the keys a row does not
    see (the causal mask aligned to the KV end)."""
    x = (q.float() @ _grouped(k, g).transpose(-1, -2)) * (scale * LOG2E)
    if causal:
        sq, skv = x.shape[-2:]
        last = torch.arange(sq, device=x.device)[:, None] + (skv - sq)
        hidden = torch.arange(skv, device=x.device)[None, :] > last
        x = x.masked_fill(hidden, -torch.inf)
    return x


def forward_plain(q, k, v, *, causal: bool, scale: float):
    """What the forward kernel computes: ``(o, o32, lse)``, o in q's dtype,
    o32 the same in f32 before the rounding, and lse (B, Hq, Sq) f32 in base
    2, lse = log2 sum_j 2^x over the keys a row sees."""
    g = q.shape[1] // k.shape[1]
    x = _scores(q, k, g, causal, scale)
    m = x.amax(-1, keepdim=True)
    p = torch.exp2(x - m)
    l = p.sum(-1, keepdim=True)
    o32 = _split_mm(p, _grouped(v, g)) / l
    return o32.to(q.dtype), o32, (m + torch.log2(l)).squeeze(-1)


def backward_plain(q, k, v, o32, lse, do, *, causal: bool, scale: float):
    """What the backward kernels compute from the forward's o32 and lse and
    the output's gradient do: P = 2^(x - lse), delta = rowsum(do o32),
    dS = P (do v^T - delta), dq = scale dS k, dk = scale dS^T q and
    dv = P^T do, the last two summed over a KV head's query heads; each
    product with P or dS as an operand split as :func:`_split_mm` does."""
    g = q.shape[1] // k.shape[1]
    p = torch.exp2(_scores(q, k, g, causal, scale) - lse[..., None])
    dof = do.float()
    delta = (dof * o32).sum(-1, keepdim=True)
    ds = p * (dof @ _grouped(v, g).transpose(-1, -2) - delta)
    dq = scale * _split_mm(ds, _grouped(k, g))
    dk = scale * _ungrouped(_split_mm(ds.transpose(-1, -2), q.float()), g)
    dv = _ungrouped(_split_mm(p.transpose(-1, -2), dof), g)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -------------------------------------------------------------- kernels
@functools.cache
def _lib():
    """The built library, its entries' C signatures set once."""
    lib = _build.load("flash_attention_train")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bddt_attn_train_fwd.argtypes = ([ptr] * 6 + [i32] * 7 +
                                        [ctypes.c_float, ptr])
    lib.bddt_attn_train_bwd.argtypes = ([ptr] * 10 + [i32] * 7 +
                                        [ctypes.c_float, ptr])
    lib.bddt_attn_train_fwd.restype = lib.bddt_attn_train_bwd.restype = i32
    return lib


def _require(q, k, v, causal: bool) -> tuple[int, ...]:
    """Check the operands the kernels take and return (B, Hq, Hkv, Sq,
    Skv, D); raise on anything else."""
    if not takes_kernels(q.device.type, q.dtype, tuple(q.shape),
                         tuple(k.shape), tuple(v.shape), causal):
        raise ValueError(
            f"the training attention kernels do not take q "
            f"{tuple(q.shape)} {q.dtype} on {q.device}, k {tuple(k.shape)},"
            f" v {tuple(v.shape)}, causal={causal} (takes_kernels)")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    for name, x in (("k", k), ("v", v)):
        _build.require(x, name, (b, hkv, skv, d), dtype=q.dtype,
                       device=q.device)
    _build.require(q, "q", (b, hq, sq, d), dtype=q.dtype)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: expected a 16-byte aligned tensor")
    return b, hq, hkv, sq, skv, d


def _count(*names: str) -> None:
    for name in names:
        flash_attention_train.launches_by_kernel[name] += 1


def _forward_kernel(q, k, v, causal: bool, scale: float, f32: bool = True):
    """``(o, o32, lse)`` as :func:`forward_plain` gives them; o32 (what the
    backward reads) only where ``f32``, else None."""
    b, hq, hkv, sq, skv, d = _require(q, k, v, causal)
    o = torch.empty_like(q)
    o32 = torch.empty(q.shape, dtype=torch.float32, device=q.device) \
        if f32 else None
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    rc = _lib().bddt_attn_train_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if o32 is None else o32.data_ptr(), lse.data_ptr(), b, hq, hkv,
        sq, skv, d, int(causal), scale, _build.stream_handle(q.device))
    _build.check(rc, "flash_attention_train forward")
    _count(KERNELS[0])
    return o, o32, lse


def _backward_kernel(q, k, v, o32, lse, do, causal: bool, scale: float):
    b, hq, hkv, sq, skv, d = _require(q, k, v, causal)
    _build.require(do, "do", tuple(q.shape), dtype=q.dtype, device=q.device)
    _build.require(o32, "o32", tuple(q.shape), device=q.device)
    _build.require(lse, "lse", (b, hq, sq), device=q.device)
    if do.data_ptr() % 16:
        raise ValueError("do: expected a 16-byte aligned tensor")
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    rc = _lib().bddt_attn_train_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o32.data_ptr(),
        lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq, skv, d, int(causal),
        scale, _build.stream_handle(q.device))
    _build.check(rc, "flash_attention_train backward")
    _count(*KERNELS[1:])
    return dq, dk, dv
