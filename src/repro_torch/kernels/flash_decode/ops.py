"""Public decode-attention ops, including the sequence-sharded form.

``decode_partial`` goes through the operator ``repro_torch::flash_decode``:
its CPU implementation is the plain version and its CUDA implementation
launches the kernel (``kernel.flash_decode``), neither falling back to
the other.  The operator has a vmap rule that folds the task axis into
the batch axis, so a task body called once per task on a host worker
launches once per task, and the same body under the staged executor's
``torch.func.vmap`` launches once per group.  It is declared with
``torch.library``'s schema API, as ``repro_torch::black_scholes`` is
(see ``kernels/black_scholes/ops.py`` for why not ``custom_op``).
"""
import torch

from . import kernel, ref

__all__ = ["decode_attention", "decode_partial", "combine_partials"]

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_decode(Tensor q, Tensor k, Tensor v, float scale, "
            "int bk) -> (Tensor, Tensor)")
_LIB.impl("flash_decode", kernel.flash_decode, "CPU")
_LIB.impl("flash_decode", kernel.flash_decode, "CUDA")
_OP = torch.ops.repro_torch.flash_decode.default


def _fold(x, dim, n: int):
    """``x`` with its vmap axis ``dim`` (None: unbatched) folded into its
    leading batch axis: (n, B, ...) -> (n * B, ...), contiguous."""
    x = x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.reshape(n * x.shape[1], *x.shape[2:]).contiguous()


def _flash_decode_vmap(info, in_dims, q, k, v, scale, bk):
    n = info.batch_size
    qd, kd, vd = in_dims[:3]
    o, lse = _OP(_fold(q, qd, n), _fold(k, kd, n), _fold(v, vd, n), scale,
                 bk)
    return (o.reshape(n, -1, *o.shape[1:]),
            lse.reshape(n, -1, lse.shape[1])), (0, 0)


torch.library.register_vmap("repro_torch::flash_decode", _flash_decode_vmap,
                            lib=_LIB)


def decode_partial(q, k, v, *, scale: float | None = None, mask=None,
                   bk: int = 512):
    """Per-shard partial: ``(o_f32, lse)``.  Combine with
    :func:`combine_partials`.  ``mask`` (B, S) of valid positions is
    taken on the CPU only, as the reference takes it on its jnp path
    only: pad KV shards to the block size on the card instead."""
    if mask is not None:
        if q.device.type != "cpu":
            raise NotImplementedError(
                "mask only on the plain CPU path; pad KV shards to the "
                "block size instead")
        return ref.decode_partial(q, k, v, scale=scale, mask=mask)
    scale = float(q.shape[-1]) ** -0.5 if scale is None else float(scale)
    return _OP(q, k, v, scale, bk)


def decode_attention(q, k, v, *, scale: float | None = None,
                     bk: int = 512):
    """Full (unsharded) decode attention for one new token."""
    o, _ = decode_partial(q, k, v, scale=scale, bk=bk)
    return o.to(q.dtype)


combine_partials = ref.combine_partials
