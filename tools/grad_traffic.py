"""The train step's counted traffic: the dry run's flops of the train
cells against the reference's, the shortened ``meta`` trace against the
unrolled one, the gradients of the loops over mesh positions, and a cell
on two meshes.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/grad_traffic.py gaps [ARCH ...]
    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/grad_traffic.py attribute ARCH
    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/grad_traffic.py shortcut [ARCH ...]
    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/grad_traffic.py positions
    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/grad_traffic.py meshes [ARCH ...]

* ``gaps``: each arch's ``train_4k`` cell at ``reduced()`` with 2 layers
  on one ``meta`` device (``tests/test_torch_dryrun.py``'s
  ``_one_device_cell``) against the reference's ``count_step`` of its
  ``build_train_step`` (``_ref_cell``): total and matmul flops, and the
  flops of ``slice_backward``, ``select_backward`` and ``add``.
* ``attribute``: the same cell's flops by aten op and the reference's by
  jaxpr primitive, side by side.
* ``shortcut``: ``predict_train`` on (2, 2) ``meta`` devices, B 2 x S 256,
  shortened (``metatrace.steps``) and unrolled: flops, bytes, by op,
  counters, collectives and the peak of live bytes.
* ``positions``: ``tests/test_torch_grad_traffic.py``'s counter, every
  op, over the backward of ``attention.attend`` and ``_slstm_sharded``
  on a (2, 2) mesh of CPU logical devices.
* ``meshes``: each arch's ``train_4k`` cell at ``reduced()`` with 2
  layers through ``dryrun.lower_cell`` on (1, 1) and (4, 4) ``meta``
  meshes: total flops and bytes summed over the devices (so they compare
  with one device directly), the flops of ``slice_backward`` and
  ``add``, and the bytes of ``copy_`` and ``index_add`` (an index's
  backward adding into zeros).

Set ``PYTHONPATH`` to another tree's ``src`` first to count that tree.
"""
from __future__ import annotations

import collections
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))

MATMUL = ("mm", "bmm", "addmm", "baddbmm")


def gaps(archs) -> None:
    import pytest
    import test_torch_dryrun as D
    for arch in archs:
        mp = pytest.MonkeyPatch()
        try:
            record, tr = D._one_device_cell(arch, "train_4k", mp)
        except Exception as e:            # a cell that does not trace
            print(arch, json.dumps({"error": f"{type(e).__name__}: {e}"}))
            continue
        finally:
            mp.undo()
        got = record["flops_per_device"] * record["n_devices"]
        ref, ref_matmul = D._ref_cell(arch, "train_4k")
        print(arch, json.dumps(dict(
            port=got, ref=ref["flops"], gap=got - ref["flops"],
            rel=(got - ref["flops"]) / ref["flops"],
            matmul=sum(tr.by_op.get(op, [0.0])[0] for op in MATMUL),
            ref_matmul=ref_matmul, port_bytes=tr.bytes,
            ref_bytes=ref["bytes"],
            **{op: tr.by_op.get(op, [0.0, 0.0])[0]
               for op in ("slice_backward", "select_backward", "add")})),
            flush=True)


def attribute(arch: str) -> None:
    import jax
    import jax.numpy as jnp
    import pytest
    import test_torch_dryrun as D
    from repro.configs import get_config, input_specs
    from repro.launch import flopcount as rf
    from repro.launch.train import build_train_step
    from repro.models import api
    from repro.optim import adamw_init

    def walk(jaxpr, m, acc):
        for eqn in jaxpr.eqns:
            prim = eqn.primitive.name
            if prim == "dot_general":
                acc[prim] += m * rf._dot_flops(eqn)
                continue
            if prim == "shard_map":
                walk(eqn.params["jaxpr"], m, acc)
                continue
            subs = list(rf._sub_jaxprs(eqn))
            for mult, sub in subs:
                walk(sub, m * mult, acc)
            if subs or prim in rf._LAYOUT_OPS or prim in rf._ZERO_FLOP:
                continue
            vs = eqn.invars if prim.startswith(("reduce_", "arg", "cum")) \
                else eqn.outvars
            acc[prim] += m * sum(rf._aval_size(v.aval) for v in vs
                                 if hasattr(v, "aval"))

    cfg = get_config(arch).reduced(n_layers=2)
    params = jax.eval_shape(lambda: api.init_params(jax.random.PRNGKey(0),
                                                    cfg))
    args = (params, jax.eval_shape(adamw_init, params),
            input_specs(cfg, "train_4k")["batch"],
            jax.ShapeDtypeStruct((), jnp.int32))
    ref = collections.Counter()
    walk(jax.make_jaxpr(build_train_step(cfg))(*args).jaxpr, 1.0, ref)
    mp = pytest.MonkeyPatch()
    try:
        _, tr = D._one_device_cell(arch, "train_4k", mp)
    finally:
        mp.undo()
    print(json.dumps({"ref": dict(ref), "port": {
        k: v[0] for k, v in tr.by_op.items() if v[0]}}, indent=1))


def shortcut(archs) -> None:
    import test_torch_dryrun as D
    from repro_torch import metatrace
    D.B, D.S = 2, 256
    for arch in archs:
        t0 = time.perf_counter()
        short = D._traced(arch, "train")[0]["train"]
        on_meta = metatrace.on_meta
        metatrace.on_meta = lambda *t: False
        try:
            unrolled = D._traced(arch, "train")[0]["train"]
        finally:
            metatrace.on_meta = on_meta
        same = {k: getattr(short, k) == getattr(unrolled, k) for k in (
            "flops", "bytes", "by_op", "counters", "collectives", "left")}
        print(arch, json.dumps(dict(same, peak_short=short.peak,
                                    peak_unrolled=unrolled.peak,
                                    seconds=time.perf_counter() - t0)),
              flush=True)


def positions() -> None:
    import torch
    import test_torch_grad_traffic as T
    from repro_torch import dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention, xlstm

    class Every(T.WholeSize):
        """Every op's whole-size new tensors, not the gathering ops'."""
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = {id(t.untyped_storage()) for t in torch.utils._pytree
                   .tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)}
            for t in torch.utils._pytree.tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor) and \
                        tuple(t.shape) in self.shapes and \
                        id(t.untyped_storage()) not in ins:
                    self.counts[tuple(t.shape),
                                func.overloadpacket.__name__] += 1
            return out

    mesh = make_mesh((2, 2), ("data", "model"),
                     dist.logical_devices(4, "cpu"))
    g = torch.Generator().manual_seed(0)
    b, h, s, d = 4, 4, 64, 8
    for hkv in (4, 2):
        q = torch.randn(b, h, s, d, generator=g, requires_grad=True)
        k, v = (torch.randn(b, hkv, s, d, generator=g, requires_grad=True)
                for _ in range(2))
        with dist.use_mesh(mesh):
            out = attention.attend(
                q, k, v, dist.PartitionSpec("data", "model", None, None),
                causal=True, impl="chunked", q_chunk=16, k_chunk=16)
            mode = Every([tuple(q.shape), tuple(k.shape)])
            with mode:
                out.sum().backward()
        print(f"attend Hkv {hkv}", {f"{sh} {op}": n for (sh, op), n
                                    in mode.counts.items()})
    x_in = torch.randn(4, 16, 128, generator=g, requires_grad=True)
    state = tuple(torch.zeros(4, 4, 8) for _ in range(4))
    with dist.use_mesh(mesh) as ctx:
        _, hs = xlstm._slstm_sharded(torch.randn(4, 8, 32, generator=g),
                                     x_in, state, ctx)
        mode = Every([tuple(x_in.shape)])
        with mode:
            hs.sum().backward()
    print("_slstm_sharded", {f"{sh} {op}": n for (sh, op), n
                             in mode.counts.items()})


def meshes(archs) -> None:
    import pytest
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    for arch in archs:
        for shape in ((1, 1), (4, 4)):
            mp = pytest.MonkeyPatch()
            mp.setattr(dryrun, "get_config",
                       lambda a: get_config(a).reduced())
            mp.setattr(dryrun, "_mesh_ctx", lambda multi, s=shape, **kw: (
                dryrun.meta_mesh(s), dict(data_axes=("data",),
                                          model_axis="model", **kw)))
            try:
                record, tr = dryrun.lower_cell(arch, "train_4k", False,
                                               n_layers=2)
            finally:
                mp.undo()
            op = {k: tr.by_op.get(k, [0.0, 0.0]) for k in (
                "slice_backward", "copy_", "add", "index_add")}
            print(arch, shape, json.dumps(dict(
                flops=tr.flops, bytes=tr.bytes,
                slice_backward_flops=op["slice_backward"][0],
                copy_bytes=op["copy_"][1], add_flops=op["add"][0],
                index_add_bytes=op["index_add"][1],
                peak=tr.peak, seconds=tr.wall_s)), flush=True)


def main(argv: list[str]) -> int:
    from repro_torch.configs import ARCH_IDS
    what, rest = (argv[0], argv[1:]) if argv else ("", [])
    if what == "gaps":
        gaps(rest or ARCH_IDS)
    elif what == "attribute" and len(rest) == 1:
        attribute(rest[0])
    elif what == "shortcut":
        shortcut(rest or ["zamba2-1.2b", "xlstm-1.3b", "mistral-nemo-12b"])
    elif what == "positions":
        positions()
    elif what == "meshes":
        meshes(rest or ARCH_IDS)
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
