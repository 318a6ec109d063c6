"""Multi-pod dry run: trace every (architecture x input shape) on the
production meshes and record flops, memory and collective statistics
(the JAX package's ``launch/dryrun.py``).

This is the proof that the distribution config is coherent: a sharding
that does not divide, a shape a kernel refuses or a missing rule fails
the cell.  How it differs from the reference:

* **traced on ``meta``, not compiled.**  The devices are ``meta``
  logical devices (``dist.logical_devices(n, "meta")``), the counterpart
  of the reference's 512 forced host devices; the parameters, optimizer
  state, batch and caches are ``meta`` tensors placed by the sharding
  rules.  The step runs eagerly on them: shapes and dtypes, nothing
  computed, nothing launched (the flash wrappers return their outputs
  on ``meta``).  ``compile_s`` is the wall time of that trace, the
  placement of the inputs included.  Each loop runs its first, second
  and last items, the second counted for the rest (``metatrace``): the
  counterpart of a scan body lowered once.
* **recorded exchanges, not HLO.**  The collectives are the exchanges
  between logical devices the step makes (``dist.record_exchanges``;
  ``hlo_stats.collective_stats``), per device.
* **the port's own memory.**  The mesh is single-controller: the
  controller gathers the parameters and computes on the first device,
  with per-position chunks and gradient chunks on the others.
  ``temp_size_in_bytes`` is the peak of everything the step allocates
  on all logical devices together (``hlo_stats.LiveBytes``; a ``meta``
  trace cannot tell them apart) less the outputs it leaves: the gathered
  compute is in it.  The arguments and outputs are each device's bytes
  (``dist.bytes_by_device``; an unplaced tensor is the first device's),
  the largest device's; the aliased bytes are the donated inputs' (train:
  parameters and optimizer state; decode: the caches).
* **decode's inputs.**  The port's decode takes the parameters prepared
  for compute (``api.prepare``: gathered once, as ``launch.serve.
  generate`` keeps them between steps) and a host ``int`` position,
  ``seq_len - 1``; the token is placed over the data axes where they
  divide the batch and gathered in the step.
* ``flops_per_device`` and ``bytes_per_device`` are ``flopcount``'s
  totals of the step divided by the devices; there is no compiled cost
  analysis, so the ``*_hlo_raw`` keys are null.

Results land in ``experiments/dryrun_torch/`` as one JSON per (arch,
shape, mesh).  Run it on any host, no card needed::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both [--skip-existing]
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch whisper-tiny --shape decode_32k --mesh single
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from dataclasses import dataclass, field

import torch

from .. import dist, metatrace
from ..configs import ARCH_IDS, SHAPES, applicable_shapes, get_config, \
    input_specs
from ..core.costmodel import H100Params
from ..dist.sharding import (batch_shardings, default_policy,
                             opt_state_shardings, param_shardings)
from ..kernels.flash_attention import kernel as fa_kernel
from ..kernels.flash_decode import kernel as fd_kernel
from ..models import api, attention, moe, transformer
from ..optim import adamw_init
from .flopcount import FlopCounter
from .hlo_stats import LiveBytes, collective_stats, memory_stats
from .mesh import make_mesh
from .train import build_train_step

__all__ = ["HW", "Trace", "trace", "counters", "held_by_device",
           "meta_mesh", "serve_steps", "predict_train", "predict_serve",
           "cell_policy", "model_in_batch", "lower_cell", "run_cells",
           "main"]

# one NVIDIA H100 SXM at its 700 W limit (data sheet: dense bf16 on the
# tensor cores, HBM3, NVLink 4 each way), the port's target
_H100 = H100Params()
HW = {
    "peak_flops_bf16": _H100.peak_flops_bf16,
    "hbm_gbps": _H100.hbm_bw,
    "nvlink_gbps": _H100.nvlink_bw,
}

# the byte counters of the mesh path, by name
COUNTERS = {"gathered_bytes": (dist.gather, "copied_bytes"),
            "placed_bytes": (dist.device_put, "copied_bytes"),
            "ep_exchanged_bytes": (moe.moe_ffn_ep, "exchanged_bytes"),
            "sp_combine_bytes": (attention.combine_stripes,
                                 "exchanged_bytes")}


def counters() -> dict:
    """The mesh path's byte counters as they stand."""
    return {k: getattr(obj, attr) for k, (obj, attr) in COUNTERS.items()}


def _tensors(tree) -> list:
    """The tensors of a tree (placed leaves as they are), a module read as
    its parameters."""
    from ..dist.sharding import _as_tree, _map_with_path
    out = []

    def visit(_, x):
        if isinstance(x, (torch.Tensor, dist.Placed)):
            out.append(x)
    _map_with_path(visit, _as_tree(tree))
    return out


def held_by_device(tree, mesh) -> dict[int, int]:
    """The bytes each logical device of ``mesh`` holds in ``tree``: each
    placed leaf's chunks (``dist.bytes_by_device``), and every unplaced
    tensor on the mesh's first device, where the controller keeps it."""
    out = {d.id: 0 for d in mesh.devices.flat}
    first = mesh.devices.flat[0].id
    for x in _tensors(tree):
        if isinstance(x, dist.Placed):
            for dev, t in x.shards.items():
                out[dev.id] += t.numel() * t.element_size()
        else:
            out[first] += x.numel() * x.element_size()
    return out


@dataclass
class Trace:
    """What one step traced on ``meta`` counted: ``flops``/``bytes``
    (``flopcount``; ``by_op`` each aten op's), the exchange ``records``
    and their ring-model ``collectives``, the mesh ``counters``'
    increments, the argument, output and donated bytes by device, the
    ``peak`` of the bytes the step allocated (transient and placed) and
    what it ``left`` allocated at its end, the flash launches (0:
    nothing launches on ``meta``) and the wall seconds."""
    flops: float
    bytes: float
    records: list
    counters: dict
    arguments: dict
    outputs: dict
    donated: dict
    peak: int
    left: int
    launches: int
    wall_s: float
    by_op: dict = field(repr=False, default_factory=dict)

    @property
    def collectives(self) -> dict:
        return collective_stats(self.records).to_dict()

    def memory(self) -> dict:
        return memory_stats(
            argument_size_in_bytes=max(self.arguments.values()),
            output_size_in_bytes=max(self.outputs.values()),
            alias_size_in_bytes=max(self.donated.values()),
            temp_size_in_bytes=max(self.peak - self.left, 0))


def trace(fn, inputs, mesh, *, donated=()) -> tuple[object, Trace]:
    """Run ``fn(*inputs)`` (on ``meta`` tensors, under the ambient mesh)
    with the flop counter, the live-bytes tracker and the exchange
    recorder open, and the byte counters read before and after.  Returns
    its output and the :class:`Trace`."""
    before = counters()
    launches = fa_kernel.flash_attention.launches + \
        fd_kernel.flash_decode.launches
    arguments = held_by_device(inputs, mesh)
    metatrace.clear()
    t0 = time.perf_counter()
    flops, live = FlopCounter(), LiveBytes()
    with dist.record_exchanges() as records, flops, live:
        out = fn(*inputs)
    wall = time.perf_counter() - t0
    metatrace.clear()                   # its backward passes are done
    after = counters()
    return out, Trace(
        flops=flops.flops, bytes=flops.bytes, records=records,
        counters={k: after[k] - before[k] for k in after},
        arguments=arguments, outputs=held_by_device(out, mesh),
        donated=held_by_device(donated, mesh), peak=live.peak,
        left=live.live, wall_s=wall, by_op=flops.by_op,
        launches=fa_kernel.flash_attention.launches +
        fd_kernel.flash_decode.launches - launches)


def meta_mesh(shape, axes=("data", "model")):
    """A mesh of ``shape`` over ``meta`` logical devices."""
    return make_mesh(shape, axes,
                     dist.logical_devices(math.prod(shape), "meta"))


def serve_steps(cfg, params, tokens, *, max_len: int, run):
    """What ``launch.serve.generate`` runs before its second token, each
    step through ``run(name, fn, inputs, donated)`` (which calls
    ``fn(*inputs)`` and returns its output): ``prepare`` (the parameters
    cast, gathered and pinned once), ``prefill`` (the prompt), ``pad``
    (the caches grown to ``max_len``) and ``decode`` (one step at the
    prompt's length).  Real tensors or ``meta`` ones alike."""
    p = run("prepare", lambda q: api.prepare(q, cfg), (params,), ())
    logits, caches = run("prefill",
                         lambda q, b: api.prefill_step(q, cfg, b),
                         (p, {"tokens": tokens}), ())
    caches = run("pad", lambda c: api.pad_caches(c, max_len), (caches,), ())
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    pos = tokens.shape[1]
    return run("decode", lambda q, t, c: api.decode_step(q, cfg, t, c, pos),
               (p, tok, caches), (caches,))


def predict_train(cfg, mesh, batch, *, policy: str = "fsdp", **ctx_kw):
    """One ``build_train_step`` step of ``cfg`` traced on ``mesh`` (of
    ``meta`` devices, its axis roles ``ctx_kw``): f32 masters and AdamW
    state placed by ``policy``, ``batch`` (``meta`` tensors) placed by
    the step's ``in_shardings`` unless it is already.  Returns
    ``(trace, bytes held by device)``."""
    with dist.use_mesh(mesh, **ctx_kw) as ctx:
        params = _abstract_params(cfg)
        p_sh = param_shardings(cfg, params, ctx, policy=policy)
        o_sh = opt_state_shardings(p_sh, ctx)
        placed = dist.device_put(params, p_sh)
        opt = adamw_init(placed)
        held = dist.bytes_by_device((placed, opt))
        b_sh = batch_shardings(cfg, batch, ctx)
        fn = build_train_step(cfg, in_shardings=(p_sh, o_sh, b_sh, None),
                              out_shardings=(p_sh, o_sh, None))
        _, tr = trace(lambda p, o, b: fn(p, o, b, 1),
                      (placed, opt, batch), mesh, donated=(placed, opt))
    return tr, held


def predict_serve(cfg, mesh, tokens, *,
                  max_len: int) -> tuple[dict, dict]:
    """:func:`serve_steps` traced on ``mesh`` (of ``meta`` devices) from
    f32 masters placed ``tp`` (the serving rule), ``tokens`` a ``meta``
    prompt.
    Returns ``({step name: trace}, bytes held by device)``."""
    traces = {}

    def run(name, fn, inputs, donated):
        out, traces[name] = trace(fn, inputs, mesh, donated=donated)
        return out

    with dist.use_mesh(mesh) as ctx, torch.inference_mode():
        params = _abstract_params(cfg)
        placed = dist.device_put(params, param_shardings(
            cfg, params, ctx, policy="tp"))
        held = dist.bytes_by_device(placed)
        serve_steps(cfg, placed, tokens, max_len=max_len, run=run)
    return traces, held


def _abstract_params(cfg, *, serving: bool = False):
    """The ``Decoder`` on ``meta``; ``serving``: its floating leaves of
    rank >= 2 in bf16, as inference deployments load them (no optimizer
    master copies to protect), the small vectors f32."""
    p = transformer.Decoder(cfg, device="meta")
    if serving:
        for t in p.parameters():
            if t.ndim >= 2 and t.is_floating_point():
                t.data = t.data.to(torch.bfloat16)
    return p


def _mesh_ctx(multi_pod: bool, *, model_in_batch: bool = False):
    """The production mesh over ``meta`` logical devices, (data 16, model
    16) or (pod 2, data 16, model 16), and the reference's axis roles."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return meta_mesh(shape, axes), dict(
        data_axes=("data",), model_axis="model",
        pod_axis="pod" if multi_pod else None,
        model_in_batch=model_in_batch)


def cell_policy(cfg, kind: str, policy: str | None = None) -> str:
    """The reference's rule: the config's policy, except that serving
    has no optimizer state, so decode under ``fsdp`` shards the weights
    ``tp`` for the dense, vlm, moe and audio families."""
    pol = policy or default_policy(cfg)
    if kind == "decode" and pol == "fsdp" and \
            cfg.family in ("dense", "vlm", "moe", "audio"):
        pol = "tp"
    return pol


def model_in_batch(cfg, spec, chips: int) -> bool:
    """The reference's rule: the recurrent families' model axis joins
    the batch in train and prefill when the chips divide the batch."""
    return (cfg.family in ("hybrid", "ssm")
            and spec.kind in ("train", "prefill")
            and spec.global_batch % chips == 0)


def lower_cell(arch: str, shape_name: str, multi_pod: bool, *,
               policy: str | None = None, n_layers: int | None = None):
    """Trace one cell on ``meta``; returns ``(record, trace)``."""
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    spec = SHAPES[shape_name]
    chips = 512 if multi_pod else 256
    mesh, ctx_kw = _mesh_ctx(
        multi_pod, model_in_batch=model_in_batch(cfg, spec, chips))
    t0 = time.perf_counter()
    with dist.use_mesh(mesh, **ctx_kw) as ctx:
        pol = cell_policy(cfg, spec.kind, policy)
        specs = input_specs(cfg, shape_name)
        if spec.kind == "train":
            batch = dist.device_put(specs["batch"], batch_shardings(
                cfg, specs["batch"], ctx))
            tr, _ = predict_train(cfg, mesh, batch, policy=pol, **ctx_kw)
        else:
            params = _abstract_params(cfg, serving=spec.kind == "decode")
            placed = dist.device_put(params, param_shardings(
                cfg, params, ctx, policy=pol))
        if spec.kind == "prefill":
            _, tr = trace(lambda p, b: api.prefill_step(p, cfg, b),
                          (placed, specs["batch"]), mesh)
        elif spec.kind == "decode":
            prepared = api.prepare(placed, cfg)
            caches = api.place_caches(cfg, specs["caches"])
            b = spec.global_batch
            tok_sh = dist.NamedSharding(mesh, dist.PartitionSpec(
                ctx.all_data_axes if b % _dp_size(ctx) == 0 else None))
            token = dist.device_put(specs["token"], tok_sh)
            pos = spec.seq_len - 1
            _, tr = trace(lambda p, t, c: api.decode_step(
                p, cfg, dist.gather(t), c, pos), (prepared, token, caches),
                mesh, donated=(caches,))
    n_dev = mesh.devices.size
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": int(n_dev),
        "policy": pol,
        "kind": spec.kind,
        "seq_len": spec.seq_len,
        "global_batch": spec.global_batch,
        "compile_s": round(time.perf_counter() - t0, 2),
        "flops_per_device": float(tr.flops) / n_dev,
        "bytes_per_device": float(tr.bytes) / n_dev,
        "flops_per_device_hlo_raw": None,
        "bytes_per_device_hlo_raw": None,
        "memory": tr.memory(),
        "collectives": tr.collectives,
    }
    return record, tr


def _dp_size(ctx) -> int:
    return math.prod(ctx.mesh.shape[a] for a in ctx.all_data_axes)


def run_cells(archs, shapes, meshes, out_dir: str, *,
              skip_existing: bool = False):
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for arch in archs:
        cfg = get_config(arch)
        valid = applicable_shapes(cfg)
        for shape_name in shapes:
            if shape_name not in valid:
                continue
            for mesh_name in meshes:
                multi = mesh_name == "multi"
                tag = f"{arch}__{shape_name}__{'2x16x16' if multi else '16x16'}"
                path = os.path.join(out_dir, tag + ".json")
                if skip_existing and os.path.exists(path):
                    print(f"[dryrun] skip {tag} (exists)")
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    record, _ = lower_cell(arch, shape_name, multi)
                except Exception as e:
                    record = {"arch": arch, "shape": shape_name,
                              "mesh": "2x16x16" if multi else "16x16",
                              "error": f"{type(e).__name__}: {e}",
                              "traceback": traceback.format_exc()[-2000:]}
                    print(f"[dryrun] FAIL {tag}: {e}", flush=True)
                with open(path, "w") as f:
                    json.dump(record, f, indent=1)
                if "error" not in record:
                    gb = record["memory"]["per_device_total_bytes"] / 2**30
                    print(f"[dryrun] OK {tag}: "
                          f"{record['flops_per_device']:.3e} flops/dev, "
                          f"{gb:.2f} GiB/dev, "
                          f"{record['collectives']['total_link_bytes']:.3e}"
                          f" link B, {record['compile_s']}s", flush=True)
                results.append(record)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry run on meta")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    results = run_cells(archs, shapes, meshes, args.out,
                        skip_existing=args.skip_existing)
    n_ok = sum(1 for r in results if "error" not in r)
    print(f"[dryrun] {n_ok}/{len(results)} cells OK")
    if n_ok != len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
