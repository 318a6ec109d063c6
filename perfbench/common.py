"""What every kind of cell shares: the manifest and the files found by
name, seeds, the weights drawn from the seed, the device's description,
the comparison of two readings, and the result line."""
from __future__ import annotations

import importlib.util
import json
import math
import pathlib
import sys

import numpy as np
import torch

from .reference import model as ref_model

ROOT = pathlib.Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level modules no run may hold: the JAX stack and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def cell_of(man: dict, name: str) -> dict:
    """The cell ``name``: its workload entry, its configuration file and
    entry, its traffic file and its own file of limits."""
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf_entry = {c["name"]: c for c in man["configs"]}[w["config"]]
    return {"workload": w, "config_entry": conf_entry,
            "config": load_json(REPO / conf_entry["file"]),
            "traffic": load_json(ROOT / "traffic" / f"{w['traffic']}.json"),
            "cell": load_json(ROOT / "cells" / f"{name}.json")}


def metrics_of(man: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's metrics: its end-to-end ones untraced, its per-layer
    ones traced; a metric with ``workloads`` belongs to those cells."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    """The ``read(record)`` of ``perfbench/metrics/<name>.py``."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one purpose of a run, mixed from ``seed``."""
    s = int(seed) % (1 << 64)
    seq = np.random.SeedSequence([s & 0xFFFFFFFF, s >> 32, *path])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


WEIGHTS, DATA, PROMPTS, SAMPLE, WARMUP = 1, 2, 3, 4, 5


def draw_leaf(t: torch.Tensor, spec, seed: int, index: int) -> torch.Tensor:
    """Fill ``t`` in place as ``spec`` (shape, init, scale) says, from
    the generator of leaf ``index`` of ``seed``, on ``t``'s device."""
    shape, init, scale = spec
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"leaf {index}: shape {tuple(t.shape)}, the "
                         f"reference's {tuple(shape)}")
    with torch.no_grad():
        if init == "ones":
            return t.fill_(1.0)
        g = torch.Generator(device=t.device).manual_seed(
            sub_seed(seed, WEIGHTS, index))
        return t.normal_(0.0, scale, generator=g).clamp_(-2 * scale,
                                                         2 * scale)


def weight_specs(conf: dict) -> dict:
    return ref_model.weight_specs(ref_model.Dims(conf))


def draw_into(named: dict, conf: dict, seed: int) -> None:
    """Draw every weight of the reference's specs into ``named`` (the
    program's parameters by name), which must hold exactly those names."""
    specs = weight_specs(conf)
    if set(named) != set(specs):
        raise ValueError(f"the program's parameters {sorted(named)} are not "
                         f"the reference's {sorted(specs)}")
    for i, name in enumerate(sorted(specs)):
        draw_leaf(named[name], specs[name], seed, i)


def fresh_weights(conf: dict, seed: int, device) -> dict:
    """The same weights as new f32 tensors ``{name: tensor}``."""
    specs = weight_specs(conf)
    out = {}
    for i, name in enumerate(sorted(specs)):
        out[name] = draw_leaf(torch.empty(specs[name][0], device=device),
                              specs[name], seed, i)
    return out


def fresh_leaf(conf: dict, seed: int, name: str, device) -> torch.Tensor:
    specs = weight_specs(conf)
    i = sorted(specs).index(name)
    return draw_leaf(torch.empty(specs[name][0], device=device),
                     specs[name], seed, i)


def device_info(device) -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_reset(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int | None:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return None


def free(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def gap(a: float, b: float, base: float) -> float:
    """``|a - b|`` over ``base`` (the reference's magnitude)."""
    return abs(a - b) / base if base > 0 else math.inf


def leaf_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's gap between two readings of per-leaf norms: the
    difference of the norms over the reference's norm of that leaf or of
    the median leaf, whichever is larger; ``keep`` names the leaves
    compared (all by default)."""
    names = sorted(ref if keep is None else keep)
    med = float(np.median([ref[n] for n in ref]))
    worst, at = 0.0, ""
    for n in names:
        if n not in prog or not math.isfinite(prog[n]):
            return math.inf, n
        g = gap(prog[n], ref[n], max(ref[n], med))
        if g > worst:
            worst, at = g, n
    return worst, at


def activities(device) -> list:
    """What a traced run profiles: the device's activity on the card
    (kernels, copies, memsets; no host operations, shapes or stacks), the
    host's operations on the CPU, where there is no device activity."""
    if torch.device(device).type == "cuda":
        return [torch.profiler.ProfilerActivity.CUDA]
    return [torch.profiler.ProfilerActivity.CPU]


def forbidden_modules() -> list[str]:
    """The forbidden top-level modules this process holds."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def p_nearest(values, q: float) -> float:
    """The ``q`` quantile by nearest rank: the smallest value with at
    least ``q`` of the values at or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]
