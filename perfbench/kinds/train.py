"""Training cells: the program's train step (``build_train_step``) driven
by the traffic file's batches, then checked against the plain reference.

Set-up builds one step object (parameters drawn from the seed, AdamW's
state, the step) and drives it through the traffic's ``check_steps``
first steps; the window then calls the same step on the next batches,
starting a new one while the elapsed time is under ``--seconds``.  The
steps are those of the schedule after its warm-up, at the peak rate, so
that the first update moves every leaf.  The reference follows the same
first steps from the same weights and batches once the window has closed
and the program's state is freed.

A traced run profiles the device's activity only: host operations are
not recorded, so the traced steps run as the untraced ones do, but for
the profiler's cost on each launch and the program's own spans and
counters (``obs.recording``), which the traced steps record and which go
into the trace (as host ranges on its clock) and the record.  Set-up's
steps run under a recording of their own in a traced run, so that the
kernels the recording adds (its counters') load before the window.
"""
from __future__ import annotations

import contextlib
import math
import time

import torch

from repro_torch import obs
from repro_torch.launch.train import build_train_step
from repro_torch.optim import adamw_init

from .. import common, program
from ..reference import train as ref_train
from ..reference.arith import Arith, tf32_off
from ..tokens import SyntheticTokens
from ..trace import Trace


def _leaf(tree: dict, name: str):
    for key in name.split("."):
        tree = tree[key]
    return tree


def check_indices(conf: dict, n_check: int) -> list[int]:
    """The schedule steps of the checked steps: the first after the
    warm-up (each step's batch is the data's row block of that index)."""
    first = conf["train"]["warmup"]
    return list(range(first, first + n_check))


def program_steps(c: dict, n_check: int):
    """Build the step object and drive it through ``n_check`` steps.
    Returns ``(state, readings)``: ``state`` holds what the window goes
    on with, ``readings`` each step's loss, each leaf's first gradient as
    AdamW took it (from its first moment after one step) and each leaf's
    change over the ``n_check`` steps."""
    conf, tr, dev, seed = c["config"], c["traffic"], c["device"], c["seed"]
    hp = conf["train"]
    cfg = program.model_config(conf, "train")
    params = program.decoder(cfg, conf, seed, dev)
    opt = adamw_init(params)
    step_fn = build_train_step(cfg, peak_lr=hp["peak_lr"],
                               warmup=hp["warmup"],
                               total_steps=hp["total_steps"], clip=hp["clip"],
                               weight_decay=hp["weight_decay"])
    data = SyntheticTokens(conf["vocab_size"], tr["seq"], tr["batch"],
                           seed=common.sub_seed(seed, common.DATA),
                           zipf_a=tr["zipf_a"])
    state = {"params": params, "opt": opt, "step_fn": step_fn, "data": data,
             "next": check_indices(conf, n_check)[0]}
    losses, first = [], None
    for i in range(n_check):
        m = take_step(state, dev)
        losses.append(m["loss"])
        if i == 0:
            first = {n: float(_leaf(state["opt"].mu, n).norm()) /
                     (1 - hp["b1"]) for n, _ in params.named_parameters()}
    change = {n: float((p.detach() - common.fresh_leaf(conf, seed, n, dev))
                       .norm()) for n, p in params.named_parameters()}
    return state, {"loss": [float(x) for x in losses], "first_grad": first,
                   "change": change}


def take_step(state: dict, dev) -> dict:
    """The next step, on the next batch; its schedule step is its index."""
    i = state["next"]
    batch = {"tokens": state["data"].batch_at(i).to(dev)}
    state["params"], state["opt"], m = state["step_fn"](
        state["params"], state["opt"], batch, i)
    state["next"] = i + 1
    return m


def reference_steps(c: dict, n_check: int, precision: str = "f32") -> dict:
    """The reference's readings of the same first steps, by the
    configuration's reference module."""
    conf, tr, dev, seed = c["config"], c["traffic"], c["device"], c["seed"]
    ref = common.reference(conf)
    tf32_off()
    dims = ref.Dims(conf)
    data = SyntheticTokens(conf["vocab_size"], tr["seq"], tr["batch"],
                           seed=common.sub_seed(seed, common.DATA),
                           zipf_a=tr["zipf_a"])
    w = common.fresh_weights(conf, seed, dev)
    steps = check_indices(conf, n_check)
    out = ref_train.run_steps(
        w, dims, [data.batch_at(i).to(dev) for i in steps], steps,
        conf["train"], Arith(precision), ref.loss)
    out["change"] = {}
    for n in sorted(w):
        out["change"][n] = float((w[n] - common.fresh_leaf(conf, seed, n,
                                                           dev)).norm())
    del w
    common.free(dev)
    return out


def compare(prog: dict, ref: dict, drop_below: float) -> dict:
    """The numbers compared: the worst step's loss gap, the worst leaf's
    first-gradient gap and the worst leaf's change gap, the last over
    the leaves whose reference gradient is at least ``drop_below`` of
    the median leaf's; beside them each step's loss gap."""
    losses = [(common.gap(a, b, abs(b)) if math.isfinite(a) else math.inf)
              for a, b in zip(prog["loss"], ref["loss"])]
    grad, grad_at = common.leaf_gap(prog["first_grad"], ref["first_grad"])
    med = sorted(ref["first_grad"].values())[len(ref["first_grad"]) // 2]
    keep = [n for n, g in ref["first_grad"].items() if g >= drop_below * med]
    change, change_at = common.leaf_gap(prog["change"], ref["change"], keep)
    return {"loss_gap": max(losses), "loss_gaps": losses,
            "grad_gap": grad, "grad_gap_leaf": grad_at,
            "change_gap": change, "change_gap_leaf": change_at,
            "dropped_leaves": sorted(set(ref["first_grad"]) - set(keep))}


def run(c: dict) -> dict:
    conf, tr, dev = c["config"], c["traffic"], c["device"]
    n_check = tr["check_steps"]
    with obs.recording() if c["trace"] else contextlib.nullcontext():
        state, prog = program_steps(c, n_check)
    common.sync(dev)
    setup_s = time.perf_counter() - c["t_start"]

    rec = {"kind": "train", "setup_s": setup_s,
           "tokens_per_step": tr["batch"] * tr["seq"]}
    losses = []
    common.peak_reset(dev)
    if not c["trace"]:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < c["seconds"]:
            losses.append(take_step(state, dev)["loss"])
        common.sync(dev)
        rec["window_s"] = time.perf_counter() - t0
        rec["steps"] = len(losses)
    else:
        with torch.profiler.profile(activities=common.activities(dev)) \
                as prof:
            with torch.profiler.record_function("perfbench/window"):
                common.sync(dev)
                with obs.recording() as spans:
                    t0 = time.perf_counter()
                    for _ in range(tr["traced_steps"]):
                        with torch.profiler.record_function(
                                "perfbench/step"):
                            losses.append(take_step(state, dev)["loss"])
                    common.sync(dev)
                    rec["traced_wall_s"] = time.perf_counter() - t0
        rec["traced_steps"] = len(losses)
        rec["trace"] = Trace.of(
            prof, lambda base_ns: obs.span_events(spans, base_ns))
        rec["counters"] = dict(spans.counters)
        del prof, spans
    rec["peak_bytes"] = common.peak_bytes(dev)
    failed = sum(not math.isfinite(float(x)) for x in losses)
    del state
    common.free(dev)

    t_ref = time.perf_counter()
    ref = reference_steps(c, n_check)
    got = compare(prog, ref, c["cell"]["drop_leaves_below"])
    got["reference_s"] = time.perf_counter() - t_ref
    return {"record": rec, "attempted": len(losses), "failed": failed,
            "readings": got}
