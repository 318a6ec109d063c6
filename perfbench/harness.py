"""One run of one cell, device aside: the cell's files found by name,
its kind's driver, its metrics read from the run's record, the numbers
compared beside their limits, and the result line."""
from __future__ import annotations

import importlib
import math

from . import common, flops


def checks(readings: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}`` of every number the cell compares."""
    return {name: {"value": float(readings[name]), "limit": float(lim)}
            for name, lim in sorted(limits.items())}


def run_cell(name: str, *, seed: int, seconds: float, trace: bool, device,
             t_start: float, man: dict | None = None,
             config: dict | None = None, traffic: dict | None = None) -> dict:
    """Run cell ``name`` and return its result (the line's object).
    ``config`` and ``traffic`` replace the cell's files (the CPU tests'
    small sizes)."""
    man = man or common.manifest()
    cell = common.cell_of(man, name)
    c = {"config": config or cell["config"],
         "traffic": traffic or cell["traffic"], "cell": cell["cell"],
         "seed": seed, "seconds": seconds, "trace": trace, "device": device,
         "t_start": t_start}
    kind = importlib.import_module(f"perfbench.kinds.{c['traffic']['kind']}")
    out = kind.run(c)
    rec = out["record"]
    dev = common.device_info(device)
    rec.update(config=c["config"], traffic=c["traffic"],
               peak=flops.peak(dev["kind"]))
    metrics = {}
    for m in common.metrics_of(man, name, trace):
        value = common.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev["memory_peak_bytes"] = rec["peak_bytes"]
    result = {"attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    tr = rec.get("trace")
    if trace and tr is not None and tr.window() is not None:
        t0, t1 = tr.window()
        dev["busy_s"] = tr.busy(t0, t1)
        dev["window_s"] = t1 - t0
        out["readings"]["trace_file_bytes"] = tr.file_bytes
        result["breakdown"] = {
            "device_ops": tr.top_device(t0, t1),
            "idle_gaps": tr.idle_gaps(t0, t1)}
    got = checks(out["readings"], c["cell"]["limits"])
    correct = out["failed"] == 0 and all(
        math.isfinite(v["value"]) and v["value"] <= v["limit"]
        for v in got.values())
    result["correct"] = correct
    result["checks"] = got
    result["readings"] = {k: v for k, v in out["readings"].items()
                          if k not in got}
    return result
