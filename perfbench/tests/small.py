"""Small sizes of the cells for the CPU tests: every width cut, the
shapes and the code paths those of the cells."""
from __future__ import annotations

import copy
import time

from perfbench import common


def config(conf: dict, compute: str = "bfloat16") -> dict:
    """``conf`` at the small size: the cut of its reference module
    (``small(conf)``); compute in ``compute``, training attention in
    chunks of 32."""
    conf = common.reference(conf).small(copy.deepcopy(conf))
    conf["program"]["settings"]["compute_dtype"] = compute
    conf["program"]["train"].update(attn_q_chunk=32, attn_k_chunk=32)
    return conf


def traffic(tr: dict) -> dict:
    tr = dict(tr)
    if tr["kind"] == "train":
        tr.update(batch=2, seq=64, traced_steps=1)
    else:
        tr.update(batch=2, prompt_lengths=[32, 64], new_tokens=4,
                  check_requests=4, traced_cycles=1)
    return tr


def context(name: str, seed: int, compute: str = "bfloat16",
            trace: bool = False, traffic_update: dict | None = None) -> dict:
    """The driver's context of cell ``name`` at the small size on the
    CPU; ``traffic_update`` overrides keys of the small traffic."""
    cell = common.cell_of(common.manifest(), name)
    return {"config": config(cell["config"], compute),
            "traffic": {**traffic(cell["traffic"]), **(traffic_update or {})},
            "cell": cell["cell"], "seed": seed, "seconds": 0.3,
            "trace": trace, "device": "cpu", "t_start": time.perf_counter()}


def run(name: str, seed: int, compute: str = "bfloat16",
        trace: bool = False, traffic_update: dict | None = None) -> dict:
    """``harness.run_cell`` of cell ``name`` at the small size."""
    from perfbench import harness
    c = context(name, seed, compute, trace, traffic_update)
    return harness.run_cell(name, seed=seed, seconds=c["seconds"],
                            trace=trace, device="cpu", t_start=c["t_start"],
                            config=c["config"], traffic=c["traffic"])
