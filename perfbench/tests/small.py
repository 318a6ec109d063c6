"""Small sizes of the cells for the CPU tests: every width cut, the
shapes and the code paths those of the cells."""
from __future__ import annotations

import copy
import time

from perfbench import common


def config(conf: dict, compute: str = "bfloat16") -> dict:
    conf = copy.deepcopy(conf)
    conf.update(num_hidden_layers=2, hidden_size=128, num_attention_heads=4,
                num_key_value_heads=2, head_dim=32, intermediate_size=96,
                vocab_size=512, padded_vocab_size=512)
    if conf.get("num_local_experts"):
        conf.update(num_local_experts=8, num_experts_per_tok=2)
        conf["program"]["settings"]["moe_capacity_factor"] = 4.0
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
            trace: bool = False) -> dict:
    """The driver's context of cell ``name`` at the small size on the
    CPU."""
    cell = common.cell_of(common.manifest(), name)
    return {"config": config(cell["config"], compute),
            "traffic": traffic(cell["traffic"]), "cell": cell["cell"],
            "seed": seed, "seconds": 0.3, "trace": trace, "device": "cpu",
            "t_start": time.perf_counter()}


def run(name: str, seed: int, compute: str = "bfloat16",
        trace: bool = False) -> dict:
    """``harness.run_cell`` of cell ``name`` at the small size."""
    from perfbench import harness
    c = context(name, seed, compute, trace)
    return harness.run_cell(name, seed=seed, seconds=c["seconds"],
                            trace=trace, device="cpu", t_start=c["t_start"],
                            config=c["config"], traffic=c["traffic"])
