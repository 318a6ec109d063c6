"""A configuration's plain reference found by name, and the program's
spans and counters recorded in traced runs only, at small sizes on the
CPU.

A second reference module (``recorded``: ``model``'s equations and CPU
cut, each call counted, and operation counts of its own) is put under
``perfbench.reference`` for the test alone: a configuration that names
it runs through both kinds of cell, and every use of the equations, the
operation counts and the CPU cut comes from it."""
from __future__ import annotations

import collections
import sys
import time
import types

import pytest

from perfbench import common, flops, harness
from perfbench.kinds import serve, train
from perfbench.reference import model
from perfbench.tests import small

SEED = 2**31 + 31


def _train_flops(conf, batch, seq):
    return 7.0 * batch * seq


def _prefill_flops(conf, batch, seq):
    return 3.0 * batch * seq


@pytest.fixture
def recorded(monkeypatch):
    """``perfbench.reference.recorded`` for the test; its calls by name."""
    calls = collections.Counter()

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    mod = types.ModuleType("perfbench.reference.recorded")
    for name in common.REFERENCE_API:
        setattr(mod, name, counted(name, getattr(model, name)))
    mod.train_step_flops = counted("train_step_flops", _train_flops)
    mod.prefill_flops = counted("prefill_flops", _prefill_flops)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return calls


def _named(cell: str, reference: str) -> tuple[dict, dict]:
    found = common.cell_of(common.manifest(), cell)
    conf = small.config(dict(found["config"], reference=reference),
                        "float32")
    return conf, small.traffic(found["traffic"])


def test_no_key_means_the_gqa_module():
    assert common.reference({}) is model
    assert common.reference({"reference": "model"}) is model
    for name in ("mistral-train-4k", "granite-train-4k"):
        assert common.reference(
            common.cell_of(common.manifest(), name)["config"]) is model
    with pytest.raises(ValueError):
        common.reference({"reference": "../model"})


@pytest.mark.parametrize("cell", ["granite-train-4k",
                                  "mistral-serve-longprompt"])
def test_a_second_reference_serves_both_kinds(cell, recorded):
    conf, tr = _named(cell, "recorded")
    assert recorded["small"] == 1
    out = harness.run_cell(cell, seed=SEED, seconds=0.3, trace=False,
                           device="cpu", t_start=time.perf_counter(),
                           config=conf, traffic=tr)
    assert out["correct"], out["checks"]
    # the program's weights and the reference's own are drawn by its specs
    assert recorded["weight_specs"] >= 2 and recorded["Dims"] >= 1
    if tr["kind"] == "train":
        assert recorded["loss"] == tr["check_steps"]
    else:
        # one call of each a request compared
        assert recorded["hidden_states"] == recorded["logits_at"] >= 1
        assert recorded["loss"] == 0


def test_a_second_reference_reads_as_the_first(recorded):
    """The same equations under another name give the same readings."""
    conf, tr = _named("mistral-train-4k", "recorded")
    c = {"config": conf, "traffic": tr, "seed": SEED, "device": "cpu"}
    via_recorded = train.reference_steps(c, 2)
    c["config"] = {k: v for k, v in conf.items() if k != "reference"}
    assert train.reference_steps(c, 2) == via_recorded
    assert recorded["loss"] == 2


def test_counts_come_from_the_reference(recorded):
    conf, tr = _named("mistral-train-4k", "recorded")
    assert flops.train_step_flops(conf, 2, 64) == _train_flops(conf, 2, 64)
    assert flops.prefill_flops(conf, 2, 64) == _prefill_flops(conf, 2, 64)
    peak = {"bf16_flops_per_s": 1e6}
    rec = {"kind": "train", "traced_steps": 2, "traced_wall_s": 0.5,
           "config": conf, "traffic": tr, "peak": peak}
    assert common.reader("mfu.train")(rec) == pytest.approx(
        100 * 2 * _train_flops(conf, tr["batch"], tr["seq"]) / 0.5 / 1e6)
    rec = {"kind": "serve", "prefill_s": [0.25, 0.25], "config": conf,
           "prefills": [(2, 32), (2, 64)], "peak": peak}
    assert common.reader("mfu.prefill")(rec) == pytest.approx(
        100 * 3.0 * (64 + 128) / 0.5 / 1e6)
    assert recorded["train_step_flops"] == 2
    assert recorded["prefill_flops"] == 3
    # without the key, the GQA formulas
    plain = {k: v for k, v in conf.items() if k != "reference"}
    assert flops.train_step_flops(plain, 2, 64) > _train_flops(plain, 2, 64)


@pytest.fixture
def opened(monkeypatch):
    """Each ``obs.recording()`` the kinds open, counted."""
    from repro_torch import obs
    calls = []
    real = obs.recording

    def spy():
        calls.append(1)
        return real()
    monkeypatch.setattr(obs, "recording", spy)
    return calls


@pytest.mark.parametrize("cell", ["granite-train-4k",
                                  "mistral-serve-longprompt"])
def test_untraced_run_opens_no_recording(cell, opened):
    out = small.run(cell, seed=SEED + 1, compute="float32")
    assert out["correct"], out["checks"]
    assert opened == []


def test_traced_train_records_spans_and_counters(opened):
    c = small.context("granite-train-4k", SEED + 2, "float32", trace=True)
    out = train.run(c)
    rec, tr = out["record"], out["record"]["trace"]
    assert opened == [1, 1]     # set-up's and the window's
    steps = tr.spans("train/step")
    assert len(steps) == rec["traced_steps"] == 1
    # the spans land inside the profiler's range around the steps
    (w0, w1), = tr.ranges("perfbench/window")
    assert all(w0 <= a < b <= w1 for a, b in steps)
    for name in ("train/forward", "train/backward", "train/clip",
                 "train/adamw", "attn/core", "attn/core.bwd", "moe/ffn",
                 "moe/ffn.bwd"):
        assert tr.spans(name), name
    layers = c["config"]["num_hidden_layers"]
    n, k = 2 * 64, c["config"]["num_experts_per_tok"]
    # remat "full" dispatches again in the recompute
    assert rec["counters"]["moe.choices"] == 2 * layers * n * k
    assert 0 < rec["counters"]["moe.peak"] <= 1


def test_traced_moe_counters_read(opened):
    out = small.run("granite-train-4k", seed=SEED + 3, compute="float32",
                    trace=True)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    # capacity 4.0 with top-2 of 8 experts: C = N slots an expert
    assert m["moe_fill.train"]["value"] == 25.0
    assert 100.0 <= m["moe_peak_load.train"]["value"] <= 400.0
    # no device, no launch: the device ms are not read on the CPU
    assert "attn_ms.train" not in m and "fwd_ms.train" not in m


def test_traced_serve_records_spans(opened):
    c = small.context("mistral-serve-longprompt", SEED + 4, "float32",
                      trace=True)
    out = serve.run(c)
    rec, tr = out["record"], out["record"]["trace"]
    assert opened == [1, 1]     # set-up's and the window's
    batches = len(rec["prefills"])
    assert len(tr.spans("serve/generate")) == batches
    assert len(tr.spans("serve/decode")) == \
        batches * c["traffic"]["new_tokens"]
    (w0, w1), = tr.ranges("perfbench/window")
    assert all(w0 <= a < b <= w1 for a, b in tr.spans("serve/generate"))
    assert rec["counters"] == {}
