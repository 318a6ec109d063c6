"""The port's span recorder (``repro_torch.obs.spans``) on the CPU.

* Off (no recording open, the default): ``obs.span`` returns the shared
  no-op, and a train step of a tiny dense and a tiny MoE configuration
  builds no span and inserts no marker into the autograd graph.
* On: two train steps give bitwise the loss, the gradient norm and the
  parameters that they give off; one recorded step gives the span tree
  of the trainer, the model step and the MoE FFN, its backward spans
  nested in time inside ``train/backward``.
* The MoE counters against hand counts from ``bincount`` over the routed
  experts; ``host/gc`` for a forced collection; the server's spans; and
  ``profile_session``'s Chrome trace, which holds the spans on the
  profiler's clock beside the host operations they enclose.
* On the card (``cuda``, skipped elsewhere): a span holds its launch's
  ``cudaLaunchKernel`` on the trace's clock.

The configurations are the two archs' ``reduced()`` sizes cut to 2
layers, remat ``full`` and the chunked attention, as the benchmark's
training cells run them.
"""
import collections
import dataclasses
import gc
import json

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokens
from repro_torch.launch.serve import generate
from repro_torch.launch.train import build_train_step
from repro_torch.models import api, moe
from repro_torch.obs import spans
from repro_torch.optim import adamw_init

ARCHS = {"dense": "mistral-nemo-12b", "moe": "granite-moe-1b-a400m"}
TRAIN = ("train/forward", "train/backward", "train/clip", "train/adamw")


def config(kind: str):
    cfg = get_config(ARCHS[kind]).reduced()
    return dataclasses.replace(cfg, n_layers=2, remat=True,
                               remat_policy="full", attn_impl="chunked",
                               attn_q_chunk=16, attn_k_chunk=32)


def steps(kind: str, n: int, record: bool):
    """``n`` train steps from seed 0; each step in a recording of its own
    when ``record``.  Returns (metrics, params, the last recording)."""
    cfg = config(kind)
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    opt = adamw_init(params)
    step = build_train_step(cfg)
    data = SyntheticTokens(cfg.vocab_size, 64, 2, seed=1)
    out, rec = [], None
    for i in range(n):
        batch = data.batch_at(i)
        if record:
            with obs.recording() as rec:
                params, opt, m = step(params, opt, batch, i)
        else:
            params, opt, m = step(params, opt, batch, i)
        out.append(m)
    return out, params, rec


def test_span_off_is_the_shared_noop():
    assert obs.current() is None
    assert obs.span("train/step", step=3) is obs.NULL_SPAN
    x = torch.ones(2)
    with obs.span("x") as sp:
        assert sp.enter(x, {"w": x}) == (x, {"w": x})
        assert sp.exit(x) is x


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_off_builds_no_span_and_no_marker(kind, monkeypatch):
    made = collections.Counter()

    def count(name, orig):
        def f(*a, **kw):
            made[name] += 1
            return orig(*a, **kw)
        return f
    monkeypatch.setattr(spans.Span, "__init__",
                        count("span", spans.Span.__init__))
    for fn in (spans._Close, spans._Open):
        monkeypatch.setattr(fn, "apply", count(fn.__name__, fn.apply))
    steps(kind, 1, record=False)
    assert not made
    # the same counters see the recorded step's spans and markers
    steps(kind, 1, record=True)
    assert made["span"] > 0 and made["_Close"] > 0 and made["_Open"] > 0


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_recording_changes_no_bit(kind):
    off, p_off, _ = steps(kind, 2, record=False)
    on, p_on, _ = steps(kind, 2, record=True)
    for a, b in zip(off, on):
        assert torch.equal(a["loss"], b["loss"])
        assert torch.equal(a["gnorm"], b["gnorm"])
    for (n, a), (_, b) in zip(p_off.named_parameters(),
                              p_on.named_parameters()):
        assert torch.equal(a, b), n


def _by_name(rec):
    out = collections.defaultdict(list)
    for s in rec.spans:
        out[s.name].append(s)
    return out


def _inside(s, outer):
    return outer.start <= s.start and s.end <= outer.end


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_one_step_gives_the_span_tree(kind):
    _, _, rec = steps(kind, 1, record=True)
    assert all(s.end is not None for s in rec.spans)
    by = _by_name(rec)
    (step,) = by["train/step"]
    assert step.parent is None and step.attrs == {"step": 0}
    for name in TRAIN:
        (s,) = by[name]
        assert s.parent is step and _inside(s, step)
    fwd, bwd = by["train/forward"][0], by["train/backward"][0]
    (prep,) = by["model/prepare"]
    assert prep.parent is fwd
    # each layer's block once in the forward pass, once in the recompute
    blocks = by["model/block"]
    assert sum(b.parent is fwd for b in blocks) == 2
    assert sum(_inside(b, bwd) for b in blocks) == 2
    attn = by["attn/core"]
    assert len(attn) == 4
    assert all(a.parent.name == "model/block" for a in attn)
    regions = ["attn/core"] + (["moe/ffn"] if kind == "moe" else [])
    for name in regions:
        backs = by[name + ".bwd"]
        assert len(backs) == 2
        for s in backs:
            assert _inside(s, bwd)
            # the autograd engine's thread: the backward span's parent is
            # a span of the backward pass
            assert s.parent is bwd or _inside(s.parent, bwd)
    if kind == "moe":
        for s in by["moe/ffn"]:
            assert s.parent.name == "model/block"
        for name in ("moe/route", "moe/dispatch", "moe/experts",
                     "moe/combine"):
            assert len(by[name]) == 4
            assert all(s.parent.name == "moe/ffn" for s in by[name])
    else:
        assert "moe/ffn" not in by
    # the recording closed: two clock pairs, spans map into the window
    assert len(rec.clock) == 2
    assert rec.epoch_ns(step.start) >= rec.clock[0][1]
    assert rec.epoch_ns(step.end) <= rec.clock[1][1]


@pytest.mark.parametrize("cf", [1.0, 4.0])
def test_moe_counters_are_the_hand_counts(cf):
    cfg = dataclasses.replace(config("moe"), moe_capacity_factor=cf)
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    p = api.prepare(params, cfg)["moe_blocks"]["moe"]
    p0 = {k: (v[0] if isinstance(v, torch.Tensor) else
              {kk: vv[0] for kk, vv in v.items()}) for k, v in p.items()}
    g = torch.Generator().manual_seed(3)
    xs = [torch.randn(2, n, cfg.d_model, generator=g).to(p0["gate"].dtype)
          for n in (16, 40)]
    choices = slots = 0
    peak = 0.0
    with torch.no_grad(), obs.recording() as rec:
        for x in xs:
            moe.moe_ffn_ep(p0, x, cfg)
            n = x.shape[0] * x.shape[1]
            _, topi, _ = moe._router(p0, x.reshape(n, -1), cfg)
            c = moe._capacity(cf, n, cfg)
            counts = torch.bincount(topi.reshape(-1),
                                    minlength=cfg.n_experts)
            choices += n * cfg.top_k
            slots += cfg.n_experts * c
            peak = max(peak, int(counts.max()) / c)
    assert rec.counters["moe.choices"] == choices
    assert rec.counters["moe.slots"] == slots
    assert rec.counters["moe.peak"] == pytest.approx(peak, rel=1e-6)


def test_gc_collection_is_a_span():
    with obs.recording() as rec:
        gc.collect()
    (s,) = [s for s in rec.spans if s.name == "host/gc"]
    assert s.attrs == {"generation": 2} and s.end >= s.start
    assert rec._on_gc not in gc.callbacks


def test_one_recording_at_a_time():
    with obs.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with obs.recording():
                pass
    assert obs.current() is None


def test_trace_span_records_into_the_recording():
    with obs.recording() as rec:
        with obs.trace_span("bddt/x"):
            pass
        with obs.trace_span("bddt/y", False):
            pass
    assert [s.name for s in rec.spans if s.name.startswith("bddt/")] == \
        ["bddt/x"]


def _serve(new_tokens=3):
    cfg = dataclasses.replace(config("dense"), attn_impl="chunked")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    return generate(cfg, params, {"tokens": tokens},
                    max_new_tokens=new_tokens, max_len=20)


def test_generate_spans():
    off = _serve()
    with obs.recording() as rec:
        on = _serve()
    assert torch.equal(off, on)
    by = _by_name(rec)
    (gen,) = by["serve/generate"]
    assert gen.attrs["batch"] == 2 and gen.attrs["prompt_len"] == 12
    seq = gen.attrs["seq"]
    assert seq is not None
    for name in ("serve/prefill", "model/prepare", "serve/pad_caches"):
        (s,) = by[name]
        assert s.parent is gen
    assert [s.attrs for s in by["serve/decode"]] == \
        [{"seq": seq, "index": i} for i in range(3)]
    assert all(s.parent is gen for s in by["serve/decode"])
    assert by["serve/prefill"][0].attrs == {"seq": seq}


def test_profile_session_writes_the_spans(tmp_path):
    a = torch.randn(256, 256)
    with obs.profile_session(tmp_path, cuda=False) as prof:
        with obs.span("outer", tag="t"):
            with obs.span("inner"):
                a @ a
    doc = json.loads(prof.trace_path.read_text())
    events = doc["traceEvents"]
    mine = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(mine) == {"outer", "inner"}
    assert mine["outer"]["args"]["tag"] == "t"
    assert mine["inner"]["args"]["parent"] == mine["outer"]["args"]["span"]
    assert mine["inner"]["tid"] == mine["outer"]["tid"]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    inner = mine["inner"]
    # the product's host operation lies inside its span on the trace's
    # clock, within 50 µs
    assert mm["ts"] >= inner["ts"] - 50
    assert mm["ts"] + mm["dur"] <= inner["ts"] + inner["dur"] + 50


@pytest.mark.cuda
def test_a_span_holds_its_launch_on_the_card(tmp_path):
    """On the card, with the device's activity alone recorded: a span
    around one launch after a synchronize holds that launch's
    ``cudaLaunchKernel`` on the trace's clock (``obs.span_events``),
    within 50 µs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    card = torch.device("cuda", torch.cuda.current_device())
    x = torch.ones(1 << 20, device=card)
    x.add_(1)
    torch.cuda.synchronize(card)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with obs.recording() as rec:
            torch.cuda.synchronize(card)
            with obs.span("one"):
                x.add_(1)
            torch.cuda.synchronize(card)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    (one,) = obs.span_events(rec, int(doc["baseTimeNanoseconds"]))
    kernels = [e for e in doc["traceEvents"] if e.get("cat") == "kernel"]
    assert len(kernels) == 1, kernels
    corr = kernels[0]["args"]["correlation"]
    (launch,) = [e for e in doc["traceEvents"]
                 if e.get("cat") in ("cuda_runtime", "cuda_driver") and
                 e.get("args", {}).get("correlation") == corr]
    t, a, b = launch["ts"], one["ts"], one["ts"] + one["dur"]
    print(f"span {a:.1f}..{b:.1f} us, {launch['name']} at {t:.1f} us: "
          f"{t - a:.1f} us after the start, {b - t:.1f} us before the end")
    assert a - 50 <= t <= b + 50
