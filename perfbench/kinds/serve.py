"""Serving cells: the program's ``generate`` over closed-loop batches of
the traffic file's prompt lengths, then the served tokens checked against
the plain reference.

One batch at a time: a batch is due when the previous one has returned,
and each of its requests' time to first token runs from then to the
moment the host holds the batch's first tokens.  The harness reads them
as a streaming server would, right after ``prefill_step`` returns (a
wrapper around the program's ``api.prefill_step``); in a traced run the
wrappers also synchronize around each prefill and decode step and time
them.  Batch ``k`` holds ``batch`` prompts of the ``k``-th length of the
traffic file's list, taken in turn: the program's prefill takes one
length a batch, so a server of it groups requests by length.  The
prompts' tokens are drawn from the seed on the device; the lengths and
their order are the same for every seed, so that the seed changes the
tokens and not the work.  Set-up warms every length with a batch of
``warmup_new_tokens`` new tokens, in the cache of the window's size.
"""
from __future__ import annotations

import time

import torch

from repro_torch.launch.serve import generate
from repro_torch.models import api

from .. import common, program
from ..reference import model as ref_model
from ..trace import Trace


def prompts(c: dict, k: int, purpose: int = common.PROMPTS):
    """Batch ``k``'s prompts: (batch, length) int32 on the device."""
    tr, dev = c["traffic"], c["device"]
    length = tr["prompt_lengths"][k % len(tr["prompt_lengths"])]
    g = torch.Generator(device=dev).manual_seed(
        common.sub_seed(c["seed"], purpose, k))
    return torch.randint(0, c["config"]["vocab_size"], (tr["batch"], length),
                         generator=g, device=dev, dtype=torch.int32)


class Hooks:
    """Wrappers around the program's ``api.prefill_step`` and
    ``api.decode_step`` while a block runs: the host's first tokens after
    each prefill (``first``, its clock) and, when ``timed``, each step's
    synchronized wall under a profiler range of its own."""

    def __init__(self, dev, timed: bool):
        self.dev, self.timed = dev, timed
        self.first: list[float] = []
        self.prefill_s: list[float] = []
        self.decode_s: list[float] = []

    def _wrap(self, fn, walls, name):
        def call(*a, **kw):
            if not self.timed:
                return fn(*a, **kw)
            common.sync(self.dev)
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*a, **kw)
                common.sync(self.dev)
            walls.append(time.perf_counter() - t0)
            return out
        return call

    def __enter__(self):
        self.orig = (api.prefill_step, api.decode_step)
        prefill = self._wrap(api.prefill_step, self.prefill_s,
                             "perfbench/prefill")

        def prefill_first(*a, **kw):
            out = prefill(*a, **kw)
            out[0][:, -1].argmax(-1).cpu()
            self.first.append(time.perf_counter())
            return out
        api.prefill_step = prefill_first
        api.decode_step = self._wrap(api.decode_step, self.decode_s,
                                     "perfbench/decode")
        return self

    def __exit__(self, *exc):
        api.prefill_step, api.decode_step = self.orig


def serve_batch(c: dict, cfg, params, tokens, hooks: Hooks,
                new_tokens: int | None = None) -> dict:
    """One batch through ``generate`` (``new_tokens`` each, the traffic
    file's by default): its time to first token and its tokens (on the
    CPU)."""
    tr = c["traffic"]
    n_first = len(hooks.first)
    t_due = time.perf_counter()
    with torch.profiler.record_function("perfbench/batch"):
        out = generate(cfg, params, {"tokens": tokens},
                       max_new_tokens=new_tokens or tr["new_tokens"],
                       max_len=tokens.shape[1] + tr["new_tokens"] +
                       tr["max_len_extra"]).cpu()
    if len(hooks.first) != n_first + 1:
        raise RuntimeError(f"generate ran {len(hooks.first) - n_first} "
                           "prefill steps for one batch; the first token's "
                           "time is not observable")
    return {"prompt_len": tokens.shape[1], "ttft_s": hooks.first[-1] - t_due,
            "tokens": out}


def check_sample(c: dict, batches: list[dict]) -> list[tuple[int, int]]:
    """``(batch, row)`` of the requests compared, drawn from the seed:
    ``check_requests`` of them spread over the prompt lengths, the
    longest first, each from the batches that finished."""
    tr = c["traffic"]
    g = torch.Generator().manual_seed(common.sub_seed(c["seed"],
                                                      common.SAMPLE))
    lengths = sorted(set(b["prompt_len"] for b in batches), reverse=True)
    want = tr["check_requests"]
    picks = []
    for j, length in enumerate(lengths):
        ks = [k for k, b in enumerate(batches) if b["prompt_len"] == length]
        n = want // len(lengths) + (j < want % len(lengths))
        order = torch.randperm(len(ks) * tr["batch"], generator=g)[:n]
        picks += [(ks[int(i) // tr["batch"]], int(i) % tr["batch"])
                  for i in order]
    return picks


@torch.inference_mode()
def served_gaps(c: dict, batches, picks, ar: ref_model.Arith,
                tokens_of=None) -> dict:
    """For each picked request, the reference's logits at every position
    that chose a served token, over its prompt and served tokens; the
    gap by which the served token's logit lies below the best one.  With
    ``tokens_of`` (a function of the request's logits under ``ar``) the
    tokens judged are those instead of the served ones, as the control
    reads them."""
    conf, dev, new = c["config"], c["device"], c["traffic"]["new_tokens"]
    ref_model.tf32_off()
    dims = ref_model.Dims(conf)
    w = common.fresh_weights(conf, c["seed"], dev)
    exact = ref_model.Arith("f32")
    worst, gaps = 0.0, []
    for k, row in picks:
        served = batches[k]["tokens"][row].to(dev).long()
        prompt = prompts(c, k)[row].long()
        seq = torch.cat([prompt, served[:-1]])[None]
        length = prompt.shape[0]
        hid = ref_model.hidden_states(w, dims, seq, exact)[0,
                                                         length - 1:]
        logits = ref_model.logits_at(w, dims, hid, exact)[:, :dims.vocab]
        judged = served
        if tokens_of is not None:
            hid_c = ref_model.hidden_states(w, dims, seq, ar)[0, length - 1:]
            judged = tokens_of(ref_model.logits_at(w, dims, hid_c, ar)
                               [:, :dims.vocab])
        g = logits.max(-1).values - logits.gather(-1, judged[:, None])[:, 0]
        gaps.append(float(g.max()))
        worst = max(worst, gaps[-1])
        del hid, logits
    del w
    common.free(dev)
    return {"logit_gap": worst, "per_request": gaps,
            "served_tokens": len(picks) * new}


def run(c: dict) -> dict:
    conf, tr, dev = c["config"], c["traffic"], c["device"]
    cfg = program.model_config(conf, "serve")
    params = program.decoder(cfg, conf, c["seed"], dev)
    lengths = tr["prompt_lengths"]
    with Hooks(dev, timed=False) as hooks:
        for k in range(len(lengths)):
            serve_batch(c, cfg, params, prompts(c, k, common.WARMUP), hooks,
                        tr["warmup_new_tokens"])
    common.sync(dev)
    rec = {"kind": "serve", "setup_s": time.perf_counter() - c["t_start"]}

    batches = []
    common.peak_reset(dev)
    if not c["trace"]:
        with Hooks(dev, timed=False) as hooks:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < c["seconds"]:
                batches.append(serve_batch(c, cfg, params,
                                           prompts(c, len(batches)), hooks))
            rec["window_s"] = time.perf_counter() - t0
    else:
        with Hooks(dev, timed=True) as hooks, \
                torch.profiler.profile(
                    activities=common.activities(dev)) as prof:
            with torch.profiler.record_function("perfbench/window"):
                common.sync(dev)
                for k in range(tr["traced_cycles"] * len(lengths)):
                    batches.append(serve_batch(c, cfg, params,
                                               prompts(c, k), hooks))
        rec["trace"] = Trace.of(prof)
        del prof
        rec["prefills"] = [(tr["batch"], b["prompt_len"]) for b in batches]
        rec["prefill_s"] = hooks.prefill_s
        rec["decode_s"] = hooks.decode_s
    rec["peak_bytes"] = common.peak_bytes(dev)
    rec["requests"] = [(b["prompt_len"], tr["new_tokens"], b["ttft_s"])
                       for b in batches for _ in range(tr["batch"])]
    failed = sum(int(((b["tokens"] < 0) | (b["tokens"] >= conf["vocab_size"]))
                     .any(-1).sum()) +
                 (tr["batch"] if tuple(b["tokens"].shape) !=
                  (tr["batch"], tr["new_tokens"]) else 0)
                 for b in batches)
    del params
    common.free(dev)

    t_ref = time.perf_counter()
    got = served_gaps(c, batches, check_sample(c, batches),
                      ref_model.Arith("f32"))
    got["reference_s"] = time.perf_counter() - t_ref
    return {"record": rec, "attempted": len(batches) * tr["batch"],
            "failed": failed, "readings": got}
