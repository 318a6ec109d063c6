"""The plain reference against the program at small widths on the CPU:
a train step of each configuration, and prefill then decode through the
cache, in float32 (no rounding to hide a wrong equation) and in bf16."""
from __future__ import annotations

import pytest
import torch

from perfbench import program
from perfbench.kinds import serve, train
from perfbench.reference import model as ref_model
from perfbench.tests import small

TRAIN = ["mistral-train-4k", "granite-train-4k"]


@pytest.mark.parametrize("cell", TRAIN)
def test_train_steps_agree_in_f32(cell):
    c = small.context(cell, seed=2**31 + 7, compute="float32")
    state, prog = train.program_steps(c, 3)
    ref = train.reference_steps(c, 3)
    got = train.compare(prog, ref, 1e-3)
    assert got["loss_gap"] < 2e-6
    assert got["grad_gap"] < 1e-4
    assert got["change_gap"] < 1e-4
    assert not got["dropped_leaves"]


@pytest.mark.parametrize("cell", TRAIN)
def test_train_steps_within_their_limits_in_bf16(cell):
    c = small.context(cell, seed=2**31 + 8)
    state, prog = train.program_steps(c, 3)
    got = train.compare(prog, train.reference_steps(c, 3), 1e-3)
    assert got["loss_gap"] < 5e-3 and got["change_gap"] < 5e-2


def test_forward_logits_agree_in_f32():
    c = small.context("mistral-serve-longprompt", seed=5, compute="float32")
    conf = c["config"]
    cfg = program.model_config(conf, "train")
    dec = program.decoder(cfg, conf, c["seed"], "cpu")
    tokens = torch.randint(0, 512, (2, 48), generator=torch.Generator()
                           .manual_seed(0))
    from repro_torch.models import api
    with torch.no_grad():
        got = api.forward_logits(dec, cfg, {"tokens": tokens})
    dims = ref_model.Dims(conf)
    w = {n: p.detach() for n, p in dec.named_parameters()}
    ar = ref_model.Arith("f32")
    want = ref_model.logits_at(w, dims, ref_model.hidden_states(
        w, dims, tokens, ar), ar)
    assert torch.allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_prefill_and_decode_serve_the_reference_best(compute):
    c = small.context("mistral-serve-longprompt", seed=2**31 + 3,
                      compute=compute)
    cfg = program.model_config(c["config"], "serve")
    params = program.decoder(cfg, c["config"], c["seed"], "cpu")
    with serve.Hooks("cpu", timed=False) as hooks:
        batches = [serve.serve_batch(c, cfg, params, serve.prompts(c, k),
                                     hooks) for k in range(2)]
    picks = serve.check_sample(c, batches)
    assert {batches[k]["prompt_len"] for k, _ in picks} == {32, 64}
    got = serve.served_gaps(c, batches, picks, ref_model.Arith("f32"))
    assert got["logit_gap"] < (1e-4 if compute == "float32" else 0.1)
    assert got["served_tokens"] == 16
