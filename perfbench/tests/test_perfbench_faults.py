"""The rest of a run, the card's look skipped, at small sizes on the
CPU: a sound run comes out correct, and with the timed path broken
underneath (a step that returns its state unchanged, half the batch left
out and the mean taken over the rest, a served token altered where it is
produced) ``correct`` comes out false.  The fp8 control, put in the
program's place, fails the cell's limits too."""
from __future__ import annotations

import pytest

from perfbench import control
from perfbench.kinds import train
from perfbench.tests import small

TRAIN = ["mistral-train-4k", "granite-train-4k", "mistral-train-1k"]


@pytest.mark.parametrize("cell", TRAIN + ["mistral-serve-longprompt"])
def test_sound_run_is_correct(cell):
    out = small.run(cell, seed=2**31 + 21, compute="float32")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", TRAIN)
def test_state_left_unchanged_is_caught(cell, monkeypatch):
    import repro_torch.launch.train as launch_train

    def unchanged(grads, state, params, **kw):
        return params, state
    monkeypatch.setattr(launch_train, "adamw_update", unchanged)
    out = small.run(cell, seed=2**31 + 22, compute="float32")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] > \
        out["checks"]["change_gap"]["limit"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_batch_is_caught(cell, monkeypatch):
    api, orig, fault = control.half_batch()
    monkeypatch.setattr(api, "loss_fn", fault)
    out = small.run(cell, seed=2**31 + 23, compute="float32")
    assert not out["correct"], out["checks"]


def test_altered_token_is_caught(monkeypatch):
    from repro_torch.models import api
    orig = api.decode_step

    def altered(params, cfg, token, caches, pos):
        logits, caches = orig(params, cfg, token, caches, pos)
        logits = logits.clone()
        if pos == 33:           # one step of the 32-token prompts
            best = logits[0, -1].argmax()
            logits[0, -1, (best + 1) % logits.shape[-1]] = 1e4
        return logits, caches
    monkeypatch.setattr(api, "decode_step", altered)
    out = small.run("mistral-serve-longprompt", seed=2**31 + 24,
                    compute="float32")
    assert not out["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_fp8_control_fails_a_limit(cell):
    c = small.context(cell, seed=2**31 + 25)
    n = c["traffic"]["check_steps"]
    ref = train.reference_steps(c, n)
    ctl = train.reference_steps(c, n, precision="fp8")
    got = train.compare(ctl, ref, c["cell"]["drop_leaves_below"])
    limits = c["cell"]["limits"]
    assert any(got[k] > limits[k] for k in limits), got


def test_fp8_control_fails_the_serving_limit():
    c = small.context("mistral-serve-longprompt", seed=2**31 + 26)
    out = control.serve_seed(c, True)
    assert out["control_fp8"]["logit_gap"] > \
        c["cell"]["limits"]["logit_gap"]
    assert out["program"]["logit_gap"] <= c["cell"]["limits"]["logit_gap"]
