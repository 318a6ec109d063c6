"""repro_torch's training path against the JAX package's, on the CPU.

Both packages run the same weights (the reference's init, carried across
by ``interop.params_from_reference``) on the same numpy-drawn tokens, at
each dense architecture's ``reduced()`` size (and, for the loss and its
gradients, each MoE architecture's: drop-free routing, deepseek's MLA
and leading dense layer) cut to 2 layers, sequence 64, f32 compute, the
attention in 16-query, 32-key chunks (so the chunked path runs several
blocks under its checkpoints).  The loss and gradients of the recurrent
families run at their parity tests' sizes (``RECURRENT``): Zamba2's 12
Mamba2 layers and one shared attention call, four 16-token SSD chunks;
xLSTM's 2 mLSTM and 2 sLSTM layers.  Whisper's (``AUDIO``) runs at its
parity tests' size too, 4 decoder and 2 encoder layers over 64 seeded
frames (``enc_frames``), in the same 16/32 attention chunks.  Tolerances,
each with its reason:

* the loss: 1e-5 relative (the frameworks sum the softmax, the products
  and the chunks in other orders).
* every gradient leaf: 1e-5 + 1e-4 * max|g| of the leaf (the same
  sums, through the backward pass).
* remat off, ``full`` and ``dots``: bit-equal gradients (recomputing
  runs the same operations on the same values).
* three whole train steps against the reference's jitted step (learning
  rates 0, 1e-2 and 9.8e-3): the loss within 1e-5 and the global norm
  within 1e-4 relative; the parameters within 1e-5 + 1e-4 * |p| (XLA
  contracts FMAs under ``jit``), except where a gradient is at its
  leaf's rounding floor (|g| < 1e-4 * max|g|, the gradient tolerance
  above).  AdamW divides each element by its own running RMS, so such an
  element moves by about lr a step in either package whatever its
  rounding; the key biases' gradients are all there (zero in exact
  arithmetic: softmax ignores a shift of all of a query's scores).
  Those elements are held to what AdamW can move them, 2.1 * sum(lr)
  apart.  The floor is read from the reference's step-1 gradients (at
  the initial weights, step 0's rate being 0).
* the port's resume: bit-identical to its straight run.
"""
import functools
import json
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.ckpt import restore_checkpoint as ref_restore
from repro.ckpt import save_checkpoint as ref_save
from repro.data import SyntheticTokens as RefTokens
from repro.launch import train as ref_train
from repro.models import api as ref_api
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro_torch import configs
from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.interop import (opt_state_from_reference, opt_state_to_numpy,
                                 params_from_reference, params_to_numpy)
from repro_torch.launch import train
from repro_torch.models import api
from repro_torch.models.transformer import tree, tree_map
from repro_torch.optim import adamw_init

DENSE = ["mistral-nemo-12b", "qwen1.5-4b", "nemotron-4-15b", "command-r-35b"]
MOE = ["deepseek-v2-lite-16b", "granite-moe-1b-a400m"]
# the recurrent families at their parity tests' sizes, not cut to 2
# layers: Zamba2's 12 (one shared attention call, at layer 6) and xLSTM's
# 4 with an sLSTM every second layer (2 layers would have neither)
RECURRENT = {"zamba2-1.2b": dict(attn_q_chunk=16, attn_k_chunk=32),
             "xlstm-1.3b": dict(slstm_every=2)}
AUDIO = {"whisper-tiny": dict(attn_q_chunk=16, attn_k_chunk=32)}
B, S = 2, 64
SMALL = dict(n_layers=2, attn_q_chunk=16, attn_k_chunk=32)
STEP_KW = dict(peak_lr=1e-2, warmup=1, total_steps=10)


def _cfgs(arch, **kw):
    small = {**RECURRENT, **AUDIO}.get(arch, SMALL)
    return (configs.get_config(arch).reduced(**small, **kw),
            ref_configs.get_config(arch).reduced(**small, **kw))


def _tiny(pkg):
    """The reference's ``tests/test_integration.py::_tiny_cfg``."""
    return pkg.get_config("qwen1.5-4b").reduced(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512)


def _tokens(cfg, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _batch(cfg, tokens) -> dict:
    """{"tokens"} as numpy, with seeded ``enc_frames`` for the audio
    family."""
    out = {"tokens": tokens}
    if cfg.family == "audio":
        out["enc_frames"] = np.random.default_rng(3).standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _flat(t, prefix=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _grads(decoder) -> dict:
    return _flat(tree_map(lambda p: p.grad.numpy(), tree(decoder)))


def _port_loss_and_grads(cfg, weights, tokens):
    params = params_from_reference(weights, cfg, device="cpu")
    params.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, tokens).items()}
    loss = api.loss_fn(params, cfg, batch)
    loss.backward()
    return loss.item(), _grads(params)


def _grad_fn(ref_cfg):
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: ref_api.loss_fn(
        p, ref_cfg, b)))
    return lambda p, tokens: grad_fn(p, {
        k: jnp.asarray(v) for k, v in _batch(ref_cfg, tokens).items()})


@functools.cache
def _reference(arch):
    """The reference's weights, its loss and gradients on token batch 0,
    and, for a dense architecture, its gradients on batch 1 (what train
    step 1 sees) and three of its jitted train steps (batches 0, 1, 0)."""
    _, ref_cfg = _cfgs(arch)
    weights = jax.tree_util.tree_map(
        np.asarray, ref_api.init_params(jax.random.PRNGKey(0), ref_cfg))
    toks = [_tokens(ref_cfg, 1), _tokens(ref_cfg, 2)]
    jp = jax.tree_util.tree_map(jnp.asarray, weights)
    grad_fn = _grad_fn(ref_cfg)
    loss, grads = grad_fn(jp, toks[0])
    out = dict(weights=weights, tokens=toks, loss=float(loss),
               grads=_flat(jax.tree_util.tree_map(np.asarray, grads)))
    if arch in MOE or arch in RECURRENT or arch in AUDIO:
        return out
    _, grads1 = grad_fn(jp, toks[1])
    step = jax.jit(ref_train.build_train_step(ref_cfg, **STEP_KW))
    p, opt, metrics = jp, ref_adamw_init(jp), []
    for k in range(3):
        p, opt, m = step(p, opt, {"tokens": jnp.asarray(toks[k % 2])},
                         jnp.int32(k))
        metrics.append({n: float(v) for n, v in m.items()})
    return dict(out, metrics=metrics,
                grads1=_flat(jax.tree_util.tree_map(np.asarray, grads1)),
                stepped=_flat(jax.tree_util.tree_map(np.asarray, p)))


# ---------------------------------------------------------------------------
# loss_fn and its gradients
@pytest.mark.parametrize("arch", DENSE + MOE + list(RECURRENT) + list(AUDIO))
def test_loss_fn_matches_reference(arch):
    ref = _reference(arch)
    cfg, _ = _cfgs(arch)
    loss, _ = _port_loss_and_grads(cfg, ref["weights"], ref["tokens"][0])
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)


@pytest.mark.parametrize("arch", DENSE + MOE + list(RECURRENT) + list(AUDIO))
def test_grads_match_reference(arch):
    ref = _reference(arch)
    cfg, _ = _cfgs(arch)
    _, grads = _port_loss_and_grads(cfg, ref["weights"], ref["tokens"][0])
    assert set(grads) == set(ref["grads"])
    for name, want in ref["grads"].items():
        np.testing.assert_allclose(
            grads[name], want, rtol=0,
            atol=1e-5 + 1e-4 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", DENSE)
def test_remat_policies_give_equal_grads(arch, policy):
    weights = _reference(arch)["weights"]
    cfg, _ = _cfgs(arch)
    tok = _tokens(cfg, 1)
    loss_off, off = _port_loss_and_grads(
        cfg.reduced(**SMALL, remat=False), weights, tok)
    loss_on, on = _port_loss_and_grads(
        cfg.reduced(**SMALL, remat=True, remat_policy=policy), weights, tok)
    assert loss_on == loss_off
    for name in off:
        np.testing.assert_array_equal(on[name], off[name], err_msg=name)


def test_loss_mask_matches_reference():
    ref = _reference("qwen1.5-4b")
    cfg, ref_cfg = _cfgs("qwen1.5-4b")
    tok = ref["tokens"][1]
    lm = (np.random.default_rng(3).random((B, S)) > 0.3).astype(np.float32)
    params = params_from_reference(ref["weights"], cfg, device="cpu")
    got = api.loss_fn(params, cfg, {"tokens": torch.from_numpy(tok),
                                    "loss_mask": torch.from_numpy(lm)})
    want = ref_api.loss_fn(jax.tree_util.tree_map(jnp.asarray,
                                                  ref["weights"]), ref_cfg,
                           {"tokens": jnp.asarray(tok),
                            "loss_mask": jnp.asarray(lm)})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_parameters_need_the_trainer_to_take_gradients():
    """Serving never records a graph: parameters are created without
    gradients; the train step turns them on."""
    cfg, _ = _cfgs("qwen1.5-4b")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    assert not any(p.requires_grad for p in params.parameters())
    tok = {"tokens": torch.from_numpy(_tokens(cfg, 1))}
    step = train.build_train_step(cfg)
    params, _, m = step(params, adamw_init(params), tok, 0)
    assert all(p.requires_grad and p.grad is None
               for p in params.parameters())
    assert torch.isfinite(m["loss"]) and m["gnorm"] > 0


def test_loss_through_the_flash_kernel_raises_under_grad():
    cfg, _ = _cfgs("mistral-nemo-12b", attn_impl="pallas")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu").requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        api.loss_fn(params, cfg, {"tokens": torch.from_numpy(
            _tokens(cfg, 1))})


# ---------------------------------------------------------------------------
# whole train steps
@pytest.mark.parametrize("arch", DENSE)
def test_train_steps_match_reference_jit(arch):
    ref = _reference(arch)
    cfg, _ = _cfgs(arch)
    params = params_from_reference(ref["weights"], cfg, device="cpu")
    opt = adamw_init(params)
    step = train.build_train_step(cfg, **STEP_KW)
    for k in range(3):
        batch = {"tokens": torch.from_numpy(ref["tokens"][k % 2])}
        params, opt, m = step(params, opt, batch, k)
        want = ref["metrics"][k]
        np.testing.assert_allclose(m["loss"].item(), want["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(m["gnorm"].item(), want["gnorm"],
                                   rtol=1e-4)
        np.testing.assert_array_max_ulp(m["lr"].numpy(),
                                        np.float32(want["lr"]), maxulp=2)
    assert int(opt.step) == 3
    lr_sum = sum(m["lr"] for m in ref["metrics"])
    got = _flat(params_to_numpy(params))
    for name, want in ref["stepped"].items():
        g = np.abs(ref["grads1"][name])
        floor = g < 1e-4 * g.max()
        gap = np.abs(got[name] - want)
        over = gap > 1e-5 + 1e-4 * np.abs(want)
        assert not (over & ~floor).any(), \
            f"{name}: {int((over & ~floor).sum())} elements off, worst " \
            f"{gap[~floor].max()}"
        assert (gap[floor] <= 2.1 * lr_sum).all(), name


def test_train_loop_resume_is_bitwise(tmp_path):
    """Stop at step 6, restart, continue to 12 == straight run to 12
    (the reference's ``test_checkpoint_restart_bitwise``)."""
    cfg = _tiny(configs)
    kw = dict(seq_len=32, global_batch=4, log_every=1000, peak_lr=1e-3,
              device="cpu")
    p_a, o_a, _ = train.train_loop(cfg, steps=12, ckpt_dir=None, **kw)
    ck = str(tmp_path / "ck")
    train.train_loop(cfg, steps=6, ckpt_dir=ck, ckpt_every=1000, **kw)
    assert latest_step(ck) == 6
    p_b, o_b, _ = train.train_loop(cfg, steps=12, ckpt_dir=ck,
                                   ckpt_every=1000, resume=True, **kw)
    assert latest_step(ck) == 12
    for a, b in zip(p_a.parameters(), p_b.parameters()):
        assert torch.equal(a, b)
    assert int(o_a.step) == int(o_b.step) == 12
    for a, b in zip(_flat(opt_state_to_numpy(o_a).mu).values(),
                    _flat(opt_state_to_numpy(o_b).mu).values()):
        np.testing.assert_array_equal(a, b)


def test_loss_decreases():
    """The reference's ``test_loss_decreases`` settings."""
    cfg = _tiny(configs)
    _, _, hist = train.train_loop(cfg, steps=30, seq_len=64, global_batch=4,
                                  ckpt_dir=None, log_every=29, peak_lr=2e-3,
                                  device="cpu")
    assert [h["step"] for h in hist] == [0, 29]
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.3


def test_async_checkpoints_and_the_committed_marker(tmp_path):
    cfg = _tiny(configs)
    ck = str(tmp_path / "ck")
    _, _, hist = train.train_loop(cfg, steps=4, seq_len=16, global_batch=2,
                                  ckpt_dir=ck, ckpt_every=2, log_every=1,
                                  device="cpu")
    assert len(hist) == 4 and latest_step(ck) == 4
    # the last async save (step 4) was joined before the final save of
    # the same step replaced it: no writer left, nothing half written
    assert not [t for t in threading.enumerate()
                if t.name.startswith("ckpt-writer-")]
    assert sorted(os.listdir(ck)) == ["step_00000002", "step_00000004"]
    os.makedirs(os.path.join(ck, "step_00000009"))   # never committed
    assert latest_step(ck) == 4
    assert latest_step(str(tmp_path / "nothing")) is None


# ---------------------------------------------------------------------------
# pytree checkpoints across the packages
def _ref_state_after_one_step(weights):
    jp = jax.tree_util.tree_map(jnp.asarray, weights)
    grads = jax.tree_util.tree_map(lambda a: a * 0.01, jp)
    _, st = ref_adamw_update(grads, ref_adamw_init(jp), jp, lr=1e-3)
    return jp, st


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref = _reference("qwen1.5-4b")
    cfg, _ = _cfgs("qwen1.5-4b")
    jp, st = _ref_state_after_one_step(ref["weights"])
    ref_save(str(tmp_path / "ref"), 7, (jp, st), meta={"arch": "x"})
    params = api.init_params(torch.Generator().manual_seed(5), cfg,
                             device="cpu")
    opt = adamw_init(params)
    (p, o), meta, step = restore_checkpoint(str(tmp_path / "ref"), 7,
                                            (params, opt))
    assert p is params and o is opt and meta == {"arch": "x"} and step == 7
    assert o.step.dtype == torch.int32 and int(o.step) == 1
    got = _flat(params_to_numpy(p))
    for name, want in _flat(ref["weights"]).items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    for field in ("mu", "nu"):
        want = _flat(jax.tree_util.tree_map(np.asarray, getattr(st, field)))
        got = _flat(getattr(opt_state_to_numpy(o), field))
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])

    # the same tree written by the port: the same manifest and files
    save_checkpoint(str(tmp_path / "port"), 7, (p, o), meta={"arch": "x"})
    manifests = [json.load(open(tmp_path / d / "step_00000007" /
                                "manifest.json")) for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    paths = [e["path"] for e in manifests[1]["leaves"]]
    assert "[0]/['blocks']/['attn']/['wq']/['w']" in paths
    assert "[1]/.nu/['embed']/['table']" in paths and "[1]/.step" in paths
    for e in manifests[0]["leaves"]:
        a, b = (np.load(tmp_path / d / "step_00000007" / e["file"])
                for d in ("ref", "port"))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    ref = _reference("nemotron-4-15b")
    cfg, ref_cfg = _cfgs("nemotron-4-15b")
    params = params_from_reference(ref["weights"], cfg, device="cpu")
    _, st = _ref_state_after_one_step(ref["weights"])
    opt = opt_state_from_reference(jax.tree_util.tree_map(np.asarray, st),
                                   device="cpu")
    save_checkpoint(str(tmp_path), 3, (params, opt), meta={"k": 1})
    ref_p = ref_api.init_params(jax.random.PRNGKey(9), ref_cfg)
    (p, o), meta, step = ref_restore(str(tmp_path), 3,
                                     (ref_p, ref_adamw_init(ref_p)))
    assert meta == {"k": 1} and step == 3 and int(o.step) == 1
    got = _flat(jax.tree_util.tree_map(np.asarray, p))
    for name, want in _flat(ref["weights"]).items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    np.testing.assert_array_equal(
        _flat(jax.tree_util.tree_map(np.asarray, o.nu))["embed.table"],
        np.asarray(st.nu["embed"]["table"]))


def test_restore_refuses_a_tree_that_does_not_match(tmp_path):
    cfg = _tiny(configs)
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    save_checkpoint(str(tmp_path), 1, (params, adamw_init(params)))
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(str(tmp_path), 1, params)
    other = api.init_params(torch.Generator().manual_seed(0),
                            cfg.reduced(d_model=32, n_layers=2),
                            device="cpu")
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 1, (other, adamw_init(other)))


class _ReferenceBatches:
    """The reference's ``SyntheticTokens`` batches as torch tensors: the
    two packages draw other bits, so the continuation test feeds the
    port the reference's batches."""

    def __init__(self, vocab_size, seq_len, global_batch, seed=0):
        self.ref = RefTokens(vocab_size, seq_len, global_batch, seed=seed)

    def batch_at(self, step, **kw):
        return {"tokens": torch.from_numpy(np.array(
            self.ref.batch_at(step, **kw)["tokens"]))}


def test_port_trainer_resumes_a_reference_run(tmp_path, monkeypatch):
    kw = dict(seq_len=32, global_batch=4, ckpt_every=1000, log_every=1000,
              peak_lr=1e-3)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_train.train_loop(_tiny(ref_configs), steps=6, ckpt_dir=ref_dir, **kw)
    shutil.copytree(ref_dir, port_dir)
    p_ref, o_ref, _ = ref_train.train_loop(_tiny(ref_configs), steps=9,
                                           ckpt_dir=ref_dir, **kw)
    monkeypatch.setattr(train, "SyntheticTokens", _ReferenceBatches)
    p_port, o_port, _ = train.train_loop(_tiny(configs), steps=9,
                                         ckpt_dir=port_dir, device="cpu",
                                         **kw)
    assert int(o_port.step) == int(o_ref.step) == 9
    got = _flat(params_to_numpy(p_port))
    for name, want in _flat(jax.tree_util.tree_map(np.asarray,
                                                   p_ref)).items():
        np.testing.assert_allclose(got[name], want, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the CLI
def test_train_main_runs_on_the_cpu(capsys):
    train.main(["--arch", "qwen1.5-4b", "--reduced", "--steps", "2",
                "--seq-len", "16", "--global-batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] step     0 loss" in out and "[train] step     1" in out


def test_train_main_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--arch", "qwen1.5-4b", "--reduced", "--steps", "1"])
