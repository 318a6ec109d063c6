"""repro_torch's ``ssm`` family (xLSTM-1.3B: mLSTM and sLSTM blocks)
against the JAX package's, on the CPU.

The blocks alone run at the reference tests' size
(``tests/test_models.py::_XlstmCfg``: d 64, 4 heads, d_inner 128, chunk
8) on S 32; the model at ``reduced(slstm_every=2)``: 4 layers, an sLSTM
after each mLSTM (plain ``reduced()`` has 4 // 8 = 0 sLSTM layers and
would never run that path), chunk 16, on prompts of 32 tokens (two
chunks) and of 24 (one chunk of 24).  Weights are the reference's init
carried across by ``interop.params_from_reference``, inputs drawn with
numpy from a seed, everything in f32.  Tolerances, each with its
reason:

* the blocks against the reference's: 1e-5 (the same f32 operations;
  the frameworks sum the einsums in other orders).
* the whole model against the reference's (logits and every cache
  leaf): 1e-4, the dense tests' tolerance.
* chunked mLSTM against the step-by-step oracle: 2e-4, and a stream
  split into prefill and continuation against one call: 3e-4 (mLSTM)
  and 1e-5 (sLSTM, the same steps), the reference's own tolerances
  (``tests/test_models.py``).
* teacher forcing on the port alone: 2e-3 (``tests/test_arch_smoke.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.configs as ref_configs
from repro.launch import serve as ref_serve
from repro.models import api as ref_api
from repro.models import xlstm as ref_xlstm
from repro_torch import configs
from repro_torch.interop import params_from_reference, params_to_numpy
from repro_torch.launch import serve
from repro_torch.models import api, transformer, xlstm
from test_torch_hybrid import _close, _leaves, _torch_tree, jit

ARCH = "xlstm-1.3b"
B = 2
PROMPTS = [32, 24]
SMALL = dict(slstm_every=2)


@dataclasses.dataclass(frozen=True)
class _XlstmCfg:
    d_model: int = 64
    n_heads: int = 4
    xlstm_d_inner: int = 128
    xlstm_d_conv: int = 4
    xlstm_chunk: int = 8


@functools.cache
def _blocks():
    cfg = _XlstmCfg()
    m = jax.tree_util.tree_map(
        np.asarray, jit(ref_xlstm.init_mlstm)(jax.random.PRNGKey(0), cfg))
    s = jax.tree_util.tree_map(
        np.asarray, jit(ref_xlstm.init_slstm)(jax.random.PRNGKey(2), cfg))
    u = (0.5 * np.random.default_rng(1).standard_normal((2, 32, 64))) \
        .astype(np.float32)
    return cfg, m, s, u


def _jnp(w):
    return jax.tree_util.tree_map(jnp.asarray, w)


def _mlstm_state(seed):
    """A drawn (C, n, m) and conv state at the block size."""
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((2, 4, 32, 32)).astype(np.float32),
             rng.standard_normal((2, 4, 32)).astype(np.float32),
             rng.standard_normal((2, 4)).astype(np.float32)),
            rng.standard_normal((2, 3, 128)).astype(np.float32))


def _as(fn, t):
    return tuple(fn(x) for x in t)


# ---------------------------------------------------------------------------
# the blocks
def test_mlstm_chunked_matches_reference_with_its_state():
    cfg, w, _, u = _blocks()
    p, jp = _torch_tree(w), _jnp(w)
    out, state, cs = xlstm.mlstm_chunked(p, torch.from_numpy(u), cfg,
                                         return_state=True)
    r_out, r_state, r_cs = jit(ref_xlstm.mlstm_chunked)(
        jp, jnp.asarray(u), cfg, return_state=True)
    _close(out, r_out, 1e-5, "out")
    _close(cs, r_cs, 1e-5, "conv_state")
    for g, x, what in zip(state, r_state, "Cnm"):
        assert tuple(g.shape) == x.shape, what
        _close(g, x, 1e-5, what)
    st0, cs0 = _mlstm_state(2)
    got = xlstm.mlstm_chunked(p, torch.from_numpy(u), cfg,
                              state=_as(torch.from_numpy, st0),
                              conv_state=torch.from_numpy(cs0))
    want = jit(ref_xlstm.mlstm_chunked)(jp, jnp.asarray(u), cfg,
                                        state=_as(jnp.asarray, st0),
                                        conv_state=jnp.asarray(cs0))
    _close(got, want, 1e-5, "from a state")


def test_mlstm_decode_matches_reference():
    cfg, w, _, u = _blocks()
    st0, cs0 = _mlstm_state(3)
    out, state, cs = xlstm.mlstm_decode(
        _torch_tree(w), torch.from_numpy(u[:, :1]), cfg,
        _as(torch.from_numpy, st0), torch.from_numpy(cs0))
    r_out, r_state, r_cs = jit(ref_xlstm.mlstm_decode)(
        _jnp(w), jnp.asarray(u[:, :1]), cfg, _as(jnp.asarray, st0),
        jnp.asarray(cs0))
    _close(out, r_out, 1e-5, "out")
    _close(cs, r_cs, 1e-5, "conv_state")
    for g, x, what in zip(state, r_state, "Cnm"):
        _close(g, x, 1e-5, what)


def test_mlstm_recurrent_ref_matches_reference():
    cfg, w, _, u = _blocks()
    _close(xlstm.mlstm_recurrent_ref(_torch_tree(w), torch.from_numpy(u),
                                     cfg),
           ref_xlstm.mlstm_recurrent_ref(_jnp(w), jnp.asarray(u), cfg),
           1e-5, "recurrent oracle")


def test_mlstm_chunked_equals_recurrent():
    cfg, w, _, u = _blocks()
    p, x = _torch_tree(w), torch.from_numpy(u)
    _close(xlstm.mlstm_chunked(p, x, cfg),
           xlstm.mlstm_recurrent_ref(p, x, cfg), 2e-4,
           "chunked vs recurrent")


@settings(max_examples=8, deadline=None)
@given(split=st.integers(8, 24))
def test_mlstm_streaming_state_handoff(split):
    cfg, w, _, u = _blocks()
    p, x = _torch_tree(w), torch.from_numpy(u[:1])
    full = xlstm.mlstm_chunked(p, x, cfg)
    o1, state, cs = xlstm.mlstm_chunked(p, x[:, :split], cfg,
                                        return_state=True)
    o2 = xlstm.mlstm_chunked(p, x[:, split:], cfg, state=state,
                             conv_state=cs)
    _close(torch.cat([o1, o2], 1), full, 3e-4, f"split at {split}")


def test_slstm_scan_matches_reference():
    """The scan from zero, with its (c, n, m, h) state, and a decode step
    from that state."""
    cfg, _, w, u = _blocks()
    p, jp = _torch_tree(w), _jnp(w)
    out, state = xlstm.slstm_scan(p, torch.from_numpy(u), cfg,
                                  return_state=True)
    r_out, r_state = jit(ref_xlstm.slstm_scan)(jp, jnp.asarray(u), cfg,
                                               return_state=True)
    _close(out, r_out, 1e-5, "out")
    for g, x, what in zip(state, r_state, "cnmh"):
        assert tuple(g.shape) == x.shape, what
        _close(g, x, 1e-5, what)
    nxt = (0.5 * np.random.default_rng(5).standard_normal((2, 1, 64))) \
        .astype(np.float32)
    got = xlstm.slstm_decode(p, torch.from_numpy(nxt), cfg, state)
    want = jit(ref_xlstm.slstm_decode)(jp, jnp.asarray(nxt), cfg, r_state)
    _close(got[0], want[0], 1e-5, "decode out")
    for g, x, what in zip(got[1], want[1], "cnmh"):
        _close(g, x, 1e-5, f"decode {what}")


def test_slstm_streaming():
    """The reference's ``test_slstm_streaming``: 16 steps scanned, then 16
    more through ``slstm_decode`` from the returned state."""
    cfg, _, w, u = _blocks()
    p, x = _torch_tree(w), torch.from_numpy(u)
    full = xlstm.slstm_scan(p, x, cfg)
    o1, state = xlstm.slstm_scan(p, x[:, :16], cfg, return_state=True)
    o2, _ = xlstm.slstm_decode(p, x[:, 16:], cfg, state)
    _close(torch.cat([o1, o2], 1), full, 1e-5, "slstm stream")


def test_init_blocks_draw_the_reference_law():
    """skip 0.5 and conv_b 0 are constants; conv_w ~ N(0, 0.1^2), the
    head projections ~ N(0, 1/dh) (dh 32 for mLSTM, 16 for sLSTM's r);
    d_up = int(d * 4/3 / 64) * 64 * 2."""
    cfg = _XlstmCfg()
    g = torch.Generator().manual_seed(0)
    m = xlstm.init_mlstm(g, cfg, layers=2)
    s = xlstm.init_slstm(g, cfg, layers=2)
    assert tuple(m.wq.shape) == (2, 4, 32, 32)
    assert (m.skip == 0.5).all() and not m.conv_b.any()
    assert 0.08 < float(m.conv_w.std()) < 0.12
    for w in (m.wq, m.wk, m.wv):
        assert 0.9 < float(w.std()) * 32 ** 0.5 < 1.1
    assert tuple(s.r.shape) == (2, 4, 16, 64)
    assert 0.9 < float(s.r.std()) * 16 ** 0.5 < 1.1
    assert tuple(s.up.w.shape) == (2, 64, 128)
    assert tuple(s.down.w.shape) == (2, 64, 64)
    full = configs.get_config(ARCH)
    s = xlstm.SLSTM(full, device="meta")
    assert tuple(s.up.w.shape) == (2048, 5376)


# ---------------------------------------------------------------------------
# the model against the reference
def _cfgs(**kw):
    return (configs.get_config(ARCH).reduced(**SMALL, **kw),
            ref_configs.get_config(ARCH).reduced(**SMALL, **kw))


@functools.cache
def _weights():
    _, ref_cfg = _cfgs()
    return jax.tree_util.tree_map(
        np.asarray, jit(ref_api.init_params)(jax.random.PRNGKey(0), ref_cfg))


def _setup(**kw):
    cfg, ref_cfg = _cfgs(**kw)
    w = _weights()
    return (cfg, ref_cfg, params_from_reference(w, cfg, device="cpu"),
            _jnp(w))


def _tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def test_reduced_configs_and_segments():
    cfg, _ = _cfgs()
    assert cfg.n_layers == 4 and transformer._xlstm_slstm_count(cfg) == 2
    assert transformer._xlstm_slstm_count(
        configs.get_config(ARCH).reduced()) == 0
    assert transformer._xlstm_slstm_count(configs.get_config(ARCH)) == 6


@pytest.mark.parametrize("s", PROMPTS)
def test_forward_logits_match_reference(s):
    cfg, ref_cfg, params, jp = _setup()
    tok = _tokens(cfg, s)
    _close(api.forward_logits(params, cfg, {"tokens": torch.from_numpy(tok)}),
           jit(ref_api.forward_logits)(jp, ref_cfg,
                                       {"tokens": jnp.asarray(tok)}),
           1e-4, f"forward_logits S {s}")


@pytest.mark.parametrize("s", PROMPTS)
def test_prefill_and_decode_match_reference(s):
    """Prefill, ``pad_caches`` (which leaves every xLSTM state as it is),
    three decode steps: the logits and every cache leaf within 1e-4 of
    the reference's."""
    cfg, ref_cfg, params, jp = _setup()
    tok = _tokens(cfg, s)
    logits, caches = api.prefill_step(params, cfg,
                                      {"tokens": torch.from_numpy(tok)})
    ref_logits, ref_caches = jit(ref_api.prefill_step)(
        jp, ref_cfg, {"tokens": jnp.asarray(tok)})
    _close(logits, ref_logits, 1e-4, "prefill logits")
    got, want = _leaves(caches), jax.tree_util.tree_leaves(ref_caches)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, 1e-4, f"prefill cache leaf {i}")
    padded = api.pad_caches(caches, s + 8)
    assert all(a is b for a, b in zip(_leaves(padded), _leaves(caches)))
    ref_caches = ref_api.pad_caches(ref_caches, s + 8)
    caches = padded
    for step in range(3):
        nxt = _tokens(cfg, 1, seed=9 + step)[:, :1]
        logits, caches = api.decode_step(params, cfg, torch.from_numpy(nxt),
                                         caches, s + step)
        ref_logits, ref_caches = jit(ref_api.decode_step)(
            jp, ref_cfg, jnp.asarray(nxt), ref_caches, jnp.int32(s + step))
        _close(logits, ref_logits, 1e-4, f"decode {step} logits")
        got, want = _leaves(caches), jax.tree_util.tree_leaves(ref_caches)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, 1e-4, f"decode {step} cache leaf {i}")


def test_generate_tokens_equal_the_reference():
    cfg, ref_cfg, params, jp = _setup()
    tok = _tokens(cfg, 24)
    got = serve.generate(cfg, params, {"tokens": torch.from_numpy(tok)},
                         max_new_tokens=4, max_len=24 + 4 + 8)
    want = ref_serve.generate(ref_cfg, jp, {"tokens": jnp.asarray(tok)},
                              max_new_tokens=4, max_len=24 + 4 + 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_decode_consistency():
    """Teacher forcing on the port alone: the decode step at position S
    reproduces the full forward over S + 1 tokens."""
    cfg = configs.get_config(ARCH).reduced(**SMALL)
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    tok = torch.from_numpy(_tokens(cfg, 32))
    nxt = torch.from_numpy(_tokens(cfg, 1, seed=9)[:, :1])
    full = api.forward_logits(params, cfg,
                              {"tokens": torch.cat([tok, nxt], 1)})
    _, caches = api.prefill_step(params, cfg, {"tokens": tok})
    logits, _ = api.decode_step(params, cfg, nxt,
                                api.pad_caches(caches, 40), 32)
    _close(logits[:, 0], full[:, 32], 2e-3, "teacher forcing")


def test_no_slstm_runs_the_mlstm_stack_alone():
    """Plain ``reduced()``: no sLSTM layer, one repeat of 4 mLSTM
    blocks, against the reference."""
    cfg = configs.get_config(ARCH).reduced()
    ref_cfg = ref_configs.get_config(ARCH).reduced()
    w = jax.tree_util.tree_map(
        np.asarray, jit(ref_api.init_params)(jax.random.PRNGKey(1), ref_cfg))
    assert "slstm" not in w
    params = params_from_reference(w, cfg, device="cpu")
    assert not hasattr(params, "slstm")
    tok = _tokens(cfg, 16)
    logits, caches = api.prefill_step(params, cfg,
                                      {"tokens": torch.from_numpy(tok)})
    ref_logits, _ = jit(ref_api.prefill_step)(_jnp(w), ref_cfg,
                                              {"tokens": jnp.asarray(tok)})
    _close(logits, ref_logits, 1e-4, "prefill logits")
    assert caches["slstm"] == [] and len(caches["mlstm"]) == 1
    assert caches["mlstm"][0][0].shape[0] == 4


# ---------------------------------------------------------------------------
# parameters, caches, prepare and the server
def test_init_params_has_the_reference_tree():
    cfg, _ = _cfgs()
    ref_tree = _weights()
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    mine = params_to_numpy(params)
    flat = dict(jax.tree_util.tree_leaves_with_path(ref_tree))
    mine_flat = dict(jax.tree_util.tree_leaves_with_path(mine))
    assert mine_flat.keys() == flat.keys()
    for key, leaf in flat.items():
        assert mine_flat[key].shape == leaf.shape, key
    assert api.count_params(params) == ref_api.count_params(ref_tree)


def test_full_width_parameter_count():
    """xLSTM-1.3B as the reference builds it: 1,915,983,872 parameters
    (``up`` is d -> 2 d_in and the sLSTM blocks carry a post-MLP),
    counted on the meta device."""
    cfg = configs.get_config(ARCH)
    assert api.count_params(transformer.Decoder(cfg, device="meta")) == \
        1_915_983_872
    zamba = configs.get_config("zamba2-1.2b")
    assert api.count_params(transformer.Decoder(zamba, device="meta")) == \
        1_096_471_424


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_reference(dtype):
    cfg, ref_cfg = _cfgs(compute_dtype=dtype)
    got = api.init_cache(cfg, 2, 24, device="cpu")
    want = ref_api.init_cache(ref_cfg, 2, 24)
    assert set(got) == set(want) == {"mlstm", "mconv", "slstm"}
    assert isinstance(got["mlstm"][0], tuple) and \
        isinstance(got["slstm"][0], tuple)
    g, w = _leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(_np32(a), np.asarray(b, np.float32))


def _np32(t):
    return t.float().numpy()


def test_prepare_keeps_the_leaves_the_reference_reads_in_f32():
    """bf16 compute: ``prepare`` casts the linears, the conv, the mLSTM
    head projections and skip, and leaves sLSTM's ``r`` and every norm
    scale the f32 masters themselves."""
    cfg = configs.get_config(ARCH).reduced(compute_dtype="bfloat16",
                                           **SMALL)
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    p, masters = api.prepare(params, cfg), transformer.tree(params)
    assert p["slstm"]["r"] is masters["slstm"]["r"]
    for name in ("mlstm", "slstm"):
        assert p[name]["out_norm"]["scale"] is \
            masters[name]["out_norm"]["scale"]
    for leaf in (p["mlstm"]["up"]["w"], p["mlstm"]["down"]["w"],
                 p["mlstm"]["w_if"]["w"], p["mlstm"]["conv_w"],
                 p["mlstm"]["conv_b"], p["mlstm"]["wq"], p["mlstm"]["wk"],
                 p["mlstm"]["wv"], p["mlstm"]["skip"],
                 p["slstm"]["w_in"]["w"], p["slstm"]["up"]["w"],
                 p["slstm"]["down"]["w"]):
        assert leaf.dtype == torch.bfloat16
    out = serve.generate(cfg, params, {"tokens": torch.from_numpy(
        _tokens(cfg, 32))}, max_new_tokens=3, max_len=40)
    assert tuple(out.shape) == (B, 3)


def test_serve_main_runs_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "24", "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens" in out and "on cpu" in out
