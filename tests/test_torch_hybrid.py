"""repro_torch's hybrid family (Zamba2-1.2B: Mamba2 blocks and a shared
attention block) against the JAX package's, on the CPU.

The Mamba2 block alone runs at the reference tests' size
(``tests/test_models.py::_MambaCfg``: d 64, d_inner 128, state 16, 4
heads, chunk 8) on S 32; the model at ``reduced()``: 12 layers, the
shared block before layer 6, chunk 16, on prompts of 32 tokens (two
chunks) and of 24 (not a multiple of the chunk: one chunk of 24).
Weights are the reference's init carried across by
``interop.params_from_reference``, inputs drawn with numpy from a seed,
everything in f32.  The conv is the reference's sum of K shifted
products in the same order (a gap of 0).  Tolerances, each with its
reason:

* the block against the reference's: 1e-5 (the same f32 operations;
  the frameworks sum the einsums in other orders).
* the whole model against the reference's (logits and every cache
  leaf): 1e-4, the dense tests' tolerance (the same sums over 12
  layers).
* chunked against the step-by-step oracle: 2e-4, and a stream split
  into prefill and continuation against one call: 3e-4, the reference's
  own tolerances for its block (``tests/test_models.py``).
* teacher forcing on the port alone: 2e-3 (``tests/test_arch_smoke.py``).
"""
import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.configs as ref_configs
from repro.launch import serve as ref_serve
from repro.models import api as ref_api
from repro.models import mamba as ref_mamba
from repro_torch import configs
from repro_torch.interop import params_from_reference, params_to_numpy
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.launch import serve
from repro_torch.models import api, mamba, transformer
from test_torch_models import ref_interpret  # noqa: F401  (a fixture)

ARCH = "zamba2-1.2b"
B = 2
PROMPTS = [32, 24]


@dataclasses.dataclass(frozen=True)
class _MambaCfg:
    d_model: int = 64
    ssm_d_inner: int = 128
    ssm_state: int = 16
    ssm_heads: int = 4
    ssm_d_conv: int = 4
    ssm_chunk: int = 8


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _torch_tree(t):
    if isinstance(t, dict):
        return {k: _torch_tree(v) for k, v in t.items()}
    return torch.from_numpy(np.array(t, dtype=np.float32))


@functools.cache
def jit(fn):
    """A reference function under ``jax.jit``, its config and
    ``return_state`` static (one compile instead of the eager scans'
    op-by-op dispatch)."""
    names = [n for n in ("cfg", "return_state")
             if n in inspect.signature(fn).parameters]
    return jax.jit(fn, static_argnames=names)


def _leaves(t):
    """Cache leaves in the reference's pytree order (dict keys sorted,
    lists and tuples in order)."""
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _leaves(v)]
    return [t]


# ---------------------------------------------------------------------------
# the Mamba2 block
@functools.cache
def _block():
    cfg = _MambaCfg()
    w = jax.tree_util.tree_map(
        np.asarray, jit(ref_mamba.init_mamba)(jax.random.PRNGKey(0), cfg))
    u = (0.5 * np.random.default_rng(1).standard_normal((2, 32, 64))) \
        .astype(np.float32)
    return cfg, w, u


def test_mamba_chunked_matches_reference_with_its_state():
    """Out, the final SSM state and the conv state, from zero and from a
    drawn state."""
    cfg, w, u = _block()
    p, jp = _torch_tree(w), jax.tree_util.tree_map(jnp.asarray, w)
    got = mamba.mamba_chunked(p, torch.from_numpy(u), cfg, return_state=True)
    want = jit(ref_mamba.mamba_chunked)(jp, jnp.asarray(u), cfg,
                                        return_state=True)
    for g, x, what in zip(got, want, ("out", "state", "conv_state")):
        assert tuple(g.shape) == x.shape, what
        _close(g, x, 1e-5, what)
    rng = np.random.default_rng(2)
    st0 = rng.standard_normal((2, 4, 16, 32)).astype(np.float32)
    cs0 = rng.standard_normal((2, 3, 160)).astype(np.float32)
    got = mamba.mamba_chunked(p, torch.from_numpy(u), cfg,
                              state=torch.from_numpy(st0),
                              conv_state=torch.from_numpy(cs0),
                              return_state=True)
    want = jit(ref_mamba.mamba_chunked)(jp, jnp.asarray(u), cfg,
                                        state=jnp.asarray(st0),
                                        conv_state=jnp.asarray(cs0),
                                        return_state=True)
    for g, x, what in zip(got, want, ("out", "state", "conv_state")):
        _close(g, x, 1e-5, f"from a state: {what}")


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("which", ["mamba", "xlstm"])
def test_causal_conv_is_the_reference_bit_for_bit(which, with_state):
    """Both blocks' depthwise conv is the reference's sum of K shifted
    products, in the same order (not ``F.conv1d``): a gap of 0, with and
    without a streaming state."""
    from repro.models import xlstm as ref_xlstm
    from repro_torch.models import xlstm
    port, ref = {"mamba": (mamba, ref_mamba),
                 "xlstm": (xlstm, ref_xlstm)}[which]
    rng = np.random.default_rng(6)
    x, w, b, state = (rng.standard_normal(shape).astype(np.float32)
                      for shape in ((2, 32, 160), (4, 160), (160,),
                                    (2, 3, 160)))
    got = port._causal_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        state=torch.from_numpy(state) if with_state else None)
    want = ref._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        state=jnp.asarray(state) if with_state else None)
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_mamba_decode_matches_reference():
    cfg, w, u = _block()
    p, jp = _torch_tree(w), jax.tree_util.tree_map(jnp.asarray, w)
    rng = np.random.default_rng(3)
    st0 = rng.standard_normal((2, 4, 16, 32)).astype(np.float32)
    cs0 = rng.standard_normal((2, 3, 160)).astype(np.float32)
    got = mamba.mamba_decode(p, torch.from_numpy(u[:, :1]), cfg,
                             torch.from_numpy(st0), torch.from_numpy(cs0))
    want = jit(ref_mamba.mamba_decode)(jp, jnp.asarray(u[:, :1]), cfg,
                                       jnp.asarray(st0), jnp.asarray(cs0))
    for g, x, what in zip(got, want, ("out", "state", "conv_state")):
        assert tuple(g.shape) == x.shape, what
        _close(g, x, 1e-5, what)


def test_mamba_recurrent_ref_matches_reference():
    cfg, w, u = _block()
    _close(mamba.mamba_recurrent_ref(_torch_tree(w), torch.from_numpy(u),
                                     cfg),
           ref_mamba.mamba_recurrent_ref(
               jax.tree_util.tree_map(jnp.asarray, w), jnp.asarray(u), cfg),
           1e-5, "recurrent oracle")


def test_mamba_chunked_equals_recurrent():
    cfg, w, u = _block()
    p, x = _torch_tree(w), torch.from_numpy(u)
    _close(mamba.mamba_chunked(p, x, cfg), mamba.mamba_recurrent_ref(p, x,
                                                                      cfg),
           2e-4, "chunked vs recurrent")


@settings(max_examples=8, deadline=None)
@given(split=st.integers(8, 24))
def test_streaming_state_handoff(split):
    """Prefill ``split`` tokens, then continue from the returned SSM and
    conv states: the stream equals one call over the whole input."""
    cfg, w, u = _block()
    p, x = _torch_tree(w), torch.from_numpy(u[:1])
    full = mamba.mamba_chunked(p, x, cfg)
    o1, state, cs = mamba.mamba_chunked(p, x[:, :split], cfg,
                                        return_state=True)
    o2 = mamba.mamba_chunked(p, x[:, split:], cfg, state=state,
                             conv_state=cs)
    _close(torch.cat([o1, o2], 1), full, 3e-4, f"split at {split}")


def test_init_mamba_draws_the_reference_law():
    """A_log = log(1..H), dt_bias 0, D 1 and conv_b 0 are constants;
    conv_w ~ N(0, 0.1^2); every layer of a stack its own draw."""
    cfg = _MambaCfg()
    m = mamba.init_mamba(torch.Generator().manual_seed(0), cfg, layers=3)
    assert tuple(m.conv_w.shape) == (3, 4, 160)
    assert torch.equal(m.A_log[1], torch.log(torch.arange(1.0, 5.0)))
    assert not m.dt_bias.any() and not m.conv_b.any()
    assert (m.D == 1).all()
    assert 0.08 < float(m.conv_w.std()) < 0.12
    assert not torch.equal(m.conv_w[0], m.conv_w[1])
    assert not any(t.requires_grad for t in m.parameters())


# ---------------------------------------------------------------------------
# the model against the reference
def _cfgs(impl="chunked", **kw):
    return (configs.get_config(ARCH).reduced(attn_impl=impl, **kw),
            ref_configs.get_config(ARCH).reduced(attn_impl=impl, **kw))


@functools.cache
def _weights():
    _, ref_cfg = _cfgs()
    return jax.tree_util.tree_map(
        np.asarray, jit(ref_api.init_params)(jax.random.PRNGKey(0), ref_cfg))


def _setup(impl="chunked", **kw):
    cfg, ref_cfg = _cfgs(impl, **kw)
    w = _weights()
    return (cfg, ref_cfg, params_from_reference(w, cfg, device="cpu"),
            jax.tree_util.tree_map(jnp.asarray, w))


def _tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def test_reduced_config_has_one_shared_call():
    cfg, _ = _cfgs()
    assert cfg.n_layers == 12 and cfg.ssm_chunk == 16
    assert transformer._zamba_attn_positions(cfg) == [6]
    assert transformer._zamba_attn_positions(
        configs.get_config(ARCH)) == [6, 12, 18, 24, 30, 36]


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
    """Prefill, ``pad_caches``, three decode steps: the logits and every
    cache leaf (SSM and conv states per segment, the shared block's K/V
    per call site) within 1e-4 of the reference's."""
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
    caches = api.pad_caches(caches, s + 8)
    ref_caches = ref_api.pad_caches(ref_caches, s + 8)
    for step in range(3):
        nxt = _tokens(cfg, 1, seed=9 + step)[:, :1]
        logits, caches = api.decode_step(params, cfg, torch.from_numpy(nxt),
                                         caches, s + step)
        ref_logits, ref_caches = jit(ref_api.decode_step)(
            jp, ref_cfg, jnp.asarray(nxt), ref_caches, jnp.int32(s + step))
        _close(logits, ref_logits, 1e-4, f"decode {step} logits")
        got, want = _leaves(caches), jax.tree_util.tree_leaves(ref_caches)
        assert [tuple(g.shape) for g in got] == [w.shape for w in want]
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, 1e-4, f"decode {step} cache leaf {i}")


def test_flash_prefill_matches_reference(ref_interpret):
    """``attn_impl="pallas"`` on both sides: the port's kernel path (its
    plain version on the CPU) against the reference's Pallas kernel in
    interpret mode, at the shared block's D 32, G 1."""
    cfg, ref_cfg, params, jp = _setup("pallas")
    tok = _tokens(cfg, 32)
    logits, _ = api.prefill_step(params, cfg,
                                 {"tokens": torch.from_numpy(tok)})
    ref_logits, _ = jit(ref_api.prefill_step)(jp, ref_cfg,
                                              {"tokens": jnp.asarray(tok)})
    _close(logits, ref_logits, 1e-4, "flash prefill logits")


def test_generate_tokens_equal_the_reference():
    cfg, ref_cfg, params, jp = _setup()
    tok = _tokens(cfg, 24)
    got = serve.generate(cfg, params, {"tokens": torch.from_numpy(tok)},
                         max_new_tokens=4, max_len=24 + 4 + 8)
    want = ref_serve.generate(ref_cfg, jp, {"tokens": jnp.asarray(tok)},
                              max_new_tokens=4, max_len=24 + 4 + 8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_decode_consistency():
    """Teacher forcing on the port alone, through the flash path's plain
    version: the decode step at position S after ``pad_caches``
    reproduces the full forward over S + 1 tokens."""
    cfg = configs.get_config(ARCH).reduced(attn_impl="pallas")
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


def test_prefill_runs_the_flash_kernel_path_once_a_shared_call(monkeypatch):
    """``attn_impl="pallas"``: prefill calls the flash kernel's wrapper
    once per shared block call site at G 1 (its plain version here, on
    CPU tensors, which counts no launch); decode does not call it."""
    cfg = configs.get_config(ARCH).reduced(attn_impl="pallas", n_layers=14,
                                           attn_every=4)
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    calls = []
    inner = fa_kernel.flash_attention

    def counted(*args, **kw):
        calls.append((args[0].shape, args[1].shape))
        return inner(*args, **kw)

    monkeypatch.setattr(fa_kernel, "flash_attention", counted)
    before = inner.launches
    out = serve.generate(cfg, params, {"tokens": torch.from_numpy(
        _tokens(cfg, 32))}, max_new_tokens=3, max_len=40)
    assert tuple(out.shape) == (B, 3)
    assert len(calls) == len(transformer._zamba_attn_positions(cfg)) == 3
    assert all(q[1] == k[1] == cfg.n_heads for q, k in calls)
    assert inner.launches == before


# ---------------------------------------------------------------------------
# parameters, caches, the two repairs and the server
def test_init_params_has_the_reference_tree():
    cfg, ref_cfg = _cfgs()
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
    assert "lm_head" not in mine and "blocks" not in mine
    assert mine["shared_attn"]["ln1"]["scale"].shape == (cfg.d_model,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_reference(dtype):
    cfg, ref_cfg = _cfgs(compute_dtype=dtype)
    got = api.init_cache(cfg, 2, 24, device="cpu")
    want = ref_api.init_cache(ref_cfg, 2, 24)
    assert set(got) == set(want) == {"mamba", "conv", "attn"}
    assert len(got["attn"]) == 1 and len(got["mamba"]) == 2
    g, w = _leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        assert not a.any()


def test_pad_caches_pads_kv_inside_lists_as_the_reference():
    """K/V held in a list (the hybrid family's shared-block caches) are
    padded on the sequence axis like stacked ones; states beside them
    and an MLA latent pair in a tuple are handled as the reference's
    ``tree_map_with_path`` handles them."""
    rng = np.random.default_rng(4)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    tree = {"mamba": [arr(2, 2, 3, 4, 5)], "conv": [arr(2, 2, 3, 6)],
            "attn": [{"k": arr(2, 4, 10, 8), "v": arr(2, 4, 10, 8)},
                     {"k": arr(2, 4, 10, 8), "v": arr(2, 4, 10, 8)}],
            "mla": ({"c_kv": arr(2, 10, 6), "k_rope": arr(2, 10, 4)},)}
    got = api.pad_caches(jax.tree_util.tree_map(torch.from_numpy, tree), 16)
    want = ref_api.pad_caches(jax.tree_util.tree_map(jnp.asarray, tree), 16)
    assert isinstance(got["attn"], list) and isinstance(got["mla"], tuple)
    g, w = _leaves(got), jax.tree_util.tree_leaves(want)
    assert [tuple(a.shape) for a in g] == [b.shape for b in w]
    assert got["attn"][1]["v"].shape == (2, 4, 16, 8)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_prepare_keeps_the_leaves_the_reference_reads_in_f32():
    """bf16 compute: ``prepare`` casts what the reference's ops cast at
    use (linears, the conv) and leaves A_log, dt_bias, D and every norm
    scale the f32 masters themselves."""
    cfg = configs.get_config(ARCH).reduced(compute_dtype="bfloat16")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    p, masters = api.prepare(params, cfg), transformer.tree(params)
    for name in ("A_log", "dt_bias", "D"):
        assert p["mamba"][name] is masters["mamba"][name], name
    assert p["mamba"]["out_norm"]["scale"] is \
        masters["mamba"]["out_norm"]["scale"]
    for name in ("ln1", "ln2"):
        assert p["shared_attn"][name]["scale"] is \
            masters["shared_attn"][name]["scale"]
    for leaf in (p["mamba"]["in_proj"]["w"], p["mamba"]["out_proj"]["w"],
                 p["mamba"]["conv_w"], p["mamba"]["conv_b"],
                 p["shared_in"]["w"], p["shared_attn"]["attn"]["wq"]["w"],
                 p["shared_attn"]["ffn"]["up"]["w"], p["lm_head"]["w"]):
        assert leaf.dtype == torch.bfloat16
    assert p["embed"]["table"].dtype == torch.float32


def test_bf16_generate_runs():
    cfg = configs.get_config(ARCH).reduced(compute_dtype="bfloat16")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    out = serve.generate(cfg, params, {"tokens": torch.from_numpy(
        _tokens(cfg, 32))}, max_new_tokens=3, max_len=40)
    assert tuple(out.shape) == (B, 3)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size


def test_serve_main_runs_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "24", "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens" in out and "on cpu" in out
