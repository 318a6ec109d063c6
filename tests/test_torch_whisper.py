"""repro_torch's encoder-decoder family (whisper-tiny: a non-causal
encoder over precomputed frame embeddings, a causal decoder whose every
layer cross-attends to the encoder output through ``kv_override``)
against the JAX package's, on the CPU.

Everything runs in f32 at ``reduced()``: d 128, 4 heads of 32, 4
decoder and 2 encoder layers, ``encoder_seq`` 64, on prompts of 32
tokens.  Weights are the reference's init carried across by
``interop.params_from_reference``; tokens and frames are drawn with
numpy from a seed.  Under ``attn_impl="pallas"`` the reference's Pallas
kernel runs in interpret mode (the ``ref_interpret`` fixture) and the
port's wrapper its plain version.  Tolerances, each with its reason:

* the attention functions against the reference's: 1e-5 (the same f32
  operations; the frameworks sum the einsums in other orders).
* the whole model (logits and every cache leaf): 1e-4, the dense tests'
  tolerance (the same sums over 6 layers).
* teacher forcing on the port alone: rtol 2e-3
  (``tests/test_arch_smoke.py``).
"""
import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.launch import serve as ref_serve
from repro.models import api as ref_api
from repro.models import attention as ref_attention
from repro_torch import configs
from repro_torch.interop import params_from_reference, params_to_numpy
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.launch import serve
from repro_torch.models import api, attention, transformer
from test_torch_models import ref_interpret  # noqa: F401  (a fixture)

ARCH = "whisper-tiny"
B, S = 2, 32


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


@functools.cache
def jit(fn):
    """A reference function under ``jax.jit``, its config static."""
    names = [n for n in ("cfg", "causal")
             if n in inspect.signature(fn).parameters]
    return jax.jit(fn, static_argnames=names)


def _leaves(t):
    """Cache leaves in the reference's pytree order (dict keys sorted)."""
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    return [t]


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


def _frames(cfg, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _batches(cfg, tok):
    frames = _frames(cfg)
    return ({"tokens": torch.from_numpy(tok),
             "enc_frames": torch.from_numpy(frames)},
            {"tokens": jnp.asarray(tok), "enc_frames": jnp.asarray(frames)})


# ---------------------------------------------------------------------------
# attention with kv_override
def _attn_setup(seed=5):
    _, ref_cfg = _cfgs()
    w = _weights()["dec_blocks"]["xattn"]
    w = jax.tree_util.tree_map(lambda a: np.array(a[0]), w)
    rng = np.random.default_rng(seed)
    h, dh = ref_cfg.n_kv_heads, ref_cfg.head_dim
    x = rng.standard_normal((B, 16, ref_cfg.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((B, h, 48, dh)).astype(np.float32)
            for _ in range(2))
    p = jax.tree_util.tree_map(torch.from_numpy, w)
    return p, jax.tree_util.tree_map(jnp.asarray, w), x, k, v


@pytest.mark.parametrize("causal", [False, True])
def test_attention_train_with_kv_override_matches_reference(causal):
    """Sq 16 over Skv 48 keys handed in head layout: only q is
    projected; causal aligns the queries to the end of the keys."""
    cfg, ref_cfg = _cfgs()
    p, jp, x, k, v = _attn_setup()
    got = attention.attention_train(
        p, torch.from_numpy(x), cfg, None, causal=causal,
        kv_override=(torch.from_numpy(k), torch.from_numpy(v)))
    want = ref_attention.attention_train(
        jp, jnp.asarray(x), ref_cfg, None, causal=causal,
        kv_override=(jnp.asarray(k), jnp.asarray(v)))
    assert tuple(got.shape) == want.shape == (B, 16, cfg.d_model)
    _close(got, want, 1e-5, f"cross-attention causal={causal}")


def test_attention_decode_with_kv_override_matches_reference():
    """One query row over every key; no cache is written and the cache
    handed in (None) comes back."""
    cfg, ref_cfg = _cfgs()
    p, jp, x, k, v = _attn_setup(seed=6)
    got, cache = attention.attention_decode(
        p, torch.from_numpy(x[:, :1]), cfg, None, 7,
        kv_override=(torch.from_numpy(k), torch.from_numpy(v)))
    want, ref_cache = ref_attention.attention_decode(
        jp, jnp.asarray(x[:, :1]), ref_cfg, None, jnp.int32(7),
        kv_override=(jnp.asarray(k), jnp.asarray(v)))
    assert cache is None and ref_cache is None
    _close(got, want, 1e-5, "cross-attention decode")


def test_kv_override_hands_the_kernel_contiguous_operands(monkeypatch):
    """``_split_heads`` returns a transposed view; the flash kernel's
    wrapper refuses a non-contiguous operand on the card, so the
    override path hands it contiguous q, k and v."""
    cfg, _ = _cfgs("pallas")
    p, _, x, k, v = _attn_setup()
    seen = []
    inner = fa_kernel.flash_attention

    def spy(q, kk, vv, **kw):
        seen.append([t.is_contiguous() for t in (q, kk, vv)])
        return inner(q, kk, vv, **kw)

    monkeypatch.setattr(fa_kernel, "flash_attention", spy)
    kt = torch.from_numpy(k).transpose(2, 3).contiguous().transpose(2, 3)
    attention.attention_train(p, torch.from_numpy(x), cfg, None,
                              causal=False,
                              kv_override=(kt, torch.from_numpy(v)))
    assert seen == [[True, True, True]]


# ---------------------------------------------------------------------------
# the model against the reference
def test_init_params_has_the_reference_tree():
    """The tree, its shapes and its count at ``reduced()``; and the full
    whisper-tiny on ``meta``: the reference's 56,443,392 parameters."""
    cfg, ref_cfg = _cfgs()
    ref_tree = _weights()
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    flat = dict(jax.tree_util.tree_leaves_with_path(ref_tree))
    mine = dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(params)))
    assert mine.keys() == flat.keys()
    for key, leaf in flat.items():
        assert mine[key].shape == leaf.shape, key
    assert api.count_params(params) == ref_api.count_params(ref_tree)
    full = transformer.Decoder(configs.get_config(ARCH), device="meta")
    ref_full = jax.eval_shape(
        lambda: ref_api.init_params(jax.random.PRNGKey(0),
                                    ref_configs.get_config(ARCH)))
    assert api.count_params(full) == ref_api.count_params(ref_full) == \
        56_443_392


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_forward_logits_match_reference(impl, ref_interpret):
    cfg, ref_cfg, params, jp = _setup(impl)
    batch, ref_batch = _batches(cfg, _tokens(cfg, S))
    _close(api.forward_logits(params, cfg, batch),
           jit(ref_api.forward_logits)(jp, ref_cfg, ref_batch),
           1e-4, f"forward_logits {impl}")


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_prefill_and_decode_match_reference(impl, ref_interpret):
    """Prefill, ``pad_caches``, three decode steps: the logits and every
    cache leaf (``enc_out``, ``self.k``, ``self.v``) within 1e-4 of the
    reference's."""
    cfg, ref_cfg, params, jp = _setup(impl)
    batch, ref_batch = _batches(cfg, _tokens(cfg, S))
    logits, caches = api.prefill_step(params, cfg, batch)
    ref_logits, ref_caches = jit(ref_api.prefill_step)(jp, ref_cfg,
                                                       ref_batch)
    _close(logits, ref_logits, 1e-4, "prefill logits")
    got, want = _leaves(caches), jax.tree_util.tree_leaves(ref_caches)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, 1e-4, f"prefill cache leaf {i}")
    caches = api.pad_caches(caches, S + 8)
    ref_caches = ref_api.pad_caches(ref_caches, S + 8)
    for step in range(3):
        nxt = _tokens(cfg, 1, seed=9 + step)[:, :1]
        logits, caches = api.decode_step(params, cfg, torch.from_numpy(nxt),
                                         caches, S + step)
        ref_logits, ref_caches = jit(ref_api.decode_step)(
            jp, ref_cfg, jnp.asarray(nxt), ref_caches, jnp.int32(S + step))
        _close(logits, ref_logits, 1e-4, f"decode {step} logits")
        got, want = _leaves(caches), jax.tree_util.tree_leaves(ref_caches)
        assert [tuple(g.shape) for g in got] == [w.shape for w in want]
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, 1e-4, f"decode {step} cache leaf {i}")


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_the_length_contract_is_the_references(impl, ref_interpret):
    """300 frames do not split into the flash kernel's 256-row blocks:
    under ``pallas`` both packages raise the same ``ValueError`` before
    any launch (the frames are not padded); under ``chunked`` both run
    the frames as one chunk and agree."""
    cfg, ref_cfg, params, jp = _setup(impl, encoder_seq=300)
    batch, ref_batch = _batches(cfg, _tokens(cfg, S))
    if impl == "chunked":
        logits, _ = api.prefill_step(params, cfg, batch)
        ref_logits, _ = jit(ref_api.prefill_step)(jp, ref_cfg, ref_batch)
        _close(logits, ref_logits, 1e-4, "prefill at 300 frames")
        return
    before = fa_kernel.flash_attention.launches
    with pytest.raises(ValueError) as got:
        api.prefill_step(params, cfg, batch)
    with pytest.raises(ValueError) as want:
        jit(ref_api.prefill_step)(jp, ref_cfg, ref_batch)
    assert str(got.value) == str(want.value) == \
        "seq lens (300, 300) not divisible by (256, 256)"
    assert fa_kernel.flash_attention.launches == before


def test_generate_tokens_equal_the_reference():
    cfg, ref_cfg, params, jp = _setup()
    batch, ref_batch = _batches(cfg, _tokens(cfg, 24))
    got = serve.generate(cfg, params, batch, max_new_tokens=4,
                         max_len=24 + 4 + 8)
    want = ref_serve.generate(ref_cfg, jp, ref_batch, max_new_tokens=4,
                              max_len=24 + 4 + 8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_prefill_decode_consistency(impl):
    """Teacher forcing on the port alone: the decode step at position S
    after ``pad_caches`` reproduces the full forward over S + 1 tokens
    (``tests/test_arch_smoke.py``'s check)."""
    cfg = configs.get_config(ARCH).reduced(attn_impl=impl)
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    batch, _ = _batches(cfg, _tokens(cfg, S))
    nxt = torch.from_numpy(_tokens(cfg, 1, seed=9)[:, :1])
    full = api.forward_logits(
        params, cfg, {**batch, "tokens": torch.cat([batch["tokens"], nxt],
                                                   1)})
    _, caches = api.prefill_step(params, cfg, batch)
    logits, _ = api.decode_step(params, cfg, nxt,
                                api.pad_caches(caches, S + 8), S)
    np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, S]),
                               rtol=2e-3, atol=2e-3)


def test_prefill_calls_the_flash_kernel_three_times_a_layer(monkeypatch):
    """``attn_impl="pallas"``: prefill calls the flash kernel's wrapper
    once per encoder layer (non-causal, S_enc²) and twice per decoder
    layer (causal S², cross-attention S over S_enc); decode does not
    call it.  On CPU tensors it runs the plain version and counts no
    launch."""
    cfg = configs.get_config(ARCH).reduced(attn_impl="pallas")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    calls = []
    inner = fa_kernel.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw["causal"]))
        return inner(q, k, v, **kw)

    monkeypatch.setattr(fa_kernel, "flash_attention", counted)
    before = inner.launches
    batch, _ = _batches(cfg, _tokens(cfg, S))
    out = serve.generate(cfg, params, batch, max_new_tokens=3,
                         max_len=S + 8)
    assert tuple(out.shape) == (B, 3)
    e = cfg.encoder_seq
    assert calls == [(e, e, False)] * cfg.encoder_layers + \
        [(S, S, True), (S, e, False)] * cfg.n_layers
    assert inner.launches == before


# ---------------------------------------------------------------------------
# caches, prepare and the server
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_reference(dtype):
    cfg, ref_cfg = _cfgs(compute_dtype=dtype)
    got = api.init_cache(cfg, 2, 24, device="cpu")
    want = ref_api.init_cache(ref_cfg, 2, 24)
    assert set(got) == set(want) == {"self", "enc_out"}
    g, w = _leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w) == 3
    for a, b in zip(g, w):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        assert not a.any()


def test_pad_caches_pads_self_kv_and_leaves_enc_out():
    rng = np.random.default_rng(4)
    tree = {"self": {"k": rng.standard_normal((4, 2, 4, 10, 8)),
                     "v": rng.standard_normal((4, 2, 4, 10, 8))},
            "enc_out": rng.standard_normal((2, 12, 16))}
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    got = api.pad_caches(jax.tree_util.tree_map(torch.from_numpy, tree), 16)
    want = ref_api.pad_caches(jax.tree_util.tree_map(jnp.asarray, tree), 16)
    assert got["self"]["v"].shape == (4, 2, 4, 16, 8)
    assert got["enc_out"].shape == (2, 12, 16)
    for a, b in zip(_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_prepare_casts_the_linears_and_keeps_the_norms():
    """bf16 compute: the reference never passes whisper's stacks through
    ``_prep_stack``, and ``linear`` casts at use: ``prepare`` casts the
    linear weights and biases and leaves every norm scale and bias (the
    encoder's, the decoder's three, ``enc_norm``) the f32 masters
    themselves."""
    cfg = configs.get_config(ARCH).reduced(compute_dtype="bfloat16")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    p, masters = api.prepare(params, cfg), transformer.tree(params)
    norms = [("enc_blocks", "ln1"), ("enc_blocks", "ln2"),
             ("dec_blocks", "ln1"), ("dec_blocks", "ln_x"),
             ("dec_blocks", "ln2")]
    for stack, ln in norms:
        for leaf in ("scale", "bias"):
            assert p[stack][ln][leaf] is masters[stack][ln][leaf], \
                (stack, ln, leaf)
    for leaf in ("scale", "bias"):
        assert p["enc_norm"][leaf] is masters["enc_norm"][leaf]
    for leaf in (p["enc_blocks"]["attn"]["wq"]["w"],
                 p["enc_blocks"]["ffn"]["up"]["w"],
                 p["dec_blocks"]["attn"]["wo"]["w"],
                 p["dec_blocks"]["xattn"]["wk"]["w"],
                 p["dec_blocks"]["ffn"]["down"]["w"], p["lm_head"]["w"]):
        assert leaf.dtype == torch.bfloat16
    assert p["embed"]["table"].dtype == torch.float32
    batch, _ = _batches(cfg, _tokens(cfg, S))
    batch["enc_frames"] = batch["enc_frames"].to(torch.bfloat16)
    out = serve.generate(cfg, params, batch, max_new_tokens=3, max_len=S + 8)
    assert tuple(out.shape) == (B, 3)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size


def test_serve_main_runs_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "24", "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens" in out and "on cpu" in out


def test_every_family_is_ported():
    for arch in configs.ARCH_IDS:
        transformer.require_ported(configs.get_config(arch))
    with pytest.raises(NotImplementedError, match="not ported"):
        transformer.require_ported(dataclasses.replace(
            configs.get_config(ARCH), family="diffusion"))
