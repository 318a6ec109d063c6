"""repro_torch's VLM family (Qwen2-VL-72B) against the JAX package's, on
the CPU.

Both packages run the same weights (the reference's init, with the q/k/v
biases redrawn so that ``qkv_bias`` is exercised, carried across by
``interop.params_from_reference``) on the same numpy-drawn tokens and
``vision_embeds`` stub at ``reduced()`` size: M-RoPE with sections
(4, 6, 6) over head dim 32, 16 vision positions spliced over the first
16 of 24.  Tolerances: 1e-4 in f32 (the dense tests'), 2e-3 for teacher
forcing (``tests/test_arch_smoke.py``).  The reference's Pallas flash
kernel runs in interpret mode, as in ``tests/test_torch_models.py``; the
port's ``attn_impl="pallas"`` runs the kernel's plain version here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.launch import serve as ref_serve
from repro.models import api as ref_api
from repro.models import rope as ref_rope
from repro_torch import configs
from repro_torch.interop import params_from_reference, params_to_numpy
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.launch import serve
from repro_torch.models import api, rope, transformer
from test_torch_models import ref_interpret  # noqa: F401  (a fixture)

ARCH = "qwen2-vl-72b"
B, S = 2, 24
IMPLS = [("chunked", "chunked"), ("pallas", "pallas")]


def _cfgs(impl_port="chunked", impl_ref="chunked", **kw):
    return (configs.get_config(ARCH).reduced(attn_impl=impl_port, **kw),
            ref_configs.get_config(ARCH).reduced(attn_impl=impl_ref, **kw))


def _weights(ref_cfg, seed=0):
    """The reference's init with the (zero-initialized) q/k/v biases
    redrawn from a seed."""
    w = jax.tree_util.tree_map(
        np.asarray, ref_api.init_params(jax.random.PRNGKey(seed), ref_cfg))
    rng = np.random.default_rng(seed + 100)
    for name in ("wq", "wk", "wv"):
        b = w["blocks"]["attn"][name]["b"]
        w["blocks"]["attn"][name]["b"] = \
            (0.1 * rng.standard_normal(b.shape)).astype(np.float32)
    return w


def _batch(cfg, n=S, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, n))
            .astype(np.int32),
            "vision_embeds": rng.standard_normal(
                (B, cfg.vision_seq, cfg.d_model)).astype(np.float32)}


def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _setup(impl_port="chunked", impl_ref="chunked", **kw):
    cfg, ref_cfg = _cfgs(impl_port, impl_ref, **kw)
    w = _weights(ref_cfg)
    return (cfg, ref_cfg, params_from_reference(w, cfg, device="cpu"),
            jax.tree_util.tree_map(jnp.asarray, w))


# ---------------------------------------------------------------------------
# the model against the reference
@pytest.mark.parametrize("impl_port,impl_ref", IMPLS)
def test_forward_logits_match_reference(impl_port, impl_ref, ref_interpret):
    cfg, ref_cfg, params, jp = _setup(impl_port, impl_ref)
    batch = _batch(cfg)
    _close(api.forward_logits(params, cfg, _port(batch)),
           ref_api.forward_logits(jp, ref_cfg, _ref(batch)), 1e-4,
           f"forward_logits {impl_port}")


@pytest.mark.parametrize("impl_port,impl_ref", IMPLS)
def test_prefill_and_decode_match_reference(impl_port, impl_ref,
                                            ref_interpret):
    cfg, ref_cfg, params, jp = _setup(impl_port, impl_ref)
    batch = _batch(cfg)
    logits, caches = api.prefill_step(params, cfg, _port(batch))
    ref_logits, ref_caches = ref_api.prefill_step(jp, ref_cfg, _ref(batch))
    assert logits.shape == (B, 1, cfg.padded_vocab)
    _close(logits, ref_logits, 1e-4, "prefill logits")
    for name in ("k", "v"):
        assert tuple(caches[name].shape) == ref_caches[name].shape == \
            (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.head_dim)
        _close(caches[name], ref_caches[name], 1e-4, f"cache {name}")

    nxt = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, 1)) \
        .astype(np.int32)
    logits, caches = api.decode_step(params, cfg, torch.from_numpy(nxt),
                                     api.pad_caches(caches, S + 8), S)
    ref_logits, ref_caches = ref_api.decode_step(
        jp, ref_cfg, jnp.asarray(nxt), ref_api.pad_caches(ref_caches, S + 8),
        jnp.int32(S))
    _close(logits, ref_logits, 1e-4, "decode logits")
    for name in ("k", "v"):
        _close(caches[name], ref_caches[name], 1e-4, f"decoded cache {name}")


def test_loss_and_gradients_match_reference():
    """``loss_fn`` splices the stub and masks its positions' labels; the
    loss within 1e-4 and every gradient leaf within 1e-4 of its largest
    element (the training tests' rule)."""
    cfg, ref_cfg, params, jp = _setup()
    batch = _batch(cfg)
    params.requires_grad_(True)
    loss = api.loss_fn(params, cfg, _port(batch))
    loss.backward()
    ref_loss, ref_grads = jax.value_and_grad(ref_api.loss_fn)(
        jp, ref_cfg, _ref(batch))
    _close(loss, ref_loss, 1e-4, "loss")
    got = dict(params.named_parameters())
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref_grads):
        name = ".".join(k.key for k in path)
        want = np.asarray(leaf)
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(_np(got[name].grad) - want).max())
        assert err <= 1e-4 * scale + 1e-7, (name, err, scale)


def test_loss_masks_the_vision_positions():
    """Tokens under the stub neither feed the model nor carry a label:
    changing them leaves the loss as it was; changing the stub moves
    it."""
    cfg = configs.get_config(ARCH).reduced()
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    batch = _port(_batch(cfg))
    loss = api.loss_fn(params, cfg, batch)
    tokens = batch["tokens"].clone()
    tokens[:, :cfg.vision_seq] = (tokens[:, :cfg.vision_seq] + 7) % \
        cfg.vocab_size
    assert torch.equal(api.loss_fn(params, cfg, {**batch, "tokens": tokens}),
                       loss)
    moved = api.loss_fn(params, cfg, {**batch, "vision_embeds":
                                      batch["vision_embeds"] + 1.0})
    assert not torch.equal(moved, loss)


@pytest.mark.parametrize("impl_port,impl_ref", IMPLS)
def test_generate_tokens_equal_the_reference(impl_port, impl_ref,
                                             ref_interpret):
    cfg, ref_cfg, params, jp = _setup(impl_port, impl_ref)
    batch = _batch(cfg)
    got = serve.generate(cfg, params, _port(batch), max_new_tokens=6,
                         max_len=S + 6 + 8)
    want = ref_serve.generate(ref_cfg, jp, _ref(batch), max_new_tokens=6,
                              max_len=S + 6 + 8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_decode_consistency():
    """Teacher forcing on the port alone, with the stub in both: the
    decode step at position S reproduces the full forward."""
    cfg = configs.get_config(ARCH).reduced(attn_impl="pallas")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    batch = _port(_batch(cfg))
    nxt = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (B, 1)).astype(np.int32))
    full = api.forward_logits(params, cfg, {
        **batch, "tokens": torch.cat([batch["tokens"], nxt], 1)})
    _, caches = api.prefill_step(params, cfg, batch)
    logits, _ = api.decode_step(params, cfg, nxt,
                                api.pad_caches(caches, S + 8), S)
    _close(logits[:, 0], full[:, S], 2e-3, "teacher forcing")


def test_splice_replaces_the_first_positions():
    """``_embed_tokens`` puts the stub (cast to the compute dtype) over
    the first ``nv`` positions and keeps the token embeddings after
    them, in a new tensor; no stub, or a config without ``vision_seq``,
    leaves the embeddings as they are."""
    cfg = configs.get_config(ARCH).reduced(compute_dtype="bfloat16")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    p = api.prepare(params, cfg)
    batch = _port(_batch(cfg))
    tokens, vis = batch["tokens"], batch["vision_embeds"]
    plain = transformer._embed_tokens(p, cfg, tokens)
    spliced = transformer._embed_tokens(p, cfg, tokens, vis)
    nv = cfg.vision_seq
    assert spliced.dtype == torch.bfloat16 and spliced.shape == plain.shape
    assert torch.equal(spliced[:, :nv], vis.to(torch.bfloat16))
    assert torch.equal(spliced[:, nv:], plain[:, nv:])
    text = configs.get_config("qwen1.5-4b").reduced()
    tp = api.prepare(api.init_params(torch.Generator().manual_seed(0), text,
                                     device="cpu"), text)
    assert torch.equal(transformer._embed_tokens(tp, text, tokens, vis),
                       transformer._embed_tokens(tp, text, tokens))


def test_prefill_runs_the_flash_kernel_path_once_a_layer(monkeypatch):
    """``attn_impl="pallas"``: prefill calls the flash kernel's wrapper
    once per layer (its plain version here, on CPU tensors, which counts
    no launch); decode does not call it."""
    cfg = configs.get_config(ARCH).reduced(attn_impl="pallas")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    calls = []
    inner = fa_kernel.flash_attention

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return inner(*args, **kw)

    monkeypatch.setattr(fa_kernel, "flash_attention", counted)
    before = inner.launches
    out = serve.generate(cfg, params, _port(_batch(cfg)), max_new_tokens=3,
                         max_len=S + 8)
    assert tuple(out.shape) == (B, 3)
    assert len(calls) == cfg.n_layers
    assert inner.launches == before


# ---------------------------------------------------------------------------
# M-RoPE, parameters, caches and the server
def test_mrope_at_the_published_sections_matches_reference():
    """D 128, sections (16, 24, 24), theta 1e6, three distinct position
    streams; and with the three streams equal (the text/stub case) it
    is ``apply_rope`` exactly."""
    rng = np.random.default_rng(30)
    x = rng.standard_normal((2, 4, 12, 128)).astype(np.float32)
    pos3 = rng.integers(0, 4096, (3, 2, 12)).astype(np.int32)
    got = rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                           (16, 24, 24), theta=1e6)
    _close(got, ref_rope.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                     (16, 24, 24), theta=1e6),
           1e-4, "mrope")
    pos = torch.from_numpy(pos3[0])
    same = rope.apply_mrope(torch.from_numpy(x), pos[None].expand(3, -1, -1),
                            (16, 24, 24), theta=1e6)
    assert torch.equal(same, rope.apply_rope(torch.from_numpy(x), pos,
                                             theta=1e6))
    with pytest.raises(ValueError, match="do not sum to 64"):
        rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                         (16, 24, 16))


def test_init_params_has_the_reference_tree():
    cfg, ref_cfg = _cfgs()
    ref_tree = jax.tree_util.tree_map(
        np.asarray, ref_api.init_params(jax.random.PRNGKey(0), ref_cfg))
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    mine = params_to_numpy(params)
    flat = dict(jax.tree_util.tree_leaves_with_path(ref_tree))
    mine_flat = dict(jax.tree_util.tree_leaves_with_path(mine))
    assert mine_flat.keys() == flat.keys()
    for key, leaf in flat.items():
        assert mine_flat[key].shape == leaf.shape, key
    assert api.count_params(params) == ref_api.count_params(ref_tree)
    for name in ("wq", "wk", "wv"):
        assert (mine["blocks"]["attn"][name]["b"] == 0).all()
    assert "b" not in mine["blocks"]["attn"]["wo"]
    assert "lm_head" in mine


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_reference(dtype):
    cfg, ref_cfg = _cfgs(compute_dtype=dtype)
    got = api.init_cache(cfg, 2, 24, device="cpu")
    want = ref_api.init_cache(ref_cfg, 2, 24)
    assert set(got) == set(want) == {"k", "v"}
    for name in ("k", "v"):
        assert tuple(got[name].shape) == want[name].shape == \
            (cfg.n_layers, 2, cfg.n_kv_heads, 24, cfg.head_dim)
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
        assert not got[name].any()


def test_serve_main_runs_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "24", "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens" in out and "on cpu" in out


def test_serve_main_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--reduced"])
