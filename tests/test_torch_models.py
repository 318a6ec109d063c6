"""repro_torch's dense LLM path against the JAX package's, on the CPU.

Both packages run the same weights (the reference's init, carried across
by ``interop.params_from_reference``) on the same numpy-drawn tokens at
each dense architecture's ``reduced()`` size.  The reference's Pallas
flash kernel runs in interpret mode: ``flash_attention_pallas`` is
wrapped so that it always gets ``interpret=True`` (the reference's model
code never passes it, and off the TPU only interpret mode lowers).  The
port's ``attn_impl="pallas"`` runs the kernel's plain version here; the
CUDA kernel itself is held against that plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Tolerances: 1e-4 in
f32, 5e-2 in bf16 compute (the two frameworks round bf16 products at
other places), 2e-3 for teacher forcing (``tests/test_arch_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.kernels.flash_attention import kernel as ref_fa_kernel
from repro.launch import serve as ref_serve
from repro.models import api as ref_api
from repro.models import layers as ref_layers
from repro.models import rope as ref_rope
from repro_torch import configs
from repro_torch.interop import params_from_reference, params_to_numpy
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.launch import serve
from repro_torch.models import api, layers, rope, transformer

DENSE = ["mistral-nemo-12b", "qwen1.5-4b", "nemotron-4-15b", "command-r-35b"]
MOE = ["deepseek-v2-lite-16b", "granite-moe-1b-a400m"]     # test_torch_moe
VLM = ["qwen2-vl-72b"]                                     # test_torch_vlm
RECURRENT = ["zamba2-1.2b", "xlstm-1.3b"]   # test_torch_hybrid, _xlstm
B, S = 2, 16


@pytest.fixture
def ref_interpret(monkeypatch):
    """The reference's Pallas flash kernel, always in interpret mode."""
    inner = ref_fa_kernel.flash_attention_pallas

    def forced(*args, **kw):
        return inner(*args, **{**kw, "interpret": True})

    monkeypatch.setattr(ref_fa_kernel, "flash_attention_pallas", forced)


def _cfgs(arch, impl_port, impl_ref, **kw):
    return (configs.get_config(arch).reduced(attn_impl=impl_port, **kw),
            ref_configs.get_config(arch).reduced(attn_impl=impl_ref, **kw))


def _weights(ref_cfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, ref_api.init_params(jax.random.PRNGKey(seed), ref_cfg))


def _tokens(cfg, n=S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# configs: a copy of the reference's
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    port, ref = configs.get_config(arch), ref_configs.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert port.padded_vocab == ref.padded_vocab
    assert configs.applicable_shapes(port) == \
        ref_configs.applicable_shapes(ref)
    assert transformer.segments(port) == \
        __import__("repro.models.transformer", fromlist=["segments"]) \
        .segments(ref)


def test_registry_and_shapes_equal_the_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    with pytest.raises(ValueError, match="unknown arch"):
        configs.get_config("gpt-2")


# ---------------------------------------------------------------------------
# layers and rope against the reference's
def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rope_matches_reference():
    rng = np.random.default_rng(20)
    x = _rand(rng, 2, 4, 12, 32)
    pos = rng.integers(0, 500, (2, 12)).astype(np.int32)
    _close(rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           theta=1e6),
           ref_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e6),
           1e-4, "rope")
    pos3 = rng.integers(0, 50, (3, 2, 12)).astype(np.int32)
    _close(rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                            (4, 6, 6)),
           ref_rope.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), (4, 6, 6)),
           1e-4, "mrope")
    _close(rope.sinusoidal_positions(20, 16),
           ref_rope.sinusoidal_positions(20, 16), 1e-6, "sinusoid")
    _close(rope.sinusoidal_position_at(7, 16),
           ref_rope.sinusoidal_position_at(jnp.int32(7), 16), 1e-6, "at")
    _close(rope.rope_freqs(32, 5e6), ref_rope.rope_freqs(32, 5e6), 1e-6,
           "freqs")


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_matches_reference(kind, dtype):
    rng = np.random.default_rng(21)
    x, scale, bias = _rand(rng, 3, 5, 64), _rand(rng, 64), _rand(rng, 64)
    p = {"scale": scale} if kind == "rmsnorm" else \
        {"scale": scale, "bias": bias}
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    got = layers.norm({k: torch.from_numpy(v) for k, v in p.items()}, tx,
                      kind, 1e-5)
    want = ref_layers.norm({k: jnp.asarray(v) for k, v in p.items()}, jx,
                           kind, 1e-5)
    assert got.dtype == tx.dtype
    _close(got, want, 1e-5 if dtype == "float32" else 1e-2, kind)


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu2"])
def test_ffn_and_linear_match_reference(act):
    rng = np.random.default_rng(22)
    names = ["gate", "up", "down"] if act == "swiglu" else ["up", "down"]
    p = {n: {"w": _rand(rng, 64, 96) if n != "down" else _rand(rng, 96, 64),
             "b": _rand(rng, 96) if n != "down" else _rand(rng, 64)}
         for n in names}
    x = _rand(rng, 2, 7, 64)
    tp = {n: {k: torch.from_numpy(v) for k, v in d.items()}
          for n, d in p.items()}
    jp = {n: {k: jnp.asarray(v) for k, v in d.items()} for n, d in p.items()}
    _close(layers.ffn(tp, torch.from_numpy(x), act),
           ref_layers.ffn(jp, jnp.asarray(x), act), 1e-4, act)
    _close(layers.linear(tp["up"], torch.from_numpy(x)),
           ref_layers.linear(jp["up"], jnp.asarray(x)), 1e-5, "linear+bias")
    with pytest.raises(ValueError):
        layers.ffn(tp, torch.from_numpy(x), "tanh")


def test_embed_and_logits_out_match_reference():
    rng = np.random.default_rng(23)
    table, head = _rand(rng, 50, 16), _rand(rng, 16, 50)
    tok = rng.integers(0, 50, (2, 5)).astype(np.int32)
    _close(layers.embed({"table": torch.from_numpy(table)},
                        torch.from_numpy(tok), scale=4.0),
           ref_layers.embed({"table": jnp.asarray(table)}, jnp.asarray(tok),
                            scale=4.0), 0, "embed")
    x = _rand(rng, 2, 5, 16)
    _close(layers.logits_out({"w": torch.from_numpy(head)},
                             torch.from_numpy(x)),
           ref_layers.logits_out({"w": jnp.asarray(head)}, jnp.asarray(x)),
           1e-5, "head")
    _close(layers.logits_out(None, torch.from_numpy(x),
                             tied_table=torch.from_numpy(table)),
           ref_layers.logits_out(None, jnp.asarray(x),
                                 tied_table=jnp.asarray(table)),
           1e-5, "tied")


# ---------------------------------------------------------------------------
# the dense architectures end to end, weights carried across
@pytest.mark.parametrize("impl_port,impl_ref", [
    ("pallas", "pallas"), ("pallas", "chunked"), ("chunked", "chunked")])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode_match_reference(arch, impl_port, impl_ref,
                                                ref_interpret):
    cfg, ref_cfg = _cfgs(arch, impl_port, impl_ref)
    w = _weights(ref_cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, w)
    params = params_from_reference(w, cfg, device="cpu")
    tok = _tokens(cfg)
    what = f"{arch} port {impl_port} vs reference {impl_ref}"

    _close(api.forward_logits(params, cfg, {"tokens": torch.from_numpy(tok)}),
           ref_api.forward_logits(jp, ref_cfg, {"tokens": jnp.asarray(tok)}),
           1e-4, what + ": forward_logits")

    logits, caches = api.prefill_step(params, cfg,
                                      {"tokens": torch.from_numpy(tok)})
    ref_logits, ref_caches = ref_api.prefill_step(
        jp, ref_cfg, {"tokens": jnp.asarray(tok)})
    assert logits.shape == (B, 1, cfg.padded_vocab)
    _close(logits, ref_logits, 1e-4, what + ": prefill logits")
    for name in ("k", "v"):
        assert tuple(caches[name].shape) == ref_caches[name].shape == \
            (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.head_dim)
        _close(caches[name], ref_caches[name], 1e-4, what + f": cache {name}")

    nxt = _tokens(cfg, 1, seed=9)
    caches = api.pad_caches(caches, S + 8)
    ref_caches = ref_api.pad_caches(ref_caches, S + 8)
    logits, caches = api.decode_step(params, cfg, torch.from_numpy(nxt),
                                     caches, S)
    ref_logits, ref_caches = ref_api.decode_step(
        jp, ref_cfg, jnp.asarray(nxt), ref_caches, jnp.int32(S))
    _close(logits, ref_logits, 1e-4, what + ": decode logits")
    for name in ("k", "v"):
        assert tuple(caches[name].shape) == ref_caches[name].shape
        _close(caches[name], ref_caches[name], 1e-4,
               what + f": decoded cache {name}")


def test_bf16_compute_matches_reference(ref_interpret):
    cfg, ref_cfg = _cfgs("mistral-nemo-12b", "pallas", "pallas",
                         compute_dtype="bfloat16")
    w = _weights(ref_cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, w)
    params = params_from_reference(w, cfg, device="cpu")
    tok = _tokens(cfg)
    got = api.forward_logits(params, cfg, {"tokens": torch.from_numpy(tok)})
    want = ref_api.forward_logits(jp, ref_cfg, {"tokens": jnp.asarray(tok)})
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want, 5e-2, "bf16 forward_logits")
    logits, caches = api.prefill_step(params, cfg,
                                      {"tokens": torch.from_numpy(tok)})
    ref_logits, ref_caches = ref_api.prefill_step(
        jp, ref_cfg, {"tokens": jnp.asarray(tok)})
    assert caches["k"].dtype == torch.bfloat16
    _close(logits, ref_logits, 5e-2, "bf16 prefill logits")
    nxt = _tokens(cfg, 1, seed=9)
    logits, _ = api.decode_step(params, cfg, torch.from_numpy(nxt),
                                api.pad_caches(caches, S + 8), S)
    ref_logits, _ = ref_api.decode_step(
        jp, ref_cfg, jnp.asarray(nxt), ref_api.pad_caches(ref_caches, S + 8),
        jnp.int32(S))
    _close(logits, ref_logits, 5e-2, "bf16 decode logits")


def test_prepare_casts_what_the_reference_casts():
    """bf16 compute: the stacked leaves of rank >= 2 (norm scales
    included, rank 2 once stacked) and the output head are cast once;
    the embedding table and the final norm stay f32."""
    cfg = configs.get_config("nemotron-4-15b").reduced(
        compute_dtype="bfloat16")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    p = api.prepare(params, cfg)
    assert api.prepare(p, cfg) is p
    assert p["blocks"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert p["blocks"]["ln1"]["scale"].dtype == torch.bfloat16
    assert p["blocks"]["ln2"]["bias"].dtype == torch.bfloat16
    assert p["lm_head"]["w"].dtype == torch.bfloat16
    assert p["embed"]["table"].dtype == torch.float32
    assert p["final_norm"]["scale"].dtype == torch.float32
    f32 = api.prepare(params, cfg.reduced(compute_dtype="float32"))
    assert f32["blocks"]["attn"]["wq"]["w"] is \
        params.blocks.attn.wq.w


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_consistency(arch):
    """Teacher forcing on the port alone: the decode step at position S
    reproduces the full-forward logits for the same next token."""
    cfg = configs.get_config(arch).reduced(attn_impl="pallas")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    tok = torch.from_numpy(_tokens(cfg))
    nxt = torch.from_numpy(_tokens(cfg, 1, seed=9))
    full = api.forward_logits(params, cfg,
                              {"tokens": torch.cat([tok, nxt], 1)})
    _, caches = api.prefill_step(params, cfg, {"tokens": tok})
    logits, _ = api.decode_step(params, cfg, nxt,
                                api.pad_caches(caches, S + 8), S)
    _close(logits[:, 0], full[:, S], 2e-3, arch)


@pytest.mark.parametrize("arch", DENSE)
def test_generate_tokens_equal_the_reference(arch, ref_interpret):
    cfg, ref_cfg = _cfgs(arch, "pallas", "pallas")
    w = _weights(ref_cfg)
    params = params_from_reference(w, cfg, device="cpu")
    tok = _tokens(cfg)
    got = serve.generate(cfg, params, {"tokens": torch.from_numpy(tok)},
                         max_new_tokens=6, max_len=S + 6 + 8)
    want = ref_serve.generate(ref_cfg, jax.tree_util.tree_map(jnp.asarray, w),
                              {"tokens": jnp.asarray(tok)},
                              max_new_tokens=6, max_len=S + 6 + 8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_matches_teacher_forcing_and_is_deterministic():
    cfg = configs.get_config("mistral-nemo-12b").reduced(attn_impl="pallas")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    tok = torch.from_numpy(_tokens(cfg))[:1]
    out = serve.generate(cfg, params, {"tokens": tok}, max_new_tokens=3,
                         max_len=32)
    assert torch.equal(out, serve.generate(cfg, params, {"tokens": tok},
                                           max_new_tokens=3, max_len=32))
    seq = tok
    for t in range(3):
        logits = api.forward_logits(params, cfg, {"tokens": seq})
        nxt = min(int(torch.argmax(logits[0, -1])), cfg.vocab_size - 1)
        assert nxt == int(out[0, t]), f"step {t}"
        seq = torch.cat([seq, torch.full((1, 1), nxt, dtype=torch.int32)], 1)


def test_sampled_generate_is_seeded_and_in_range():
    cfg = configs.get_config("qwen1.5-4b").reduced()
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(cfg))}
    kw = dict(max_new_tokens=5, max_len=S + 5, temperature=1.0)
    a = serve.generate(cfg, params, batch, seed=3, **kw)
    assert torch.equal(a, serve.generate(cfg, params, batch, seed=3, **kw))
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


# ---------------------------------------------------------------------------
# parameters: init, interop, caches
@pytest.mark.parametrize("arch", DENSE)
def test_init_params_has_the_reference_tree_and_distribution(arch):
    cfg = configs.get_config(arch).reduced()
    ref_tree = _weights(ref_configs.get_config(arch).reduced())
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    mine = params_to_numpy(params)
    flat = dict(jax.tree_util.tree_leaves_with_path(ref_tree))
    mine_flat = dict(jax.tree_util.tree_leaves_with_path(mine))
    assert mine_flat.keys() == flat.keys()
    for key, leaf in flat.items():
        assert mine_flat[key].shape == leaf.shape, key
    assert api.count_params(params) == ref_api.count_params(ref_tree)
    assert abs(float(mine["embed"]["table"].std()) - 0.02) < 2e-3
    w = mine["blocks"]["attn"]["wq"]["w"]
    assert np.abs(w).max() <= 2 * cfg.d_model ** -0.5 + 1e-6
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 0.88) < 0.05
    assert (mine["blocks"]["ln1"]["scale"] == 1).all()
    if cfg.qkv_bias:
        assert (mine["blocks"]["attn"]["wq"]["b"] == 0).all()
    if cfg.norm == "layernorm":
        assert (mine["final_norm"]["bias"] == 0).all()
    again = params_to_numpy(api.init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    np.testing.assert_array_equal(again["blocks"]["ffn"]["down"]["w"],
                                  mine["blocks"]["ffn"]["down"]["w"])


def test_block_and_attention_inits_have_the_reference_shapes():
    from repro.models import attention as ref_attention
    from repro.models import transformer as ref_transformer
    from repro_torch.models import attention
    cfg = configs.get_config("qwen1.5-4b").reduced()
    ref_cfg = ref_configs.get_config("qwen1.5-4b").reduced()
    gen = torch.Generator().manual_seed(0)
    pairs = [
        (attention.init_attention(gen, cfg, device="cpu"),
         ref_attention.init_attention(jax.random.PRNGKey(0), ref_cfg)),
        (transformer.init_block(gen, cfg, layers=3, device="cpu"),
         jax.vmap(lambda k: ref_transformer.init_block(
             k, ref_cfg, moe_layer=False))(jax.random.split(
                 jax.random.PRNGKey(0), 3))),
    ]
    for module, ref_tree in pairs:
        got = {jax.tree_util.keystr(k): v.shape for k, v in
               jax.tree_util.tree_leaves_with_path(
                   _numpy_tree(module))}
        want = {jax.tree_util.keystr(k): v.shape for k, v in
                jax.tree_util.tree_leaves_with_path(ref_tree)}
        assert got == want
    # a MoE layer (ported since): the block takes the MoE FFN in place of
    # the FFN, as the reference's does
    moe_cfg = configs.get_config("granite-moe-1b-a400m").reduced()
    block = transformer.init_block(gen, moe_cfg, moe_layer=True,
                                   device="cpu")
    ref_block = ref_transformer.init_block(
        jax.random.PRNGKey(0),
        ref_configs.get_config("granite-moe-1b-a400m").reduced(),
        moe_layer=True)
    assert not hasattr(block, "ffn")
    assert jax.tree_util.tree_map(np.shape, _numpy_tree(block)) == \
        jax.tree_util.tree_map(np.shape, ref_block)


def _numpy_tree(module):
    return transformer.tree_map(lambda t: t.numpy(), transformer.tree(module))


def test_params_round_trip_and_refusals():
    cfg = configs.get_config("command-r-35b").reduced()
    w = _weights(ref_configs.get_config("command-r-35b").reduced())
    back = params_to_numpy(params_from_reference(w, cfg, device="cpu"))
    for (ka, a), (kb, b) in zip(jax.tree_util.tree_leaves_with_path(w),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert ka == kb
        np.testing.assert_array_equal(a, b)
    assert "lm_head" not in back                     # tied embeddings
    missing = {k: v for k, v in w.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing.*final_norm"):
        params_from_reference(missing, cfg, device="cpu")
    with pytest.raises(ValueError, match="extra.*lm_head"):
        params_from_reference({**w, "lm_head": {"w": np.zeros((1, 1))}},
                              cfg, device="cpu")
    bad = {**w, "embed": {"table": w["embed"]["table"][:-1]}}
    with pytest.raises(ValueError, match="embed.table: shape"):
        params_from_reference(bad, cfg, device="cpu")


def test_caches_match_reference():
    cfg = configs.get_config("mistral-nemo-12b").reduced()
    ref_cfg = ref_configs.get_config("mistral-nemo-12b").reduced()
    got = api.init_cache(cfg, 2, 24, device="cpu")
    want = ref_api.init_cache(ref_cfg, 2, 24)
    rng = np.random.default_rng(24)
    for name in ("k", "v"):
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
    k = _rand(rng, 4, 2, 2, 10, 32)
    padded = api.pad_caches({"k": torch.from_numpy(k),
                             "enc_out": torch.zeros(1)}, 16)
    ref_padded = ref_api.pad_caches({"k": jnp.asarray(k)}, 16)
    _close(padded["k"], ref_padded["k"], 0, "pad")
    assert padded["enc_out"].shape == (1,)
    assert api.pad_caches({"k": torch.from_numpy(k)}, 8)["k"].shape[-2] == 10


def test_decode_writes_the_cache_in_place_clamped():
    """The cache write clamps its position into range, as the reference's
    ``dynamic_update_slice`` clamps its start."""
    cfg, ref_cfg = _cfgs("qwen1.5-4b", "chunked", "chunked")
    w = _weights(ref_cfg)
    params = params_from_reference(w, cfg, device="cpu")
    tok = _tokens(cfg)
    _, caches = api.prefill_step(params, cfg,
                                 {"tokens": torch.from_numpy(tok)})
    _, ref_caches = ref_api.prefill_step(
        jax.tree_util.tree_map(jnp.asarray, w), ref_cfg,
        {"tokens": jnp.asarray(tok)})
    nxt = _tokens(cfg, 1, seed=9)
    k_before = caches["k"]
    logits, out = api.decode_step(params, cfg, torch.from_numpy(nxt), caches,
                                  S + 5)
    ref_logits, ref_out = ref_api.decode_step(
        jax.tree_util.tree_map(jnp.asarray, w), ref_cfg, jnp.asarray(nxt),
        ref_caches, jnp.int32(S + 5))
    assert out["k"] is k_before
    _close(out["k"], ref_out["k"], 1e-4, "clamped write")
    _close(logits, ref_logits, 1e-4, "clamped decode")


def test_cpu_model_path_runs_the_plain_kernel_without_counting():
    cfg = configs.get_config("mistral-nemo-12b").reduced(attn_impl="pallas")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    before = fa_kernel.flash_attention.launches
    out = serve.generate(cfg, params, {"tokens": torch.from_numpy(
        _tokens(cfg))}, max_new_tokens=2, max_len=S + 4)
    assert tuple(out.shape) == (B, 2)
    assert fa_kernel.flash_attention.launches == before


def test_serve_main_runs_on_the_cpu(capsys):
    serve.main(["--arch", "qwen1.5-4b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--max-new-tokens",
                "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens" in out and "on cpu" in out
