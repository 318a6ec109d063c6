"""repro_torch's MoE family (``models/moe.py``, ``models/mla.py``, the
MoE segments of ``models/transformer.py``) against the JAX package's, on
the CPU.

Both packages run the same weights (the reference's init, carried across
as numpy arrays, through ``interop.params_from_reference`` for whole
models) on the same numpy-drawn inputs.  Tolerances, each with its
reason:

* the MoE FFN: 2e-5 (``tests/test_models.py``'s, f32 products summed in
  other orders); at ``moe_capacity_factor=0.3`` the same choices are
  dropped (the dispatch's slots and keep mask are equal) and the output
  is within the same 2e-5;
* MLA and the whole models in f32: 1e-4; in bf16 compute 5e-2 (the two
  frameworks round bf16 products at other places); teacher forcing
  2e-3 (``tests/test_models.py``'s MLA tolerance);
* ``moe_ffn_ep`` under a mesh: the port on 1, 2 and 4 logical CPU
  devices (EP over 1, 2 and 2 of 4; and an EP axis of size 1 under 2
  data shards) against the reference on as many forced host devices
  (one subprocess per count, this file run as a script), outputs within
  2e-5 and gradients within 1e-5 + 1e-4 * max|g| of the leaf (the
  training tests' rule).

The reference's Pallas flash kernel runs in interpret mode, as in
``tests/test_torch_models.py``.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


@dataclasses.dataclass(frozen=True)
class MoeCfg:
    """The reference tests' MoE config (``tests/test_models.py``)."""
    d_model: int = 64
    n_experts: int = 8
    top_k: int = 2
    d_expert: int = 32
    n_shared_experts: int = 0
    moe_renorm: bool = True
    moe_capacity_factor: float = 8.0
    moe_impl: str = "ep"


#: the meshes over ("data", "model"), on 1, 2 and 4 devices: EP over
#: all of them, and over 2 of 4 with 2 data shards; "2dp" has an EP axis
#: of size 1 (each data shard routes its own tokens, its own capacity)
MESHES = {"1": (1, 1), "2": (1, 2), "2dp": (2, 1), "4": (2, 2)}
#: the EP cases: (x shape, capacity factor); drop-free, dropping, and a
#: decode-shaped input whose sequence does not split over EP
EP_CASES = {"dropfree": ((4, 16, 64), 8.0), "drops": ((4, 16, 64), 0.3),
            "decode": ((4, 1, 64), 8.0)}
EP_CFG = MoeCfg(n_shared_experts=2)


def _ep_inputs(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def reference_ep(ndev: int, path: str) -> None:
    """The reference's ``moe_ffn_ep`` on ``ndev`` forced host devices, on
    each mesh of that many: each case's output and gradients of
    sum(out ** 2), and the weights, saved to ``path``."""
    import jax
    import jax.numpy as jnp
    from repro import dist
    from repro.models import moe

    p = moe.init_moe(jax.random.PRNGKey(0), EP_CFG)
    out = {f"w/{k}": np.asarray(v) for k, v in _flat(p).items()}
    for mesh_name, shape in MESHES.items():
        if np.prod(shape) != ndev:
            continue
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        for name, (x_shape, cf) in EP_CASES.items():
            x = jnp.asarray(_ep_inputs(x_shape))
            cfg = dataclasses.replace(EP_CFG, moe_capacity_factor=cf)

            def loss(pp):
                with dist.use_mesh(mesh):
                    y = moe.moe_ffn_ep(pp, x, cfg)
                return (y ** 2).sum(), y

            (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(p)
            key = f"{mesh_name}/{name}"
            out[f"{key}/out"] = np.asarray(y)
            out.update({f"{key}/grad/{k}": np.asarray(v)
                        for k, v in _flat(g).items()})
    np.savez(path, **out)


def _flat(t, prefix=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# Run as a script, this file computes the reference's EP results instead
# (``python tests/test_torch_moe.py N out.npz``, with
# XLA_FLAGS=--xla_force_host_platform_device_count=N set).
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    import repro  # noqa: F401  (installs the jax compatibility shims)
    reference_ep(int(sys.argv[1]), sys.argv[2])
    sys.exit(0)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.kernels.flash_attention import kernel as ref_fa_kernel  # noqa
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro.models import mla as ref_mla  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro_torch import configs, dist  # noqa: E402
from repro_torch.interop import (params_from_reference,  # noqa: E402
                                 params_to_numpy)
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api, mla, moe, transformer  # noqa: E402
from test_torch_moe_routes import RouteReplay  # noqa: E402

MOE_ARCHS = ["deepseek-v2-lite-16b", "granite-moe-1b-a400m"]
B, S = 2, 16


@pytest.fixture
def ref_interpret(monkeypatch):
    """The reference's Pallas flash kernel, always in interpret mode."""
    inner = ref_fa_kernel.flash_attention_pallas

    def forced(*args, **kw):
        return inner(*args, **{**kw, "interpret": True})

    monkeypatch.setattr(ref_fa_kernel, "flash_attention_pallas", forced)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _to_torch(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))
    return t.to(dtype) if dtype is not None else t


def _moe_weights(cfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, ref_moe.init_moe(jax.random.PRNGKey(seed), cfg))


def _rand(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# the MoE FFN
def test_moe_init_has_the_reference_tree_and_distribution():
    cfg = MoeCfg(n_shared_experts=2)
    mine = transformer.tree_map(
        lambda t: t.numpy(),
        transformer.tree(moe.init_moe(torch.Generator().manual_seed(0), cfg,
                                      device="cpu")))
    want = _moe_weights(cfg)
    assert jax.tree_util.tree_map(np.shape, mine) == \
        jax.tree_util.tree_map(np.shape, want)
    for name, fan_in in (("gate", 64), ("up", 64), ("down", 32)):
        w = mine[name]
        assert np.abs(w).max() <= 2 * fan_in ** -0.5 + 1e-6, name
        assert abs(float(w.std()) * fan_in ** 0.5 - 0.88) < 0.05, name
    # stacked on a layer axis like Linear
    stacked = moe.MoE(cfg, layers=3, device="cpu")
    assert tuple(stacked.gate.shape) == (3, 8, 64, 32)
    assert tuple(stacked.router.w.shape) == (3, 64, 8)
    assert tuple(stacked.shared.down.w.shape) == (3, 64, 64)


@pytest.mark.parametrize("case", ["dropfree", "shared", "drops",
                                  "drops_shared"])
def test_moe_ffn_matches_reference(case):
    cfg = MoeCfg(n_shared_experts=2 if "shared" in case else 0,
                 moe_capacity_factor=0.3 if "drops" in case else 8.0)
    w = _moe_weights(cfg)
    x = _rand((2, 64, 64))
    tp, jp = _to_torch(w), jax.tree_util.tree_map(jnp.asarray, w)
    got = moe.moe_ffn_ep(tp, torch.from_numpy(x), cfg)
    want = ref_moe.moe_ffn_ep(jp, jnp.asarray(x), cfg)
    _close(got, want, 2e-5, "moe_ffn_ep")
    ref_got = moe.moe_ffn_ref(tp, torch.from_numpy(x), cfg)
    _close(ref_got, ref_moe.moe_ffn_ref(jp, jnp.asarray(x), cfg), 2e-5,
           "moe_ffn_ref")
    gap = float(np.abs(_np(got) - _np(ref_got)).max())
    if "drops" in case:
        assert gap > 1e-3               # choices were dropped
    else:
        assert gap < 2e-5               # drop-free: the exact reference
    assert torch.isfinite(got).all()
    assert moe.moe_ffn(tp, torch.from_numpy(x), cfg).equal(got)
    _close(moe.moe_ffn(tp, torch.from_numpy(x),
                       dataclasses.replace(cfg, moe_impl="ref")),
           ref_got, 0)


@pytest.mark.parametrize("cf", [8.0, 0.3])
def test_dispatch_drops_the_reference_choices(cf):
    """The counting sort puts every choice in the reference's slot and
    drops the same ones (those past the capacity in flat order)."""
    cfg = MoeCfg(moe_capacity_factor=cf)
    w = _moe_weights(cfg)
    xt = _rand((128, 64))
    tp, jp = _to_torch(w), jax.tree_util.tree_map(jnp.asarray, w)
    topv, topi, _ = moe._router(tp, torch.from_numpy(xt), cfg)
    rtopv, rtopi, _ = ref_moe._router(jp, jnp.asarray(xt), cfg)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(rtopi))
    _close(topv, rtopv, 1e-6)
    cap = moe._capacity(cf, 128, cfg)
    assert cap == max(1, int(np.ceil(cf * 128 * 2 / 8)))
    buf, slot, keep = moe._dispatch_local(torch.from_numpy(xt), topi, 8, cap,
                                          torch.float32)
    rbuf, rslot, rkeep = ref_moe._dispatch_local(
        jnp.asarray(xt), rtopv, rtopi, 8, cap, jnp.float32)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(rslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rkeep))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(rbuf))
    assert bool(keep.all()) == (cf == 8.0)
    ye = _rand((8 * cap, 64), seed=3)
    _close(moe._unscatter_local(torch.from_numpy(ye), slot, keep, topv, 128,
                                2, torch.float32),
           ref_moe._unscatter_local(jnp.asarray(ye), rslot, rkeep, rtopv,
                                    128, 2, jnp.float32), 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("router", ["zero", "equal_columns"])
def test_router_breaks_ties_as_the_reference(router, dtype):
    """Tied gates: the k largest with the lower expert first, as
    ``lax.top_k`` picks them."""
    cfg = MoeCfg(top_k=3)
    w = _moe_weights(cfg)
    rw = w["router"]["w"].copy()
    if router == "zero":
        rw[:] = 0.0                      # every gate ties
    else:
        rw[:, [1, 4, 6]] = rw[:, [6, 6, 6]]  # three experts tie everywhere
    w = {**w, "router": {"w": rw}}
    xt = _rand((32, 64))
    got = moe._router(_to_torch(w, getattr(torch, dtype)),
                      torch.from_numpy(xt).to(getattr(torch, dtype)), cfg)
    want = ref_moe._router(
        jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), w),
        jnp.asarray(xt, dtype), cfg)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[0], want[0], 1e-6)
    if router == "zero":
        assert (got[1].numpy() == [0, 1, 2]).all()


def test_load_balance_loss_matches_reference():
    cfg = MoeCfg()
    w = _moe_weights(cfg)
    x = _rand((4, 64, 64))
    _close(moe.load_balance_loss(_to_torch(w), torch.from_numpy(x), cfg),
           ref_moe.load_balance_loss(jax.tree_util.tree_map(jnp.asarray, w),
                                     jnp.asarray(x), cfg), 1e-6)
    # router weights 0 -> uniform gates -> the loss is 1
    flat = {**w, "router": {"w": np.zeros_like(w["router"]["w"])}}
    ll = moe.load_balance_loss(_to_torch(flat), torch.from_numpy(x), cfg)
    assert 0.9 < float(ll) < 1.1


# ---------------------------------------------------------------------------
# MLA
def _mla_setup():
    cfg = configs.get_config("deepseek-v2-lite-16b").reduced()
    ref_cfg = ref_configs.get_config("deepseek-v2-lite-16b").reduced()
    w = jax.tree_util.tree_map(
        np.asarray, ref_mla.init_mla(jax.random.PRNGKey(0), ref_cfg))
    x = 0.5 * _rand((2, 9, cfg.d_model))
    pos = np.tile(np.arange(9, dtype=np.int32)[None], (2, 1))
    return cfg, ref_cfg, w, x, pos


def test_mla_init_has_the_reference_tree():
    cfg, _, w, _, _ = _mla_setup()
    mine = transformer.tree_map(lambda t: t.numpy(), transformer.tree(
        mla.init_mla(torch.Generator().manual_seed(0), cfg, device="cpu")))
    assert jax.tree_util.tree_map(np.shape, mine) == \
        jax.tree_util.tree_map(np.shape, w)
    assert (mine["kv_norm"]["scale"] == 1).all()


def test_mla_train_prefill_decode_match_reference():
    cfg, ref_cfg, w, x, pos = _mla_setup()
    tp, jp = _to_torch(w), jax.tree_util.tree_map(jnp.asarray, w)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    tpos, jpos = torch.from_numpy(pos), jnp.asarray(pos)
    full = mla.mla_train(tp, tx, cfg, tpos)
    _close(full, ref_mla.mla_train(jp, jx, ref_cfg, jpos), 1e-4, "train")
    out, cache = mla.mla_prefill(tp, tx[:, :8], cfg, tpos[:, :8])
    rout, rcache = ref_mla.mla_prefill(jp, jx[:, :8], ref_cfg, jpos[:, :8])
    _close(out, rout, 1e-4, "prefill")
    assert tuple(cache["c_kv"].shape) == (2, 8, cfg.kv_lora_rank)
    assert tuple(cache["k_rope"].shape) == (2, 8, cfg.rope_head_dim)
    for name in ("c_kv", "k_rope"):
        _close(cache[name], rcache[name], 1e-4, name)
    cache = {k: torch.cat([v, v.new_zeros(2, 1, v.shape[-1])], 1)
             for k, v in cache.items()}
    rcache = {k: jnp.pad(v, ((0, 0), (0, 1), (0, 0)))
              for k, v in rcache.items()}
    dec, new = mla.mla_decode(tp, tx[:, 8:9], cfg, cache, 8)
    rdec, rnew = ref_mla.mla_decode(jp, jx[:, 8:9], ref_cfg, rcache,
                                    jnp.int32(8))
    _close(dec, rdec, 1e-4, "decode")
    assert new["c_kv"] is cache["c_kv"]            # written in place
    for name in ("c_kv", "k_rope"):
        _close(new[name], rnew[name], 1e-4, "decoded " + name)
    # the absorbed decode equals materializing K/V (the reference's test)
    _close(dec[:, 0], full[:, 8], 2e-3, "absorbed vs materialized")


def test_mla_decode_clamps_its_cache_write():
    """A position past the cache writes its last row, as
    ``dynamic_update_slice_in_dim`` clamps its start."""
    cfg, ref_cfg, w, x, pos = _mla_setup()
    tp, jp = _to_torch(w), jax.tree_util.tree_map(jnp.asarray, w)
    _, cache = mla.mla_prefill(tp, torch.from_numpy(x[:, :8]), cfg,
                               torch.from_numpy(pos[:, :8]))
    _, rcache = ref_mla.mla_prefill(jp, jnp.asarray(x[:, :8]), ref_cfg,
                                    jnp.asarray(pos[:, :8]))
    dec, new = mla.mla_decode(tp, torch.from_numpy(x[:, 8:9]), cfg, cache, 11)
    rdec, rnew = ref_mla.mla_decode(jp, jnp.asarray(x[:, 8:9]), ref_cfg,
                                    rcache, jnp.int32(11))
    _close(dec, rdec, 1e-4, "clamped decode")
    for name in ("c_kv", "k_rope"):
        _close(new[name], rnew[name], 1e-4, name)


# ---------------------------------------------------------------------------
# moe_ffn_ep under a mesh: 1, 2 and 4 logical devices against the
# reference on as many forced host devices
_REF_EP: dict[int, dict] = {}


def _reference_ep(ndev: int, tmp_dir) -> dict:
    """The reference's EP results on ``ndev`` forced host devices; the
    first call starts the three subprocesses (1, 2 and 4 devices)
    together and waits for all."""
    if not _REF_EP:
        procs = {}
        for n in sorted({int(np.prod(m)) for m in MESHES.values()}):
            env = dict(os.environ, JAX_PLATFORMS="cpu",
                       XLA_FLAGS="--xla_force_host_platform_device_count="
                                 f"{n}")
            env["PYTHONPATH"] = os.pathsep.join(
                [str(ROOT / "src"), str(ROOT), env.get("PYTHONPATH", "")])
            path = pathlib.Path(tmp_dir) / f"ref_ep_{n}.npz"
            procs[n] = (path, subprocess.Popen(
                [sys.executable, __file__, str(n), str(path)], cwd=ROOT,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        for n, (path, proc) in procs.items():
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-3000:]
            with np.load(path) as z:
                _REF_EP[n] = dict(z)
    return _REF_EP[ndev]


def _port_mesh(shape):
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = dist.logical_devices(devs.size, "cpu")
    return dist.Mesh(devs.reshape(shape), ("data", "model"))


@pytest.mark.parametrize("case", sorted(EP_CASES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_ffn_ep_on_logical_devices_matches_reference(mesh, case,
                                                        tmp_path_factory):
    mesh_shape = MESHES[mesh]
    ndev = int(np.prod(mesh_shape))
    ref = _reference_ep(ndev, tmp_path_factory.mktemp("ref_ep"))
    shape, cf = EP_CASES[case]
    cfg = dataclasses.replace(EP_CFG, moe_capacity_factor=cf)
    weights = {k[2:]: v for k, v in ref.items() if k.startswith("w/")}
    p = {}
    for name, v in weights.items():
        *path, leaf = name.split(".")
        node = p
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = torch.from_numpy(v).requires_grad_(True)
    x = torch.from_numpy(_ep_inputs(shape))
    moe.moe_ffn_ep.exchanged_bytes = 0
    with dist.use_mesh(_port_mesh(mesh_shape)):
        y = moe.moe_ffn_ep(p, x, cfg)
    _close(y, ref[f"{mesh}/{case}/out"], 2e-5, f"mesh {mesh_shape}, {case}")
    (y ** 2).sum().backward()
    leaves = _flat(p)
    for name in weights:
        g = leaves[name].grad.numpy()
        want = ref[f"{mesh}/{case}/grad/{name}"]
        assert np.abs(g).sum() > 0, name              # gradients flow
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(want).max(),
                                   err_msg=name)
    # the exchange moved every chunk that changes device, both ways
    n_dp, n_ep = mesh_shape
    if n_ep == 1:
        assert moe.moe_ffn_ep.exchanged_bytes == 0
    else:
        groups = n_dp
        b_l = shape[0] // n_dp
        s_l = shape[1] // n_ep if shape[1] % n_ep == 0 else shape[1]
        cap = moe._capacity(cf, b_l * s_l, cfg)
        chunk = (cfg.n_experts // n_ep) * cap * cfg.d_model * 4
        assert moe.moe_ffn_ep.exchanged_bytes == \
            2 * groups * n_ep * (n_ep - 1) * chunk


def test_moe_ffn_ep_without_a_mesh_is_the_local_path():
    cfg = EP_CFG
    w = _moe_weights(cfg)
    x = torch.from_numpy(_ep_inputs((4, 16, 64)))
    tp = _to_torch(w)
    got = moe.moe_ffn_ep(tp, x, cfg)
    assert got.equal(moe._moe_local(tp, x, cfg, cfg.moe_capacity_factor))
    with dist.use_mesh(_port_mesh((1, 1))):
        one = moe.moe_ffn_ep(tp, x, cfg)
    _close(one, got, 1e-6, "one device")
    with pytest.raises(ValueError, match="do not split"):
        with dist.use_mesh(dist.Mesh(np.array(
                dist.logical_devices(3, "cpu"), dtype=object)
                .reshape(1, 3), ("data", "model"))):
            moe.moe_ffn_ep(tp, x, cfg)


# ---------------------------------------------------------------------------
# the two MoE architectures end to end, weights carried across
def _cfgs(arch, **kw):
    return (configs.get_config(arch).reduced(**kw),
            ref_configs.get_config(arch).reduced(**kw))


def _weights(ref_cfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, ref_api.init_params(jax.random.PRNGKey(seed), ref_cfg))


def _tokens(cfg, n=S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def _cache_leaves(caches):
    return {f"{seg}.{name}": leaf for seg, tree in caches.items()
            for name, leaf in tree.items()}


def shared_routes(monkeypatch, exact: bool) -> RouteReplay:
    """The reference's expert choices replayed in the port
    (``tests/test_torch_moe_routes.py``): the reference's ``_router`` records its
    ids and gates through an ordered ``jax.debug.callback``, the port's
    takes them in call order."""
    routes = RouteReplay(exact)
    ref_inner = ref_moe._router

    def ref_spy(p, xt, cfg):
        out = ref_inner(p, xt, cfg)
        jax.debug.callback(routes.record, out[1], out[2], ordered=True)
        return out

    monkeypatch.setattr(ref_moe, "_router", ref_spy)
    monkeypatch.setattr(moe, "_router", routes.replaying(moe._router))
    return routes


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
@pytest.mark.parametrize("arch,impl", [("deepseek-v2-lite-16b", "chunked"),
                                       ("granite-moe-1b-a400m", "chunked"),
                                       ("granite-moe-1b-a400m", "pallas")])
def test_forward_prefill_decode_match_reference(arch, impl, dtype, tol,
                                                ref_interpret, monkeypatch):
    cfg, ref_cfg = _cfgs(arch, attn_impl=impl, compute_dtype=dtype)
    w = _weights(ref_cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, w)
    params = params_from_reference(w, cfg, device="cpu")
    routes = shared_routes(monkeypatch, exact=dtype == "float32")
    tok = _tokens(cfg)
    what = f"{arch} {impl} {dtype}"
    want = ref_api.forward_logits(jp, ref_cfg, {"tokens": jnp.asarray(tok)})
    got = api.forward_logits(params, cfg, {"tokens": torch.from_numpy(tok)})
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, tol, what + ": forward_logits")

    ref_logits, ref_caches = ref_api.prefill_step(
        jp, ref_cfg, {"tokens": jnp.asarray(tok)})
    logits, caches = api.prefill_step(params, cfg,
                                      {"tokens": torch.from_numpy(tok)})
    _close(logits, ref_logits, tol, what + ": prefill logits")
    mine, want = _cache_leaves(caches), _cache_leaves(ref_caches)
    assert mine.keys() == want.keys()
    for name, leaf in want.items():
        assert tuple(mine[name].shape) == leaf.shape, name
        _close(mine[name], leaf, tol, what + f": cache {name}")

    nxt = _tokens(cfg, 1, seed=9)
    ref_logits, ref_caches = ref_api.decode_step(
        jp, ref_cfg, jnp.asarray(nxt), ref_api.pad_caches(ref_caches, S + 8),
        jnp.int32(S))
    logits, caches = api.decode_step(params, cfg, torch.from_numpy(nxt),
                                     api.pad_caches(caches, S + 8), S)
    _close(logits, ref_logits, tol, what + ": decode logits")
    for name, leaf in _cache_leaves(ref_caches).items():
        _close(_cache_leaves(caches)[name], leaf, tol,
               what + f": decoded cache {name}")
    routes.done()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_decode_consistency(arch):
    """Teacher forcing on the port alone (drop-free at ``reduced()``):
    the decode step at position S reproduces the full forward."""
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


@pytest.mark.parametrize("arch,impl", [("deepseek-v2-lite-16b", "chunked"),
                                       ("granite-moe-1b-a400m", "pallas")])
def test_generate_tokens_equal_the_reference(arch, impl, ref_interpret):
    cfg, ref_cfg = _cfgs(arch, attn_impl=impl)
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


def test_granite_prefill_runs_the_flash_kernel_path_once_a_layer(
        monkeypatch):
    """``attn_impl="pallas"``: prefill calls the flash kernel's wrapper
    once per layer (its plain version here, on CPU tensors, which counts
    no launch); decode does not call it."""
    cfg = configs.get_config("granite-moe-1b-a400m").reduced(
        attn_impl="pallas")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    calls = []
    inner = fa_kernel.flash_attention

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return inner(*args, **kw)

    monkeypatch.setattr(fa_kernel, "flash_attention", counted)
    before = inner.launches
    out = serve.generate(cfg, params, {"tokens": torch.from_numpy(
        _tokens(cfg))}, max_new_tokens=3, max_len=S + 8)
    assert tuple(out.shape) == (B, 3)
    assert len(calls) == cfg.n_layers
    assert inner.launches == before


# ---------------------------------------------------------------------------
# parameters and caches
@pytest.mark.parametrize("arch", MOE_ARCHS)
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
    e = mine["moe_blocks"]["moe"]
    for name, fan_in in (("gate", cfg.d_model), ("down", cfg.d_expert)):
        assert np.abs(e[name]).max() <= 2 * fan_in ** -0.5 + 1e-6
        assert abs(float(e[name].std()) * fan_in ** 0.5 - 0.88) < 0.05
    assert ("shared" in e) == bool(cfg.n_shared_experts)
    assert ("dense_blocks" in mine) == bool(cfg.first_dense)
    if cfg.first_dense:
        assert mine["dense_blocks"]["ffn"]["up"]["w"].shape == \
            (cfg.first_dense, cfg.d_model, cfg.first_dense_ff)
    assert ("lm_head" in mine) != cfg.tie_embeddings


def test_block_inits_have_the_reference_shapes():
    """``init_block`` with MLA, with a MoE layer, and with a dense FFN of
    another width."""
    cfg = configs.get_config("deepseek-v2-lite-16b").reduced()
    ref_cfg = ref_configs.get_config("deepseek-v2-lite-16b").reduced()
    gen = torch.Generator().manual_seed(0)
    for kw in (dict(moe_layer=True), dict(moe_layer=False, d_ff=96)):
        module = transformer.init_block(gen, cfg, layers=2, device="cpu",
                                        **kw)
        ref_tree = jax.vmap(lambda k: ref_transformer.init_block(
            k, ref_cfg, **kw))(jax.random.split(jax.random.PRNGKey(0), 2))
        got = {jax.tree_util.keystr(k): v.shape for k, v in
               jax.tree_util.tree_leaves_with_path(transformer.tree_map(
                   lambda t: t.numpy(), transformer.tree(module)))}
        want = {jax.tree_util.keystr(k): v.shape for k, v in
                jax.tree_util.tree_leaves_with_path(ref_tree)}
        assert got == want, kw


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_cache_matches_reference(arch):
    cfg, ref_cfg = _cfgs(arch, compute_dtype="bfloat16")
    got = _cache_leaves(api.init_cache(cfg, 2, 24, device="cpu"))
    want = _cache_leaves(ref_api.init_cache(ref_cfg, 2, 24))
    assert got.keys() == want.keys()
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(leaf.dtype)
        assert not got[name].any()
    if arch.startswith("deepseek"):
        assert set(got) == {"dense.c_kv", "dense.k_rope", "moe.c_kv",
                            "moe.k_rope"}


def test_granite_without_dense_layers_has_moe_caches_only():
    cfg = configs.get_config("granite-moe-1b-a400m").reduced()
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    _, caches = api.prefill_step(params, cfg, {"tokens": torch.from_numpy(
        _tokens(cfg))})
    assert set(caches) == {"moe"} and set(caches["moe"]) == {"k", "v"}


def test_pad_caches_grows_the_latent_leaves():
    rng = np.random.default_rng(24)
    caches = {"dense": {"c_kv": rng.standard_normal((1, 2, 10, 32)),
                        "k_rope": rng.standard_normal((1, 2, 10, 16))},
              "moe": {"c_kv": rng.standard_normal((3, 2, 10, 32)),
                      "k_rope": rng.standard_normal((3, 2, 10, 16))}}
    got = _cache_leaves(api.pad_caches(_to_torch(caches), 16))
    want = _cache_leaves(ref_api.pad_caches(
        jax.tree_util.tree_map(jnp.asarray, caches), 16))
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape
        _close(got[name], leaf, 0, name)


def test_prepare_casts_every_stacked_segment():
    cfg = configs.get_config("deepseek-v2-lite-16b").reduced(
        compute_dtype="bfloat16")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    p = api.prepare(params, cfg)
    for seg in ("dense_blocks", "moe_blocks"):
        assert p[seg]["attn"]["wkv_a"]["w"].dtype == torch.bfloat16
        assert p[seg]["attn"]["kv_norm"]["scale"].dtype == torch.bfloat16
    assert p["moe_blocks"]["moe"]["router"]["w"].dtype == torch.bfloat16
    assert p["moe_blocks"]["moe"]["gate"].dtype == torch.bfloat16
    assert p["moe_blocks"]["moe"]["shared"]["down"]["w"].dtype == \
        torch.bfloat16
    assert p["embed"]["table"].dtype == torch.float32


def test_params_from_reference_refuses_a_tree_that_does_not_match():
    cfg, ref_cfg = _cfgs("deepseek-v2-lite-16b")
    w = _weights(ref_cfg)
    back = params_to_numpy(params_from_reference(w, cfg, device="cpu"))
    for (ka, a), (kb, b) in zip(jax.tree_util.tree_leaves_with_path(w),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert ka == kb
        np.testing.assert_array_equal(a, b)
    no_shared = {**w, "moe_blocks": {**w["moe_blocks"], "moe": {
        k: v for k, v in w["moe_blocks"]["moe"].items() if k != "shared"}}}
    with pytest.raises(ValueError, match="missing.*moe_blocks.moe.shared"):
        params_from_reference(no_shared, cfg, device="cpu")
    with pytest.raises(ValueError, match="extra.*blocks"):
        params_from_reference({**w, "blocks": w["moe_blocks"]}, cfg,
                              device="cpu")
    gate = w["moe_blocks"]["moe"]["gate"]
    bad = {**w, "moe_blocks": {**w["moe_blocks"], "moe": {
        **w["moe_blocks"]["moe"], "gate": gate[:, :-1]}}}
    with pytest.raises(ValueError, match="moe_blocks.moe.gate: shape"):
        params_from_reference(bad, cfg, device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_main_runs_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "8", "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) tokens" in out and "on cpu" in out
