"""repro_torch's model under a mesh against the JAX package's, on the CPU:
the sharding hooks, placed leaves, sequence-parallel decode, the sLSTM
batch-shard branch and restore onto a mesh.

The port runs on meshes of 4 logical CPU devices, (data, model) = (1,
4), (2, 2) and (4, 1); the reference on the same meshes of 4 forced host
devices, in one subprocess (this file run as a script) shared by every
case.  Exact checks:

* the specs ``constrain_seq``/``constrain_heads`` impose on every call of
  a Granite and a DeepSeek-V2-Lite forward at ``reduced()``, and the EP
  pin of the stacked experts, in order (the reference's captured by
  wrapping ``jax.lax.with_sharding_constraint`` while its forward is
  traced: its ``lax.scan`` traces a segment's body once, where the port
  runs it once a layer);
* every placed leaf's per-device index under ``fsdp``, ``tp`` and
  ``replicated`` and under ``cache_shardings``, against the reference's
  ``addressable_shards``, each chunk the full leaf's slice in storage of
  its own;
* a reference checkpoint restored with ``shardings=`` onto each mesh:
  the values bit for bit, the indices the reference's.

Within a tolerance (f32): ``_decode_sp`` alone at ``pos`` on a stripe
boundary, at S - 1 and at S (no stripe writes), output and cache within
1e-5 (the log-sum-exp combine sums the stripes in another order than
XLA's ``psum``), the cache never gathered and the combine's bytes the
exchange of (max, sum, output) within each model group; sLSTM's
batch-shard branch with and without ``model_in_batch``, output within
1e-5 and gradients within 1e-5 + 1e-4 * max|g| of each leaf (the
training tests' rule).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

MESHES = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1)}
ARCHS = ("granite-moe-1b-a400m", "deepseek-v2-lite-16b")
POLICIES = ("fsdp", "tp", "replicated")
B, S = 4, 16
#: _decode_sp's positions over a 16-row cache: a stripe boundary (of 4
#: and of 2 stripes), the last row, one past it (no stripe writes)
DECODE_POS = (8, 15, 16)


def _flat(t, prefix=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _canon(spec) -> list:
    """A spec as one list of axis names per dimension."""
    return [[] if e is None else [e] if isinstance(e, str) else list(e)
            for e in spec]


def _norm_index(index, shape) -> list:
    return [list(s.indices(n)[:2]) for s, n in zip(index, shape)]


def _rng(seed):
    return np.random.default_rng(seed)


def _decode_inputs(cfg):
    r = _rng(3)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    f = np.float32
    return (r.standard_normal((B, hq, 1, d)).astype(f),
            r.standard_normal((B, hkv, 1, d)).astype(f),
            r.standard_normal((B, hkv, 1, d)).astype(f),
            r.standard_normal((B, hkv, S, d)).astype(f),
            r.standard_normal((B, hkv, S, d)).astype(f))


def reference(path: str, ckpt_dir: str) -> None:
    """The reference's results on each mesh of 4 forced host devices,
    saved to ``path`` (arrays, and a JSON document under ``doc``); a
    checkpoint of Granite's parameters and AdamW state under
    ``ckpt_dir``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import dist
    from repro.ckpt import restore_checkpoint, save_checkpoint
    from repro.configs import get_config
    from repro.dist import sharding
    from repro.launch.mesh import make_mesh
    from repro.models import api, attention, transformer, xlstm
    from repro.optim import adamw_init

    out, doc = {}, {"specs": {}, "index": {}, "restore": {}}
    log: list = []
    pinning = [False]
    inner = jax.lax.with_sharding_constraint

    def recording(x, sh):
        log.append(["pin" if pinning[0] else "hook", list(x.shape),
                    _canon(sh.spec)])
        return inner(x, sh)

    prep = transformer._prep_stack

    def prep_tagged(*a, **kw):
        pinning[0] = True
        try:
            return prep(*a, **kw)
        finally:
            pinning[0] = False

    jax.lax.with_sharding_constraint = recording
    transformer._prep_stack = prep_tagged

    def indices(mesh, tree, shardings):
        flat_devs = list(mesh.devices.flat)
        got = {}
        for name, leaf in _flat(tree).items():
            arr = jax.device_put(np.asarray(leaf), _flat(shardings)[name])
            got[name] = sorted(
                [flat_devs.index(s.device), _norm_index(s.index, arr.shape)]
                for s in arr.addressable_shards)
        return got

    tokens = jnp.asarray(_rng(1).integers(0, 512, (B, S)), jnp.int32)
    init = jax.jit(api.init_params, static_argnums=1)
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        params = init(jax.random.PRNGKey(0), cfg)
        out.update({f"{arch}/w/{k}": np.asarray(v)
                    for k, v in _flat(params).items()})
        caches = api.init_cache(cfg, B, S)
        for mname, shape in MESHES.items():
            mesh = make_mesh(shape, ("data", "model"))
            with dist.use_mesh(mesh) as ctx:
                log.clear()
                jax.make_jaxpr(lambda p: api.forward_logits(
                    p, cfg, {"tokens": tokens}))(params)
                doc["specs"][f"{arch}/{mname}"] = list(log)
                for pol in POLICIES:
                    doc["index"][f"{arch}/{mname}/{pol}"] = indices(
                        mesh, params, sharding.param_shardings(
                            cfg, params, ctx, policy=pol))
                doc["index"][f"{arch}/{mname}/cache"] = indices(
                    mesh, caches, sharding.cache_shardings(cfg, caches, ctx))

    cfg = get_config(ARCHS[0]).reduced()
    q, kn, vn, kc, vc = map(jnp.asarray, _decode_inputs(cfg))
    decode_sp = jax.jit(attention._decode_sp, static_argnums=(5, 6))
    for mname, shape in MESHES.items():
        mesh = make_mesh(shape, ("data", "model"))
        with dist.use_mesh(mesh) as ctx:
            for pos in DECODE_POS:
                o, c = decode_sp(q, kn, vn, {"k": kc, "v": vc},
                                 jnp.int32(pos), cfg, ctx)
                out[f"sp/{mname}/{pos}/o"] = np.asarray(o)
                out[f"sp/{mname}/{pos}/k"] = np.asarray(c["k"])
                out[f"sp/{mname}/{pos}/v"] = np.asarray(c["v"])

    xcfg = get_config("xlstm-1.3b").reduced()
    p = xlstm.init_slstm(jax.random.PRNGKey(4), xcfg)
    out.update({f"slstm/w/{k}": np.asarray(v) for k, v in _flat(p).items()})
    u = jnp.asarray(_rng(5).standard_normal((B, 8, xcfg.d_model)),
                    jnp.float32)
    for mname, shape in MESHES.items():
        mesh = make_mesh(shape, ("data", "model"))
        for mib in (False, True):
            def loss(pp):
                with dist.use_mesh(mesh, model_in_batch=mib):
                    y = xlstm.slstm_scan(pp, u, xcfg)
                return (y ** 2).sum(), y
            (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(p)
            key = f"slstm/{mname}/{int(mib)}"
            out[f"{key}/out"] = np.asarray(y)
            out.update({f"{key}/grad/{k}": np.asarray(v)
                        for k, v in _flat(g).items()})

    params = init(jax.random.PRNGKey(0), cfg)
    save_checkpoint(ckpt_dir, 1, (params, adamw_init(params)))
    for mname, shape in MESHES.items():
        mesh = make_mesh(shape, ("data", "model"))
        with dist.use_mesh(mesh) as ctx:
            p_sh = sharding.param_shardings(cfg, params, ctx, policy="fsdp")
            sh = (p_sh, type(adamw_init(params))(
                step=NamedSharding(mesh, P()), mu=p_sh, nu=p_sh))
            (rp, _), _, _ = restore_checkpoint(ckpt_dir, 1,
                                               (params, adamw_init(params)),
                                               shardings=sh)
            flat_devs = list(mesh.devices.flat)
            doc["restore"][mname] = {
                name: sorted([flat_devs.index(s.device),
                              _norm_index(s.index, leaf.shape)]
                             for s in leaf.addressable_shards)
                for name, leaf in _flat(rp).items()}
    out["doc"] = np.asarray(json.dumps(doc))
    np.savez(path, **out)


# Run as a script, this file computes the reference's results instead
# (``python tests/test_torch_mesh.py out.npz ckpt_dir``, with
# XLA_FLAGS=--xla_force_host_platform_device_count=4 set).
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    import repro  # noqa: F401  (installs the jax compatibility shims)
    reference(sys.argv[1], sys.argv[2])
    sys.exit(0)

import torch  # noqa: E402

from repro_torch import dist  # noqa: E402
from repro_torch.ckpt import restore_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import api, attention, xlstm  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

_REF: dict = {}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results (one subprocess for the whole file)."""
    if not _REF:
        tmp = tmp_path_factory.mktemp("ref_mesh")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT / "src"), str(ROOT), env.get("PYTHONPATH", "")])
        proc = subprocess.run(
            [sys.executable, __file__, str(tmp / "ref.npz"),
             str(tmp / "ckpt")], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with np.load(tmp / "ref.npz") as z:
            _REF.update({k: z[k] for k in z.files})
        _REF["doc"] = json.loads(str(_REF["doc"]))
        _REF["ckpt"] = str(tmp / "ckpt")
    return _REF


def _mesh(name):
    return make_mesh(MESHES[name], ("data", "model"),
                     dist.logical_devices(4, "cpu"))


def _weights(ref, prefix):
    tree: dict = {}
    for key, v in ref.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split(".")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = v
    return tree


def _decoder(ref, arch):
    return params_from_reference(_weights(ref, f"{arch}/w/"),
                                 get_config(arch).reduced(), "cpu")


def _index_of(mesh, placed) -> list:
    flat = list(mesh.devices.flat)
    return sorted([flat.index(d), _norm_index(placed.index[d], placed.shape)]
                  for d in placed.shards)


def _check_chunks(full, placed):
    """Each chunk is the full leaf's slice, in storage of its own."""
    ptrs = set()
    for dev, chunk in placed.shards.items():
        assert torch.equal(chunk, torch.as_tensor(full)[placed.index[dev]])
        ptrs.add(chunk.data_ptr())
    assert len(ptrs) == len(placed.shards)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_hooks_impose_the_reference_specs_on_every_call(ref, arch,
                                                        mesh_name):
    """The port's forward records, call for call, the specs the
    reference's imposes: the pins first (``prepare``), then the embedding
    and each layer's block, where the reference traces each segment's
    block once."""
    cfg = get_config(arch).reduced()
    decoder = _decoder(ref, arch)
    tokens = torch.from_numpy(_rng(1).integers(0, 512, (B, S))).int()
    with dist.use_mesh(_mesh(mesh_name)), dist.record_constraints() as log:
        api.forward_logits(decoder, cfg, {"tokens": tokens})
    got = [[kind, list(shape), _canon(spec)] for kind, shape, spec in log]
    want = ref["doc"]["specs"][f"{arch}/{mesh_name}"]
    pins = [e for e in want if e[0] == "pin"]
    hooks = [e[1:] for e in want if e[0] == "hook"]
    n = len(pins)
    assert [e[1:] for e in got[:n]] == [e[1:] for e in pins]
    assert all(e[0] == "pin" for e in got[:n]) and n == 3
    segs = [cfg.first_dense, cfg.n_layers - cfg.first_dense] \
        if cfg.first_dense else [cfg.n_layers]
    blocks = [hooks[1 + 5 * i: 6 + 5 * i] for i in range(len(segs))]
    assert len(hooks) == 1 + 5 * len(segs)
    expected = [hooks[0]] + [e for blk, n_l in zip(blocks, segs)
                             for _ in range(n_l) for e in blk]
    assert [e[1:] for e in got[n:]] == expected
    assert {e[0] for e in got[n:]} == {"seq", "heads"}


@pytest.mark.parametrize("policy", POLICIES + ("cache",))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_leaves_have_the_reference_indices(ref, arch, mesh_name,
                                                  policy):
    cfg = get_config(arch).reduced()
    mesh = _mesh(mesh_name)
    want = ref["doc"]["index"][f"{arch}/{mesh_name}/{policy}"]
    with dist.use_mesh(mesh) as ctx:
        if policy == "cache":
            tree = api.init_cache(cfg, B, S, device="cpu")
            full = _flat(api._zeroed_caches(cfg, B, S, device="cpu"))
            placed = _flat(dist.device_put(tree, sharding.cache_shardings(
                cfg, tree, ctx)))
        else:
            decoder = _decoder(ref, arch)
            full = _flat(sharding._as_tree(decoder))
            before = dist.device_put.copied_bytes
            placed = _flat(dist.device_put(decoder, sharding.param_shardings(
                cfg, decoder, ctx, policy=policy)))
            held = sum(dist.bytes_by_device(placed).values())
            assert dist.device_put.copied_bytes - before == held
    assert set(placed) == set(want)
    for name, leaf in placed.items():
        assert _index_of(mesh, leaf) == want[name], name
        _check_chunks(full[name].detach(), leaf)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_prepare_pins_the_experts_by_the_ep_layout(ref, mesh_name):
    """``prepare`` places the stacked experts by ``P(None, model, None,
    None)``: each device holds its own experts, which ``moe_ffn_ep``
    reads with no copy of a full tensor."""
    arch = ARCHS[0]
    cfg = get_config(arch).reduced()
    mesh = _mesh(mesh_name)
    decoder = _decoder(ref, arch)
    with dist.use_mesh(mesh):
        p = api.prepare(decoder, cfg)
    m = mesh.shape["model"]
    for name in ("gate", "up", "down"):
        w = p["moe_blocks"]["moe"][name]
        assert _canon(w.sharding.spec) == [[], ["model"], [], []]
        full = getattr(decoder.moe_blocks.moe, name).detach()
        _check_chunks(full, w)
        for dev, chunk in w.shards.items():
            assert chunk.shape[1] == cfg.n_experts // m


@pytest.mark.parametrize("pos", DECODE_POS)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_decode_sp_matches_the_reference_without_gathering(ref, mesh_name,
                                                           pos):
    cfg = get_config(ARCHS[0]).reduced()
    mesh = _mesh(mesh_name)
    q, kn, vn, kc, vc = map(torch.from_numpy, _decode_inputs(cfg))
    with dist.use_mesh(mesh) as ctx:
        cache = api.place_caches(cfg, {"k": kc.clone(), "v": vc.clone()})
        assert isinstance(cache["k"], dist.Placed)
        chunks = {d: t.data_ptr() for d, t in cache["k"].shards.items()}
        gathered = dist.gather.copied_bytes
        combined = attention.combine_stripes.exchanged_bytes
        o, new = attention._decode_sp(q, kn, vn, cache, pos, cfg, ctx)
        assert dist.gather.copied_bytes == gathered
        assert new is cache and all(
            t.data_ptr() == chunks[d] for d, t in new["k"].shards.items())
        n_m, n_d = MESHES[mesh_name][1], MESHES[mesh_name][0]
        # (max, sum, output) of f32 per (batch row, query head)
        part = (B // n_d) * cfg.n_heads * (2 + cfg.head_dim) * 4
        assert attention.combine_stripes.exchanged_bytes - combined == \
            n_d * n_m * (n_m - 1) * part
    key = f"sp/{mesh_name}/{pos}"
    np.testing.assert_allclose(o.numpy(), ref[f"{key}/o"], atol=1e-5)
    np.testing.assert_allclose(dist.gather(new["k"]).numpy(),
                               ref[f"{key}/k"], atol=1e-5)
    np.testing.assert_allclose(dist.gather(new["v"]).numpy(),
                               ref[f"{key}/v"], atol=1e-5)
    if pos >= S:     # no stripe writes; the no-mesh path would clamp
        assert torch.equal(dist.gather(new["k"]), kc)


@pytest.mark.parametrize("mib", (False, True))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_slstm_batch_shards_match_the_reference(ref, mesh_name, mib):
    cfg = get_config("xlstm-1.3b").reduced()
    w = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in _flat(_weights(ref, "slstm/w/")).items()}
    p = {}
    for name, t in w.items():
        *path, leaf = name.split(".")
        node = p
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    u = torch.from_numpy(_rng(5).standard_normal((B, 8, cfg.d_model))
                         .astype(np.float32))
    with dist.use_mesh(_mesh(mesh_name), model_in_batch=mib):
        y = xlstm.slstm_scan(p, u, cfg)
    (y ** 2).sum().backward()
    key = f"slstm/{mesh_name}/{int(mib)}"
    np.testing.assert_allclose(y.detach().numpy(), ref[f"{key}/out"],
                               atol=1e-5)
    for name, t in w.items():
        want = ref[f"{key}/grad/{name}"]
        tol = 1e-5 + 1e-4 * np.abs(want).max()
        np.testing.assert_allclose(t.grad.numpy(), want, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_reference_checkpoint_restores_onto_each_mesh(ref, mesh_name):
    cfg = get_config(ARCHS[0]).reduced()
    mesh = _mesh(mesh_name)
    like = api.init_params(torch.Generator().manual_seed(9), cfg,
                           device="cpu")
    with dist.use_mesh(mesh) as ctx:
        p_sh = sharding.param_shardings(cfg, like, ctx, policy="fsdp")
        sh = (p_sh, sharding.opt_state_shardings(p_sh, ctx))
        (params, opt), _, step = restore_checkpoint(
            ref["ckpt"], 1, (like, adamw_init(like)), shardings=sh)
    assert step == 1 and isinstance(opt.step, dist.Placed)
    want = ref["doc"]["restore"][mesh_name]
    flat = _flat(params)
    assert set(flat) == set(want)
    for name, leaf in flat.items():
        assert _index_of(mesh, leaf) == want[name], name
        _check_chunks(ref[f"{ARCHS[0]}/w/{name}"], leaf)


@functools.cache
def _chip_smoke():
    """``chip_smoke.py`` as a module (importing it runs nothing)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _restore_breaks():
    """Faulty restores for the card's restore check to catch: each wraps
    the ``device_put`` that ``restore_checkpoint`` places a leaf by."""
    def wrong_mesh(put, saved_mesh):
        return lambda x, sh: put(x, dist.NamedSharding(saved_mesh, sh.spec))

    def one_value(put, _):
        return lambda x, sh: put(x.flatten().index_fill(
            0, torch.tensor([0]), 7.0).reshape(x.shape) if x.ndim == 2
            else x, sh)

    def rolled(put, _):
        return lambda x, sh: put(torch.roll(x, 1, 0) if x.ndim >= 2
                                 else x, sh)

    def step(put, _):
        return lambda x, sh: put(x + 1 if x.ndim == 0 else x, sh)

    return {"none": None, "wrong_mesh": wrong_mesh, "one_value": one_value,
            "rolled": rolled, "step": step}


@pytest.mark.parametrize("fault", list(_restore_breaks()))
def test_card_restore_check_holds_only_a_faithful_restore(
        fault, tmp_path, monkeypatch):
    """``chip_smoke.mesh_restore_equal`` (the ``[mesh]`` phase's restore
    check, (2, 2) onto (1, 4)) run on the CPU at ``reduced()``: True for
    the real restore, False for a restore onto the saved mesh, with one
    value changed, with a leaf's rows rolled, or with the step off by
    one."""
    from repro_torch.ckpt import checkpoint as ck
    cfg = get_config(ARCHS[0]).reduced(n_layers=1)
    decoder = api.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    mesh, other = _mesh("2x2"), _mesh("1x4")
    make = _restore_breaks()[fault]
    if make is not None:
        put = make(dist.device_put, mesh)

        class Dist:         # the checkpoint module's view of ``dist``
            device_put = staticmethod(put)

            def __getattr__(self, name):
                return getattr(dist, name)
        monkeypatch.setattr(ck, "dist", Dist())
    assert _chip_smoke().mesh_restore_equal(
        cfg, decoder, mesh, other, tmp_path / "ckpt") == (make is None)
