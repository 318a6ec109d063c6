"""repro_torch's MoE models trained and served under a mesh against the
JAX package's, on the CPU.

Both MoE archs at ``reduced()`` (f32, drop-free capacity, so each mesh
position's own capacity drops nothing), the reference's weights carried
across as numpy, on meshes of 4 logical CPU devices (data, model) = (1,
4), (2, 2) and (4, 1); the reference on a (2, 2) mesh of 4 forced host
devices, in one subprocess (this file run as a script) shared by every
case.  Drop-free in f32, the results do not depend on the mesh beyond
the order of sums, so each of the port's meshes is held to the
reference's (2, 2) run (``tests/test_torch_mesh.py`` holds the layouts
mesh by mesh).  Tolerances (f32 against f32, the same sums in other
orders):

* two train steps under ``fsdp`` at a peak learning rate of 1e-2, the
  port's ``build_train_step`` with in/out shardings against the
  reference's step jitted with them: loss and global norm within 1e-4;
  each parameter's change over the steps within 1e-3 of the reference's
  change in 2-norm, and AdamW's moments elementwise within 1e-3 of
  their largest element (measured: at most 3.6e-4 and 3.1e-4); every
  chunk of every placed leaf, replicas included, equal to the gathered
  leaf at its index;
* Zamba2-1.2B at 2 layers, below its first shared-block call, so the
  loss reaches none of the shared block's leaves: the same two ``fsdp``
  steps on (2, 2) against the port's own step without a mesh from the
  same seeded weights, at the tolerances above; each unreached leaf
  equal to the plain step's (decayed only), its moments 0 in every
  chunk;
* serving under ``tp``: prefill's last-token logits and four decode steps
  (teacher tokens, so both packages decode the same tokens) within
  1e-4, the caches placed by ``cache_shardings`` and never gathered.
"""
from __future__ import annotations

import copy
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

MESHES = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1)}
ARCHS = ("granite-moe-1b-a400m", "deepseek-v2-lite-16b")
# an arch and depth whose loss reaches no leaf of one part (the prefix)
UNREACHED = ("zamba2-1.2b", 2, "shared_")
B, S, STEPS, DECODES = 4, 16, 2, 4
MAX_LEN = S + DECODES + 8
# a learning rate large enough that two steps move every parameter far
# past the tolerance (the defaults' warm-up would move it by ~1e-5)
STEP_KW = dict(peak_lr=1e-2, warmup=1, total_steps=10)


def _flat(t, prefix=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _tokens(vocab):
    r = np.random.default_rng(1)
    return (r.integers(0, vocab, (B, S)).astype(np.int32),
            r.integers(0, vocab, (B, DECODES)).astype(np.int32))


REF_MESH = "2x2"


def reference(path: str) -> None:
    """The reference's train steps and serving on the (2, 2) mesh of 4
    forced host devices, saved to ``path``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import dist
    from repro.configs import get_config
    from repro.dist import sharding
    from repro.launch.mesh import make_mesh
    from repro.launch.train import build_train_step
    from repro.models import api
    from repro.optim import adamw_init

    out = {}
    init = jax.jit(api.init_params, static_argnums=1)
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        params = init(jax.random.PRNGKey(0), cfg)
        out.update({f"{arch}/w/{k}": np.asarray(v)
                    for k, v in _flat(params).items()})
        prompt, nxt = map(jnp.asarray, _tokens(cfg.vocab_size))
        batch = {"tokens": prompt}
        mesh = make_mesh(MESHES[REF_MESH], ("data", "model"))
        with dist.use_mesh(mesh) as ctx:
            p_sh = sharding.param_shardings(cfg, params, ctx,
                                            policy="fsdp")
            repl = NamedSharding(mesh, P())
            o_sh = type(adamw_init(params))(step=repl, mu=p_sh, nu=p_sh)
            b_sh = sharding.batch_shardings(cfg, batch, ctx)
            step = jax.jit(build_train_step(cfg, **STEP_KW),
                           in_shardings=(p_sh, o_sh, b_sh, repl),
                           out_shardings=(p_sh, o_sh, None))
            # placed first, so both steps share one compilation
            p, o = jax.device_put((params, adamw_init(params)),
                                  (p_sh, o_sh))
            for i in range(1, STEPS + 1):
                p, o, m = step(p, o, batch, jnp.int32(i))
                out[f"{arch}/loss/{i}"] = np.asarray(m["loss"])
                out[f"{arch}/gnorm/{i}"] = np.asarray(m["gnorm"])
            for name, tree in (("trained", p), ("mu", o.mu), ("nu", o.nu)):
                out.update({f"{arch}/{name}/{k}": np.asarray(v)
                            for k, v in _flat(tree).items()})

            tp = jax.device_put(params, sharding.param_shardings(
                cfg, params, ctx, policy="tp"))
            logits, caches = jax.jit(
                lambda pp, b: api.prefill_step(pp, cfg, b))(tp, batch)
            out[f"{arch}/prefill"] = np.asarray(logits)
            caches = api.pad_caches(caches, MAX_LEN)
            decode = jax.jit(lambda pp, t, c, pos: api.decode_step(
                pp, cfg, t, c, pos))
            for i in range(DECODES):
                logits, caches = decode(tp, nxt[:, i:i + 1], caches,
                                        jnp.int32(S + i))
                out[f"{arch}/decode/{i}"] = np.asarray(logits)
    np.savez(path, **out)


# Run as a script, this file computes the reference's results instead
# (``python tests/test_torch_mesh_train.py out.npz``, with
# XLA_FLAGS=--xla_force_host_platform_device_count=4 set).
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    import repro  # noqa: F401  (installs the jax compatibility shims)
    reference(sys.argv[1])
    sys.exit(0)

import torch  # noqa: E402

from repro_torch import dist  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.train import build_train_step  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.transformer import tree  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

_REF: dict = {}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results (one subprocess for the whole file)."""
    if not _REF:
        path = tmp_path_factory.mktemp("ref_mesh_train") / "ref.npz"
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT / "src"), str(ROOT), env.get("PYTHONPATH", "")])
        proc = subprocess.run([sys.executable, __file__, str(path)],
                              cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with np.load(path) as z:
            _REF.update({k: z[k] for k in z.files})
    return _REF


def _setup(ref, arch, mesh_name):
    cfg = get_config(arch).reduced()
    tree: dict = {}
    prefix = f"{arch}/w/"
    for key, v in ref.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split(".")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = v
    mesh = make_mesh(MESHES[mesh_name], ("data", "model"),
                     dist.logical_devices(4, "cpu"))
    prompt, nxt = map(torch.from_numpy, _tokens(cfg.vocab_size))
    return cfg, params_from_reference(tree, cfg, "cpu"), mesh, prompt, nxt


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_under_the_mesh_match_the_reference(ref, arch,
                                                        mesh_name):
    cfg, decoder, mesh, prompt, _ = _setup(ref, arch, mesh_name)
    batch = {"tokens": prompt}
    with dist.use_mesh(mesh) as ctx:
        p_sh = sharding.param_shardings(cfg, decoder, ctx, policy="fsdp")
        o_sh = sharding.opt_state_shardings(p_sh, ctx)
        b_sh = sharding.batch_shardings(cfg, batch, ctx)
        step = build_train_step(cfg, **STEP_KW,
                                in_shardings=(p_sh, o_sh, b_sh, None),
                                out_shardings=(p_sh, o_sh, None))
        p, o = decoder, adamw_init(decoder)
        gathered = dist.gather.copied_bytes
        for i in range(1, STEPS + 1):
            p, o, m = step(p, o, batch, i)
            np.testing.assert_allclose(float(m["loss"]),
                                       ref[f"{arch}/loss/{i}"], atol=1e-4)
            np.testing.assert_allclose(float(m["gnorm"]),
                                       ref[f"{arch}/gnorm/{i}"], atol=1e-4)
        # every step gathers each parameter once, and the batch
        n_bytes = sum(x.numel() * 4 for x in decoder.parameters())
        assert dist.gather.copied_bytes - gathered == \
            STEPS * (n_bytes + prompt.numel() * 4)
    assert isinstance(o.step, dist.Placed) and \
        int(dist.gather(o.step)) == STEPS
    for kind, tree in (("trained", p), ("mu", o.mu), ("nu", o.nu)):
        for name, leaf in _flat(tree).items():
            assert leaf.sharding == _flat(p_sh)[name]
            full = dist.gather(leaf)
            # every chunk, replicas included, is the full leaf at its index
            for dev, chunk in leaf.shards.items():
                assert torch.equal(chunk, full[leaf.index[dev]]), \
                    (kind, name, dev)
            want, got = ref[f"{arch}/{kind}/{name}"], full.numpy()
            if kind == "trained":
                # the update itself: a relative 2-norm, since AdamW moves
                # an element whose gradient is near its f32 noise by that
                # noise (no mesh, single elements differ from the
                # reference's by up to 5% of the largest change)
                p0 = ref[f"{arch}/w/{name}"]
                assert np.linalg.norm(got - want) <= \
                    1e-3 * np.linalg.norm(want - p0), name
            else:
                # the moments are linear in the gradients (and their
                # squares): elementwise
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=1e-3 * np.abs(want).max(),
                                           err_msg=f"{kind} {name}")


def test_placed_step_where_the_loss_reaches_no_leaf_matches_the_plain():
    arch, n_layers, prefix = UNREACHED
    cfg = get_config(arch).reduced(n_layers=n_layers)
    decoder = api.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    w0 = {k: v.detach().clone() for k, v in _flat(tree(decoder)).items()}
    prompt, _ = map(torch.from_numpy, _tokens(cfg.vocab_size))
    batch = {"tokens": prompt}
    plain = copy.deepcopy(decoder)
    plain_opt = adamw_init(plain)
    step = build_train_step(cfg, **STEP_KW)
    metrics = []
    for i in range(1, STEPS + 1):
        plain, plain_opt, m = step(plain, plain_opt, batch, i)
        metrics.append(m)
    mesh = make_mesh(MESHES["2x2"], ("data", "model"),
                     dist.logical_devices(4, "cpu"))
    with dist.use_mesh(mesh) as ctx:
        p_sh = sharding.param_shardings(cfg, decoder, ctx, policy="fsdp")
        o_sh = sharding.opt_state_shardings(p_sh, ctx)
        b_sh = sharding.batch_shardings(cfg, batch, ctx)
        step = build_train_step(cfg, **STEP_KW,
                                in_shardings=(p_sh, o_sh, b_sh, None),
                                out_shardings=(p_sh, o_sh, None))
        p, o = decoder, adamw_init(decoder)
        for i, want in enumerate(metrics, 1):
            p, o, m = step(p, o, batch, i)
            for key in ("loss", "gnorm"):
                np.testing.assert_allclose(float(m[key]), float(want[key]),
                                           atol=1e-4)
    unreached = 0
    for kind, placed, want_tree in (("trained", p, tree(plain)),
                                    ("mu", o.mu, plain_opt.mu),
                                    ("nu", o.nu, plain_opt.nu)):
        want_flat = _flat(want_tree)
        for name, leaf in _flat(placed).items():
            got, want = dist.gather(leaf), want_flat[name].detach()
            if name.startswith(prefix):
                unreached += 1
                if kind == "trained":
                    assert torch.equal(got, want), name
                    assert want.ndim < 2 or not torch.equal(want, w0[name])
                else:
                    assert not any(c.any() for c in leaf.shards.values()), \
                        (kind, name)
            elif kind == "trained":
                assert torch.linalg.norm(got - want) <= \
                    1e-3 * torch.linalg.norm(want - w0[name]), name
            else:
                np.testing.assert_allclose(
                    got.numpy(), want.numpy(), rtol=0,
                    atol=1e-3 * want.abs().max().item(),
                    err_msg=f"{kind} {name}")
    assert unreached


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_under_the_mesh_match_the_reference(
        ref, arch, mesh_name):
    cfg, decoder, mesh, prompt, nxt = _setup(ref, arch, mesh_name)
    with torch.inference_mode(), dist.use_mesh(mesh) as ctx:
        params = dist.device_put(decoder, sharding.param_shardings(
            cfg, decoder, ctx, policy="tp"))
        p = api.prepare(params, cfg)
        logits, caches = api.prefill_step(p, cfg, {"tokens": prompt})
        np.testing.assert_allclose(logits.numpy(), ref[f"{arch}/prefill"],
                                   atol=1e-4)
        caches = api.pad_caches(caches, MAX_LEN)
        seq = dist.placed_leaves(caches)
        assert seq and all(x.shape[-2] == MAX_LEN for x in seq)
        gathered = dist.gather.copied_bytes
        for i in range(DECODES):
            logits, caches = api.decode_step(p, cfg, nxt[:, i:i + 1], caches,
                                             S + i)
            np.testing.assert_allclose(logits.numpy(),
                                       ref[f"{arch}/decode/{i}"], atol=1e-4,
                                       err_msg=f"decode step {i}")
        assert dist.gather.copied_bytes == gathered


def test_remat_recompute_reinstalls_the_mesh_on_the_backward_thread():
    """The autograd engine runs a CUDA backward pass (a checkpoint's
    recompute included) on a thread of its own, where the ambient mesh is
    not installed: ``_remat`` reinstalls it.  Here the backward runs on
    another thread on the CPU, the gradients equal the same thread's."""
    import threading
    cfg = get_config(ARCHS[0]).reduced()
    decoder = api.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    prompt, _ = map(torch.from_numpy, _tokens(cfg.vocab_size))
    mesh = make_mesh(MESHES["2x2"], ("data", "model"),
                     dist.logical_devices(4, "cpu"))
    grads = []
    for thread in (False, True):
        with dist.use_mesh(mesh) as ctx:
            placed = dist.device_put(decoder, sharding.param_shardings(
                cfg, decoder, ctx, policy="fsdp"))
            shards = [t for x in dist.placed_leaves(placed)
                      for t in x.shards.values()]
            for t in shards:
                t.requires_grad_(True)
            loss = api.loss_fn(placed, cfg, {"tokens": prompt})
        if thread:
            errors = []

            def backward():
                try:
                    loss.backward()
                except Exception as e:      # re-raised on this thread
                    errors.append(e)
            worker = threading.Thread(target=backward)
            worker.start()
            worker.join(timeout=120)
            assert not worker.is_alive() and not errors, errors
        else:
            with dist.use_mesh(mesh):
                loss.backward()
        grads.append([t.grad for t in shards])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
