"""The dry run (``repro_torch.launch.dryrun``, ``launch.hlo_stats``, the
exchange recorder, the live-bytes tracker and ``metatrace``'s count
once, times the trip count) against the reference and against real
runs, at ``reduced()`` sizes on the CPU.

* the ring model equals the reference's ``collective_stats`` on HLO
  text with the same instruction and group (equality);
* ``meta`` predictions of the bytes held, gathered, placed,
  EP-exchanged and combined equal the counters of the same steps run on
  CPU logical devices (equality); the recorded all-gathers sum to
  ``gather.copied_bytes``;
* the shortened ``meta`` trace equals one that unrolls every loop:
  flops, bytes, exchanges by kind, bytes by device, counters and the
  peak of live bytes (equality);
* the matmul flops equal the reference's ``count_step`` on the same
  function; the argument and output bytes equal the reference's
  ``memory_stats``, less the one leaf the port keeps on the host;
* ``run_cells`` and ``main``: a cell's JSON has the reference's keys
  and tag, ``--skip-existing``, an error record and exit 1; the policy
  and ``model_in_batch`` of every cell against a table of the
  reference's;
* the flash wrappers on ``meta``: the kernel's output shape and dtype,
  the block contract, no launch.
"""
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch import hlo_stats as ref_hlo
from repro_torch import dist, metatrace
from repro_torch.configs import (ARCH_IDS, SHAPES, applicable_shapes,
                                 get_config)
from repro_torch.dist import sharding
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_decode import kernel as fd_kernel
from repro_torch.launch import dryrun, hlo_stats
from repro_torch.launch.flopcount import FlopCounter
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import build_train_step
from repro_torch.models import api
from repro_torch.optim import adamw_init

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
GRANITE, DEEPSEEK = "granite-moe-1b-a400m", "deepseek-v2-lite-16b"
B, S, MAX_LEN = 4, 64, 72


# ---------------------------------------------------------------------------
# the ring model
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_ring_model_equals_the_reference(kind, g):
    n = 4096                                    # f32 elements of the result
    groups = f"replica_groups=[{8 // g},{g}]<=[8]" if g > 1 else \
        "replica_groups={{0}}"
    hlo = f"""
ENTRY %main.1 (a: f32[{n}]) -> f32[{n}] {{
  %c = f32[{n}]{{0}} {kind}(%a), channel_id=1, {groups}
}}
"""
    want = ref_hlo.collective_stats(hlo).to_dict()
    got = hlo_stats.collective_stats([(kind, 4 * n, g)]).to_dict()
    assert got == want
    # a record standing for 3 executions counts three times
    thrice = hlo_stats.collective_stats([(kind, 4 * n, g, 3)]).to_dict()
    assert thrice["counts"][kind] == 3 * want["counts"][kind]
    assert thrice["total_link_bytes"] == 3 * want["total_link_bytes"]


def test_memory_stats_keys_and_total():
    ms = hlo_stats.memory_stats(argument_size_in_bytes=10,
                                output_size_in_bytes=7,
                                alias_size_in_bytes=4, temp_size_in_bytes=5)
    assert list(ms) == ["generated_code_size_in_bytes",
                        "argument_size_in_bytes", "output_size_in_bytes",
                        "alias_size_in_bytes", "temp_size_in_bytes",
                        "per_device_total_bytes"]
    assert ms["generated_code_size_in_bytes"] == 0
    assert ms["per_device_total_bytes"] == 10 + 7 + 5 - 4


# ---------------------------------------------------------------------------
# predictions on meta, short and unrolled, and the same steps on the CPU
def _cfg(arch, **kw):
    return get_config(arch).reduced(**kw)


def _meta_tokens(seq=S):
    return torch.empty((B, seq), dtype=torch.int32, device="meta")


def _predict(arch, mode, seq=S, mesh=(2, 2), **kw):
    """``{step: trace}`` and the bytes held, predicted on ``mesh`` meta
    devices; ``kw`` overrides the config."""
    cfg = _cfg(arch, **kw)
    mesh = dryrun.meta_mesh(mesh)
    if mode == "train":
        tr, held = dryrun.predict_train(cfg, mesh,
                                        {"tokens": _meta_tokens(seq)})
        return {"train": tr}, held
    return dryrun.predict_serve(cfg, mesh, _meta_tokens(), max_len=MAX_LEN)


def _prefill_trace(arch):
    """One prefill step of a recurrent family on (2, 2) meta devices."""
    cfg = _cfg(arch)
    mesh = dryrun.meta_mesh((2, 2))
    with dist.use_mesh(mesh) as ctx, torch.inference_mode():
        params = dryrun._abstract_params(cfg)
        placed = dist.device_put(params, sharding.param_shardings(
            cfg, params, ctx, policy="tp"))
        _, tr = dryrun.trace(lambda p, b: api.prefill_step(p, cfg, b),
                             (placed, {"tokens": _meta_tokens()}), mesh)
    return {"prefill": tr}, {}


# xlstm-train: a backward pass through the layers', the mLSTM chunks' and
# the sLSTM time steps' shortened loops; mistral-blocks-train: four
# layers (the middle ones' leftovers and their weights' gradients overlap
# in their backward passes), S 128 in four key blocks of 32 (a small
# vocabulary, so that the loss does not hold the peak);
# qwen-replicas-train: 6 heads that the 8-wide model axis of a (1, 8)
# mesh does not divide, so that the chunk runs on the 8 positions that
# hold it, each query block reading every key block
CELLS = {"granite-train": (GRANITE, "train"),
         "granite-serve": (GRANITE, "serve"),
         "deepseek-serve": (DEEPSEEK, "serve"),
         "zamba2-prefill": ("zamba2-1.2b", "prefill"),
         "xlstm-prefill": ("xlstm-1.3b", "prefill"),
         "xlstm-train": ("xlstm-1.3b", "train"),
         "mistral-blocks-train": ("mistral-nemo-12b", "train", dict(
             seq=128, n_layers=4, attn_q_chunk=128, attn_k_chunk=32,
             vocab_size=32)),
         "qwen-replicas-train": ("qwen1.5-4b", "train", dict(
             seq=128, mesh=(1, 8), n_layers=1, n_heads=6, n_kv_heads=6,
             vocab_size=32))}


def _traced(arch, mode, kw=None):
    return _prefill_trace(arch) if mode == "prefill" else \
        _predict(arch, mode, **(kw or {}))


@pytest.fixture(scope="module")
def predicted():
    """Every cell's short traces, made once."""
    return {name: _traced(*cell) for name, cell in CELLS.items()}


def _real(arch, mode):
    """The same steps on (2, 2) CPU logical devices from seeded weights:
    ``({step: counter increments}, bytes held, the recorded all-gather
    bytes, the gathered bytes)``."""
    cfg = _cfg(arch)
    mesh = make_mesh((2, 2), ("data", "model"),
                     dist.logical_devices(4, "cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    decoder = api.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    real = {}

    def run(name, fn, inputs, donated):
        before = dryrun.counters()
        out = fn(*inputs)
        after = dryrun.counters()
        real[name] = {k: after[k] - before[k] for k in after}
        return out

    with dist.use_mesh(mesh) as ctx, dist.record_exchanges() as records:
        start = dist.gather.copied_bytes
        if mode == "train":
            p_sh = sharding.param_shardings(cfg, decoder, ctx, policy="fsdp")
            o_sh = sharding.opt_state_shardings(p_sh, ctx)
            placed = dist.device_put(decoder, p_sh)
            opt = adamw_init(placed)
            held = dist.bytes_by_device((placed, opt))
            b_sh = sharding.batch_shardings(cfg, {"tokens": tokens}, ctx)
            step = build_train_step(cfg, in_shardings=(p_sh, o_sh, b_sh,
                                                       None),
                                    out_shardings=(p_sh, o_sh, None))
            run("train", lambda p, o, b: step(p, o, b, 1),
                (placed, opt, {"tokens": tokens}), ())
        else:
            placed = dist.device_put(decoder, sharding.param_shardings(
                cfg, decoder, ctx, policy="tp"))
            held = dist.bytes_by_device(placed)
            with torch.inference_mode():
                dryrun.serve_steps(cfg, placed, tokens, max_len=MAX_LEN,
                                   run=run)
        gathered = dist.gather.copied_bytes - start
    all_gathers = sum(r[1] * r[3] for r in records if r[0] == "all-gather")
    return real, held, all_gathers, gathered


@pytest.mark.parametrize("name", ["granite-train", "granite-serve",
                                  "deepseek-serve"])
def test_meta_predictions_equal_the_cpu_run(predicted, name):
    traces, held = predicted[name]
    real, real_held, all_gathers, gathered = _real(*CELLS[name])
    assert held == real_held
    assert set(traces) == set(real)
    for step, tr in traces.items():
        assert tr.counters == real[step], step
        assert tr.launches == 0
    # the recorder's all-gathers are the gathered bytes
    assert all_gathers == gathered > 0
    recorded = sum(r[1] * r[3] for tr in traces.values()
                   for r in tr.records if r[0] == "all-gather")
    assert recorded == sum(tr.counters["gathered_bytes"]
                           for tr in traces.values())


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_shortcut_equals_the_unrolled_trace(predicted, name,
                                                monkeypatch):
    short, _ = predicted[name]
    assert metatrace.steps(range(4), like=_meta_tokens()).short
    monkeypatch.setattr(metatrace, "on_meta", lambda *t: False)
    assert not metatrace.steps(range(4), like=_meta_tokens()).short
    unrolled, _ = _traced(*CELLS[name])
    assert set(short) == set(unrolled)
    for step in short:
        a, b = short[step], unrolled[step]
        assert (a.flops, a.bytes) == (b.flops, b.bytes), step
        assert a.by_op == b.by_op, step
        assert a.collectives == b.collectives, step
        assert (a.arguments, a.outputs, a.donated) == \
            (b.arguments, b.outputs, b.donated), step
        assert a.counters == b.counters, step
        # the item that ran stands for the others' live bytes too
        assert (a.peak, a.left) == (b.peak, b.left), step


def test_exchanges_map_to_collectives():
    """gather: an all-gather over the distinct chunks, a reduce-scatter in
    its backward; a placement and a reshard (the choice of this port:
    placements are no collective) record nothing."""
    mesh = make_mesh((2, 2), ("data", "model"),
                     dist.logical_devices(4, "cpu"))
    x = torch.arange(32.0).reshape(4, 8)
    rows = dist.NamedSharding(mesh, dist.PartitionSpec("data", None))
    cols = dist.NamedSharding(mesh, dist.PartitionSpec(None, "model"))
    with dist.record_exchanges() as log:
        placed = dist.device_put(x, rows)
        moved = dist.reshard(placed, cols)
    assert log == []
    for t in moved.shards.values():
        t.requires_grad_(True)
    with dist.record_exchanges() as log:
        full = dist.gather(moved)
        full.sum().backward()
    assert log == [("all-gather", 128, 2, 1), ("reduce-scatter", 64, 2, 1)]


def test_live_bytes_counts_what_a_step_allocates():
    with hlo_stats.LiveBytes() as live:
        a = torch.empty(256, device="meta")               # 1 KiB
        b = a.view(16, 16)                                # no new bytes
        c = torch.ones(512, device="meta")                # 2 KiB
        del a, b
        a_gone = live.live
        d = c * 2                                         # 2 KiB
        del c, d
    assert a_gone == 2048 and live.peak == 4096 and live.live == 0


def _loop_peak(kind: str, n: int = 8) -> tuple[int, int]:
    """A loop over ``n`` pieces of a ``meta`` tensor, on its own:
    (peak, left) of its forward and backward passes.  ``split`` and
    ``unbind``: each piece's gradient is held until the split's backward
    gathers them, and the first piece's backward (the last to run)
    makes a large temporary; ``gathered``: a split whose gathering
    ``cat`` is the peak; ``collected``: the items' outputs are
    concatenated and dropped while what each item saved lives on, then
    a large temporary."""
    x = torch.empty(n, 16, 64, device="meta", requires_grad=True)
    w = torch.empty(64, 64, device="meta", requires_grad=True)
    metatrace.clear()
    with hlo_stats.LiveBytes() as live:
        pieces = x.split(1, 0) if kind in ("split", "gathered") \
            else x.unbind(0)
        loop = metatrace.steps(pieces, like=x)
        outs = []
        for p in loop:
            if kind == "collected":
                outs.append((p * 2).sin())
            elif kind == "gathered":
                outs.append(p.sin())
            else:
                # (16, 64, 64): a temporary of 16 pieces in its backward
                outs.append((p[..., None] * w).sum(-1))
        y = torch.cat(loop.fill(outs), 0)
        del outs, p
        if kind == "collected":
            y = torch.empty(n * 64, 64, 64, device="meta") + y.sum()
        y.sum().backward()
        del y
    metatrace.clear()
    return live.peak, live.live


@pytest.mark.parametrize("kind", ["split", "unbind", "gathered",
                                  "collected"])
def test_the_shortcut_counts_every_piece_the_loop_skips(kind, monkeypatch):
    """A piece's gradient stands for the pieces the shortened loop did not
    read until the split's backward gathers them (the zeros made in their
    place are not counted); an item's collected output, for the
    others' outputs, only as long as it lives."""
    short = _loop_peak(kind)
    monkeypatch.setattr(metatrace, "on_meta", lambda *t: False)
    assert short == _loop_peak(kind)


# ---------------------------------------------------------------------------
# against the reference's flop counter and memory analysis
def _ref_matmul_flops(fn, *args) -> float:
    """The reference's dot_general flops of ``fn`` (its count_step's walk,
    dot_general alone)."""
    from repro.launch import flopcount as ref_fc

    def walk(jaxpr, m):
        total = 0.0
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                total += m * ref_fc._dot_flops(eqn)
            elif eqn.primitive.name == "shard_map":
                total += m * walk(eqn.params["jaxpr"], 1.0)
            else:
                for mult, sub in ref_fc._sub_jaxprs(eqn):
                    total += walk(sub, m * mult)
        return total
    return walk(jax.make_jaxpr(fn)(*args).jaxpr, 1.0)


def _ref_cell(arch, shape_name):
    """The reference's step of a cell at reduced() with 2 layers, no mesh:
    (count_step totals, matmul flops)."""
    from repro.configs import get_config as ref_config, input_specs
    from repro.launch.flopcount import count_step
    from repro.launch.train import build_train_step as ref_build
    from repro.models import api as ref_api
    from repro.optim import adamw_init as ref_adamw_init
    cfg = ref_config(arch).reduced(n_layers=2)
    params = jax.eval_shape(
        lambda: ref_api.init_params(jax.random.PRNGKey(0), cfg))
    specs = input_specs(cfg, shape_name)
    if SHAPES[shape_name].kind == "train":
        fn = ref_build(cfg)
        args = (params, jax.eval_shape(ref_adamw_init, params),
                specs["batch"], jax.ShapeDtypeStruct((), jnp.int32))
    elif SHAPES[shape_name].kind == "prefill":
        def fn(p, b):
            return ref_api.prefill_step(p, cfg, b)
        args = (params, specs["batch"])
    else:
        params = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, jnp.bfloat16)
            if x.ndim >= 2 else x, params)

        def fn(p, t, c, i):
            return ref_api.decode_step(p, cfg, t, c, i)
        args = (params, specs["token"], specs["caches"], specs["pos"])
    return count_step(fn, *args), _ref_matmul_flops(fn, *args)


def _one_device_cell(arch, shape_name, monkeypatch):
    """The port's ``lower_cell`` at reduced() with 2 layers, its mesh one
    ``meta`` device (the reference's count here runs without a mesh)."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).reduced())
    monkeypatch.setattr(dryrun, "_mesh_ctx", lambda multi, **kw: (
        dryrun.meta_mesh((1, 1)), dict(data_axes=("data",),
                                       model_axis="model", **kw)))
    return dryrun.lower_cell(arch, shape_name, False, n_layers=2)


_SILU = ("the reference's silu is x * logistic(x), one multiply an "
         "element more than the port's silu")
_EMBED = ("the port's embedding lookup counts a flop an output element, "
          "the reference's gather bytes only")
_SP_DIV = ("the port's decode on a mesh (here of one device) divides the "
           "(B, H, D) output once after the value product, the "
           "reference's plain decode every (B, H, S) probability")
_ROUTER = ("the router and dispatch: the reference's top_k and one-hot "
           "capacity arithmetic (lt, le, div, add) against the port's "
           "stable sort, searchsorted and scatter")
# the port's flops less the reference's, matmul flops equal, and why
FLOP_GAPS = {
    ("mistral-nemo-12b", "prefill_32k"): (
        -411041792.0, f"{_SILU} (-536,870,912); {_EMBED} (+134,217,728); "
        "the norms' and rotary tables' spellings (-8,388,608)"),
    ("mistral-nemo-12b", "decode_32k"): (
        -33372040.0, f"{_SP_DIV} (-33,522,304); the stripe's mask, the "
        f"merge's max and exp, the norms (+133,880); {_EMBED} (+16,384)"),
    (GRANITE, "prefill_32k"): (
        -2560622336.0, f"{_SILU} (-2,147,483,648); {_ROUTER}; {_EMBED} "
        "(+134,217,728); the norms' and rotary tables' spellings"),
    (GRANITE, "decode_32k"): (
        -33600904.0, f"{_SP_DIV} (-33,528,960); {_ROUTER}; the stripe's "
        f"mask, the merge, the norms; {_EMBED} (+16,384)"),
}


# a train step, the same rule (per op, the port's count less the
# reference's): before the block loops split their operands once, the
# slices' whole-size gradients and their additions made Mistral's gap
# +4,444,098,125,124 (15.8%); before attend split its operands once
# per mesh position's chunk, +45,380,525,380 (its slices of k and v,
# one position here, +134,217,728)
TRAIN_FLOP_GAPS = {
    ("mistral-nemo-12b", "train_4k"): (
        45246307652.0, "the backward pass's reductions (sum and mean "
        "against reduce_sum, +32,198,622,592); mul +12,876,586,857; the "
        "masks' spellings (gt, lt, eq, masked_fill_ against le, lt, ge, "
        "eq: +1,044,381,672); div +1,178,599,456; silu and its backward "
        f"(+536,870,912: {_SILU}); {_EMBED} (+134,217,728); the gold "
        "logit's select (select_backward, +1,048,576); add, sub, exp and "
        "neg against "
        "add_any, add, sub, exp, neg (-2,713,796,578); the norms', rotary "
        "tables' and clip's spellings (-10,223,563)"),
}


@pytest.mark.parametrize("arch,shape_name",
                         sorted({**FLOP_GAPS, **TRAIN_FLOP_GAPS}))
def test_matmul_flops_equal_the_reference(arch, shape_name, monkeypatch):
    record, tr = _one_device_cell(arch, shape_name, monkeypatch)
    got_total = record["flops_per_device"] * record["n_devices"]
    matmul = sum(tr.by_op.get(op, [0.0])[0]
                 for op in ("mm", "bmm", "addmm", "baddbmm"))
    ref_total, ref_matmul = _ref_cell(arch, shape_name)
    assert matmul == ref_matmul
    gap, cause = {**FLOP_GAPS, **TRAIN_FLOP_GAPS}[arch, shape_name]
    assert cause
    assert got_total - ref_total["flops"] == gap


def test_argument_and_output_bytes_equal_the_reference():
    """The integration test's tiny train cell on one device: arguments
    and outputs of the step, the reference's ``memory_stats`` of the
    compiled step against the port's trace."""
    from repro.configs import get_config as ref_config
    from repro.launch.train import build_train_step as ref_build
    from repro.models import api as ref_api
    from repro.optim.adamw import adamw_init as ref_adamw_init
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
              d_ff=128, vocab_size=512)
    rcfg = ref_config("qwen1.5-4b").reduced(**kw)
    params_abs = jax.eval_shape(
        lambda: ref_api.init_params(jax.random.PRNGKey(0), rcfg))
    opt_abs = jax.eval_shape(ref_adamw_init, params_abs)
    args = (params_abs, opt_abs,
            {"tokens": jax.ShapeDtypeStruct((4, 32), jnp.int32)},
            jax.ShapeDtypeStruct((), jnp.int32))
    step = ref_build(rcfg)
    compiled = jax.jit(step).lower(*args).compile()
    want = ref_hlo.memory_stats(compiled)
    out_leaves = len(jax.tree_util.tree_leaves(jax.eval_shape(step, *args)))

    cfg = get_config("qwen1.5-4b").reduced(**kw)
    tr, _ = dryrun.predict_train(
        cfg, dryrun.meta_mesh((1, 1)),
        {"tokens": torch.empty((4, 32), dtype=torch.int32, device="meta")})
    got = tr.memory()
    # the step counter: a 0-dim int32 argument of the reference's step,
    # a host int of the port's (``build_train_step``'s ``step``)
    assert got["argument_size_in_bytes"] + 4 == \
        want["argument_size_in_bytes"]
    # XLA's output is one tuple, its index table a pointer a leaf
    assert got["output_size_in_bytes"] + 8 * out_leaves == \
        want["output_size_in_bytes"]
    assert got["alias_size_in_bytes"] > 0 and got["temp_size_in_bytes"] > 0
    print("alias", got["alias_size_in_bytes"], want["alias_size_in_bytes"],
          "temp", got["temp_size_in_bytes"], want["temp_size_in_bytes"])


# ---------------------------------------------------------------------------
# run_cells and main
RECORD_KEYS = ["arch", "shape", "mesh", "n_devices", "policy", "kind",
               "seq_len", "global_batch", "compile_s", "flops_per_device",
               "bytes_per_device", "flops_per_device_hlo_raw",
               "bytes_per_device_hlo_raw", "memory", "collectives"]


def test_run_cells_writes_skips_and_fails(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).reduced())
    out = tmp_path / "records"
    dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                 "--mesh", "single", "--out", str(out)])
    path = out / "whisper-tiny__decode_32k__16x16.json"
    record = json.loads(path.read_text())
    assert list(record) == RECORD_KEYS
    assert (record["n_devices"], record["policy"], record["kind"]) == \
        (256, "tp", "decode")
    assert record["flops_per_device_hlo_raw"] is None
    assert record["memory"]["per_device_total_bytes"] > 0
    assert record["collectives"]["counts"]["all-reduce"] > 0
    mtime = path.stat().st_mtime_ns
    dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                 "--mesh", "single", "--out", str(out), "--skip-existing"])
    assert path.stat().st_mtime_ns == mtime
    assert "skip whisper-tiny__decode_32k__16x16 (exists)" in \
        capsys.readouterr().out

    def broken(*a, **k):
        raise ValueError("a forced failure")
    monkeypatch.setattr(dryrun, "lower_cell", broken)
    with pytest.raises(SystemExit) as exit_:
        dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                     "--mesh", "multi", "--out", str(out)])
    assert exit_.value.code == 1
    err = json.loads((out / "whisper-tiny__decode_32k__2x16x16.json")
                     .read_text())
    assert err["error"] == "ValueError: a forced failure"
    assert "a forced failure" in err["traceback"]
    assert len(err["traceback"]) <= 2000


# the reference's rules (``dryrun.py``: the policy, decode's fsdp -> tp
# for the dense, vlm, moe and audio families, model_in_batch for the
# recurrent families in train and prefill when the chips divide the
# batch), cell by cell: "tp" or "fsdp", "+mib" where the model axis
# joins the batch
EXPECTED = {
    **{arch: {"train_4k": ("fsdp", "fsdp"), "prefill_32k": ("fsdp", "fsdp"),
              "decode_32k": ("tp", "tp")}
       for arch in ("granite-moe-1b-a400m", "deepseek-v2-lite-16b",
                    "qwen2-vl-72b", "command-r-35b", "qwen1.5-4b",
                    "mistral-nemo-12b", "nemotron-4-15b", "whisper-tiny")},
    **{arch: {"train_4k": ("fsdp+mib", "fsdp"),
              "prefill_32k": ("fsdp", "fsdp"), "decode_32k": ("fsdp", "fsdp"),
              "long_500k": ("fsdp", "fsdp")}
       for arch in ("zamba2-1.2b", "xlstm-1.3b")},
}


def test_policy_and_model_in_batch_follow_the_reference_table():
    cells = 0
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        assert sorted(applicable_shapes(cfg)) == sorted(EXPECTED[arch])
        for shape_name in applicable_shapes(cfg):
            spec = SHAPES[shape_name]
            for multi, want in zip((False, True),
                                   EXPECTED[arch][shape_name]):
                mib = dryrun.model_in_batch(cfg, spec, 512 if multi else 256)
                got = dryrun.cell_policy(cfg, spec.kind) + \
                    ("+mib" if mib else "")
                assert got == want, (arch, shape_name, multi)
                cells += 1
    assert cells == 64


# ---------------------------------------------------------------------------
# the flash wrappers on meta
def test_flash_wrappers_on_meta_launch_nothing():
    before = (fa_kernel.flash_attention.launches,
              fd_kernel.flash_decode.launches)
    q = torch.empty(2, 8, 256, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 4, 512, 64, dtype=torch.bfloat16, device="meta")
    with FlopCounter() as counted:
        o = fa_kernel.flash_attention(q, k, k, causal=True)
    assert (o.shape, o.dtype, o.device.type) == (q.shape, q.dtype, "meta")
    with FlopCounter() as plain:
        fa_kernel.flash_attention_plain(q, k, k, causal=True)
    assert (counted.flops, counted.bytes) == (plain.flops, plain.bytes) \
        and counted.flops > 0
    qd = torch.empty(2, 8, 128, device="meta")
    kd = torch.empty(2, 2, 1024, 128, dtype=torch.bfloat16, device="meta")
    o, lse = fd_kernel.flash_decode(qd, kd, kd)
    assert (o.shape, o.dtype, lse.shape, lse.dtype) == \
        ((2, 8, 128), torch.float32, (2, 8), torch.float32)
    assert (fa_kernel.flash_attention.launches,
            fd_kernel.flash_decode.launches) == before
    # whisper's 1,500 frames miss the 256-row blocks on meta as on the card
    frames = torch.empty(1, 6, 1500, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match=r"not divisible by \(256, 256\)"):
        fa_kernel.flash_attention(frames, frames, frames, causal=False)
    with pytest.raises(ValueError, match="not divisible"):
        fd_kernel.flash_decode(qd, kd[:, :, :1000], kd[:, :, :1000])
    bad = torch.empty(1, 2, 256, 48, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head dim"):
        fa_kernel.flash_attention(bad, bad, bad)
