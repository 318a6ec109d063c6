"""Pipeline parallelism as a BDDT task graph (the JAX package's
``core/pipeline.py``).

The paper's thesis is that declared footprints + dynamic dependence
analysis give you the schedule for free.  Pipeline-parallel training is a
perfect showcase: forward/backward microbatch steps are *tasks*, stage
activations/gradients are *blocks*, per-stage weight gradients are INOUT
accumulators — run the BDDT analysis over those footprints and the
classic 1F1B schedule *emerges* from greedy backward-first scheduling of
the discovered DAG, bubbles and all.  No pipeline-specific scheduler is
written anywhere.

:func:`derive_pipeline_schedule` builds the DAG with the same
``DependenceAnalyzer`` machinery the tile programs use and extracts a
per-clock timetable; its blocks live on the ``meta`` device, so deriving
a schedule allocates no tensor anywhere.  :func:`pipeline_step` executes
a timetable on a mesh of :class:`~repro_torch.dist.LogicalDevice`: where
the reference runs every task SPMD under ``shard_map`` (each stage
evaluates every body and masks the result, and each clock does a
``ppermute``), this single controller runs each task only on the
logical device of its stage, and carries each forward output to the
next stage and each input gradient to the previous one as a copy
(counted on the function: ``pipeline_step.hops`` and
``pipeline_step.hopped_bytes``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import dist
from .blocks import BlockArray, In, InOut, Out
from .deps import DependenceAnalyzer
from .graph import DescriptorPool

__all__ = ["derive_pipeline_schedule", "schedule_table", "pipeline_step",
           "PipeTask"]


@dataclass(frozen=True)
class PipeTask:
    kind: str          # "F" | "B"
    stage: int
    micro: int

    def __repr__(self):
        return f"{self.kind}{self.stage}.{self.micro}"


def _noop(*args):  # task body placeholder (schedule derivation only)
    return torch.zeros((1, 1), device="meta")


def derive_pipeline_schedule(n_stages: int, n_micro: int
                             ) -> list[list[PipeTask | None]]:
    """Run BDDT dependence analysis over the pipeline's footprints and
    greedily schedule: each stage is a worker; backward tasks take
    priority (1F1B memory behaviour).  Returns the per-clock timetable:
    ``table[t][s]`` is the task stage ``s`` runs at clock ``t`` (None =
    bubble)."""
    analyzer = DependenceAnalyzer()
    pool = DescriptorPool(capacity=4 * n_stages * n_micro + 16)

    # blocks: activations A[s][m], gradients G[s][m], weight grads dW[s];
    # footprints only, so they hold no data (meta: nothing is allocated)
    acts = BlockArray((n_stages, n_micro), (1, 1), name="A", device="meta")
    grads = BlockArray((n_stages, n_micro), (1, 1), name="G", device="meta")
    wgrad = BlockArray((n_stages, 1), (1, 1), name="dW", device="meta")

    tasks: dict[int, PipeTask] = {}
    edges: dict[int, list[int]] = {}
    indeg: dict[int, int] = {}

    def spawn(kind, s, m, args):
        td = pool.acquire(_noop, args, name=f"{kind}{s}.{m}")
        deps = analyzer.analyze(td)
        tasks[td.tid] = PipeTask(kind, s, m)
        edges[td.tid] = []
        indeg[td.tid] = len(deps)
        for d in deps:
            edges[d.tid].append(td.tid)

    for m in range(n_micro):
        for s in range(n_stages):
            args = [Out(acts[s, m])]
            if s > 0:
                args.append(In(acts[s - 1, m]))
            spawn("F", s, m, args)
    for m in range(n_micro):
        for s in reversed(range(n_stages)):
            args = [In(acts[s, m]), Out(grads[s, m]),
                    InOut(wgrad[s, 0])]        # accumulation serializes
            if s < n_stages - 1:
                args.append(In(grads[s + 1, m]))
            spawn("B", s, m, args)

    # greedy list scheduling: one slot per stage per clock, backward first
    table: list[list[PipeTask | None]] = []
    ready = {tid for tid, d in indeg.items() if d == 0}
    done: set[int] = set()
    while len(done) < len(tasks):
        row: list[PipeTask | None] = [None] * n_stages
        fired = []
        for s in range(n_stages):
            cands = [tid for tid in ready if tasks[tid].stage == s]
            if not cands:
                continue
            # 1F1B: prefer backward, then lowest microbatch id
            cands.sort(key=lambda tid: (tasks[tid].kind != "B",
                                        tasks[tid].micro))
            pick = cands[0]
            row[s] = tasks[pick]
            fired.append(pick)
            ready.discard(pick)
        if not fired:
            raise RuntimeError("pipeline schedule deadlock")
        for tid in fired:
            done.add(tid)
            for nxt in edges[tid]:
                indeg[nxt] -= 1
                if indeg[nxt] == 0:
                    ready.add(nxt)
        table.append(row)
    return table


def schedule_table(table) -> str:
    """Pretty-print the timetable (stages = rows, clocks = columns)."""
    n_stages = len(table[0])
    lines = []
    for s in range(n_stages):
        cells = [f"{table[t][s]!r:>7s}" if table[t][s] else "      ."
                 for t in range(len(table))]
        lines.append(f"stage{s} |" + "".join(cells))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
def _tree_map(fn, t, *rest):
    """``fn`` over the leaves of a tensor or a nested dict of tensors (and
    the same leaves of ``rest``, trees of the same structure)."""
    if isinstance(t, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in t.items()}
    return fn(t, *rest)


def _first_leaf(t):
    return _first_leaf(next(iter(t.values()))) if isinstance(t, dict) else t


def _hop(t, dst):
    """``t`` as the next (or previous) stage's logical device ``dst``
    receives it: always a copy, on ``dst``'s torch device, counted in
    ``pipeline_step.hops`` and ``pipeline_step.hopped_bytes``."""
    pipeline_step.hops += 1
    pipeline_step.hopped_bytes += t.numel() * t.element_size()
    dist.record_exchange("collective-permute", t.numel() * t.element_size(),
                         2)
    return t.to(dst.torch_device, copy=True)


def pipeline_step(stage_fwd, stage_bwd, params, micro_inputs, *, mesh,
                  stage_axis: str, n_stages: int):
    """Execute a derived timetable, each task on its stage's device.

    ``stage_fwd(w, x) -> y`` / ``stage_bwd(w, x, g_out) -> (g_in, dw)``
    are the per-stage task bodies (``stage_bwd`` differentiates with
    ``torch.func.vjp`` or ``torch.autograd.grad``); ``params``: (S, ...)
    stacked stage weights, a tensor or a nested dict of them;
    ``micro_inputs``: (M, B, d) fed to stage 0.  The last stage's output
    gradient is all ones.  Stage ``s`` is the ``s``-th logical device of
    ``mesh`` along ``stage_axis`` (the first along any other axis, over
    which the reference computes the same values): its weights,
    the activations and gradients it receives and its weight gradient
    live there.  Forward tasks run without autograd; a stage's received
    activation and gradient are dropped after its backward task, so no
    microbatch outlives its B.  Returns the accumulated weight-grad
    stack (S, ...), assembled on the device of ``params`` (the
    reference leaves it sharded over ``stage_axis``); each stage
    accumulates in the weights' dtype in microbatch order.
    """
    if stage_axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no axis "
                         f"{stage_axis!r}")
    if mesh.shape[stage_axis] != n_stages:
        raise ValueError(f"{n_stages} stages on a {stage_axis!r} axis of "
                         f"{mesh.shape[stage_axis]} devices")
    lead = _first_leaf(params)
    if lead.shape[0] != n_stages:
        raise ValueError(f"params stack {lead.shape[0]} stages, "
                         f"expected {n_stages}")
    n_micro = micro_inputs.shape[0]
    table = derive_pipeline_schedule(n_stages, n_micro)
    index = [0] * mesh.devices.ndim
    devs = []
    for s in range(n_stages):
        index[mesh.axis_names.index(stage_axis)] = s
        devs.append(mesh.devices[tuple(index)])

    ws = [_tree_map(lambda a: a[s].to(devs[s].torch_device), params)
          for s in range(n_stages)]
    micros = micro_inputs.to(devs[0].torch_device)
    acts_in: list[dict[int, torch.Tensor]] = [{} for _ in devs]  # received x
    gr_in: list[dict[int, torch.Tensor]] = [{} for _ in devs]    # received g
    dw = [_tree_map(torch.zeros_like, w) for w in ws]

    for row in table:
        for s, task in enumerate(row):
            if task is None:
                continue
            m = task.micro
            if task.kind == "F":
                x = micros[m] if s == 0 else acts_in[s][m]
                with torch.no_grad():
                    y = stage_fwd(ws[s], x)
                if s + 1 < n_stages:
                    acts_in[s + 1][m] = _hop(y, devs[s + 1])
                continue
            x = micros[m] if s == 0 else acts_in[s].pop(m)
            g_out = torch.ones_like(x) if s == n_stages - 1 \
                else gr_in[s].pop(m)
            g_in, dw_m = stage_bwd(ws[s], x, g_out)
            dw[s] = _tree_map(lambda a, u: a + u, dw[s], dw_m)
            if s > 0:
                gr_in[s - 1][m] = _hop(g_in, devs[s - 1])
    return _tree_map(lambda *a: torch.stack([x.to(lead.device) for x in a]),
                     *dw)


pipeline_step.hops = 0
pipeline_step.hopped_bytes = 0
