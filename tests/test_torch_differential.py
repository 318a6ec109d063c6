"""Differential task-graph fuzzing inside repro_torch: seven paths, one answer.

The port of ``tests/test_differential.py``.  Every pinned seed of
``repro_torch.fuzz_graphs.SEEDS`` generates the reference's random task
program (mixed footprints, overlapping regions, firstprivate indices,
mixed dtypes, uneven waves) and replays it on the CPU on

* ``sequential``                — the eager oracle,
* ``staged``                    — wavefront vmap batching,
* ``sharded``                   — the sharded executor with no mesh (the
  staged dispatch plus owner-computes accounting),
* ``host``                      — master + four worker threads,
* ``staged`` + ``kernel_backend="pallas"`` — ``_gemm`` groups through
  ``matmul_batched``'s plain version, every other body ``no_kernel``,
* ``staged`` + ``dep_manager="sharded"`` under ``dep_pump="sync"`` and
  ``"threaded"``.

On the CPU every path is bit-identical to the oracle: each body runs the
same torch ops alone, under vmap or batched, and the batched 8x8 products
gave the single products' bits on every seed (measured gap 0).  The
dependence counts are identical across the staged paths, and the two
pumps put identical wire counts on the MPB rings.  The reference's
outputs and counts are ``tests/test_torch_differential_ref.py``'s.

A failing seed replays exactly:
``PYTHONPATH=src python -m repro_torch.fuzz_graphs --device cpu <seed>``.
"""
from __future__ import annotations

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch import fuzz_graphs
from repro_torch.fuzz_graphs import SEEDS, compare_paths, generate, run_case


def test_seed_corpus_is_pinned():
    assert SEEDS == tuple(range(60))


def test_generator_covers_the_op_mix():
    ops, sizes = set(), set()
    for seed in SEEDS:
        steps = generate(seed)
        sizes.add(len(steps))
        ops.update(s[0] for s in steps)
    assert ops == set(fuzz_graphs._OPS)
    assert len(sizes) > 3


@pytest.mark.parametrize("seed", SEEDS)
def test_all_paths_agree(seed):
    runs = compare_paths(seed, "cpu")
    pallas = runs["staged+pallas"][1]
    # every group either launched the kernel or took a named fallback
    assert pallas.kernel_dispatches + pallas.kernel_fallbacks > 0
    sync = runs["staged+sharded-sync"][1]
    assert sync.dep_messages > 0
    assert sum(sync.manager_admissions) >= sync.tasks_spawned
    sharded = runs["sharded"][1]
    assert sharded.cross_home_bytes + sharded.local_home_bytes > 0
    assert sharded.sharded_dispatches == 0          # no mesh installed


def test_gemm_kernel_path_fuses_somewhere_in_corpus():
    """Across the first 12 seeds the registered ``_gemm`` groups really
    take the wave-kernel path (not 100% fallback)."""
    fused = 0
    for seed in SEEDS[:12]:
        _, stats = run_case(seed, "cpu", kernel_backend="pallas")
        fused += stats.kernel_dispatches
    assert fused > 0


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(min_value=1000, max_value=10_000_000))
def test_property_unpinned_seeds(seed):
    """The same contract on seeds outside the pinned corpus."""
    runs = compare_paths(seed, "cpu")
    stats = runs["staged+pallas"][1]
    assert stats.kernel_dispatches + stats.kernel_fallbacks > 0
