"""The fuzz corpus on repro_torch against the same corpus on repro.

For every pinned seed, the reference's generator (``tests/fuzz_graphs.py``)
and the port's (``repro_torch.fuzz_graphs``) must give the same program,
and the port's runs (on the CPU) must match the reference's:

* outputs within ``RTOL``/``ATOL`` of ``repro``'s sequential outputs (the
  int32 array bit for bit).  The reference's bodies run under ``jax.jit``,
  where XLA contracts ``c + alpha * a`` into one fused multiply-add; torch
  rounds the product and the sum apart.  Over the 60 seeds the largest
  gap measured is 1.9e-6 (one f32 ulp at magnitudes 16-32), so
  1e-5 + 1e-5·|x| keeps a fivefold margin and still catches a wrong tile;
* ``tasks_spawned``, ``deps_found`` and ``blocks_walked`` equal to
  ``repro``'s staged counts, exactly;
* the kernel-dispatch mapping, the designed deviation of the wave
  registry: the reference lowers any eligible body into its fused grid,
  the port launches only registered bodies (here ``_gemm``) and every
  other eligible group falls back as ``no_kernel``.  So the fallbacks
  by reason other than ``no_kernel`` equal the reference's other than
  ``lowering_failed``, and ``port.kernel_dispatches + port.no_kernel ==
  ref.kernel_dispatches + ref.lowering_failed``;
* on the ``sharded`` path (no mesh), the owner-computes accounting
  (``cross_home_bytes``, ``local_home_bytes``) and the dispatch and
  residency counts equal ``repro``'s.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

import fuzz_graphs as ref_fuzz
from repro.obs import InMemoryTracker as RefTracker
from repro_torch import fuzz_graphs
from repro_torch.obs import InMemoryTracker

RTOL = ATOL = 1e-5


def _reasons(tracker) -> Counter:
    """Groups by dispatch decision: ``"fused"`` or the fallback reason."""
    return Counter(e.data["reason"] or "fused"
                   for e in tracker.events_of("kernel_dispatch"))


def test_generators_agree_on_every_seed():
    assert fuzz_graphs.SEEDS == ref_fuzz.SEEDS
    assert (fuzz_graphs.TILE, fuzz_graphs.GRID) == \
        (ref_fuzz.TILE, ref_fuzz.GRID)
    for seed in fuzz_graphs.SEEDS:
        assert fuzz_graphs.generate(seed) == ref_fuzz.generate(seed)


@pytest.mark.parametrize("seed", fuzz_graphs.SEEDS)
def test_seed_matches_reference(seed):
    ref_out, _ = ref_fuzz.run_case(seed, executor="sequential")
    ref_trk = RefTracker()
    _, ref_st = ref_fuzz.run_case(seed, executor="staged",
                                  kernel_backend="pallas", tracker=ref_trk)
    seq_out, _ = fuzz_graphs.run_case(seed, "cpu", executor="sequential")
    trk = InMemoryTracker()
    out, st = fuzz_graphs.run_case(seed, "cpu", kernel_backend="pallas",
                                   tracker=trk)
    for got in (seq_out, out):
        for name, want in ref_out.items():
            assert got[name].dtype == want.dtype, name
            if want.dtype == np.int32:
                np.testing.assert_array_equal(got[name], want)
            else:
                np.testing.assert_allclose(got[name], want, rtol=RTOL,
                                           atol=ATOL, err_msg=name)
    for fld in ("tasks_spawned", "deps_found", "blocks_walked", "waves",
                "grouped_dispatches"):
        assert getattr(st, fld) == getattr(ref_st, fld), fld
    port, ref = _reasons(trk), _reasons(ref_trk)
    assert sum(port.values()) == sum(ref.values()) == \
        st.kernel_dispatches + st.kernel_fallbacks
    assert port["fused"] == st.kernel_dispatches
    assert ref["fused"] == ref_st.kernel_dispatches
    others = lambda c, drop: {k: v for k, v in c.items()
                              if k not in ("fused", drop)}
    assert others(port, "no_kernel") == others(ref, "lowering_failed")
    assert port["fused"] + port["no_kernel"] == \
        ref["fused"] + ref["lowering_failed"]


@pytest.mark.parametrize("seed", fuzz_graphs.SEEDS)
def test_sharded_path_matches_reference(seed):
    """The reference's ``sharded`` fuzz path (no mesh): the port's
    owner-computes accounting and dispatch counts equal ``repro``'s, and
    its outputs are the port's sequential run's, bit for bit."""
    _, ref_st = ref_fuzz.run_case(seed, executor="sharded")
    seq_out, _ = fuzz_graphs.run_case(seed, "cpu", executor="sequential")
    out, st = fuzz_graphs.run_case(seed, "cpu", executor="sharded")
    for fld in ("cross_home_bytes", "local_home_bytes", "sharded_dispatches",
                "owner_overrides", "tile_moves", "bytes_moved",
                "bytes_staged", "grouped_dispatches", "waves", "deps_found"):
        assert getattr(st, fld) == getattr(ref_st, fld), fld
    for name, want in seq_out.items():
        np.testing.assert_array_equal(out[name], want, err_msg=name)
