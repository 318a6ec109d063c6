"""Replay one run's MoE expert choices in another run of the port, and
the tests of that replay (``RouteReplay`` serves
``tests/test_torch_moe.py`` and the card test in
``tests/test_torch_cuda.py``; it imports no JAX).

In bf16 compute two runs (the two packages, or the CPU and the card)
round the router's input at other places, so where two experts' gates
nearly tie, the runs can pick different ones; one such flip moves that
token's output by a fraction of its size, far past any rounding
tolerance.  A :class:`RouteReplay` records the first run's ``_router``
results (ids and gates, in call order) and makes the port's
``_router`` take the recorded ids, with its own gates at them, so the
rest of the two paths compares at the rounding tolerance.  Every choice
the port would have made otherwise is checked: under ``exact`` it must
be the recorded one; otherwise, where it differs, the recorded gates of
the experts swapped must lie within ``FLIP_GAP`` (relative) of each
other: a near-tie that a few bf16 steps of the logits can reorder.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch


class RouteReplay:
    FLIP_GAP = 2 ** -5

    def __init__(self, exact: bool):
        self.records: list[tuple[np.ndarray, np.ndarray]] = []
        self.flips: list[float] = []
        self.exact = exact

    def record(self, topi, gates) -> None:
        self.records.append((np.asarray(topi), np.asarray(gates)))

    def recording(self, inner):
        """A port ``_router`` that records what ``inner`` returns."""
        def router(p, xt, cfg):
            out = inner(p, xt, cfg)
            self.record(out[1].cpu().numpy(), out[2].cpu().numpy())
            return out
        return router

    def replaying(self, inner):
        """A port ``_router`` that returns the recorded ids, in order."""
        def router(p, xt, cfg):
            _, topi, gates = inner(p, xt, cfg)
            want_i, want_g = self.records.pop(0)
            self._check(topi.cpu().numpy(), want_i, want_g)
            ids = torch.from_numpy(want_i.astype(np.int64)).to(topi.device)
            topv = gates.gather(1, ids)
            if cfg.moe_renorm:
                topv = topv / topv.sum(-1, keepdim=True)
            return topv, ids, gates
        return router

    def _check(self, topi, want_i, want_g) -> None:
        if self.exact:
            np.testing.assert_array_equal(topi, want_i)
            return
        for t in range(topi.shape[0]):
            mine, want = set(topi[t].tolist()), set(want_i[t].tolist())
            if mine == want:
                continue
            swapped = want_g[t][sorted(want ^ mine)]
            gap = float(swapped.max() - swapped.min()) / float(swapped.max())
            self.flips.append(gap)
            assert gap <= self.FLIP_GAP, (t, sorted(mine), sorted(want),
                                          gap)

    def done(self) -> None:
        assert not self.records, f"{len(self.records)} routes unused"


# ---------------------------------------------------------------------------
class _Cfg:
    top_k = 2
    moe_renorm = True


def _inner(ids, gates):
    """A ``_router`` returning fixed ids and gates."""
    def router(p, xt, cfg):
        g = torch.tensor(gates)
        return g.gather(1, torch.tensor(ids)), torch.tensor(ids), g
    return router


GATES = [[0.40, 0.301, 0.299, 0.0], [0.1, 0.2, 0.3, 0.4]]


def test_exact_replay_refuses_another_choice():
    routes = RouteReplay(exact=True)
    routes.record(np.array([[0, 1], [3, 2]]), np.array(GATES))
    router = routes.replaying(_inner([[0, 2], [3, 2]], GATES))
    with pytest.raises(AssertionError):
        router(None, None, _Cfg)


def test_near_tie_flip_is_allowed_and_the_recorded_ids_returned():
    routes = RouteReplay(exact=False)
    routes.record(np.array([[0, 1], [3, 2]]), np.array(GATES))
    # the run itself would take expert 2 (gate 0.299) for 1 (0.301)
    topv, ids, gates = routes.replaying(_inner([[0, 2], [3, 2]], GATES))(
        None, None, _Cfg)
    assert ids.tolist() == [[0, 1], [3, 2]]
    np.testing.assert_allclose(topv.numpy(), [[0.4 / 0.701, 0.301 / 0.701],
                                              [0.4 / 0.7, 0.3 / 0.7]],
                               rtol=1e-6)
    assert len(routes.flips) == 1 and routes.flips[0] < RouteReplay.FLIP_GAP
    routes.done()


def test_far_flip_is_refused():
    routes = RouteReplay(exact=False)
    routes.record(np.array([[0, 1], [3, 2]]), np.array(GATES))
    router = routes.replaying(_inner([[0, 3], [3, 2]], GATES))
    with pytest.raises(AssertionError):
        router(None, None, _Cfg)                # 0.301 against 0.0


def test_recording_then_done_counts_unused_routes():
    routes = RouteReplay(exact=True)
    router = routes.recording(_inner([[0, 1], [3, 2]], GATES))
    router(None, None, _Cfg)
    assert len(routes.records) == 1
    with pytest.raises(AssertionError, match="1 routes unused"):
        routes.done()
