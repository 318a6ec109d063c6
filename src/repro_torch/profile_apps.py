"""Where the paper apps' wall time goes on the card.

Runs each app at the §4.2 sizes (``apps.PAPER_SIZES``) on the staged
executor with the wave kernels (or, with ``--executor sharded``, on the
sharded executor, under ``--mesh N``: no mesh for 0, a one-device mesh
for 1, N logical devices on the card above) — a warm-up run, a timed
run, and a run under ``torch.profiler`` with CPU and CUDA activities —
and prints one JSON line per app:

* ``wall_s`` — spawn to verified result on the host clock, ending in a
  synchronize; ``spawn_s``/``barrier_s``/``wait_s`` from ``RuntimeStats``
  (host time inside task initiation and the staged dispatch);
* ``device_busy_ms`` — the sum of the CUDA kernel and memory-op times of
  a third, profiled run, and ``idle_share`` = 1 - busy / wall (None when
  the trace holds no device events);
* ``top`` — device time by kernel name, largest first, and
  ``host_top_profiled`` — host self time by operator in the profiled run
  (inflated by the profiler; read it for proportions only);
* ``gc_s``/``gc_collections`` — host seconds the timed run spent in
  Python's cyclic garbage collector, and its collections by generation;
* with ``--cprofile``, ``host_top_cprofile`` — host functions by their
  own time in a fourth run under ``cProfile`` (which inflates every
  Python call: read it for proportions only).

Usage, on a machine with a CUDA device::

    PYTHONPATH=src python -m repro_torch.profile_apps [--app NAME ...] \
        [--cprofile] [--executor staged|sharded] [--mesh N]
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import time

import torch
from torch.autograd import DeviceType

from . import apps, dist
from .core import RuntimeConfig, TaskRuntime


class GCTimer:
    """Host seconds spent in Python's cyclic garbage collector while the
    timer is installed (``with GCTimer() as t: ...; t.seconds``), and the
    collections by generation."""

    def __init__(self):
        self.seconds = 0.0
        self.collections = [0, 0, 0]
        self._t0 = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0
            self.collections[info["generation"]] += 1

    def __enter__(self) -> "GCTimer":
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)


def _device_ms(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return v / 1e3
    return 0.0


def mesh_of(n: int, device: str = "cuda"):
    """The mesh ``--mesh n`` names: None for 0, the one-device mesh for
    1, ``n`` logical devices on ``device`` above."""
    if n <= 0:
        return None
    if n == 1:
        return dist.single_device_mesh(device=device)
    return dist.Mesh(dist.logical_devices(n, device), ("data",))


def _run(name: str, device: str, executor: str = "staged", mesh: int = 0,
         **config) -> tuple[float, object]:
    m = mesh_of(mesh, device)
    with dist.use_mesh(m) if m is not None else contextlib.nullcontext():
        rt = TaskRuntime(RuntimeConfig(executor=executor,
                                       kernel_backend="pallas",
                                       device=device, **config))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        apps.APPS[name](rt, **apps.PAPER_SIZES[name])     # self-verifies
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rt.shutdown()
    return wall, rt.stats()


def profile_app(name: str, device: str = "cuda", top: int = 8,
                cprofile: bool = False, **config) -> dict:
    """One warm-up run, one timed run, one run under the profiler (whose
    host overhead would distort the timed run's wall), and with
    ``cprofile`` one under ``cProfile``.  ``config`` goes to
    :class:`RuntimeConfig`, apart from ``executor`` (``"staged"`` by
    default) and ``mesh`` (see :func:`mesh_of`)."""
    _run(name, device, **config)
    with GCTimer() as gct:
        wall, stats = _run(name, device, **config)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _run(name, device, **config)
    extra = {}
    if cprofile:
        import cProfile
        import pstats
        prof_c = cProfile.Profile()
        prof_c.runcall(_run, name, device, **config)
        st = pstats.Stats(prof_c)
        rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:2 * top]
        extra["host_top_cprofile"] = [
            dict(fn=f"{path.rsplit('/', 1)[-1]}:{line}:{fn}", calls=nc,
                 own_s=tt, cum_s=ct)
            for (path, line, fn), (_, nc, tt, ct, _) in rows]
    by_name: dict[str, float] = {}
    host: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + _device_ms(evt)
        else:
            host[evt.key] = host.get(evt.key, 0.0) + \
                evt.self_cpu_time_total / 1e3
    busy = sum(by_name.values())

    def ranked(d):
        return [dict(name=k[:80], ms=v) for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return dict(app=name, size=apps.PAPER_SIZES[name], config=config,
                wall_s=wall, spawn_s=stats.spawn_time_s,
                barrier_s=stats.barrier_time_s, wait_s=stats.wait_time_s,
                pump_wall_s=stats.pump_wall_s,
                sharded_dispatches=stats.sharded_dispatches,
                tile_moves=stats.tile_moves, bytes_moved=stats.bytes_moved,
                gc_s=gct.seconds,
                gc_collections=gct.collections, device_trace=bool(by_name),
                device_busy_ms=busy,
                idle_share=1.0 - busy / (wall * 1e3) if by_name else None,
                top=ranked(by_name), host_top_profiled=ranked(host), **extra)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--app", action="append", choices=sorted(apps.APPS),
                        help="app to profile (repeatable; default: all)")
    parser.add_argument("--cprofile", action="store_true",
                        help="add a run under cProfile (host functions)")
    parser.add_argument("--executor", choices=("staged", "sharded"),
                        default="staged")
    parser.add_argument("--mesh", type=int, default=0, metavar="N",
                        help="sharded only: 0 = no mesh, 1 = one-device "
                        "mesh, N > 1 = N logical devices on the card")
    args = parser.parse_args(argv)
    if args.mesh and args.executor != "sharded":
        parser.error("--mesh needs --executor sharded")
    if not torch.cuda.is_available():
        parser.error("needs a CUDA device")
    print(torch.cuda.get_device_name(0), flush=True)
    for name in args.app or list(apps.APPS):
        print(json.dumps(profile_app(name, cprofile=args.cprofile,
                                     executor=args.executor,
                                     mesh=args.mesh)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
