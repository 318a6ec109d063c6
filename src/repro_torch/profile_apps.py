"""Where the paper apps' wall time goes on the card.

Runs each app at the §4.2 sizes (``apps.PAPER_SIZES``) on the staged
executor with the wave kernels — a warm-up run, a timed run, and a run
under ``torch.profiler`` with CPU and CUDA activities — and prints one
JSON line per app:

* ``wall_s`` — spawn to verified result on the host clock, ending in a
  synchronize; ``spawn_s``/``barrier_s``/``wait_s`` from ``RuntimeStats``
  (host time inside task initiation and the staged dispatch);
* ``device_busy_ms`` — the sum of the CUDA kernel and memory-op times of
  a third, profiled run, and ``idle_share`` = 1 - busy / wall (None when
  the trace holds no device events);
* ``top`` — device time by kernel name, largest first, and
  ``host_top_profiled`` — host self time by operator in the profiled run
  (inflated by the profiler; read it for proportions only).

Usage, on a machine with a CUDA device::

    PYTHONPATH=src python -m repro_torch.profile_apps [--app NAME ...]
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType

from . import apps
from .core import RuntimeConfig, TaskRuntime


def _device_ms(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return v / 1e3
    return 0.0


def _run(name: str, device: str) -> tuple[float, object]:
    rt = TaskRuntime(RuntimeConfig(executor="staged", kernel_backend="pallas",
                                   device=device))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    apps.APPS[name](rt, **apps.PAPER_SIZES[name])     # self-verifies
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rt.shutdown()
    return wall, rt.stats()


def profile_app(name: str, device: str = "cuda", top: int = 8) -> dict:
    """One warm-up run, one timed run, one run under the profiler (whose
    host overhead would distort the timed run's wall)."""
    _run(name, device)
    wall, stats = _run(name, device)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _run(name, device)
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

    return dict(app=name, size=apps.PAPER_SIZES[name], wall_s=wall,
                spawn_s=stats.spawn_time_s, barrier_s=stats.barrier_time_s,
                wait_s=stats.wait_time_s, device_trace=bool(by_name),
                device_busy_ms=busy,
                idle_share=1.0 - busy / (wall * 1e3) if by_name else None,
                top=ranked(by_name), host_top_profiled=ranked(host))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--app", action="append", choices=sorted(apps.APPS),
                        help="app to profile (repeatable; default: all)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        parser.error("needs a CUDA device")
    print(torch.cuda.get_device_name(0), flush=True)
    for name in args.app or list(apps.APPS):
        print(json.dumps(profile_app(name)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
