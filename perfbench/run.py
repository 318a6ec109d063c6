"""Run one cell of ``BENCHMARK.json`` on this machine's card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: whether
the timed path's output was correct, the requests or steps attempted and
failed, the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics (``--trace 1``), the device, and last the numbers compared with
their limits, which also close standard error.  Exits with another code
than 0, and prints no result, when the card or the program is missing,
or when the process holds the JAX stack or the JAX package.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own kernels build into ``build/repro_torch``)."""
    base = REPO / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    for path in (REPO / "src", REPO):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))

    import torch
    from perfbench import common, harness

    man = common.manifest()
    chips = {w["name"]: w["chips"] for w in man["workloads"]}
    if args.workload not in chips:
        print(f"perfbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < chips[args.workload]:
        print(f"perfbench: {args.workload} needs {chips[args.workload]} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)    # one process, few threads: steadier hosts
    out = harness.run_cell(args.workload, seed=args.seed,
                           seconds=args.seconds, trace=bool(args.trace),
                           device=torch.device("cuda", 0), t_start=T_START,
                           man=man)
    bad = common.forbidden_modules()
    if bad:
        print(f"perfbench: the process holds {bad}", file=sys.stderr)
        return 4
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": out["device"]}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["readings"] = out["readings"]
    line["checks"] = out["checks"]
    for name, v in out["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
