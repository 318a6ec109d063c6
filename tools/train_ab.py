"""Two source trees of the port against each other on one card: the
``[train]`` step (Mistral-NeMo-12B, 4 layers, B 2 x S 4,096), the
``[train_recurrent]`` steps (xLSTM-1.3B, Zamba2-1.2B) and the ``[mesh]``
train step (Granite-3.0-1B-A400M, ``fsdp`` on a (2, 2) mesh of logical
devices, B 4 x S 4,096) of ``chip_smoke.py``.

Each run is a process of its own that executes this checkout's
``chip_smoke.py`` as if it sat at the root of the tree, so that its
measurement functions import that tree's ``repro_torch``.  The trees run
in turns, first, second, second, first, and every line a run prints is
repeated with the run's label and index.  Unpack the tree to compare
first, for example the parent commit::

    mkdir -p build/parent && git archive HEAD~1 src | tar -x -C build/parent
    python tools/train_ab.py parent=build/parent change=.

Needs one card; TF32 is off, as ``chip_smoke.main`` sets it.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys
import types

REPO = pathlib.Path(__file__).resolve().parent.parent


def run_one(tree: pathlib.Path) -> None:
    """This checkout's ``chip_smoke.py``, rooted at ``tree``: its
    ``[train]``, ``[train_recurrent]`` and ``[mesh]`` train lines."""
    mod = types.ModuleType("chip_smoke")
    mod.__file__ = str(tree / "chip_smoke.py")
    sys.modules["chip_smoke"] = mod
    exec(compile((REPO / "chip_smoke.py").read_text(), mod.__file__,
                  "exec"), mod.__dict__)
    import torch
    if not torch.cuda.is_available():
        sys.exit("train_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = mod.card_line()
    print(f"[card] {card}", flush=True)
    mod.train_step(dev, card)
    torch.cuda.empty_cache()
    mod.train_recurrent(dev, card)
    torch.cuda.empty_cache()
    mod.mesh_train(dev, card, mod.logical_mesh(dev, mod.MESH_SHAPE))


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        run_one(pathlib.Path(argv[1]).resolve())
        return 0
    trees = [a.split("=", 1) for a in argv]
    if len(trees) != 2 or any(len(t) != 2 for t in trees):
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for i, (label, path) in enumerate(trees + trees[::-1]):
        proc = subprocess.run([sys.executable, __file__, "--one", path],
                              capture_output=True, text=True, cwd=REPO)
        for line in proc.stdout.splitlines():
            print(f"[ab {label} {i}] {line}", flush=True)
        if proc.returncode:
            print(f"[ab {label} {i}] exit {proc.returncode}: "
                  f"{proc.stderr[-3000:]}", flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
