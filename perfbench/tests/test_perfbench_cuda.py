"""The cells at small sizes on a card: each comes out correct through
the program's card path, serving in bf16 through the flash kernel and
training in f32 (at these widths bf16's rounding is a larger share of
the numbers than at the cells' own, which set the limits), and every
reader of the program's spans and counters finds them.  Skipped
where there is no CUDA device; decided in a fixture."""
from __future__ import annotations

import pytest

from perfbench import common
from perfbench.tests import small

CELLS = [w["name"] for w in common.manifest()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    from perfbench import harness
    serving = common.cell_of(common.manifest(), cell)["traffic"]["kind"] \
        == "serve"
    c = small.context(cell, seed=2**31 + 41,
                      compute="bfloat16" if serving else "float32")
    out = harness.run_cell(cell, seed=c["seed"], seconds=1.0, trace=True,
                           device=card, t_start=c["t_start"],
                           config=c["config"], traffic=c["traffic"])
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    # the readers of the program's spans and counters find them
    for m in common.metrics_of(common.manifest(), cell, True):
        if m["source"] in ("program_span", "program_counter"):
            assert m["name"] in out["metrics"], m["name"]
