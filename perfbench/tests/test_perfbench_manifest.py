"""The manifest against the benchmark's contract, and every file a cell
names found by name."""
from __future__ import annotations

import importlib.util
import re

import pytest

from perfbench import common

MAN = common.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert all(not p.startswith("/") and ".." not in p for p in MAN["paths"])
    assert all(not w.startswith("/") and ".." not in w.split("/")
               for w in MAN["command"])


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in SOURCES


def test_names_distinct():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    found = common.cell_of(MAN, cell)
    assert found["traffic"]["kind"] in ("train", "serve")
    assert found["cell"]["limits"]
    for m in common.metrics_of(MAN, cell, False) + \
            common.metrics_of(MAN, cell, True):
        assert callable(common.reader(m["name"]))


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda e: e["name"])
def test_config_reduced_keys(conf):
    data = common.load_json(common.REPO / conf["file"])
    assert data["name"] == conf["name"]
    assert sorted(conf["reduced"]) == sorted(data["reduced"])
    assert set(data.get("published", {})) == set(conf["reduced"])
    for key in conf["reduced"]:
        assert data[key] != data["published"][key]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in common.metrics_of(MAN, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert common.metrics_of(MAN, cell, True)


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda e: e["name"])
def test_moves_is_reported_where_the_metric_is(metric):
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert metric["moves"] in e2e
    for cell in metric.get("workloads", CELLS):
        names = [m["name"] for m in common.metrics_of(MAN, cell, False)]
        assert metric["moves"] in names, (metric["name"], cell)


def test_layers_are_named_once():
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert layers <= {"trainer", "LLM server", "model step", "kernel",
                      "device"}


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in MAN["end_to_end"]}["setup_s"] \
        == 0.25


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda e: e["name"])
def test_config_reference_defines_the_interface(conf):
    data = common.load_json(common.REPO / conf["file"])
    ref = common.reference(data)
    assert ref.__name__ == \
        f"perfbench.reference.{data.get('reference', 'model')}"
    for name in common.REFERENCE_API:
        assert callable(getattr(ref, name, None)), name
    dims = ref.Dims(data)
    assert dims.vocab == data["vocab_size"]
    assert ref.weight_specs(dims)


PROGRAM_METRICS = [m for m in MAN["per_layer"]
                   if m["source"] in ("program_span", "program_counter")]


@pytest.mark.parametrize("metric", PROGRAM_METRICS, ids=lambda e: e["name"])
def test_program_metrics_list_cells_that_record_them(metric):
    """A reader of the program's spans or counters names its cells: a
    later cell of its kind, whose model has no such span, is not held to
    it.  Every kind's traced run records both
    (``test_perfbench_lookup.py``)."""
    assert metric["workloads"]
    for cell in metric["workloads"]:
        kind = common.cell_of(MAN, cell)["traffic"]["kind"]
        assert importlib.util.find_spec(f"perfbench.kinds.{kind}"), cell
