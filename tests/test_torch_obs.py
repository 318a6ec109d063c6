"""The port's trace tooling (``repro_torch.obs``: chrome, summary, the CLI
and ``profile_session``) against the JAX package's.

* One event list, from a staged run of the port with the wave kernels on
  the CPU (and the same records read by the reference): the port's
  ``chrome_trace``, ``slowest_waves``, ``mode_latency`` and
  ``summary_table`` equal the reference's.
* The CLI (``python -m repro_torch.obs summary|chrome``) round-trips a
  JSONL trace through a subprocess, and its output equals the
  reference CLI's on the same file.
* ``profile_session``: False for a falsy ``logdir``; a Chrome trace under
  ``logdir`` holding the wave ranges of a profiled run, also when the
  body raises; a request for CUDA activity raises where there is none.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import repro.obs as ref_obs
from repro_torch import apps
from repro_torch.obs import (Event, InMemoryTracker, JsonlTracker,
                             chrome_trace, export_chrome_trace, load_jsonl,
                             mode_latency, profile_session,
                             profiler_available, slowest_waves,
                             summary_table)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _events() -> list[Event]:
    trk = InMemoryTracker()
    apps.run_app("cholesky", "staged", device="cpu", tracker=trk,
                 kernel_backend="pallas", app_kwargs=dict(n=128, tile=32))
    return trk.events


@pytest.fixture(scope="module")
def both():
    """The port's events and the same records as reference events."""
    port = _events()
    ref = [ref_obs.Event.from_record(json.loads(e.to_json())) for e in port]
    return port, ref


def test_chrome_trace_equals_reference(both):
    port, ref = both
    doc = chrome_trace(port)
    assert doc == ref_obs.chrome_trace(ref)
    evs = json.loads(json.dumps(doc))["traceEvents"]
    waves = [e for e in evs if e["ph"] == "X" and
             e["name"].startswith("wave ")]
    assert len(waves) == len([e for e in port if e.kind == "wave_close"])
    ts = [e["ts"] for e in evs if e["ph"] != "M"]
    assert ts == sorted(ts) and min(ts) >= 0


@pytest.mark.parametrize("top", [1, 3, 100])
def test_summaries_equal_reference(both, top):
    port, ref = both
    assert [e.to_record() for e in slowest_waves(port, top)] == \
        [e.to_record() for e in ref_obs.slowest_waves(ref, top)]
    assert mode_latency(port) == ref_obs.mode_latency(ref)
    assert summary_table(port, top) == ref_obs.summary_table(ref, top)
    assert set(mode_latency(port)) == {"pallas", "vmap", "jit"}


def test_summary_of_no_events():
    assert mode_latency([]) == {}
    assert summary_table([]) == ref_obs.summary_table([])


def test_export_from_jsonl_path(tmp_path):
    trace = tmp_path / "t.jsonl"
    trk = JsonlTracker(str(trace))
    apps.run_app("matmul", "staged", device="cpu", tracker=trk,
                 app_kwargs=dict(n=64, tile=32))
    trk.close()
    out = tmp_path / "t.json"
    doc = export_chrome_trace(trace, out)
    assert json.loads(out.read_text())["traceEvents"] == doc["traceEvents"]
    assert doc == ref_obs.chrome_trace(ref_obs.load_jsonl(str(trace)))
    assert [e.to_record() for e in load_jsonl(str(trace))] == \
        [e.to_record() for e in ref_obs.load_jsonl(str(trace))]


def _cli(package: str, *args) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": "src"}
    return subprocess.run([sys.executable, "-m", package, *args],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=300, env=env)


def test_cli_round_trips(tmp_path):
    trace = tmp_path / "t.jsonl"
    trk = JsonlTracker(str(trace))
    apps.run_app("jacobi", "staged", device="cpu", tracker=trk,
                 kernel_backend="pallas",
                 app_kwargs=dict(n=128, tile=32, iters=2))
    trk.close()
    out = _cli("repro_torch.obs", "summary", str(trace), "--top", "3")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == summary_table(load_jsonl(str(trace)), 3)
    ref = _cli("repro.obs", "summary", str(trace), "--top", "3")
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert out.stdout == ref.stdout
    chrome_out = tmp_path / "t.json"
    out = _cli("repro_torch.obs", "chrome", str(trace), "-o",
               str(chrome_out))
    assert out.returncode == 0, out.stderr[-2000:]
    doc = json.loads(chrome_out.read_text())
    assert doc == chrome_trace(load_jsonl(str(trace)))
    assert f"({len(doc['traceEvents'])} trace events)" in out.stdout


def test_profile_session_none_yields_false():
    for logdir in (None, ""):
        with profile_session(logdir) as prof:
            assert prof is False


def test_profile_session_writes_the_wave_ranges(tmp_path):
    """A staged run with ``profile_waves=True`` inside a session: the
    Chrome trace under ``logdir`` holds one ``bddt/staged/wave<i>``
    range per wave, on the CPU where there is no card."""
    assert profiler_available()
    with profile_session(tmp_path / "prof", cuda=False) as prof:
        st = apps.run_app("matmul", "staged", device="cpu",
                          profile_waves=True, tracker="memory",
                          app_kwargs=dict(n=64, tile=32))
    assert prof.trace_path.parent == tmp_path / "prof"
    names = [e.get("name", "") for e in
             json.loads(prof.trace_path.read_text())["traceEvents"]]
    waves = {n for n in names if n.startswith("bddt/staged/wave")}
    assert len(waves) == st.waves == 2


def test_profile_session_writes_its_trace_when_the_body_raises(tmp_path):
    with pytest.raises(ValueError, match="body"):
        with profile_session(tmp_path, cuda=False) as prof:
            with torch.profiler.record_function("bddt/partial"):
                torch.ones(4).sum()
            raise ValueError("the body failed")
    names = [e.get("name") for e in
             json.loads(prof.trace_path.read_text())["traceEvents"]]
    assert "bddt/partial" in names


def test_profile_session_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with profile_session(tmp_path, cuda=True):
            pass
    assert not list(tmp_path.iterdir())
