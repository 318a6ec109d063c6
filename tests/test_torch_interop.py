"""repro_torch.interop round trips, and the port's import hygiene.

The port must stand alone: ``src/repro_torch/`` and ``chip_smoke.py``
import neither JAX nor anything of ``repro`` (an AST scan), and the
package imports in a process where both are unimportable.
"""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro
from repro_torch import RuntimeConfig, TaskRuntime
from repro_torch.interop import (blockarray_from_numpy,
                                 config_from_reference, tiles_to_numpy)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float64])
def test_tiles_round_trip_from_a_reference_blockarray(dtype):
    x = np.random.default_rng(5).standard_normal((8, 12)).astype(dtype)
    ref_rt = repro.TaskRuntime(repro.RuntimeConfig(executor="staged"))
    ref = ref_rt.from_array(x, (4, 6))
    tiles = {idx: np.asarray(ref.get_tile(idx))
             for idx in ref.block_indices()}
    port = blockarray_from_numpy(tiles, ref.shape, ref.block_shape,
                                 ref.dtype, "cpu")
    assert port.grid == ref.grid
    back = tiles_to_numpy(port)
    assert back.keys() == tiles.keys()
    for idx, tile in tiles.items():
        np.testing.assert_array_equal(back[idx], tile)
        assert back[idx].dtype == tile.dtype
    np.testing.assert_array_equal(port.gather().numpy(),
                                  np.asarray(ref.gather()))
    rt = TaskRuntime(RuntimeConfig(executor="staged", device="cpu"))
    assert rt.register(port) is port
    assert port.home == ref.home


def test_tiles_must_cover_the_grid():
    with pytest.raises(ValueError, match="grid"):
        blockarray_from_numpy({(0, 0): np.zeros((2, 2), np.float32)},
                              (4, 2), (2, 2), np.float32, "cpu")


def test_config_fields_round_trip():
    ref = repro.RuntimeConfig(executor=repro.ExecutorKind.STAGED,
                              kernel_backend="pallas", n_workers=3,
                              placement="striped_rows", tracker="memory",
                              mpb_slots=8, seed=7)
    fields = {f.name: getattr(ref, f.name)
              for f in dataclasses.fields(ref)}
    port = config_from_reference({**fields, "device": "cpu"})
    for name, value in fields.items():
        assert getattr(port, name) == value, name
        assert type(getattr(port, name)) is not repro.ExecutorKind
    assert port.device == "cpu"
    assert config_from_reference(fields).device == "cuda"
    back = {f.name: getattr(port, f.name) for f in dataclasses.fields(ref)}
    assert repro.RuntimeConfig(**back).validate() == ref.validate()


def test_config_carries_sim_params_field_by_field():
    """A reference ``SCCParams`` (the object, or its fields as
    ``dataclasses.asdict`` of a configuration gives them) becomes the
    port's, field for field, and the runtime's DES runs on it."""
    from repro.core.costmodel import SCCParams as RefParams
    from repro_torch.core.costmodel import SCCParams
    slow = dataclasses.replace(RefParams(), freq_hz=133e6,
                               contention_alpha=0.3)
    ref = repro.RuntimeConfig(executor="sim", sim_params=slow)
    for fields in ({f.name: getattr(ref, f.name)
                    for f in dataclasses.fields(ref)},
                   dataclasses.asdict(ref)):
        port = config_from_reference({**fields, "device": "cpu"})
        assert type(port.sim_params) is SCCParams
        assert dataclasses.asdict(port.sim_params) == \
            dataclasses.asdict(slow)
        with TaskRuntime(port) as rt:
            assert rt._exec.params == port.sim_params
    with pytest.raises(ValueError, match="SCCParams fields"):
        config_from_reference({"sim_params": {"no_such_field": 1.0}})


def test_config_refuses_what_the_port_cannot_take():
    with pytest.raises(ValueError, match="unknown"):
        config_from_reference({"no_such_field": 1})
    with pytest.raises(ValueError, match="sim_cost_fn.*reference"):
        config_from_reference({"sim_cost_fn": lambda td: (0, 0)})
    with pytest.raises(ValueError, match="tracker"):
        config_from_reference({"tracker": repro.obs.InMemoryTracker()})


# ---------------------------------------------------------------------------
def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    assert path.is_file()
    assert not _imports(path) & set(FORBIDDEN), path


def test_port_imports_with_jax_and_repro_unimportable():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro', 'benchmarks'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch, repro_torch.apps, repro_torch.interop\n"
        "import repro_torch.kernels._build\n"
        "import repro_torch.configs, repro_torch.models\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "from repro_torch.launch import serve\n"
        "rt = repro_torch.TaskRuntime(executor='staged', device='cpu',\n"
        "                             kernel_backend='pallas')\n"
        "repro_torch.apps.matmul_app(rt, n=32, tile=16)\n"
        "print(rt.stats().kernel_dispatches)\n"
        "serve.main(['--arch', 'mistral-nemo-12b', '--reduced',\n"
        "            '--device', 'cpu', '--max-new-tokens', '2'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "2"
    assert lines[1].startswith("generated (4, 2) tokens")
