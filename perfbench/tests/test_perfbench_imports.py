"""No file the benchmark runs imports the JAX stack or the JAX package,
and the plain reference imports nothing of the program; top-level module
names are compared whole (``repro_torch`` is not ``repro``)."""
from __future__ import annotations

import ast
import pathlib

import pytest

from perfbench import common

FILES = sorted(p for p in common.ROOT.rglob("*.py")
               if "tests" not in p.relative_to(common.ROOT).parts)
REFERENCE = sorted((common.ROOT / "reference").rglob("*.py"))


def top_level_imports(path: pathlib.Path) -> set[str]:
    """The top-level names of every module the file imports (a relative
    import counts as the benchmark's own package)."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                out.add("perfbench")
            else:
                out.add(node.module.split(".", 1)[0])
    return out


def test_the_files_are_found():
    names = {p.name for p in FILES}
    assert {"run.py", "harness.py", "model.py", "mfu.train.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & set(common.FORBIDDEN)


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & {"repro_torch", "repro", "jax",
                                          "jaxlib", "flax"}
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            # relative imports stay inside perfbench/reference
            assert node.level == 1


def from_the_gqa_reference(path: pathlib.Path) -> set[str]:
    """What ``path`` imports from ``perfbench/reference/model.py``: the
    names it takes from it, and ``*`` for the module itself."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    inside = path.parent == common.ROOT / "reference"
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update("*" for a in node.names
                       if a.name == "perfbench.reference.model")
        elif isinstance(node, ast.ImportFrom):
            mod = ("." * node.level) + (node.module or "")
            if mod in ("perfbench.reference.model", "..reference.model",
                       ".reference.model") or (inside and mod == ".model"):
                out.update(a.name for a in node.names)
            elif mod in ("perfbench.reference", "..reference",
                         ".reference") or (inside and mod == "."):
                out.update("*" for a in node.names if a.name == "model")
    return out


@pytest.mark.parametrize("path", [p for p in FILES
                                  if p.name != "model.py"],
                         ids=lambda p: str(p.relative_to(common.ROOT)))
def test_only_the_lookup_picks_the_equations(path):
    """No module of the benchmark imports ``reference/model.py`` for its
    equations: ``common.reference`` finds a configuration's module by
    name, and a reference module may share only helpers of it."""
    taken = from_the_gqa_reference(path)
    assert "*" not in taken
    assert not taken & set(common.REFERENCE_API)


def test_the_lookup_check_sees_an_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("from ..reference import model\n"
                   "from perfbench.reference.model import Dims\n")
    assert from_the_gqa_reference(bad) == {"*", "Dims"}


def test_whole_names_are_compared():
    assert "repro" in common.FORBIDDEN and "repro_torch" not in \
        common.FORBIDDEN
    import sys
    sys.modules.setdefault("repro_torch_lookalike", sys)
    try:
        assert "repro_torch_lookalike" not in common.forbidden_modules()
    finally:
        sys.modules.pop("repro_torch_lookalike", None)
