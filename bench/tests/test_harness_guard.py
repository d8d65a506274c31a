"""The import guard: top-level module names compared whole, `jax` and the
JAX package `repro` refused everywhere the benchmark runs, and the
plain reference free of the program (`repro_torch`) too."""
from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest

from bench import run
from bench.harness import config

BENCH = config.BENCH
FORBID_ALL = {"jax", "jaxlib", "flax", "repro"}


def _top_level_imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return out


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not _top_level_imports(path) & FORBID_ALL


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _top_level_imports(path)
    assert not names & (FORBID_ALL | {"repro_torch"})
    assert names <= {"__future__", "math", "numpy", "torch", "bench"}
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "bench."):
            assert node.module.startswith("bench.reference"), node.module


def test_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_mod", sys)
    monkeypatch.setitem(sys.modules, "reprox", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.fleetsim", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert run.forbidden_modules() == ["jaxlib", "repro.fleetsim"]


def test_a_run_loads_no_jax():
    code = ("import sys, torch; sys.path[:0] = ['src', '.']\n"
            "from bench import run\n"
            "from bench.tests.conftest import tiny\n"
            "c = tiny('lossy_dumbbell_100k.fault_sweep128')\n"
            "r = run.run_cell(c, 3, 0.3, False, torch.device('cpu'))\n"
            "print(r.get('forbidden'), r['correct'], run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=config.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["None", "True", "[]"]
