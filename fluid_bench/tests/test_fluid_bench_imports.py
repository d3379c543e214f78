"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the program's own name, `tpu_fluid_torch`,
begins with the JAX package's), and the reference imports nothing of the
program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from fluid_bench.tests.conftest import REPO

BENCH = REPO / "fluid_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_fluid"}


def _top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(base: Path):
    return sorted(p for p in base.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", _sources(BENCH),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere_the_benchmark_runs(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", _sources(BENCH / "reference"),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    found = _top_level_imports(path)
    assert "tpu_fluid_torch" not in found
    assert found <= {"__future__", "numpy", "torch", "fluid_bench"}
    # and of the benchmark only the reference itself
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("fluid_bench"):
            assert node.module.startswith("fluid_bench.reference")


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from fluid_bench import run
    baseline = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu_fluid_torch.fake", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.forbidden_modules() == baseline
    monkeypatch.setitem(sys.modules, "tpu_fluid.core", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.forbidden_modules() == sorted(set(baseline)
                                             | {"jax", "tpu_fluid"})


def test_a_whole_run_loads_no_jax(tmp_path):
    """A run of a tiny cell on the CPU, in a fresh interpreter, then the
    run's own check of `sys.modules`."""
    from fluid_bench.tests.conftest import tiny_root
    root = tiny_root(tmp_path)
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from fluid_bench import run\n"
        "for cell in ('tiny.stream', 'tiny.view'):\n"
        "    r = run.run_cell(Path(%r), cell, 3, 0.2, False, 'cpu',"
        " time.perf_counter())\n"
        "    assert r['correct'], r\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(run.forbidden_modules())\n" % (str(REPO), str(root)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, forbidden = out.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]"
    assert "'tpu_fluid_torch'" in loaded
