"""Nothing the benchmark runs imports JAX or the JAX package, the
reference imports nothing of the program, and nothing reads the JAX
package's old benchmarks."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(HERE.rglob("*.py"))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_import(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "math", "typing", "numpy",
                        "orderbench"}, (path, tops)
        for name in _imports(path):
            if name.startswith("orderbench"):
                assert name.startswith("orderbench.reference"), (path, name)


def test_nothing_reads_the_old_benchmarks():
    this = Path(__file__).resolve()
    for path in SOURCES:
        if path.resolve() == this:
            continue
        text = path.read_text()
        assert "BENCH_" not in text and "benchmarks" not in text, path


def test_a_run_loads_no_jax():
    """A whole (CPU) run in a fresh process leaves no module of JAX or of
    the JAX package loaded, compared by whole top-level names."""
    code = ("import sys; from orderbench import testing; "
            "from orderbench import harness; "
            "out = testing.cpu_run('m3d-30-noband.single'); "
            "assert out['result']['correct']; "
            "print(harness.forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env={"PATH": "/usr/bin:/bin",
                               "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
