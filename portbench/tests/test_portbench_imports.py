"""What the benchmark imports: no module it runs is JAX, jaxlib, flax or
the JAX package (top-level names compared whole: the program's name
begins with the JAX package's), and the yardstick (the reference and the
counts) imports nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench.harness import core

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in core.BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


def imported(path) -> set:
    """Top-level names of the modules a source file imports."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(core.BENCH)))
def test_no_jax_anywhere(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if p.parent.name in
                                  ("reference", "counts")],
                         ids=lambda p: str(p.relative_to(core.BENCH)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in imported(path)


def test_a_loaded_run_holds_no_jax():
    """Every module of the harness, the runners and the readers loaded in
    a fresh process, with the program they drive: no forbidden module."""
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "from portbench.harness import core\n"
        "import portbench.run, portbench.kinds.train\n"
        "import repro_torch.train, repro_torch.models\n"
        "for p in (core.BENCH / 'metrics').glob('*.py'):\n"
        "    core.load_module(p)\n"
        "print(core.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
