"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX or the reference package ``repro``.

Two checks: every source file is read for an import statement of either
(at module level or inside a function), and a fresh interpreter imports
every module of the port, the cycle model and the perf sweep included,
and then finds neither in ``sys.modules``.
"""
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
_BAD = re.compile(r"^\s*(import jax\b|from jax\b|import repro\.|from repro\.|"
                  r"import repro\s*$|from repro import)", re.M)


def _sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_import_pattern_catches_what_it_must():
    for line in ("import jax.numpy as jnp", "    from jax import lax",
                 "from repro.core import simulator", "import repro.perf",
                 "from repro import core", "import repro"):
        assert _BAD.search(line), line
    for line in ("from repro_torch.core import simulator",
                 "import repro_torch", "# see repro.core.simulator"):
        assert not _BAD.search(line), line


def test_port_sources_import_neither_jax_nor_repro():
    files = _sources()
    assert any(f.parent.name == "perf" for f in files)
    assert any(f.name == "simulator.py" for f in files)
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in _BAD.finditer(f.read_text())]
    assert hits == []


def test_every_port_module_imports_without_jax_or_repro():
    mods = sorted(
        ".".join(f.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for f in (ROOT / "src" / "repro_torch").rglob("*.py"))
    assert "repro_torch.perf.gate" in mods and "repro_torch.mmu.iotlb" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
