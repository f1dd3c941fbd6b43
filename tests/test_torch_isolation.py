"""The port stands alone: it imports neither JAX nor the JAX package."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parent.parent / "src"
ROOT = SRC.parent


def _modules():
    import repro_torch
    return ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]


def test_every_module_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'repro' or m.startswith('repro.')"
        " or m.startswith('jax'))\n"
        "assert not [m for m in bad if sys.modules[m] is not None], bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(SRC)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list((SRC / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_no_source_names_jax(path):
    """No import of ``jax`` or of the ``repro`` package in the port's
    sources or in ``chip_smoke.py``."""
    for line in (ROOT / path).read_text().splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            mod = s.split()[1]
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), (path, s)
