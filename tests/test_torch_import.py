"""The PyTorch port imports without jax and never imports it."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "visma_tpu_torch"


def test_imports_with_jax_blocked():
    """Every module of visma_tpu_torch imports in a process where
    `import jax` fails."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import importlib, pkgutil, visma_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    visma_tpu_torch.__path__, 'visma_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 20, mods\n"
        "assert not any(k.startswith('visma_tpu.filter') for k in sys.modules)\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_source_imports_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax\b)", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    assert not offenders, offenders
    assert not pat.search((ROOT / "chip_smoke.py").read_text())


def test_chip_smoke_refuses_without_cuda():
    """Without a CUDA device chip_smoke.py exits non-zero and prints no
    result line."""
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
