"""Nothing the benchmark runs is JAX, Flax or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's), and
the plain reference imports nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

PKG = Path(harness.__file__).resolve().parent
FILES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_forbidden_import(path):
    found = set(_imports(path))
    assert not found & set(harness.FORBIDDEN)
    if "reference" in path.parts or "scenes" in path.parts:
        assert "visma_tpu_torch" not in found


def test_top_level_names_compared_whole():
    assert harness.forbidden_modules() == [] or "visma_tpu" in sys.modules
    names = {"visma_tpu_torch", "visma_tpu_torch.pipeline", "jaxtyping"}
    assert {n.split(".")[0] for n in names} & set(harness.FORBIDDEN) == set()


def test_rehearsal_loads_no_forbidden_module():
    """A whole run (the CPU rehearsal of vio.fleet64 at a small size) in a
    process of its own: sys.modules holds none of them afterwards."""
    code = (
        "import sys, json\n"
        "from portbench import harness\n"
        "r = harness.rehearse('vio.fleet64', 2**31 + 3, 0.2, "
        "config={'scene': {'num_frames': 4}}, traffic={'batches': 1, "
        "'streams': 2, 'frames_per_call': 2, 'streams_checked': 1})\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
