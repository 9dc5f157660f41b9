"""The PyTorch port stands on its own: it imports with `jax` and the JAX
package `visma_tpu` blocked, its sources name neither, its own copies of
the numpy-only `proto` and `io` modules give what the reference's give,
and its entry points want the card unless told otherwise."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "visma_tpu_torch"

# modules chip_smoke.py imports (inside its functions)
SMOKE_IMPORTS = sorted(set(re.findall(
    r"^\s*from (visma_tpu_torch[\w.]*) import", (ROOT / "chip_smoke.py")
    .read_text(), re.M)))


def _run(code):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=180)


def test_imports_with_jax_blocked():
    """Every module of visma_tpu_torch, and everything chip_smoke.py
    imports, loads in a process where `import jax` and `import visma_tpu`
    fail."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None; sys.modules['visma_tpu'] = None\n"
        "import importlib, pkgutil, visma_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    visma_tpu_torch.__path__, 'visma_tpu_torch.')]\n"
        f"mods += {SMOKE_IMPORTS!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 40, mods\n"
        "bad = [k for k in sys.modules if k.startswith('jax.')\n"
        "       or k.startswith('visma_tpu.')]\n"
        "assert not bad, bad\n"
        "assert sys.modules['jax'] is None\n"
        "assert sys.modules['visma_tpu'] is None\n"
        "print(len(mods))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert len(SMOKE_IMPORTS) >= 10


def test_no_source_imports_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax\b)", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    assert not offenders, offenders
    assert not pat.search((ROOT / "chip_smoke.py").read_text())


def test_no_source_imports_the_jax_package():
    """No `import visma_tpu...` / `from visma_tpu... import` in the port's
    sources or chip_smoke.py (`visma_tpu_torch` is another name)."""
    pat = re.compile(
        r"^\s*(import\s+visma_tpu(\.[\w.]+)?(\s|,|$)"
        r"|from\s+visma_tpu(\.[\w.]+)?\s+import\b)", re.M)
    sources = [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]
    offenders = [str(p) for p in sources if pat.search(p.read_text())]
    assert not offenders, offenders
    assert pat.search("from visma_tpu.proto import Feature\n")
    assert pat.search("    import visma_tpu.io.mesh as m\n")
    assert not pat.search("from visma_tpu_torch.proto import Feature\n")


def test_chip_smoke_refuses_without_cuda():
    """Without a CUDA device chip_smoke.py exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_want_the_card():
    """Without device= an entry point resolves to CUDA and raises where
    there is none; it never carries on on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from visma_tpu_torch.filter.config import FilterConfig
    from visma_tpu_torch.filter.msckf import Msckf
    from visma_tpu_torch.io.procedural import box_mesh
    from visma_tpu_torch.pipeline import VioPipeline
    from visma_tpu_torch.render.camera import Intrinsics
    from visma_tpu_torch.render.raster import MultiMeshRenderer
    from visma_tpu_torch.semantic import (SemanticMapper,
                                          refine_pose_cem_batched)

    intr = Intrinsics(50.0, 50.0, 16.0, 16.0, 32, 32)
    db = {"box": box_mesh(0.3, 0.3, 0.3)}
    for make in (lambda: VioPipeline(FilterConfig()),
                 lambda: Msckf(FilterConfig()),
                 lambda: MultiMeshRenderer(intr),
                 lambda: SemanticMapper(intr, db)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    mr = MultiMeshRenderer(intr, device="cpu")
    mr.set_meshes(db)
    pose = np.eye(3, 4, dtype=np.float32)[None]
    with pytest.raises(RuntimeError, match="CUDA"):
        refine_pose_cem_batched(mr, np.zeros((32, 32), np.float32), pose,
                                np.zeros(1, np.int64))
    assert SemanticMapper(intr, db, device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# The port's copies of the numpy-only modules give what the reference's give
# ---------------------------------------------------------------------------

def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_synthetic_copies_equal_reference():
    from visma_tpu.io import synthetic as JS, synthetic_images as JSI
    from visma_tpu_torch.io import synthetic as TS, synthetic_images as TSI

    kw = dict(num_frames=6, num_landmarks=40, rows=64, cols=96, fx=80.0,
              fy=80.0, cx=48.0, cy=32.0, seed=5)
    tc, jc = TS.SyntheticConfig(**kw), JS.SyntheticConfig(**kw)
    _assert_tree_equal(TS.make_imu(tc), JS.make_imu(jc))
    for name in ("render_adversarial_frames", "render_blob_frames"):
        tf, jf = getattr(TSI, name)(tc), getattr(JSI, name)(jc)
        for x, y in zip(tf, jf):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_procedural_and_mesh_copies_equal_reference(tmp_path):
    from visma_tpu.io import mesh as JM, procedural as JP
    from visma_tpu_torch.io import mesh as TM, procedural as TP

    tdb, jdb = TP.bench_mesh_db(), JP.bench_mesh_db()
    assert list(tdb) == list(jdb) == ["chair", "desk"]
    for n in tdb:
        np.testing.assert_array_equal(tdb[n][0], jdb[n][0])
        np.testing.assert_array_equal(tdb[n][1], jdb[n][1])
    assert 5000 <= len(tdb["chair"][1]) <= 6000 and len(tdb["desk"][1]) == 5148
    V, F = TP.cylinder_mesh(0.2, 0.5, segments=8, stacks=2)
    for ext, save in (("obj", TM.save_obj), ("ply", TM.save_ply)):
        path = str(tmp_path / f"m.{ext}")
        save(path, V, F)
        tv, tf = TM.load_mesh(path)
        jv, jf = JM.load_mesh(path)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tv, V, atol=1e-6)


def test_proto_copies_equal_reference():
    from visma_tpu import proto as JPr
    from visma_tpu_torch import proto as TPr

    assert {s.name: s.value for s in TPr.FeatureStatus} \
        == {s.name: s.value for s in JPr.FeatureStatus}
    rng = np.random.default_rng(2)

    def packet(P):
        feats = [P.Feature(id=i, status=P.FeatureStatus(i % 4),
                           xp=rng.uniform(0, 100, 2), xw=rng.normal(size=3))
                 for i in range(5)]
        return P.Packet(ts=1.25, gwc=np.arange(12.0), features=feats,
                        wg=np.array([0.1, -0.2]))

    rng = np.random.default_rng(2)
    tb = packet(TPr).encode()
    rng = np.random.default_rng(2)
    jb = packet(JPr).encode()
    assert tb == jb
    tp, jp = TPr.Packet.decode(jb), JPr.Packet.decode(tb)
    np.testing.assert_array_equal(tp.gwc, jp.gwc)
    assert [f.id for f in tp.features] == [f.id for f in jp.features]
    np.testing.assert_array_equal(tp.features[3].xw, jp.features[3].xw)

    def boxes(P):
        return P.BoundingBoxList(bounding_boxes=[P.BoundingBox(
            top_left_x=1.0, top_left_y=2.0, bottom_right_x=30.0,
            bottom_right_y=40.0, scores=np.array([0.9], np.float32),
            class_name="chair", azimuth_prob=np.full(12, 1 / 12, np.float32))])

    assert boxes(TPr).encode() == boxes(JPr).encode()
    em = dict(rows=4, cols=6, data=np.linspace(0, 1, 24).astype(np.float32))
    assert TPr.EdgeMap(**em).encode() == JPr.EdgeMap(**em).encode()
