"""The PyTorch port stands on its own: it imports with `jax` and the JAX
package `visma_tpu` blocked, its sources name neither, its own copies of
the numpy-only `proto`, `io`, `align.registration`, `eval.sampling`,
`eval.assembly` and `utils.term` modules give what the reference's give,
its copy of `ba.from_vio`'s host numpy is the reference's source apart
from the device, its `Heartbeat` and `Watchdog`, `proto.vlslam_pb2`,
`io.native_loader` and `utils.logging` are the reference's source, every
module file of the JAX package has its counterpart, and its entry points
want the card unless told otherwise."""
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
        "assert len(mods) >= 60, mods\n"
        "for m in ('cli.run_vio', 'cli.undistort_images', 'cli.example_load',\n"
        "          'cli.example_dump', 'io.loader', 'io.glob', 'io.binary',\n"
        "          'io.json_io', 'filter.feed', 'frontend.klt',\n"
        "          'image.remap', 'image.undistort', 'utils.timer',\n"
        "          'utils.platform', 'filter.slam', 'align.umeyama',\n"
        "          'align.nn', 'align.voxel', 'align.icp', 'align.annotation',\n"
        "          'align.registration', 'eval.metrics', 'eval.evaluate',\n"
        "          'eval.sampling', 'eval.assembly', 'utils.term',\n"
        "          'cli.evaluate', 'cli.annotate', 'ba', 'ba.problem',\n"
        "          'ba.gauss_newton', 'ba.pose_graph', 'ba.from_vio',\n"
        "          'dist', 'dist.mesh', 'dist.sharded_ba', 'dist.pcg_ba',\n"
        "          'dist.submap_ba', 'dist.pipeline_pp', 'dist.multihost',\n"
        "          'utils.checkpoint', 'dryrun', 'utils.logging',\n"
        "          'utils.misc', 'proto.vlslam_pb2', 'io.native_loader',\n"
        "          'cli.render_depth', 'cli.run_semantic', 'cli.visualize',\n"
        "          'cli.generate_depthmaps', 'cli.prepare_sfmlearner',\n"
        "          'cli.show_2dmap', 'bench_scaling', 'tools.common',\n"
        "          'tools.profile_filter', 'tools.profile_stages',\n"
        "          'tools.profile_cem', 'tools.diag_semantic',\n"
        "          'tools.noise_sweep', 'tools.spawn_sweep',\n"
        "          'tools.scaling_model'):\n"
        "    assert 'visma_tpu_torch.' + m in mods, m\n"
        "bad = [k for k in sys.modules if k.startswith('jax.')\n"
        "       or k.startswith('visma_tpu.')]\n"
        "assert not bad, bad\n"
        "assert sys.modules['jax'] is None\n"
        "assert sys.modules['visma_tpu'] is None\n"
        "print(len(mods))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert len(SMOKE_IMPORTS) >= 14


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

    from visma_tpu_torch.ba.problem import make_problem, synthetic_ba_problem

    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic_ba_problem(num_poses=3, num_landmarks=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_problem(np.eye(3)[None], np.zeros((1, 3)), np.zeros((1, 3)),
                     np.zeros((1, 1, 2)), np.ones((1, 1), bool), 1, 1, 0, 0)
    assert synthetic_ba_problem(3, 8, device="cpu")[0].R.device.type == "cpu"

    from visma_tpu_torch.align import icp, register_model_to_scene
    from visma_tpu_torch.cli import annotate, evaluate
    from visma_tpu_torch.eval import (measure_surface_error, mesh_alignment,
                                      point_mesh_distances,
                                      quantitative_evaluation)

    pts = np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32)
    V, F = db["box"]
    for call in (lambda: icp(pts, pts, 0.1),
                 lambda: register_model_to_scene(pts, pts, num_yaw=2),
                 lambda: point_mesh_distances(pts, V, F),
                 lambda: measure_surface_error(V, F, V, F, 16),
                 lambda: mesh_alignment({}),
                 lambda: quantitative_evaluation({}),
                 lambda: evaluate.main(["tool.json"]),
                 lambda: annotate.main(["scan.ply", "cad", "chair"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert icp(pts, pts, 0.1, max_iters=1, device="cpu").fitness == 1.0

    from visma_tpu_torch.cli import render_depth, run_semantic, visualize

    for call in (lambda: render_depth.main(["cfg.json"]),
                 lambda: run_semantic.main(["--synthetic", "2"]),
                 lambda: visualize.main(["seq", "--animate", "anim"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


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


def test_loader_copies_equal_reference(tmp_path):
    """io.glob, io.loader (Python codec on both sides), io.binary and
    io.json_io on one written sequence and on seeded arrays."""
    from visma_tpu import io as JIO
    from visma_tpu.io import loader as JL
    from visma_tpu_torch import io as TIO
    from visma_tpu_torch.io import loader as TL
    from visma_tpu_torch.io.synthetic import SyntheticConfig, write_sequence

    root = str(tmp_path / "seq")
    write_sequence(root, SyntheticConfig(num_frames=4, num_landmarks=30,
                                         rows=48, cols=64, fx=60.0, fy=60.0,
                                         cx=32.0, cy=24.0, seed=9),
                   write_images=True)
    for ext in (".png", ".edge", ".bbox"):
        assert TIO.glob_by_timestamp(root, ext) \
            == JIO.glob_by_timestamp(root, ext) != []
    (tmp_path / "names").mkdir()
    for name in ("b.txt", "a.txt", "10.txt", "9.txt", "x9.dat"):
        (tmp_path / "names" / name).write_text("")
    for args in ((".txt",), ("txt", "1"), (".dat", "x")):
        assert TIO.glob_by_timestamp(str(tmp_path / "names"), *args) \
            == JIO.glob_by_timestamp(str(tmp_path / "names"), *args)

    tl, jl = TIO.VlslamDatasetLoader(root), JIO.VlslamDatasetLoader(root)
    assert len(tl) == len(jl) == 4
    _assert_tree_equal(tl.packed_packets(max_features=16),
                       jl.packed_packets(max_features=16, native=False))
    for i in (0, 3):
        tf, jf = tl.grab(i), jl.grab(i)
        np.testing.assert_array_equal(tf.image, jf.image)
        np.testing.assert_array_equal(tf.edgemap, jf.edgemap)
        np.testing.assert_array_equal(tf.gwc, jf.gwc)
        np.testing.assert_array_equal(tf.Rg, jf.Rg)
        assert tf.ts == jf.ts and tf.path == jf.path
        assert tf.bboxlist.encode() == jf.bboxlist.encode()
        _assert_tree_equal(tl.grab_sparse_depth(i), jl.grab_sparse_depth(i))
        _assert_tree_equal(tl.grab_pointcloud(i, tf.image),
                           jl.grab_pointcloud(i, jf.image))
    np.testing.assert_array_equal(TL.edge_u8(tf.edgemap),
                                  JL.edge_u8(jf.edgemap))
    assert TL.load_edgemap(str(tmp_path / "missing.edge")) is None
    with pytest.raises(IndexError):
        tl.grab(4)

    rng = np.random.default_rng(3)
    mat = rng.normal(size=(5, 7)).astype(np.float32)
    TIO.save_mat(str(tmp_path / "t.bin"), mat)
    JIO.save_mat(str(tmp_path / "j.bin"), mat)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    np.testing.assert_array_equal(TIO.load_mat(str(tmp_path / "j.bin")), mat)

    cfg = tmp_path / "cfg.json"
    cfg.write_text('{\n  // a comment\n  "a": {"b": 1, "url": "x//y"}, '
                   '/* block */ "m": [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12]\n}')
    tj, jj = TIO.load_json(str(cfg)), JIO.load_json(str(cfg))
    assert tj == jj and tj["a"]["url"] == "x//y"
    assert TIO.merge_json(tj, {"a": {"c": 2}}) \
        == JIO.merge_json(jj, {"a": {"c": 2}})
    np.testing.assert_array_equal(TIO.matrix_from_json(tj, "m"),
                                  JIO.matrix_from_json(jj, "m"))
    td, jd = {}, {}
    TIO.matrix_to_json(td, "m", mat)
    JIO.matrix_to_json(jd, "m", mat)
    assert td == jd


def test_align_eval_copies_equal_reference():
    """align.registration, eval.sampling, eval.assembly and utils.term: the
    same outputs bit for bit on seeded inputs."""
    from scipy.spatial.transform import Rotation

    from visma_tpu.align import registration as JR
    from visma_tpu.eval import assembly as JAs, sampling as JSa
    from visma_tpu.utils import term as JT
    from visma_tpu_torch.align import registration as TR
    from visma_tpu_torch.eval import assembly as TAs, sampling as TSa
    from visma_tpu_torch.io.procedural import bench_mesh_db
    from visma_tpu_torch.utils import term as TT

    V, F = bench_mesh_db()["desk"]
    np.testing.assert_array_equal(TSa.sample_mesh(V, F, 3000, seed=4),
                                  JSa.sample_mesh(V, F, 3000, seed=4))
    rng = np.random.default_rng(7)
    T_off = np.eye(4)
    T_off[:3, :3] = Rotation.from_euler("z", 0.3).as_matrix()
    T_off[:3, 3] = [0.5, -0.2, 0.1]
    tgt, src = {}, {}
    for i in range(5):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("y", rng.uniform(0, 6)).as_matrix()
        T[:3, 3] = rng.uniform(-2, 2, 3)
        noise = np.eye(4)
        noise[:3, 3] = rng.normal(0, 0.01, 3)
        tgt[i] = {"name": "chair" if i % 2 else "desk", "pose": T,
                  "V": V, "F": F}
        src[i] = {"name": tgt[i]["name"], "pose": noise @ T_off @ T,
                  "V": V, "F": F}
    (Tt, mt), (Tj, mj) = TR.register_scenes(tgt, src), \
        JR.register_scenes(tgt, src)
    np.testing.assert_array_equal(Tt, Tj)
    assert mt == mj and len(mt) == 5
    poses = {k: v["pose"] for k, v in tgt.items()}
    assert TR.find_correspondences(poses, poses, np.eye(4)) \
        == JR.find_correspondences(poses, poses, np.eye(4))
    scene = rng.uniform(-3, 3, (500, 3))
    for a, b in zip(TAs.assemble_scene(src, alignment=T_off,
                                       scene_points=scene,
                                       crop_points_in_boxes=True),
                    JAs.assemble_scene(src, alignment=T_off,
                                       scene_points=scene,
                                       crop_points_in_boxes=True)):
        _assert_tree_equal(a, b)
    assert TT.TermColor.wrap("x", TT.TermColor.cyan) \
        == JT.TermColor.wrap("x", JT.TermColor.cyan)


def test_example_tools_run_on_a_sequence(tmp_path, capsys):
    """cli.example_load and cli.example_dump print and write what the
    reference's tools do on the same directory."""
    from visma_tpu.cli import example_dump as JD, example_load as JLd
    from visma_tpu_torch.cli import example_dump as TD, example_load as TLd
    from visma_tpu_torch.io.synthetic import SyntheticConfig, write_sequence

    root = str(tmp_path / "seq")
    write_sequence(root, SyntheticConfig(num_frames=3, num_landmarks=30,
                                         rows=48, cols=64, fx=60.0, fy=60.0,
                                         cx=32.0, cy=24.0, seed=9),
                   write_images=True)
    TLd.main([root, "--max-frames", "2"])
    got = capsys.readouterr().out
    JLd.main([root, "--max-frames", "2"])
    assert got == capsys.readouterr().out and "--- frame 1" in got
    TD.main([root, str(tmp_path / "t")])
    JD.main([root, str(tmp_path / "j")])
    for rel in ("K.txt", "pose/000002.txt", "depth/000002.txt"):
        assert (tmp_path / "t" / rel).read_text() \
            == (tmp_path / "j" / rel).read_text() != ""
    assert (tmp_path / "t" / "image" / "000000.jpg").exists()


def test_from_vio_copy_is_the_reference_source():
    """`ba.from_vio` is host numpy in both packages: the port's helpers are
    the reference's source line for line, and the two entry points differ
    only where the problem goes to the caller's device and the solution
    comes back from it."""
    import difflib
    import inspect

    from visma_tpu.ba import from_vio as J
    from visma_tpu_torch.ba import from_vio as T

    for name in ("select_keyframes", "_camera_poses", "_triangulate"):
        assert inspect.getsource(getattr(T, name)) \
            == inspect.getsource(getattr(J, name)), name

    def changed(name):
        diff = difflib.unified_diff(
            inspect.getsource(getattr(J, name)).splitlines(),
            inspect.getsource(getattr(T, name)).splitlines(),
            lineterm="", n=0)
        return [ln[0] + ln[1:].strip() for ln in diff
                if ln[:1] in "+-" and not ln.startswith(("+++", "---"))]

    assert changed("ba_problem_from_vio") == [
        "-max_landmarks: int = 512,",
        "+max_landmarks: int = 512, device=None,",
        "-R_bc/p_bc: camera-IMU extrinsics (identity by default).",
        "+R_bc/p_bc: camera-IMU extrinsics (identity by default). device: "
        "where",
        "+the problem lands (None means the CUDA card).",
        "-prob = make_problem(Rc, pc, X, obs, mask, *intr)",
        "+prob = make_problem(Rc, pc, X, obs, mask, *intr, device=device)"]
    assert changed("refine_trajectory") == [
        "-Rc = np.asarray(solved.R, np.float64)",
        "-pc = np.asarray(solved.p, np.float64)",
        "+Rc = solved.R.cpu().numpy().astype(np.float64)",
        "+pc = solved.p.cpu().numpy().astype(np.float64)"]


def test_heartbeat_and_watchdog_are_the_reference_source():
    """dist/multihost.py's `Heartbeat` and `Watchdog` are pure Python and
    copied unchanged but for the package's name (Watchdog's docstring
    names the checkpoint module its worker loads), so the reference's
    drills of them (tests/test_multihost.py) hold for the port's too."""
    import inspect

    from visma_tpu.dist import multihost as J
    from visma_tpu_torch.dist import multihost as T

    for name in ("Heartbeat", "Watchdog"):
        assert inspect.getsource(getattr(T, name)).replace(
            "visma_tpu_torch", "visma_tpu") \
            == inspect.getsource(getattr(J, name)), name


def _body_without_docstring(source):
    """The module's AST dump without its docstring, `visma_tpu_torch` read
    as `visma_tpu` so that the import lines compare equal."""
    import ast

    tree = ast.parse(source.replace("visma_tpu_torch", "visma_tpu"))
    body = tree.body
    if body and isinstance(body[0], ast.Expr) \
            and isinstance(body[0].value, ast.Constant):
        body = body[1:]
    return [ast.dump(node) for node in body]


@pytest.mark.parametrize("rel", ["proto/vlslam_pb2.py",
                                 "io/native_loader.py", "utils/logging.py"])
def test_copies_are_the_reference_source(rel):
    """The shim, the ctypes binding and the logging helpers are copies:
    their code is the reference's statement for statement, apart from the
    package name in the import lines (and the default logger name, which
    is the package's), the docstrings and the comments."""
    ref = (ROOT / "visma_tpu" / rel).read_text()
    port = (PKG / rel).read_text()
    if rel == "utils/logging.py":
        port = port.replace('name: str = "visma_tpu_torch"',
                            'name: str = "visma_tpu"')
    assert _body_without_docstring(port) == _body_without_docstring(ref)


def test_every_reference_module_has_a_counterpart():
    """Each module file of the JAX package has a file of the same relative
    path in the port."""
    ref = sorted(p.relative_to(ROOT / "visma_tpu")
                 for p in (ROOT / "visma_tpu").rglob("*.py")
                 if "__pycache__" not in p.parts)
    assert len(ref) >= 89
    missing = [str(r) for r in ref if not (PKG / r).is_file()]
    assert not missing, missing
