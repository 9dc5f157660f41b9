"""Parity of the port's evaluation path (visma_tpu_torch.eval, the evaluate
and annotate tools, run_vio --no-imu) with the JAX reference on the CPU:
the same seeded numpy inputs through both, with the tolerance stated in
each test."""
import json
import os
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

import visma_tpu.eval as JE
from visma_tpu.eval import metrics as jmetrics
from visma_tpu.io import save_obj, save_ply
from visma_tpu.io.json_io import matrix_to_json
from visma_tpu.io.procedural import bench_mesh_db

import visma_tpu_torch.eval as TE
from visma_tpu_torch.eval import metrics as tmetrics

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the bench's eval scene and its constants)


def cube_mesh(size=1.0):
    s = size / 2
    V = np.array([[x, y, z] for x in (-s, s) for y in (-s, s)
                  for z in (-s, s)], np.float32)
    F = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return V, F


def _tri(V, F):
    return [np.asarray(V, np.float32)[np.asarray(F)[:, k]] for k in range(3)]


def _queries(V, F, n_far, n_on, seed):
    return np.concatenate([
        np.random.default_rng(seed).uniform(-1, 1, (n_far, 3)),
        JE.sample_mesh(V, F, n_on, seed=seed + 1),
        np.asarray(V)[:8],
    ]).astype(np.float32)


def _meshes():
    """The cube of test_eval.py:243 and the bench chair of :270."""
    V, F = cube_mesh(1.0)
    Vc, Fc = bench_mesh_db()["chair"]
    return {"cube": (V, F, _queries(V, F, 64, 64, 5)),
            "chair": (np.asarray(Vc, np.float32), np.asarray(Fc),
                      _queries(Vc, Fc, 256, 512, 2))}


@pytest.fixture(scope="module")
def meshes():
    """Each mesh with its queries and the reference's squared distances
    by both forms (chunk 256)."""
    out = {}
    for name, (V, F, q) in _meshes().items():
        A, B, C = (jnp.asarray(x) for x in _tri(V, F))
        out[name] = (V, F, q,
                     np.asarray(jmetrics._pm_dist_aos(jnp.asarray(q), A, B, C,
                                                      256)),
                     np.asarray(jmetrics._pm_dist(jnp.asarray(q), A, B, C,
                                                  256)))
    return out


def test_error_metric_and_pose_error_equal_reference():
    rng = np.random.default_rng(0)
    e = rng.random(101)
    assert TE.compute_error_metric(e).to_json() \
        == JE.compute_error_metric(e).to_json()
    assert TE.compute_error_metric(np.zeros(0)).to_json() \
        == JE.compute_error_metric(np.zeros(0)).to_json()
    assert TE.compute_error_metric(e).scaled(2.0).to_json() \
        == JE.compute_error_metric(e).scaled(2.0).to_json()
    Gs = [np.hstack([Rotation.from_rotvec(rng.normal(size=3) * 0.1)
                     .as_matrix(), rng.uniform(-2, 2, (3, 1))])
          for _ in range(5)]
    Gt = [G + np.hstack([np.zeros((3, 3)), rng.normal(0, 0.05, (3, 1))])
          for G in Gs[:4]]
    for a, b in zip(TE.measure_pose_error(Gs, Gt),
                    JE.measure_pose_error(Gs, Gt)):
        assert a.to_json() == b.to_json()


def test_point_triangle_d2_matches_jax():
    """Broadcast (P, T) pairs of random points and triangles, including
    degenerate ones: 1e-6 relative."""
    rng = np.random.default_rng(1)
    p = rng.normal(size=(64, 1, 3)).astype(np.float32)
    a, b, c = (rng.normal(size=(1, 40, 3)).astype(np.float32)
               for _ in range(3))
    c[0, :4] = a[0, :4]                      # sliver triangles
    b[0, 4:6] = a[0, 4:6]
    ref = np.asarray(jmetrics._point_triangle_d2(p, a, b, c))
    got = tmetrics._point_triangle_d2(*(torch.as_tensor(x)
                                        for x in (p, a, b, c))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["cube", "chair"])
def test_pm_dist_aos_matches_jax(meshes, name):
    """The pairwise oracle: distances within 1e-6 m of the reference's."""
    V, F, q, ref_aos, _ = meshes[name]
    got = tmetrics._pm_dist_aos(torch.as_tensor(q),
                                *(torch.as_tensor(x) for x in _tri(V, F)),
                                256).numpy()
    np.testing.assert_allclose(np.sqrt(got), np.sqrt(ref_aos), atol=1e-6)


@pytest.mark.parametrize("name", ["cube", "chair"])
def test_pm_dist_matches_jax(meshes, name):
    """The SoA production path against the reference's SoA and against the
    AoS oracle: max difference < 1.5e-3 m and mean < 1e-5 m, the
    reference's documented bound (test_eval.py:270)."""
    V, F, q, ref_aos, ref_soa = meshes[name]
    d2 = tmetrics._pm_dist(torch.as_tensor(q),
                           *(torch.as_tensor(x) for x in _tri(V, F)),
                           256).numpy()
    for ref in (ref_soa, ref_aos):
        err = np.abs(np.sqrt(d2) - np.sqrt(ref))
        assert err.max() < 1.5e-3 and err.mean() < 1e-5, (err.max(),
                                                          err.mean())
    # the entry point (its own chunk) gives the same bytes
    np.testing.assert_array_equal(
        TE.point_mesh_distances(q, V, F, device="cpu"),
        np.sqrt(d2.astype(np.float64)))


def test_point_mesh_distances_reference_cases():
    """test_eval.py:44-65's cases through the port's entry point."""
    V, F = cube_mesh(2.0)
    np.testing.assert_allclose(
        TE.point_mesh_distances(np.array([[0.0, 0.0, 3.0]]), V, F,
                                device="cpu"), [2.0], atol=1e-5)
    V = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    F = np.array([[0, 1, 2]], np.int32)
    q = np.array([[-1.0, -1.0, 0.0], [0.5, -1.0, 0.0], [0.25, 0.25, 1.0],
                  [1.5, 0.5, 0.0]])
    d = TE.point_mesh_distances(q, V, F, device="cpu")
    np.testing.assert_allclose(d[:3], [np.sqrt(2), 1.0, 1.0], atol=1e-5)
    np.testing.assert_allclose(
        d, JE.point_mesh_distances(q, V, F), atol=1e-6)
    m = TE.measure_surface_error(V + np.array([0.1, 0, 0]), F, V, F, 2000,
                                 device="cpu")
    mj = JE.measure_surface_error(V + np.array([0.1, 0, 0]), F, V, F, 2000)
    for k, v in mj.to_json().items():
        assert abs(m.to_json()[k] - v) < 1e-6, k


def test_bench_surface_reference_mean():
    """chip_smoke.py holds the card's surface error on bench.py's eval scene
    to the JAX package's mean over the 20,000 samples of seed 0: the
    constant it compares with is this run's."""
    sc = chip_smoke.bench_eval_scene()
    V = jnp.asarray(sc["Vt"], jnp.float32)
    F = jnp.asarray(sc["Ft"], jnp.int32)
    pts = JE.sample_mesh(sc["Vs"], sc["Ft"], chip_smoke.EVAL_AOS_SAMPLES,
                         seed=0)
    d2 = jmetrics._pm_dist(jnp.asarray(pts, jnp.float32), V[F[:, 0]],
                           V[F[:, 1]], V[F[:, 2]], 1024)
    mean = float(np.sqrt(np.asarray(d2, np.float64)).mean())
    assert abs(mean - chip_smoke.SURFACE_REF_MEAN_20K_M) < 1e-12, mean


def write_eval_scene(root, seed=0, samples_per_model=5000):
    """test_eval.py:109's VISMA evaluation directory: a cube CAD database,
    three ground-truth poses, result.json in a frame offset by a known
    T_ef_corvis, and a pseudo-ground-truth cloud (objects and a floor)."""
    cad = os.path.join(root, "cad")
    scene_dir = os.path.join(root, "data", "clutter1")
    os.makedirs(cad)
    os.makedirs(os.path.join(scene_dir, "fragments"))
    V, F = cube_mesh(0.6)
    save_obj(os.path.join(cad, "chair.obj"), V, F)
    rng = np.random.default_rng(seed)
    gt_poses = {}
    for i in range(3):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("z", rng.uniform(0, 6)).as_matrix()
        T[:3, 3] = rng.uniform(-1.5, 1.5, 3)
        gt_poses[f"chair_{i}"] = T
    gt_json = {}
    for k, T in gt_poses.items():
        matrix_to_json(gt_json, k, T[:3, :4])
    with open(os.path.join(scene_dir, "fragments", "alignment.json"),
              "w") as fp:
        json.dump(gt_json, fp)
    T_ef_corvis = np.eye(4)
    T_ef_corvis[:3, :3] = Rotation.from_rotvec([0.1, -0.2, 0.3]).as_matrix()
    T_ef_corvis[:3, 3] = [0.4, -0.3, 0.2]
    result_objs = []
    for i, T in enumerate(gt_poses.values()):
        obj = {"id": i, "model_name": "chair", "status": 2}
        matrix_to_json(obj, "model_pose",
                       (np.linalg.inv(T_ef_corvis) @ T)[:3, :4])
        result_objs.append(obj)
    with open(os.path.join(scene_dir, "result.json"), "w") as fp:
        json.dump([result_objs], fp)
    pts = [JE.sample_mesh(V, F, 4000) @ T[:3, :3].T + T[:3, 3]
           for T in gt_poses.values()]
    floor = np.column_stack([rng.uniform(-2, 2, (3000, 2)),
                             np.full(3000, -0.3)])
    save_ply(os.path.join(scene_dir, "test.klg.ply"),
             np.concatenate(pts + [floor]).astype(np.float32))
    config = {
        "dataroot": os.path.join(root, "data"), "dataset": "clutter1",
        "CAD_database_root": cad,
        "evaluation": {"ICP_refinement": True, "voxel_size": 0.05,
                       "max_distance": 0.075,
                       "samples_per_model": samples_per_model},
        "visualization": {"model_samples": 5000},
    }
    return config, T_ef_corvis, scene_dir


def _read(scene_dir, name):
    with open(os.path.join(scene_dir, name)) as fp:
        return json.load(fp)


def test_quantitative_evaluation_matches_jax(tmp_path, capsys):
    """The three-cube scene through the reference's quantitative_evaluation
    and the port's evaluate tool: every metric and T_ef_corvis within 1e-4,
    the reference's gates (test_eval.py:165), all five files written. ICP
    takes 2,000 samples a model where test_eval.py takes 5,000: the
    reference's padded neighbour search makes those 40 s alone."""
    config, T_true, scene_dir = write_eval_scene(str(tmp_path),
                                                 samples_per_model=2000)
    ref = JE.quantitative_evaluation(config)
    T_ref = np.asarray(_read(scene_dir, "result_alignment.json")
                       ["T_ef_corvis"]).reshape(3, 4)
    for name in ("surface_error.json", "augmented_view.ply"):
        os.remove(os.path.join(scene_dir, name))

    from visma_tpu_torch.cli import evaluate

    cfg_path = tmp_path / "tool.json"
    cfg_path.write_text(json.dumps(config))
    got = evaluate.main([str(cfg_path), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    T_got = np.asarray(_read(scene_dir, "result_alignment.json")
                       ["T_ef_corvis"]).reshape(3, 4)
    np.testing.assert_allclose(T_got, T_ref, atol=1e-4)
    # rotation errors are arccos((tr(dR) - 1) / 2) of angles near 0, where
    # float32 rounding of a rotation (1e-7 in its trace) moves the angle by
    # ~sqrt(1e-7) rad: those are held to 0.05 deg, the rest to 1e-4
    for kind in ref:
        tol = 0.05 if kind == "rotation" else 1e-4
        for k, v in ref[kind].items():
            assert abs(got[kind][k] - v) < tol, (kind, k, got[kind][k], v)
    np.testing.assert_allclose(T_got[:, :3], T_true[:3, :3], atol=0.02)
    np.testing.assert_allclose(T_got[:, 3], T_true[:3, 3], atol=0.02)
    assert got["surface"]["mean"] < 0.02
    assert got["translation"]["max"] < 0.05
    assert got["rotation"]["max"] < 3.0
    for name in ("surface_error.json", "translation_error.json",
                 "rotation_error.json", "augmented_view.ply",
                 "result_alignment.json"):
        assert os.path.exists(os.path.join(scene_dir, name)), name
    assert _read(scene_dir, "surface_error.json") == got["surface"]


def test_annotate_tool(tmp_path, capsys):
    """cli.annotate on test_align.py:202's L-shaped model yawed by 2.4 rad
    in a scan: writes alignment.json with the pose the reference's
    register_model_to_scene finds (1e-4), fitness > 0.6."""
    from visma_tpu.align import register_model_to_scene as j_register
    from visma_tpu_torch.cli import annotate
    from visma_tpu_torch.io import load_ply

    rng = np.random.default_rng(4)
    V = np.array([[x, y, z] for x in (0, 1.0) for y in (0, 0.2)
                  for z in (0, 0.5)], np.float32)
    F = cube_mesh()[1]
    V2 = V.copy()
    V2[:, 0] *= 0.2
    V2[:, 1] *= 4.0
    Vl = np.concatenate([V, V2])
    Fl = np.concatenate([F, F + 8])
    save_obj(str(tmp_path / "ell.obj"), Vl, Fl)
    model = JE.sample_mesh(Vl, Fl, 800, seed=3)
    R = Rotation.from_euler("z", 2.4).as_matrix()
    scan = (model @ R.T + [0.3, -0.2, 0.0]
            + rng.normal(0, 0.002, model.shape)).astype(np.float32)
    save_ply(str(tmp_path / "scan.ply"), scan)
    out = tmp_path / "alignment.json"
    fits = annotate.main([str(tmp_path / "scan.ply"), str(tmp_path), "ell",
                          "--output", str(out), "--voxel", "0.05",
                          "--max-distance", "0.1", "--samples", "800",
                          "--device", "cpu"])
    T = np.asarray(json.loads(out.read_text())["ell_0"]).reshape(3, 4)
    scene, _ = load_ply(str(tmp_path / "scan.ply"))
    Tj, rj = j_register(JE.sample_mesh(Vl, Fl, 800).astype(np.float32),
                        scene.astype(np.float32), num_yaw=24,
                        max_distance=0.1, voxel=0.05)
    np.testing.assert_allclose(T, Tj[:3, :4], atol=1e-4)
    assert fits["ell_0"].correspondences == rj.correspondences
    assert fits["ell_0"].fitness > 0.6
    assert Rotation.from_matrix(T[:, :3].T @ R).magnitude() < 0.1


def test_run_vio_no_imu(capsys):
    """tests/test_cli.py:120's vision-only run through the port's tool on
    the CPU: 24 frames, similarity-aligned ATE < 0.1 m."""
    from visma_tpu_torch.cli import run_vio

    rec = run_vio.main(["--synthetic", "24", "--no-imu", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[0]) == rec
    assert rec["frames"] == 24
    assert rec["ate_sim_aligned_m"] < 0.1
