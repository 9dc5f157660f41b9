"""Parity of the port's alignment (visma_tpu_torch.align) with the JAX
reference on the CPU: the same seeded numpy inputs through both, with the
tolerance stated in each test."""
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

import visma_tpu.align as JA
from visma_tpu.align.icp import _estimate_normals as j_normals

import visma_tpu_torch.align as TA
from visma_tpu_torch.align.icp import _estimate_normals, _icp_core
from visma_tpu_torch.align.nn import rows_per_chunk

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the bench's eval scene and its constants)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _cloud(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


def _rigid(seed, angle=None):
    rng = np.random.default_rng(seed)
    T = np.eye(4)
    rv = rng.normal(size=3)
    if angle is not None:
        rv = rv / np.linalg.norm(rv) * angle
    T[:3, :3] = Rotation.from_rotvec(rv).as_matrix()
    T[:3, 3] = rng.normal(size=3) * (0.1 if angle is not None else 1.0)
    return T


@pytest.mark.parametrize("fn", ["umeyama", "umeyama_4dof"])
@pytest.mark.parametrize("with_scaling", [False, True])
def test_umeyama_matches_jax(fn, with_scaling):
    """Noisy, weighted correspondences with scale: 1e-5 on every entry."""
    rng = np.random.default_rng(1)
    src = _cloud(200, 0)
    T = _rigid(2)
    dst = (1.3 * src @ T[:3, :3].T + T[:3, 3]
           + rng.normal(scale=0.01, size=src.shape)).astype(np.float32)
    w = rng.random(200).astype(np.float32)
    w[:20] = 0.0
    ref = np.asarray(getattr(JA, fn)(jnp.asarray(src), jnp.asarray(dst),
                                     weights=jnp.asarray(w),
                                     with_scaling=with_scaling))
    got = getattr(TA, fn)(_t(src), _t(dst), weights=_t(w),
                          with_scaling=with_scaling).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    unweighted = getattr(TA, fn)(_t(src), _t(dst),
                                 with_scaling=with_scaling).numpy()
    np.testing.assert_allclose(
        unweighted, np.asarray(getattr(JA, fn)(
            jnp.asarray(src), jnp.asarray(dst), with_scaling=with_scaling)),
        atol=1e-5)


def _assert_nn_close(q, r, idx_t, d2_t, idx_j, d2_j, d2_all):
    """Squared distances to 1e-5 relative plus the rounding floor of the
    expansion |q|^2 + |r|^2 - 2 q.r in float32 (8 ulp of the magnitudes it
    cancels: XLA and torch round it in different orders); indices equal
    wherever the best and second-best squared distances (float64 oracle)
    differ by more than that same tolerance."""
    eps = np.finfo(np.float32).eps
    floor = 8 * eps * (np.sum(q * q, 1) + np.sum(r[idx_j] ** 2, 1))
    assert (np.abs(d2_t - d2_j) <= 1e-5 * d2_j + floor).all()
    srt = np.sort(d2_all, axis=1)
    clear = (srt[:, 1] - srt[:, 0]) > 1e-5 * srt[:, 1] + 2 * floor
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(idx_t[clear], idx_j[clear])


@pytest.mark.parametrize("chunk", [2048, 300])
def test_nearest_neighbors_matches_jax(chunk):
    """5000 queries against 3000 refs of which a fifth are padding, with
    the reference's chunk and with one that does not divide N."""
    rng = np.random.default_rng(3)
    q, r = _cloud(5000, 4), _cloud(3000, 5)
    rv = rng.random(3000) > 0.2
    ij, dj = JA.nearest_neighbors(jnp.asarray(q), jnp.asarray(r),
                                  jnp.asarray(rv), chunk=chunk)
    it, dt = TA.nearest_neighbors(_t(q), _t(r), _t(rv), chunk=chunk)
    d2_all = np.sum((q[:, None].astype(np.float64) - r[None]) ** 2, -1)
    d2_all[:, ~rv] = np.inf
    _assert_nn_close(q, r, it.numpy(), dt.numpy(), np.asarray(ij),
                     np.asarray(dj), d2_all)
    assert rv[it.numpy()].all()


def test_rows_per_chunk():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert rows_per_chunk(2048, 500_000, cpu) == 2048
    assert rows_per_chunk(2048, 500_000, cuda) == 2048
    assert rows_per_chunk(1024, 10_164, cuda) == 6144
    assert rows_per_chunk(2048, 8192, cuda) == 8192


@pytest.mark.parametrize("max_out", [0, 300])
def test_voxel_downsample_matches_jax(max_out):
    """Valid mask equal, means within 1e-6 (the segment sums add in the
    reference's order: equal here bit for bit); max_out=300 drops the
    voxels past the capacity as the reference's mode="drop" does."""
    rng = np.random.default_rng(6)
    pts = (_cloud(4000, 7) * 0.5).astype(np.float32)
    valid = rng.random(4000) > 0.1
    oj, vj = JA.voxel_downsample(jnp.asarray(pts), 0.25,
                                 valid=jnp.asarray(valid), max_out=max_out)
    ot, vt = TA.voxel_downsample(_t(pts), 0.25, valid=_t(valid),
                                 max_out=max_out)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-6)
    assert ot.shape[0] == (max_out or 4000)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


def test_estimate_normals_matches_jax():
    """test_align.py:234's bumpy surface, chunk 128 of 301 points: each
    normal within |dot| > 1 - 1e-5 of the reference's (the sign is free)."""
    rng = np.random.default_rng(11)
    xy = rng.uniform(-1, 1, (301, 2))
    z = 0.2 * np.sin(2 * xy[:, 0]) * np.cos(2 * xy[:, 1])
    pts = np.column_stack([xy, z]).astype(np.float32)
    valid = np.ones(301, bool)
    valid[::17] = False
    nj = np.asarray(j_normals(jnp.asarray(pts), jnp.asarray(valid), k=12,
                              chunk=128))
    nt = _estimate_normals(_t(pts), _t(valid), k=12, chunk=128).numpy()
    assert (np.abs(np.sum(nt * nj, axis=1)) > 1 - 1e-5).all()


def _icp_pair(point_to_plane):
    rng = np.random.default_rng(5)
    if point_to_plane:
        xy = rng.uniform(-1, 1, (600, 2))
        z = 0.1 * xy[:, 0] + 0.15 * np.sin(3 * xy[:, 0]) * np.sin(3 * xy[:, 1])
        src = np.column_stack([xy, z]).astype(np.float32)
    else:
        src = _cloud(400, 0)
    T = _rigid(8, angle=0.08)
    dst = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    return src, dst


@pytest.mark.parametrize("point_to_plane", [False, True])
def test_icp_matches_jax(point_to_plane):
    """Both variants on a padded target (every fifth point invalid, plus
    padding rows at the origin): transformation within 1e-4, the same
    correspondence count, fitness and rmse within 1e-5."""
    src, dst = _icp_pair(point_to_plane)
    pad = np.concatenate([dst, np.zeros((100, 3), np.float32)])
    dv = np.ones(len(pad), bool)
    dv[::5] = False
    dv[len(dst):] = False
    kw = dict(max_distance=0.3, max_iters=20, point_to_plane=point_to_plane)
    rj = JA.icp(src, pad, target_valid=jnp.asarray(dv), **kw)
    rt = TA.icp(src, pad, target_valid=dv, device="cpu", **kw)
    np.testing.assert_allclose(rt.transformation, rj.transformation,
                               atol=1e-4)
    assert rt.correspondences == rj.correspondences > 300
    assert abs(rt.fitness - rj.fitness) < 1e-5
    assert abs(rt.inlier_rmse - rj.inlier_rmse) < 1e-5


def test_icp_padded_equals_compacted():
    """The port compacts a padded target before its loop: _icp_core on the
    padded target and on its valid rows gives the same bytes."""
    src, dst = _icp_pair(False)
    pad = np.concatenate([dst, np.zeros((100, 3), np.float32)])
    dv = np.ones(len(pad), bool)
    dv[::5] = False
    dv[len(dst):] = False
    sv = torch.ones(len(src), dtype=torch.bool)
    T0 = torch.eye(4)
    args = (0.3, 20, False)
    padded = _icp_core(_t(src), sv, _t(pad), _t(dv),
                       torch.zeros(len(pad), 3), T0, *args)
    comp = _icp_core(_t(src), sv, _t(pad[dv]),
                     torch.ones(int(dv.sum()), dtype=torch.bool),
                     torch.zeros(int(dv.sum()), 3), T0, *args)
    for a, b in zip(padded, comp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fitness_zero_when_far():
    src, dst = _cloud(100, 1), _cloud(100, 2) + 100.0
    kw = dict(max_distance=0.05, max_iters=2)
    rj = JA.icp(src, dst, **kw)
    rt = TA.icp(src, dst, device="cpu", **kw)
    assert rt.fitness == rj.fitness == 0.0
    np.testing.assert_allclose(rt.transformation, rj.transformation,
                               atol=1e-4)


def test_bench_icp_reference():
    """chip_smoke.py holds the card's ICP on bench.py's eval operating point
    (voxel 0.05 capped at 8192, 0.075 m, 30 iterations) to the JAX
    package's result: the constants it compares with are this run's, and
    the port on the CPU gives them too."""
    sc = chip_smoke.bench_eval_scene()
    vox = [JA.voxel_downsample(jnp.asarray(sc[k], jnp.float32), 0.05,
                               max_out=chip_smoke.EVAL_VOXEL_CAP)
           for k in ("src", "scan")]
    kw = dict(max_distance=0.075, max_iters=30)
    rj = JA.icp(vox[0][0], vox[1][0], source_valid=vox[0][1],
                target_valid=vox[1][1], **kw)
    assert rj.correspondences == chip_smoke.ICP_REF_CORRESPONDENCES
    assert rj.inlier_rmse == chip_smoke.ICP_REF_RMSE_M
    rt = TA.icp(*[np.array(x) for x in (vox[0][0], vox[1][0])],
                source_valid=np.array(vox[0][1]),
                target_valid=np.array(vox[1][1]), device="cpu", **kw)
    assert rt.correspondences == rj.correspondences
    assert abs(rt.inlier_rmse - rj.inlier_rmse) < 1e-5
    np.testing.assert_allclose(rt.transformation, rj.transformation,
                               atol=1e-4)


# 1-ulp perturbations of the model cloud: the seeds of the reference's own
# rounding envelope in `test_register_model_to_scene_matches_jax`
REGISTER_SEEDS = range(1, 8)


def test_register_model_to_scene_matches_jax():
    """test_align.py:202's L-shaped cloud, yawed by 2.4 rad: the port's
    best hypothesis is one the reference gives (transformation within
    1e-4, equal correspondences) and meets the reference's own gates
    (rotation < 0.1 rad, fitness > 0.6).

    "One the reference gives" is over the cloud as it is and its 1-ulp
    perturbations (seeds 1-7): the first hypothesis with 500
    correspondences (yaw 6) has not converged after 30 ICP iterations, and
    at iteration 14 one query's two nearest targets differ by 2.1e-8 in
    squared distance, below the 1.5e-7 float32 rounding of
    |q|^2 + |r|^2 - 2 q.r; which one wins depends on the transformation's
    last bits (the two packages' differ by 1.7e-6 there, each step as
    close to a float64 step as the other's). The two outcomes lie 5.3e-3
    apart, and the reference itself lands on either under a 1-ulp
    perturbation. Where its outcome does not move, the set holds one
    transformation and the test is the 1e-4 one."""
    rng = np.random.default_rng(4)
    a = rng.uniform([0, 0, 0], [1.0, 0.2, 0.5], (300, 3))
    b = rng.uniform([0, 0, 0], [0.2, 0.8, 0.5], (200, 3))
    model = np.concatenate([a, b]).astype(np.float32)
    R = Rotation.from_euler("z", 2.4).as_matrix()
    scene = (model @ R.T + np.array([0.3, -0.2, 0.0])).astype(np.float32)
    kw = dict(num_yaw=24, max_distance=0.1, voxel=0.05)
    Tt, rt = TA.register_model_to_scene(model, scene, device="cpu", **kw)
    refs = []
    for seed in [0, *REGISTER_SEEDS]:     # up to the first one it matches
        m = model
        if seed:
            ulp = np.random.default_rng(seed).integers(-1, 2, model.shape)
            m = (model * (1 + ulp * np.float32(2 ** -23))).astype(np.float32)
        refs.append(JA.register_model_to_scene(m, scene, **kw))
        if np.abs(Tt - refs[-1][0]).max() <= 1e-4:
            break
    else:
        pytest.fail(f"no reference outcome within 1e-4: "
                    f"{[np.abs(Tt - T).max() for T, _ in refs]}")
    assert refs[-1][1].correspondences == rt.correspondences
    for T, r in [(Tt, rt), refs[0]]:
        assert Rotation.from_matrix(T[:3, :3].T @ R).magnitude() < 0.1
        assert r.fitness > 0.6
    rng = np.random.default_rng(3)
    floor = np.column_stack([rng.uniform(-1, 1, 500), rng.uniform(-1, 1, 500),
                             rng.normal(0, 0.01, 500)])
    np.testing.assert_array_equal(TA.find_plane_normal(floor),
                                  JA.find_plane_normal(floor))
