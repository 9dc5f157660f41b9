"""The port's bundle adjustment (visma_tpu_torch.ba: problem, Gauss-Newton
with the Schur complement, the pose graph, the VIO -> BA loop) and
`run_vio --ba dense` against the JAX reference on the CPU: the same seeded
numpy inputs through both, with the tolerance stated in each test.

The reference's own cross-implementation tolerances set the solver's
(__graft_entry__.py:70-71, :113-118): one GN step to 2e-4 in the poses,
a 10-step solve to 1e-3 relative in the cost and 2e-2 in the poses. The
building blocks agree to 1e-5 relative (float32, other summation orders).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from visma_tpu.ba import from_vio as JF, gauss_newton as JG
from visma_tpu.ba import pose_graph as JPG
from visma_tpu.ba.problem import BaProblem as JBaProblem
from visma_tpu.ba.problem import synthetic_ba_problem as j_synthetic

from visma_tpu_torch import convert
from visma_tpu_torch.ba import from_vio as TF, gauss_newton as TG
from visma_tpu_torch.ba import pose_graph as TPG
from visma_tpu_torch.ba.problem import synthetic_ba_problem as t_synthetic

BLOCK_REL = 1e-5
STEP_TOL = 2e-4
COST_REL = 1e-3
POSE_TOL = 2e-2
FIELDS = ("R", "p", "X", "obs", "mask", "intr")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _port(jprob):
    return convert.ba_problem_from_reference(
        jax.tree.map(np.asarray, jprob), device="cpu")


@pytest.fixture(scope="module")
def probs():
    """The 8-pose x 64-landmark problem of tests/test_ba.py:15 from both
    packages, and its scale anchor."""
    jp, truth = j_synthetic(num_poses=8, num_landmarks=64, noise_px=0.5,
                            pose_noise=0.03)
    tp, _ = t_synthetic(num_poses=8, num_landmarks=64, noise_px=0.5,
                        pose_noise=0.03, device="cpu")
    anchor = float(np.linalg.norm(np.asarray(jp.p)[-1] - np.asarray(jp.p)[0]))
    return jp, tp, truth, anchor


@pytest.fixture(scope="module")
def solved(probs):
    jp, tp, _, _ = probs
    js, jh = JG.ba_solve(jp, iters=10)
    ts, th = TG.ba_solve(tp, iters=10)
    return js, np.asarray(jh), ts, th


@pytest.mark.parametrize("args", [(8, 64, 0.5, 0.03, 0), (5, 40, 1.0, 0.02, 3),
                                  (32, 2048, 0.5, 0.02, 0)])
def test_synthetic_problem_is_the_reference_bit_for_bit(args):
    K, L, noise, pose_noise, seed = args
    jp, jt = j_synthetic(K, L, noise, pose_noise, seed)
    tp, tt = t_synthetic(K, L, noise, pose_noise, seed, device="cpu")
    for f in FIELDS:
        got, ref = _np(getattr(tp, f)), np.asarray(getattr(jp, f))
        assert got.dtype == ref.dtype, f
        np.testing.assert_array_equal(got, ref, err_msg=f)
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k])
    assert tp.num_poses == K and tp.num_landmarks == L


def test_problem_converters_round_trip(probs):
    jp, tp, _, _ = probs
    back = convert.ba_problem_to_numpy(_port(jp))
    for f in FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jp, f)))
    rebuilt = JBaProblem(**{f: jnp.asarray(v) for f, v in
                            convert.ba_problem_to_numpy(tp).items()})
    assert float(JG.total_cost(rebuilt)) == float(JG.total_cost(jp))


def test_residual_jacobians_and_cost(probs):
    jp, tp, _, _ = probs
    for got, ref in zip(TG._residual_jacobians(tp),
                        JG._residual_jacobians(jp)):
        assert _rel(got, ref) < BLOCK_REL
    assert _rel(TG.total_cost(tp), JG.total_cost(jp)) < BLOCK_REL


def test_build_blocks(probs):
    jp, tp, _, _ = probs
    with jax.default_matmul_precision("highest"):
        ref = JG.build_blocks(jp, 1e-3)
    for name, got, want in zip(("Hpp", "bp", "Hll_inv", "Hpl", "bl"),
                               TG.build_blocks(tp, 1e-3), ref):
        assert _rel(got, want) < BLOCK_REL, name


@pytest.mark.parametrize("with_anchor", [False, True])
def test_build_reduced_system_and_backsub(probs, with_anchor):
    """S and b, with and without the scale prior, and the landmark
    back-substitution from one shared pose increment."""
    jp, tp, _, anchor = probs
    with jax.default_matmul_precision("highest"):
        jS, jb, jaux = JG.build_reduced_system(
            jp, 1e-3, scale_anchor=jnp.float32(anchor) if with_anchor
            else None)
        dxp = np.random.default_rng(1).normal(
            scale=1e-2, size=6 * jp.num_poses).astype(np.float32)
        jdxl = JG.backsub_landmarks(jaux, jnp.asarray(dxp))
    tS, tb, taux = TG.build_reduced_system(
        tp, 1e-3, scale_anchor=torch.tensor(anchor) if with_anchor else None)
    assert _rel(tS, jS) < BLOCK_REL
    assert _rel(tb, jb) < BLOCK_REL
    for got, ref in zip(taux, jaux):
        assert _rel(got, ref) < BLOCK_REL
    # back-substitution on the reference's own blocks: bl - Hpl^T dxp
    # cancels, so blocks 1e-7 apart would give answers 5e-5 apart
    aux = tuple(torch.as_tensor(np.asarray(a)) for a in jaux)
    assert _rel(TG.backsub_landmarks(aux, torch.as_tensor(dxp)),
                jdxl) < BLOCK_REL
    # the gauge rows of pose 0 and the prior on the last pose's position
    S = _np(tS)
    np.testing.assert_array_equal(S[:6, :6], 1e6 * np.eye(6))
    assert not S[:6, 6:].any() and not _np(tb)[:6].any()


def test_one_gn_step(probs):
    """One step at damping 1e-3 with the anchor: poses to 2e-4 (the
    reference's step tolerance), and the new cost to 1e-2 relative (an f32
    step of an ill-conditioned system: the port's lands closer to a
    float64 step than the reference's)."""
    jp, tp, _, anchor = probs
    js, jc = JG.ba_step(jp, jnp.float32(1e-3), jnp.float32(anchor))
    ts, tc = TG.ba_step(tp, 1e-3, torch.tensor(anchor))
    assert np.abs(_np(ts.p) - np.asarray(js.p)).max() < STEP_TOL
    assert np.abs(_np(ts.R) - np.asarray(js.R)).max() < STEP_TOL
    assert _rel(tc, jc) < 1e-2
    assert torch.isfinite(ts.X).all()
    # the same step in float64 (the port's code on double tensors)
    t64 = tp.replace(**{f: getattr(tp, f).double()
                        for f in ("R", "p", "X", "obs", "intr")})
    s64, _ = TG.ba_step(t64, 1e-3, torch.tensor(anchor, dtype=torch.float64))
    err_port = np.abs(_np(ts.p) - _np(s64.p)).max()
    err_ref = np.abs(np.asarray(js.p) - _np(s64.p)).max()
    assert err_port < err_ref < STEP_TOL, (err_port, err_ref)


def test_ba_solve_matches_reference(probs, solved):
    """10 LM steps: cost within 1e-3 relative, poses within 2e-2 m, the
    history of the accepted costs non-increasing, pose 0 fixed."""
    jp, tp, truth, _ = probs
    js, jh, ts, th = solved
    assert th.shape == (10,)
    c_ref = float(JG.total_cost(js))
    c_got = float(TG.total_cost(ts))
    assert abs(c_got - c_ref) / c_ref < COST_REL, (c_got, c_ref)
    assert np.abs(_np(ts.p) - np.asarray(js.p)).max() < POSE_TOL
    h = _np(th)
    assert (np.diff(h) <= 0).all() and h[-1] < 0.2 * float(TG.total_cost(tp))
    np.testing.assert_array_equal(_np(ts.R[0]), _np(tp.R[0]))
    np.testing.assert_array_equal(_np(ts.p[0]), _np(tp.p[0]))


def test_chip_smoke_holds_the_reference_solve():
    """chip_smoke.py's constants for the multichip dryrun's problem (32 x
    2048, 10 steps) are the JAX package's solve on the CPU: its final cost
    and positions."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    K, L, iters = chip_smoke.BA_DRYRUN
    jp, _ = j_synthetic(K, L, 0.5, 0.02)
    sol, _ = JG.ba_solve(jp, iters=iters)
    np.testing.assert_allclose(float(JG.total_cost(sol)),
                               chip_smoke.BA_REF_COST[(K, L)], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(sol.p), chip_smoke.BA_REF_P_32,
                               atol=1e-6)


def test_gauge_pose_fixed():
    """tests/test_ba.py:41-46 on the port."""
    prob, _ = t_synthetic(device="cpu")
    sol, _ = TG.ba_solve(prob, iters=5)
    np.testing.assert_allclose(_np(sol.R[0]), _np(prob.R[0]), atol=1e-5)
    np.testing.assert_allclose(_np(sol.p[0]), _np(prob.p[0]), atol=1e-5)


def test_huber_downweights_outliers():
    """tests/test_ba.py:48-68 on the port: 5% of the observations moved by
    80 px; the Sim(3)-aligned poses within 2 cm of the truth, and the cost
    within 1e-3 relative of the reference's on the same problem."""
    from visma_tpu_torch.align import umeyama

    jp, truth = j_synthetic(num_poses=6, num_landmarks=48, noise_px=0.3,
                            pose_noise=0.02, seed=2)
    obs = np.asarray(jp.obs)
    bad = np.random.default_rng(0).random(obs.shape[:2]) < 0.05
    obs = obs + bad[..., None] * 80.0
    jbad = JBaProblem(R=jp.R, p=jp.p, X=jp.X, obs=jnp.asarray(obs),
                      mask=jp.mask, intr=jp.intr)
    sol, _ = TG.ba_solve(_port(jbad), iters=15)
    T = _np(umeyama(sol.p, torch.as_tensor(truth["p"], dtype=torch.float32),
                    with_scaling=True))
    p_al = _np(sol.p) @ T[:3, :3].T + T[:3, 3]
    assert np.linalg.norm(p_al - truth["p"], axis=1).max() < 0.02
    jsol, _ = JG.ba_solve(jbad, iters=15)
    c_ref = float(JG.total_cost(jsol))
    assert abs(float(TG.total_cost(sol)) - c_ref) / c_ref < COST_REL


def _circle(K=12, seed=1):
    """tests/test_ba.py:70-115: poses on a circle, a drifting odometry
    chain as the estimate, exact odometry edges and one loop closure."""
    rng = np.random.default_rng(seed)
    R_gt, p_gt = [], []
    for k in range(K):
        th = 2 * np.pi * k / K
        R_gt.append(Rotation.from_euler("z", th).as_matrix())
        p_gt.append(np.array([np.cos(th), np.sin(th), 0.0]))
    R_gt, p_gt = np.asarray(R_gt), np.asarray(p_gt)
    R_est, p_est = [R_gt[0]], [p_gt[0]]
    for k in range(1, K):
        dR = R_gt[k - 1].T @ R_gt[k]
        dp = R_gt[k - 1].T @ (p_gt[k] - p_gt[k - 1])
        nR = Rotation.from_rotvec(rng.normal(scale=0.03, size=3)).as_matrix()
        R_est.append(R_est[-1] @ dR @ nR)
        p_est.append(p_est[-1] + R_est[-2] @ dp
                     + rng.normal(scale=0.02, size=3))
    ei = list(range(K - 1)) + [K - 1]
    ej = list(range(1, K)) + [0]
    Rm = [R_gt[i].T @ R_gt[j] for i, j in zip(ei, ej)]
    pm = [R_gt[i].T @ (p_gt[j] - p_gt[i]) for i, j in zip(ei, ej)]
    f32 = np.float32
    args = (np.asarray(R_est, f32), np.asarray(p_est, f32),
            np.asarray(ei, np.int32), np.asarray(ej, np.int32),
            np.asarray(Rm, f32), np.asarray(pm, f32))
    return args, p_gt, np.linalg.norm(np.asarray(p_est) - p_gt, axis=1).max()


def test_pose_graph_loop_closure_matches_reference():
    """The circle, 15 iterations: the port's poses within 1e-4 of the
    reference's, and the reference test's gates (error < 0.02 m and < a
    quarter of the drift)."""
    args, p_gt, drift = _circle()
    R_j, p_j = JPG.pose_graph_solve(*map(jnp.asarray, args), iters=15)
    R_t, p_t = TPG.pose_graph_solve(*map(torch.as_tensor, args), iters=15)
    np.testing.assert_allclose(_np(p_t), np.asarray(p_j), atol=1e-4)
    np.testing.assert_allclose(_np(R_t), np.asarray(R_j), atol=1e-4)
    err = np.linalg.norm(_np(p_t) - p_gt, axis=1).max()
    assert err < 0.02 and err < 0.25 * drift, (err, drift)


def test_pose_graph_edge_jacobians_are_forward_mode():
    """The batched forward-mode Jacobians of every edge against
    `torch.func.jacfwd` of one edge's residual (float64 inputs, as an
    independent oracle) and against the reference's `jax.jacfwd`, 1e-5."""
    args, _, _ = _circle()
    R, p, ei, ej, Rm, pm = (torch.as_tensor(a) for a in args)
    ei, ej = ei.long(), ej.long()
    res, Ji, Jj = TPG._edge_terms(R[ei], p[ei], R[ej], p[ej], Rm, pm)
    z = torch.zeros(6, dtype=torch.float64)
    for e in (0, 5, 11):
        a = [x.double() for x in (R[ei[e]], p[ei[e]], R[ej[e]], p[ej[e]],
                                  Rm[e], pm[e])]
        Ai = torch.func.jacfwd(lambda x: TPG._edge_res_perturbed(x, z, *a))(z)
        Aj = torch.func.jacfwd(lambda x: TPG._edge_res_perturbed(z, x, *a))(z)
        np.testing.assert_allclose(_np(Ji[e]), _np(Ai), atol=1e-5)
        np.testing.assert_allclose(_np(Jj[e]), _np(Aj), atol=1e-5)

    zj = jnp.zeros(6)

    @jax.jit
    @jax.vmap
    def ref_terms(*a):
        return (JPG._edge_residual(*a),
                jax.jacfwd(lambda x: JPG._edge_res_perturbed(x, zj, *a))(zj),
                jax.jacfwd(lambda x: JPG._edge_res_perturbed(zj, x, *a))(zj))

    ja = [jnp.asarray(_np(x)) for x in (R[ei], p[ei], R[ej], p[ej], Rm, pm)]
    for got, ref in zip((res, Ji, Jj), ref_terms(*ja)):
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5)


@pytest.fixture(scope="module")
def feed():
    """A packed synthetic feature feed (numpy) and pose estimates: the
    ground truth perturbed with a seed, in place of a filter run."""
    from visma_tpu_torch.filter.config import FilterConfig
    from visma_tpu_torch.filter.feed import pack_frames
    from visma_tpu_torch.io.synthetic import (SyntheticConfig, make_dataset,
                                              make_trajectory)

    syn = SyntheticConfig(num_frames=40, num_landmarks=150, pixel_noise=0.5,
                          seed=3)
    cfg = FilterConfig(window=8, max_tracks=96, fx=syn.fx, fy=syn.fy,
                       cx=syn.cx, cy=syn.cy)
    packed = pack_frames(cfg, make_dataset(syn), None, max_feats=96)
    _, gwc = make_trajectory(syn)
    rng = np.random.default_rng(11)
    R = np.stack([g[:, :3] @ Rotation.from_rotvec(
        rng.normal(scale=0.01, size=3)).as_matrix() for g in gwc])
    p = gwc[:, :, 3] + rng.normal(scale=0.02, size=(len(gwc), 3))
    obs = (packed["ids"], packed["xp"], packed["valid"])
    return obs, R.astype(np.float32), p.astype(np.float32), \
        (cfg.fx, cfg.fy, cfg.cx, cfg.cy)


def test_from_vio_problem_matches_reference(feed):
    """The same feed arrays and estimates give the same keyframes, ids,
    observations, mask and triangulated landmarks (1e-6), with and without
    the landmark cap; the reference's numpy helpers agree exactly."""
    obs, R, p, intr = feed
    np.testing.assert_array_equal(TF.select_keyframes(10, 4),
                                  JF.select_keyframes(10, 4))
    for kw in (dict(stride=3), dict(stride=2, max_landmarks=40)):
        jp, jinfo = JF.ba_problem_from_vio(*obs, R, p, intr, **kw)
        tp, tinfo = TF.ba_problem_from_vio(*obs, R, p, intr, device="cpu",
                                           **kw)
        np.testing.assert_array_equal(tinfo["kf"], jinfo["kf"])
        np.testing.assert_array_equal(tinfo["ids"], jinfo["ids"])
        np.testing.assert_array_equal(_np(tp.mask), np.asarray(jp.mask))
        for f in ("obs", "X", "R", "p", "intr"):
            np.testing.assert_allclose(_np(getattr(tp, f)),
                                       np.asarray(getattr(jp, f)), atol=1e-6)
        assert tp.num_landmarks <= kw.get("max_landmarks", 512)


def test_refine_trajectory_matches_reference(feed):
    """The reference's BA solution, carried across, written back over every
    frame by both packages: the same body poses to 1e-6."""
    obs, R, p, intr = feed
    jp, info = JF.ba_problem_from_vio(*obs, R, p, intr, stride=3)
    jsol, _ = JG.ba_solve(jp, iters=6)
    R_j, p_j = JF.refine_trajectory(jsol, info, R, p)
    R_t, p_t = TF.refine_trajectory(_port(jsol), info, R, p)
    np.testing.assert_allclose(R_t, R_j, atol=1e-6)
    np.testing.assert_allclose(p_t, p_j, atol=1e-6)
    assert R_t.dtype == p_t.dtype == np.float32


def test_run_vio_ba_dense_on_the_cpu(tmp_path, capsys):
    """`run_vio --synthetic 48 --no-imu --ba dense --ba-stride 2 --device
    cpu`: the similarity-aligned ATE of the BA trajectory below the
    filter's (tests/test_ba_from_vio.py:234), both datasets written and
    loadable with 48 packets; `--ba sharded` is no longer refused (it runs
    since dist/ is ported: tests/test_torch_dist.py holds it to `--ba
    dense`)."""
    from visma_tpu_torch.cli.run_vio import main
    from visma_tpu_torch.io import VlslamDatasetLoader

    out = tmp_path / "est"
    report = main(["--synthetic", "48", "--pixel-noise", "1.0", "--no-imu",
                   "--ba", "dense", "--ba-stride", "2", "--output", str(out),
                   "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert printed == report
    assert report["ba"] == "dense" and report["ba_keyframes"] == 25
    for k in ("ba_landmarks", "ate_ba_m", "ate_kf_m", "ate_kf_ba_m"):
        assert np.isfinite(report[k]), k
    assert report["ate_ba_sim_aligned_m"] < report["ate_sim_aligned_m"]
    for name in ("dataset", "dataset_ba"):
        assert (out / name).exists()
    assert len(VlslamDatasetLoader(str(out))) == 48
    (tmp_path / "ba").mkdir()
    (tmp_path / "ba" / "dataset").write_bytes((out / "dataset_ba")
                                              .read_bytes())
    assert len(VlslamDatasetLoader(str(tmp_path / "ba"))) == 48

    capsys.readouterr()
    report = main(["--synthetic", "8", "--ba", "sharded", "--device", "cpu"])
    assert "not ported" not in capsys.readouterr().err
    assert report["frames"] == 8
