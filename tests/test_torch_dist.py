"""The port's distributed layer (visma_tpu_torch.dist: the landmark-sharded
step and solve, the matrix-free PCG, the submap solver, the mesh and its
collectives) against the JAX package on the CPU.

Four gloo ranks, spawned once for the module (this file's `__main__`
branch is the rank), run every case of `CASES` on the same seeded problems
and write what they got; the JAX package runs the same cases on
`make_mesh(4)` of its 8 virtual CPU devices, as tests/test_pcg_ba.py and
tests/test_submap.py do. The problems are those tests' own.

Tolerances: one GN step of a float32 problem is ill-conditioned (gauge
rows and the scale prior at 1e6), so the port's sharded step is held to
the JAX package's sharded step and to the port's `ba_step` at the
reference's 2e-4 (__graft_entry__.py:70-71), and its cost at 5e-3
relative: one step's cost moves by 1.1e-3 relative between the JAX
package's own 1-, 4- and 8-device meshes on 8 x 96, and the port's
single-device step is 1.8e-3 from a float64 step. The dense and pcg
solves to the JAX package's at tests/test_multihost.py's 5e-4 in the poses
and step by step at that 5e-3 in the cost history, the last cost of a
10-step solve at 1e-5 relative (the 3-step padding solves stop before they
converge: 1e-4).

The submap solver's chunk solves are ill-conditioned in float32 (five
poses and a one-frame halo): on 16 x 128 (seed 2) chunk 1's solve lands
0.90 m from a float64 solve in one landmark in the JAX package and 0.39 m
in the port, so the two packages' submap results differ by up to 3e-2 m
and are not held to each other. The submap is held to the reference
tests' own quality gates (tests/test_submap.py, tests/test_pcg_ba.py:126),
and its stitch to the JAX package's stitch of the same chunk solutions.
Replicated outputs are identical on every rank, bit for bit.
"""
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
N_RANKS = 4
RANK_TIMEOUT_S = 120

STEP_TOL = 2e-4
STEP_COST_REL = 5e-3
COST_REL = {10: 1e-5, 3: 1e-4}   # the last cost, by GN steps
POSE_TOL = 5e-4
STITCH_TOL = 1e-5

# synthetic_ba_problem(num_poses, num_landmarks, noise_px, pose_noise, seed)
PROBLEMS = {
    "6x64": (6, 64, 0.5, 0.02, 0),       # tests/test_pcg_ba.py:26
    "8x96": (8, 96, 0.5, 0.03, 0),       # tests/test_pcg_ba.py:61
    "6x50": (6, 50, 1.0, 0.02, 0),       # tests/test_pcg_ba.py:78, L % 4 != 0
    "16x128": (16, 128, 0.5, 0.03, 2),   # tests/test_submap.py:44
    "24x128": (24, 128, 0.5, 0.03, 4),   # tests/test_submap.py:66
    "16x128p": (16, 128, 0.5, 0.02, 0),  # tests/test_pcg_ba.py:129
}
# case -> (solver, problem, keyword arguments)
CASES = {
    "step-8x96": ("step", "8x96", {}),
    "step-6x64": ("step", "6x64", {}),
    "dense-8x96": ("dense", "8x96", dict(iters=10)),
    "pcg-8x96": ("pcg", "8x96", dict(iters=10, cg_iters=30)),
    "dense-6x50": ("dense", "6x50", dict(iters=3)),
    "pcg-6x50": ("pcg", "6x50", dict(iters=3, cg_iters=20)),
    "submap-halo1": ("submap", "16x128", dict(iters=10, halo=1,
                                              consensus=True)),
    "submap-halo1-owner": ("submap", "16x128", dict(iters=10, halo=1,
                                                    consensus=False)),
    "submap-halo2": ("submap", "24x128", dict(iters=10, halo=2,
                                              consensus=True)),
    "submap-pcg-polish": ("submap", "16x128p", dict(iters=6, polish_iters=3,
                                                    polish_solver="pcg")),
}
# the reference tests' gates on a submap solve: similarity-aligned ATE
# below `ate_max` and below `ate_frac` x the initial one, total cost below
# `cost_frac` x the initial one (tests/test_submap.py:41-83,
# tests/test_pcg_ba.py:126-139)
SUBMAP_GATES = {
    "submap-halo1": dict(ate_max=0.035, ate_frac=0.5, cost_frac=0.5),
    "submap-halo1-owner": dict(ate_frac=0.5),
    "submap-halo2": dict(ate_frac=0.35, cost_frac=0.5),
    "submap-pcg-polish": dict(ate_max=0.02),
}
MATVEC_PROBLEM, MATVEC_DAMPING, MATVEC_VECTORS = "6x64", 1e-3, 5
COUNT_CG_ITERS = 30


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are small: one torch thread is faster than many
    beside the suite's other workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _port_problem(name):
    from visma_tpu_torch.ba.problem import synthetic_ba_problem

    return synthetic_ba_problem(*PROBLEMS[name], device="cpu")[0]


def run_port_case(case, mesh):
    """One case on the port: {R, p, X, cost (a 0-d or history)}."""
    from visma_tpu_torch import dist
    from visma_tpu_torch.dist.submap_ba import submap_ba_solve

    solver, name, kw = CASES[case]
    prob = _port_problem(name)
    if solver == "step":
        sol, cost = dist.sharded_ba_step(prob, mesh, damping=1e-3, **kw)
    elif solver == "submap":
        sol, _ = submap_ba_solve(prob, mesh, **kw)
        from visma_tpu_torch.ba.gauss_newton import total_cost

        cost = total_cost(sol)
    else:
        sol, cost = dist.sharded_ba_solve(prob, mesh, solver=solver, **kw)
    return {"R": _np(sol.R), "p": _np(sol.p), "X": _np(sol.X),
            "cost": _np(cost)}


def _matvec_vectors():
    K = PROBLEMS[MATVEC_PROBLEM][0]
    rng = np.random.default_rng(0)
    return rng.standard_normal((MATVEC_VECTORS, 6 * K)).astype(np.float32)


def _rank_main(rank, world, addr, out_dir):
    """One gloo rank: every case, the PCG operator, the collective counts
    and a mesh that leaves ranks out; writes rank{r}.npz."""
    torch.set_num_threads(1)
    import torch.distributed as tdist

    from visma_tpu_torch.dist import make_mesh, sharded_ba_step
    from visma_tpu_torch.dist.pcg_ba import _pcg_step, _schur_pieces
    from visma_tpu_torch.dist.sharded_ba import _shard_problem
    from visma_tpu_torch.utils.misc import full_f32

    tdist.init_process_group("gloo", init_method=f"tcp://{addr}",
                             world_size=world, rank=rank)
    mesh = make_mesh(device="cpu")
    res = {}
    for case in CASES:
        for k, v in run_port_case(case, mesh).items():
            res[f"{case}/{k}"] = v

    shard, _ = _shard_problem(_port_problem(MATVEC_PROBLEM), mesh)
    with full_f32():
        matvec, _, b, _ = _schur_pieces(shard, MATVEC_DAMPING, 1e6, mesh)
        res["matvec/Sv"] = np.stack([_np(matvec(torch.as_tensor(v)))
                                     for v in _matvec_vectors()])
    res["matvec/b"] = _np(b)

    prob = _port_problem("8x96")
    mesh.counts.update(all_reduce=0, all_gather=0)
    sharded_ba_step(prob, mesh)
    res["counts/dense_step"] = np.array([mesh.counts["all_reduce"],
                                         mesh.counts["all_gather"]])
    shard, _ = _shard_problem(prob, mesh)
    mesh.counts.update(all_reduce=0, all_gather=0)
    _pcg_step(shard, torch.tensor(1e-3), mesh, COUNT_CG_ITERS)
    res["counts/pcg_step"] = np.array([mesh.counts["all_reduce"],
                                       mesh.counts["all_gather"]])

    half = make_mesh(world // 2, device="cpu")
    try:
        sol, _ = sharded_ba_step(prob, half)
        res["half/p"] = _np(sol.p)
    except RuntimeError as e:
        res["half/refused"] = np.array(str(e))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    tdist.destroy_process_group()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def _spawned(tmp_path_factory):
    """The four ranks, started (not waited for)."""
    out = tmp_path_factory.mktemp("dist_ranks")
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + ([os.environ["PYTHONPATH"]]
                       if os.environ.get("PYTHONPATH") else [])),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(N_RANKS), addr, str(out)],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(N_RANKS)]
    yield out, procs
    for p in procs:
        if p.poll() is None:
            p.kill()  # exact pids we spawned
            p.wait()


@pytest.fixture(scope="module")
def reference(_spawned):
    """The JAX package's results for every case, on make_mesh(4) of its
    virtual CPU devices (computed while the ranks run)."""
    from visma_tpu.ba.gauss_newton import total_cost
    from visma_tpu.ba.problem import synthetic_ba_problem
    from visma_tpu.dist import make_mesh
    from visma_tpu.dist.sharded_ba import sharded_ba_solve, sharded_ba_step
    from visma_tpu.dist.submap_ba import submap_ba_solve

    mesh = make_mesh(N_RANKS)
    out = {}
    for case, (solver, name, kw) in CASES.items():
        prob, _ = synthetic_ba_problem(*PROBLEMS[name])
        if solver == "step":
            sol, cost = sharded_ba_step(prob, mesh, damping=1e-3, **kw)
        elif solver == "submap":
            sol, _ = submap_ba_solve(prob, mesh, **kw)
            cost = total_cost(sol)
        else:
            sol, cost = sharded_ba_solve(prob, mesh, solver=solver, **kw)
        out[case] = {k: np.asarray(v) for k, v in
                     dict(R=sol.R, p=sol.p, X=sol.X, cost=cost).items()}
    return out


@pytest.fixture(scope="module")
def ranks(_spawned):
    """Every rank's results: {case: [rank 0's dict, ...]}."""
    out, procs = _spawned
    deadline = time.time() + RANK_TIMEOUT_S
    for p in procs:
        try:
            log, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()  # exact pids we spawned
            pytest.fail(f"the gloo ranks ran past {RANK_TIMEOUT_S} s")
        assert p.returncode == 0, log.decode()
    res = [dict(np.load(out / f"rank{r}.npz")) for r in range(N_RANKS)]
    grouped = {}
    for r in range(N_RANKS):
        for key, v in res[r].items():
            case, field = key.split("/")
            grouped.setdefault(case, [{} for _ in range(N_RANKS)])
            grouped[case][r][field] = v
    return grouped


@pytest.mark.parametrize("case", [c for c in CASES
                                  if CASES[c][0] == "step"])
def test_sharded_step_matches_reference_and_ba_step(case, reference,
                                                    ranks):
    """One GN step over 4 ranks against the JAX package's sharded step on 4
    devices and against the port's single-device `ba_step` (scale anchor
    from the same poses)."""
    from visma_tpu_torch.ba.gauss_newton import ba_step

    got, ref = ranks[case][0], reference[case]
    prob = _port_problem(CASES[case][1])
    anchor = torch.linalg.norm(prob.p[-1] - prob.p[0])
    one, one_cost = ba_step(prob, torch.tensor(1e-3), anchor)
    for other in (ref["p"], _np(one.p)):
        assert np.abs(got["p"] - other).max() < STEP_TOL
    assert np.abs(got["R"] - ref["R"]).max() < STEP_TOL
    for c in (ref["cost"], _np(one_cost)):
        assert abs(got["cost"] - c) <= STEP_COST_REL * abs(c)


@pytest.mark.parametrize("case", [c for c in CASES
                                  if CASES[c][0] in ("dense", "pcg")])
def test_solver_matches_reference(case, reference, ranks):
    """Dense and pcg solves (landmark padding at L = 50 over 4 ranks too)
    against the JAX package's on the same mesh size."""
    _, name, kw = CASES[case]
    got, ref = ranks[case][0], reference[case]
    assert got["X"].shape == ref["X"].shape == (PROBLEMS[name][1], 3)
    assert np.isfinite(got["cost"]).all()
    np.testing.assert_allclose(got["cost"], ref["cost"], rtol=STEP_COST_REL)
    assert abs(got["cost"][-1] - ref["cost"][-1]) \
        <= COST_REL[kw["iters"]] * ref["cost"][-1]
    assert np.abs(got["p"] - ref["p"]).max() < POSE_TOL
    assert np.abs(got["R"] - ref["R"]).max() < POSE_TOL


def _sim3_ate(p_est, p_gt):
    from visma_tpu_torch.align.umeyama import umeyama

    T = umeyama(torch.as_tensor(p_est, dtype=torch.float32),
                torch.as_tensor(p_gt, dtype=torch.float32),
                with_scaling=True).numpy()
    p_al = p_est @ T[:3, :3].T + T[:3, 3]
    return float(np.linalg.norm(p_al - p_gt, axis=1).max())


@pytest.mark.parametrize("case", [c for c in CASES
                                  if CASES[c][0] == "submap"])
def test_submap_meets_the_reference_gates(case, ranks):
    """Submap over 4 ranks (halo 1 and 2, consensus on and off, a pcg
    polish) passes the gates the reference's own tests set it."""
    from visma_tpu_torch.ba.gauss_newton import total_cost
    from visma_tpu_torch.ba.problem import synthetic_ba_problem

    name = CASES[case][1]
    prob, truth = synthetic_ba_problem(*PROBLEMS[name], device="cpu")
    got, gate = ranks[case][0], SUBMAP_GATES[case]
    assert got["X"].shape == (PROBLEMS[name][1], 3)
    ate0 = _sim3_ate(_np(prob.p), truth["p"])
    ate = _sim3_ate(got["p"], truth["p"])
    assert ate < gate.get("ate_max", np.inf), ate
    assert ate < gate.get("ate_frac", np.inf) * ate0, (ate, ate0)
    assert float(got["cost"]) \
        < gate.get("cost_frac", np.inf) * float(total_cost(prob))


@pytest.mark.parametrize("case", ["submap-halo1", "submap-halo1-owner",
                                  "submap-halo2"])
def test_stitch_matches_reference(case):
    """The stitch (chordal mean over the halo, the pose graph over the
    chunk anchors, owner or consensus write-back) of the same chunk
    solutions equals the JAX package's to 1e-5."""
    import jax.numpy as jnp

    from visma_tpu.ba.problem import BaProblem as JBaProblem
    from visma_tpu.ba.problem import synthetic_ba_problem as j_synthetic
    from visma_tpu.dist.submap_ba import _stitch as j_stitch

    from visma_tpu_torch.ba.problem import BaProblem
    from visma_tpu_torch.dist.submap_ba import (_local_solve, _stitch,
                                                split_into_chunks)

    _, name, kw = CASES[case]
    prob = _port_problem(name)
    chunks, info = split_into_chunks(prob, N_RANKS, halo=kw["halo"])
    info["consensus"] = kw["consensus"]
    fields = ("R", "p", "X", "obs", "mask", "intr")
    sols = [_local_solve(BaProblem(*(getattr(chunks, f)[d] for f in fields)),
                         kw["iters"]) for d in range(N_RANKS)]
    sol = chunks.replace(**{f: torch.stack([getattr(x, f) for x in sols])
                            for f in ("R", "p", "X")})
    got = _stitch(prob, sol, info)
    jsol = JBaProblem(*(jnp.asarray(_np(getattr(sol, f))) for f in fields))
    ref = j_stitch(j_synthetic(*PROBLEMS[name])[0], jsol, info)
    for f in ("R", "p", "X"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(ref, f)),
                                   atol=STITCH_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_replicated_outputs_identical_across_ranks(case, ranks):
    """The poses, landmarks and costs every rank gets back are the same
    bytes."""
    r0 = ranks[case][0]
    for other in ranks[case][1:]:
        for k in ("R", "p", "X", "cost"):
            np.testing.assert_array_equal(other[k], r0[k])


def test_matvec_matches_dense(ranks):
    """The reduced matrix-free S@v (gauge pinning, damping, floor and the
    scale-anchor prior) equals the dense reduced system's product, and the
    reduced right-hand side its b (tests/test_pcg_ba.py:18-55)."""
    from visma_tpu_torch.ba.gauss_newton import build_reduced_system
    from visma_tpu_torch.utils.misc import full_f32

    prob = _port_problem(MATVEC_PROBLEM)
    with full_f32():
        anchor = torch.linalg.norm(prob.p[-1] - prob.p[0])
        S, b, _ = build_reduced_system(prob, MATVEC_DAMPING,
                                       scale_anchor=anchor, scale_weight=1e6)
        Sv_dense = _np(torch.as_tensor(_matvec_vectors()) @ S.T)
    got = ranks["matvec"][0]
    scale = np.abs(Sv_dense).max()
    np.testing.assert_allclose(got["Sv"], Sv_dense, atol=2e-5 * scale)
    np.testing.assert_allclose(got["b"], _np(b),
                               atol=2e-5 * max(1.0, np.abs(_np(b)).max()))
    for other in ranks["matvec"][1:]:
        np.testing.assert_array_equal(other["Sv"], got["Sv"])


def test_collective_counts(ranks):
    """Per GN step the dense path reduces S, b and the cost (3
    all_reduces); the pcg path D, b, one (6K,) vector a CG iteration and the
    cost (cg_iters + 2 + 1); sharded_ba_step gathers the landmarks once."""
    for r in range(N_RANKS):
        c = ranks["counts"][r]
        assert list(c["dense_step"]) == [3, 1]
        assert list(c["pcg_step"]) == [COUNT_CG_ITERS + 2 + 1, 0]


def test_ranks_outside_the_mesh_raise(ranks):
    """make_mesh(2) on 4 ranks: ranks 0 and 1 step together (the same
    bytes), ranks 2 and 3 are refused when they use the mesh."""
    half = ranks["half"]
    np.testing.assert_array_equal(half[0]["p"], half[1]["p"])
    assert np.isfinite(half[0]["p"]).all()
    for r in (2, 3):
        assert "p" not in half[r]
        assert "not in the 2-rank mesh" in str(half[r]["refused"])


# ---- in-process cases: the one-rank mesh, the routing, the chunking ------

def _one_rank():
    from visma_tpu_torch.dist import make_mesh

    return make_mesh(device="cpu")


@pytest.mark.parametrize("name, n, halo", [("16x128", 4, 1),
                                           ("24x128", 4, 2),
                                           ("6x64", 3, 1)])
def test_split_into_chunks_is_the_reference(name, n, halo):
    """The chunking is the reference's, array for array: linspace bounds,
    votes >= 2, argmax owners, edge-padded poses, the masked duplicate
    columns."""
    from visma_tpu.ba.problem import synthetic_ba_problem
    from visma_tpu.dist.submap_ba import split_into_chunks as j_split

    from visma_tpu_torch.dist.submap_ba import split_into_chunks

    jc, ji = j_split(synthetic_ba_problem(*PROBLEMS[name])[0], n, halo=halo)
    tc, ti = split_into_chunks(_port_problem(name), n, halo=halo)
    assert ti.keys() == ji.keys()
    for k in ji:
        np.testing.assert_array_equal(ti[k], ji[k])
    for f in ("R", "p", "X", "obs", "mask", "intr"):
        got, ref = _np(getattr(tc, f)), np.asarray(getattr(jc, f))
        assert got.dtype == ref.dtype, f
        np.testing.assert_array_equal(got, ref)


def test_auto_crossover(monkeypatch):
    """auto = dense below the crossover, pcg above it
    (tests/test_pcg_ba.py:108-127); an unknown solver is refused."""
    from visma_tpu_torch.ba.problem import synthetic_ba_problem
    from visma_tpu_torch.dist import pcg_ba, sharded_ba as sba

    calls = []
    monkeypatch.setattr(pcg_ba, "pcg_ba_solve",
                        lambda prob, mesh, **kw: calls.append("pcg")
                        or (prob, None))
    monkeypatch.setattr(sba, "_lm_loop",
                        lambda step, shard, c0, lam, iters:
                        calls.append("dense") or (shard, None))
    small, _ = synthetic_ba_problem(num_poses=6, num_landmarks=32,
                                    device="cpu")
    big, _ = synthetic_ba_problem(num_poses=sba.PCG_CROSSOVER_K + 1,
                                  num_landmarks=32, device="cpu")
    mesh = _one_rank()
    sba.sharded_ba_solve(small, mesh, iters=1, solver="auto")
    sba.sharded_ba_solve(big, mesh, iters=1, solver="auto")
    assert calls == ["dense", "pcg"]
    with pytest.raises(ValueError, match="unknown solver"):
        sba.sharded_ba_solve(small, mesh, solver="cholesky")


def test_one_rank_mesh_is_the_single_device_solver():
    """Without a process group the mesh has one rank and every reduction is
    the identity: the sharded step is `ba_step` (scale anchor from the
    step's own poses) to 1e-6, the dense solve is that step in the LM loop
    to 1e-6, and it lands within the dryrun's gates (2e-2 m, 1e-3 in the
    cost) of `ba_solve`, which holds its anchor at the initial poses."""
    from visma_tpu_torch.ba.gauss_newton import ba_solve, ba_step, total_cost
    from visma_tpu_torch.dist import sharded_ba_solve, sharded_ba_step

    mesh = _one_rank()
    prob = _port_problem("8x96")
    anchor = torch.linalg.norm(prob.p[-1] - prob.p[0])
    one, _ = ba_step(prob, torch.tensor(1e-3), anchor)
    got, _ = sharded_ba_step(prob, mesh)
    assert float((got.p - one.p).abs().max()) <= 1e-6
    assert float((got.X - one.X).abs().max()) <= 1e-6

    lam = torch.tensor(1e-3)
    cur, cost = prob, total_cost(prob)
    for _ in range(10):
        cand, c = ba_step(cur, lam, torch.linalg.norm(cur.p[-1] - cur.p[0]))
        better = c < cost
        cur = cur.replace(R=torch.where(better, cand.R, cur.R),
                          p=torch.where(better, cand.p, cur.p),
                          X=torch.where(better, cand.X, cur.X))
        lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-6),
                          torch.clamp(lam * 4.0, max=1e2))
        cost = torch.where(better, c, cost)
    sol, hist = sharded_ba_solve(prob, mesh, iters=10, solver="dense")
    assert float((sol.p - cur.p).abs().max()) <= 1e-6
    assert float(hist[0]) == float(total_cost(prob))

    oracle, _ = ba_solve(prob, iters=10)
    assert float((sol.p - oracle.p).abs().max()) < 2e-2
    c_or = float(total_cost(oracle))
    assert (float(total_cost(sol)) - c_or) / c_or < 1e-3


def test_problem_on_another_device_is_refused():
    from visma_tpu_torch.dist import sharded_ba_step
    from visma_tpu_torch.dist.mesh import Mesh

    mesh = Mesh(group=None, rank=0, size=1, device=torch.device("meta"))
    with pytest.raises(ValueError, match="computes on meta"):
        sharded_ba_step(_port_problem("6x64"), mesh)


def test_run_vio_ba_sharded_equals_dense(capsys):
    """`run_vio --synthetic 24 --no-imu --ba sharded` runs (one process: the
    one-rank mesh) and lands where `--ba dense` does: the report's keys are
    the same and the refined ATEs agree within the dryrun's pose gate."""
    from visma_tpu_torch.cli.run_vio import main

    args = ["--synthetic", "24", "--no-imu", "--ba-stride", "2",
            "--device", "cpu"]
    sharded = main(args + ["--ba", "sharded"])
    dense = main(args + ["--ba", "dense"])
    capsys.readouterr()
    assert sharded["ba"] == "sharded" and dense["ba"] == "dense"
    assert sharded.keys() == dense.keys()
    for k in ("ate_ba_m", "ate_kf_ba_m", "ate_ba_sim_aligned_m"):
        assert abs(sharded[k] - dense[k]) < 2e-2, k
    assert sharded["ate_rmse_m"] == dense["ate_rmse_m"]
    assert sharded["ba_landmarks"] == dense["ba_landmarks"]


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
