"""The refinement solvers' compiled run on the CPU: `ba_solve`, `ba_step`,
`pose_graph_solve` and the mesh solvers through the graph runners of
`utils.graphs` (`graph=True`: on the CPU the graph's static buffers
without capture) against their eager loops (`graph=False`) bit for bit,
and against the JAX package's solves at test_torch_ba.py's tolerances;
a second problem of the same shapes through the cached graph (a tensor
read from a closure would give it the first problem's answer), and the
rule of which meshes capture (`Mesh.graphed`)."""
import socket
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from visma_tpu.ba import gauss_newton as JG
from visma_tpu.ba import pose_graph as JPG
from visma_tpu.ba.problem import synthetic_ba_problem as j_synthetic

from visma_tpu_torch.ba import gauss_newton as TG
from visma_tpu_torch.ba import pose_graph as TPG
from visma_tpu_torch.ba.problem import synthetic_ba_problem as t_synthetic
from visma_tpu_torch.dist import mesh as tmesh
from visma_tpu_torch.dist import sharded_ba as TS
from visma_tpu_torch.dist.mesh import Mesh
from visma_tpu_torch.dist.pcg_ba import pcg_ba_solve
from visma_tpu_torch.utils.graphs import StepGraph

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_ba import COST_REL, POSE_TOL, STEP_TOL, _circle  # noqa: E402

# synthetic_ba_problem(num_poses, num_landmarks, noise_px, pose_noise, seed)
PROBLEMS = {"8x64": (8, 64, 0.5, 0.03, 0), "5x40": (5, 40, 1.0, 0.02, 3)}
ITERS = 10
CG_ITERS = 12


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy()


def _equal(a, b):
    """Every tensor of two (solution, history) pairs equal bit for bit."""
    (sa, ha), (sb, hb) = a, b
    for f in ("R", "p", "X"):
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    assert torch.equal(ha, hb)


@pytest.fixture(scope="module")
def solves():
    """Per problem: the port's problem, its solve graphed and eager, and
    the JAX package's solve of the same problem."""
    out = {}
    for name, args in PROBLEMS.items():
        prob, _ = t_synthetic(*args, device="cpu")
        jsol, _ = JG.ba_solve(j_synthetic(*args)[0], iters=ITERS)
        out[name] = (prob, TG.ba_solve(prob, ITERS, graph=True),
                     TG.ba_solve(prob, ITERS, graph=False), jsol)
    return out


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_ba_solve_graph_equals_eager_and_the_reference(name, solves):
    """The LM loop through StepGraph's buffers is the eager loop bit for
    bit; both within 1e-3 in the cost and 2e-2 m in the poses of the JAX
    package's solve; the history is the cost after each step."""
    prob, graphed, eager, jsol = solves[name]
    _equal(graphed, eager)
    sol, hist = graphed
    assert hist.shape == (ITERS,)
    assert float(hist[-1]) == float(TG.total_cost(sol))
    c_ref = float(JG.total_cost(jsol))
    assert abs(float(TG.total_cost(sol)) - c_ref) / c_ref < COST_REL
    assert np.abs(_np(sol.p) - np.asarray(jsol.p)).max() < POSE_TOL
    assert sol.obs is prob.obs and sol.mask is prob.mask


def test_second_problem_through_the_cached_graph(solves, monkeypatch):
    """Two problems of the same shapes (other seeds) through one StepGraph:
    the second gets its own eager answer, and the graph holds one entry.
    A tensor that the step read from a closure instead of the buffers
    would hand the second solve the first one's numbers."""
    monkeypatch.setattr(TG, "_RUN", StepGraph(TG._lm_body))
    K, L, noise, pose_noise, _ = PROBLEMS["8x64"]
    for seed in (5, 6):
        prob, _ = t_synthetic(K, L, noise, pose_noise, seed, device="cpu")
        _equal(TG.ba_solve(prob, ITERS, graph=True),
               TG.ba_solve(prob, ITERS, graph=False))
    assert len(TG._RUN._entries) == 1


def test_ba_step_call_graph(solves):
    """`ba_step` through its CallGraph equals the eager step bit for bit,
    on its first and its second call (the capture's place on the card),
    and the JAX step within 2e-4 m."""
    prob = solves["8x64"][0]
    anchor = torch.linalg.norm(prob.p[-1] - prob.p[0])
    eager, e_cost = TG.ba_step(prob, 1e-3, anchor, graph=False)
    for _ in range(2):
        got, cost = TG.ba_step(prob, 1e-3, anchor, graph=True)
        for f in ("R", "p", "X"):
            assert torch.equal(getattr(got, f), getattr(eager, f)), f
        assert torch.equal(cost, e_cost) and got.obs is prob.obs
    jprob = j_synthetic(*PROBLEMS["8x64"])[0]
    js, _ = JG.ba_step(jprob, jnp.float32(1e-3),
                       jnp.float32(float(anchor)))
    assert np.abs(_np(got.p) - np.asarray(js.p)).max() < STEP_TOL


def test_pose_graph_graph_equals_eager_and_the_reference():
    """The 16-node circle, 15 iterations: through StepGraph's buffers bit
    for bit the eager loop, and within 1e-4 of the JAX package's solve."""
    args, _, _ = _circle(K=16)
    t_args = [torch.as_tensor(a) for a in args]
    R_g, p_g = TPG.pose_graph_solve(*t_args, iters=15, graph=True)
    R_e, p_e = TPG.pose_graph_solve(*t_args, iters=15, graph=False)
    assert torch.equal(R_g, R_e) and torch.equal(p_g, p_e)
    R_j, p_j = JPG.pose_graph_solve(*map(jnp.asarray, args), iters=15)
    np.testing.assert_allclose(_np(p_g), np.asarray(p_j), atol=1e-4)
    np.testing.assert_allclose(_np(R_g), np.asarray(R_j), atol=1e-4)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_mesh_solver_graph_equals_eager(solver, solves):
    """The dense and PCG loops on the group-less one-rank mesh through
    their StepGraph's buffers: bit for bit the eager loop, the history the
    cost each step started from, and the same all_reduces a GN step (dense
    3, PCG cg_iters + 3) counted in both."""
    prob = solves["8x64"][0]
    mesh = tmesh.make_mesh(device="cpu")
    got, counts = {}, {}
    for graph in (True, False):
        mesh.counts.update(all_reduce=0, all_gather=0)
        got[graph] = (TS.sharded_ba_solve(prob, mesh, ITERS, solver="dense",
                                          graph=graph)
                      if solver == "dense" else
                      pcg_ba_solve(prob, mesh, ITERS, cg_iters=CG_ITERS,
                                   graph=graph))
        counts[graph] = dict(mesh.counts)
    _equal(got[True], got[False])
    hist = got[True][1]
    assert float(hist[0]) == float(TG.total_cost(prob))
    assert (np.diff(_np(hist)) <= 0).all()
    per_step = 3 if solver == "dense" else CG_ITERS + 3
    assert counts[True] == counts[False] == {"all_reduce": per_step * ITERS,
                                             "all_gather": 1}


@pytest.fixture
def gloo_group():
    """A one-rank gloo process group in this process."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=1, rank=0)
    try:
        yield tdist.group.WORLD
    finally:
        tdist.destroy_process_group()


def test_which_meshes_capture(gloo_group, solves, monkeypatch):
    """Mesh.graphed: on a CUDA device the group-less mesh and an nccl
    group capture, a gloo group loops eagerly and refuses graph=True; on
    the CPU graph=None is the eager loop and graph=True the static buffers
    on any backend. The gloo mesh's solve with graph=None is the eager
    loop and caches no graph."""
    cuda = torch.device("cuda")
    gloo = Mesh(group=gloo_group, rank=0, size=1, device=cuda)
    assert Mesh(group=None, rank=0, size=1, device=cuda).graphed(None)
    assert not gloo.graphed(None) and not gloo.graphed(False)
    with pytest.raises(ValueError, match="gloo group cannot be captured"):
        gloo.graphed(True)
    with pytest.raises(ValueError, match="gloo group cannot be captured"):
        TS.lm_runner(gloo, (gloo, "dense"), TS._sharded_step, True)
    cpu_mesh = tmesh.make_mesh(device="cpu")
    assert cpu_mesh.group is gloo_group
    assert not cpu_mesh.graphed(None) and cpu_mesh.graphed(True)
    prob = solves["8x64"][0]
    _equal(TS.sharded_ba_solve(prob, cpu_mesh, ITERS, solver="dense"),
           TS.sharded_ba_solve(prob, cpu_mesh, ITERS, solver="dense",
                               graph=False))
    assert not [k for k in TS._RUNS if k[0] is cpu_mesh]
    monkeypatch.setattr(tmesh.dist, "get_backend", lambda group: "nccl")
    assert gloo.graphed(None) and gloo.graphed(True)
