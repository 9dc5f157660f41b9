"""Landmark-sharded distributed bundle adjustment (port of
visma_tpu/dist/sharded_ba.py).

The landmark axis L shards over the mesh (landmarks are conditionally
independent given the poses: the Schur complement is a sum of
per-landmark terms). Each rank, every GN step:

  local build:   S_local, b_local from the rank's landmark shard
  collective:    (S, b) = all_reduce over the mesh, one (6K)^2 + one 6K
  replicated:    dense Cholesky solve for the pose update
  local:         landmark back-substitution on the shard

and one all_reduce of the shard's cost. Communication is O((6K)^2) a
step, independent of L. Every rank calls the solver with the same whole
problem and gets the whole solution back: the poses and costs are
replicated (equal on every rank bit for bit), the landmark shards are put
together by one all_gather at the end.

The reference caches its jitted executables by the mesh's value
(`_jitted_step`, `_jitted_solver`, sharded_ba.py:91-121: `lru_cache(
maxsize=16)`; a JAX mesh hashes by its devices and axis). Here, where the
mesh captures (`Mesh.graphed`: the one-rank mesh without a group, an nccl
group), the step is a `CallGraph` and the LM loop a `StepGraph` a GN step
(`utils.graphs`), cached the same way: by the mesh's value (`mesh_key`),
so that two `make_mesh()` calls share one capture, and the 16 most
recently used entries only; an evicted entry's graph and memory pool go
with it. A cached runner counts the collectives of the mesh it is called
with, as the eager step does. On a gloo group the loop is eager.
"""
from __future__ import annotations

from collections import OrderedDict
from functools import partial
from typing import Callable, Optional, Tuple

import torch

from visma_tpu_torch.ba.gauss_newton import (_apply, backsub_landmarks,
                                             build_reduced_system,
                                             cho_solve_sym, total_cost)
from visma_tpu_torch.ba.problem import BaProblem
from visma_tpu_torch.dist.mesh import Mesh
from visma_tpu_torch.utils.graphs import (CallGraph, StepGraph, lru_get,
                                          run_eager, steps_of)
from visma_tpu_torch.utils.misc import full_f32


def _rows(t: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """Rows [lo, lo + n) of t, zero-padded past its end."""
    part = t[lo:lo + n]
    return torch.cat([part, part.new_zeros((n - part.shape[0],)
                                           + t.shape[1:])])


def _shard_problem(prob: BaProblem, mesh: Mesh) -> Tuple[BaProblem, int]:
    """Pad L to a multiple of the mesh size; this rank keeps landmark rows
    [r*Ls, (r+1)*Ls) (the padded rows are unobserved), the poses and
    intrinsics whole. Returns (shard, L)."""
    if prob.R.device != mesh.device:
        raise ValueError(f"the problem is on {prob.R.device}, the mesh's "
                         f"rank computes on {mesh.device}")
    n = mesh.size
    L = prob.num_landmarks
    Ls = (L + (-L) % n) // n
    lo = mesh.shard_rank() * Ls
    return prob.replace(X=_rows(prob.X, lo, Ls), obs=_rows(prob.obs, lo, Ls),
                        mask=_rows(prob.mask, lo, Ls)), L


def _gather(shard: BaProblem, prob: BaProblem, L: int, mesh: Mesh
            ) -> BaProblem:
    """The whole solution on every rank: the replicated poses and the
    landmark shards put together (observations do not change)."""
    return prob.replace(R=shard.R, p=shard.p,
                        X=mesh.all_gather(shard.X)[:L])


@full_f32()
def _sharded_step(shard: BaProblem, damping, mesh: Mesh):
    """One GN step on this rank's shard (sharded_ba.py:62-87). Returns
    (new shard, cost over the mesh)."""
    n = mesh.size
    anchor = torch.linalg.norm(shard.p[-1] - shard.p[0])
    # poses are replicated, so the scale prior is added on every shard;
    # divide its weight by the mesh size to keep the reduced total equal to
    # the single-device prior
    S_local, b_local, aux = build_reduced_system(
        shard, damping, scale_anchor=anchor, scale_weight=1e6 / n)
    # the gauge rows are written identically on every shard by
    # build_reduced_system; rescale so the sum keeps them intact
    gauge = torch.arange(S_local.shape[0], device=S_local.device) < 6
    gmask = gauge[:, None] | gauge[None, :]
    S_local = torch.where(gmask, S_local / n, S_local)

    S = mesh.all_reduce(S_local)
    b = mesh.all_reduce(torch.where(gauge, b_local / n, b_local))

    dxp = cho_solve_sym(0.5 * (S + S.T), b)
    dxl = backsub_landmarks(aux, dxp)
    new = _apply(shard, dxp, dxl)
    return new, mesh.all_reduce(total_cost(new))


def _lm_body(step: Callable, state, _):
    """One step of the reference's scan (sharded_ba.py:105-119), accepted
    or rejected by `torch.where` on the device (the cost is the mesh's, so
    every rank decides alike); damping halves on accept (floor 1e-6) and
    quadruples on reject (cap 1e2). The state is (shard, damping, cost);
    the output is the cost the step started from, as the reference's
    history holds it."""
    cur, lam, cost = state
    cand, cand_cost = step(cur, lam)
    better = cand_cost < cost
    cur = cur.replace(R=torch.where(better, cand.R, cur.R),
                      p=torch.where(better, cand.p, cur.p),
                      X=torch.where(better, cand.X, cur.X))
    lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-6),
                      torch.clamp(lam * 4.0, max=1e2))
    return (cur, lam, torch.where(better, cand_cost, cost)), cost


# the LM loops' StepGraphs by (mesh, solver, CG iterations) and the
# sharded step's CallGraph by mesh: the reference's `_jitted_solver`,
# `_jitted_pcg_solver` and `_jitted_step`, with its `lru_cache`'s size
_RUNS: OrderedDict = OrderedDict()
_STEPS: OrderedDict = OrderedDict()
_CACHE_SIZE = 16                # sharded_ba.py:91, :96 of the reference


def mesh_key(mesh: Mesh) -> tuple:
    """A mesh's value, what its graphs are cached under: equal for two
    `make_mesh()` calls over the same group and device."""
    return (mesh.group, mesh.rank, mesh.size, mesh.device, mesh.axis)


def lm_runner(mesh: Mesh, key: tuple, step: Callable,
              graph: Optional[bool]) -> Callable:
    """`run(state, steps)` of the LM loop over `step(shard, damping)`: the
    replays of its StepGraph, cached under the mesh's value and `key`
    (the solver and its settings), where the mesh captures
    (`Mesh.graphed`), else the eager loop."""
    body = partial(_lm_body, step)
    if not mesh.graphed(graph):
        return partial(run_eager, body)
    run = lru_get(_RUNS, (mesh_key(mesh), *key), lambda: StepGraph(body),
                  _CACHE_SIZE)
    # an entry made by an equal mesh: this one's step and counters
    run.body, run.counts = body, (mesh.counts,)
    return run.run


def _lm_loop(run: Callable, shard: BaProblem, c0: torch.Tensor,
             damping: float, iters: int) -> Tuple[BaProblem, torch.Tensor]:
    """Exactly `iters` steps of `run` (`lm_runner`) from the cost `c0`.
    Returns (shard, the cost each step started from)."""
    lam = torch.full((), damping, dtype=torch.float32, device=c0.device)
    (cur, _, _), hist = run((shard, lam, c0), steps_of(iters, c0.device))
    return cur, hist


def _step_call(shard: BaProblem, damping, mesh: Mesh):
    new, cost = _sharded_step(shard, damping, mesh)
    return new.R, new.p, new.X, cost


def sharded_ba_step(prob: BaProblem, mesh: Mesh, damping: float = 1e-3,
                    graph: Optional[bool] = None):
    """One distributed GN step. Returns (problem, cost). Where the mesh
    captures, a replay of its cached step (its first call for a shape is
    eager, the second captures); `graph=False` is the eager step."""
    shard, L = _shard_problem(prob, mesh)
    lam = torch.full((), damping, dtype=torch.float32, device=mesh.device)
    if mesh.graphed(graph):
        call = lru_get(_STEPS, mesh_key(mesh), lambda: CallGraph(_step_call),
                       _CACHE_SIZE)
        call.fn, call.counts = partial(_step_call, mesh=mesh), (mesh.counts,)
        R, p, X, cost = call(shard, lam)
        new = shard.replace(R=R, p=p, X=X)
    else:
        new, cost = _sharded_step(shard, lam, mesh)
    return _gather(new, prob, L, mesh), cost


# Past this many keyframes the matrix-free PCG path wins: the dense path
# reduces the full (6K)^2 system and Cholesky-factors it replicated
# (O(K^2) comm, O(K^3) flops per GN step); PCG communicates O(6K) per CG
# iteration and never materializes S.
PCG_CROSSOVER_K = 64


def sharded_ba_solve(prob: BaProblem, mesh: Mesh, iters: int = 10,
                     damping: float = 1e-3, solver: str = "auto",
                     cg_iters: int = 25, graph: Optional[bool] = None):
    """Distributed LM loop (the acceptance logic of ba_solve). Returns
    (solution, cost history).

    solver: "dense" reduces the (6K)^2 reduced system and solves it
    replicated; "pcg" uses the matrix-free distributed PCG
    (dist/pcg_ba.py, O(6K) comm per CG iteration); "auto" picks PCG when
    num_poses > PCG_CROSSOVER_K.
    graph: None replays a captured graph a GN step where the mesh captures
    (`Mesh.graphed`), False is the eager loop.
    """
    if solver == "auto":
        solver = "pcg" if prob.num_poses > PCG_CROSSOVER_K else "dense"
    if solver == "pcg":
        from visma_tpu_torch.dist import pcg_ba

        return pcg_ba.pcg_ba_solve(prob, mesh, iters=iters,
                                   cg_iters=cg_iters, damping=damping,
                                   graph=graph)
    if solver != "dense":
        raise ValueError(f"unknown solver {solver!r}")
    shard, L = _shard_problem(prob, mesh)
    # the initial cost is the reference's replicated evaluation: every rank
    # holds the whole problem
    run = lm_runner(mesh, ("dense",), partial(_sharded_step, mesh=mesh),
                    graph)
    sol, hist = _lm_loop(run, shard, total_cost(prob), damping, iters)
    return _gather(sol, prob, L, mesh), hist
