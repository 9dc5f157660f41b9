"""Pose-graph optimisation: GN on SE(3) relative-pose constraints (port of
visma_tpu/ba/pose_graph.py).

Edges (i, j, T_ij_meas): residual = log(T_ij_meas^-1 T_i^-1 T_j) in se(3).
The per-edge Jacobians are forward-mode derivatives over the two 6-dof
perturbations through the port's `SE3` (its log and exp branch with
`torch.where` only, so functorch traces them), as the reference takes
`jax.jacfwd` under `vmap` over the edges. Here the edges stay a batch axis
of the residual function and `torch.func.vmap` runs `torch.func.jvp` over
the 12 tangent directions: what `jacfwd` does, one edge at a time. The
edges are not vmapped one by one because under forward AD a Python scalar
against a 0-d tensor (`0.5 * (trace - 1.0)` in the log map) promotes the
tangent to float64 in this PyTorch, and the next float32 matmul refuses
it. Dense assembly + Cholesky, as the reference: graphs here are
window-scale.

The (K,K,6,6) blocks are summed with `index_put(..., accumulate=True)` and
`index_add`. On CUDA their order of accumulation is not fixed, so a result
on the card can vary in its last bits from run to run.

The reference jits the solve and scans its iterations
(pose_graph.py:34, :94). Here, on a CUDA device, the iterations replay a
`StepGraph` a GN iteration (`utils.graphs`), the vmapped `jvp` inside the
capture; the state is the poses, and the edges, measurements and weights
pass through the graph's buffers unchanged. `graph=False` is the eager
loop.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import torch
from torch.func import jvp, vmap

from visma_tpu_torch.ba.gauss_newton import cho_solve_sym
from visma_tpu_torch.geom import SE3
from visma_tpu_torch.geom.rotations import rodrigues
from visma_tpu_torch.utils.graphs import (StepGraph, run_eager, steps_of,
                                          wants_graph)
from visma_tpu_torch.utils.misc import full_f32


def _edge_residual(Ri, pi, Rj, pj, Rm, pm):
    """log( T_meas^-1 * T_i^-1 * T_j )."""
    return (SE3(Rm, pm).inv() @ (SE3(Ri, pi).inv() @ SE3(Rj, pj))).log()


def _edge_res_perturbed(xi_i, xi_j, Ri, pi, Rj, pj, Rm, pm):
    return _edge_residual(rodrigues(xi_i[..., :3]) @ Ri, pi + xi_i[..., 3:],
                          rodrigues(xi_j[..., :3]) @ Rj, pj + xi_j[..., 3:],
                          Rm, pm)


def _edge_terms(Ri, pi, Rj, pj, Rm, pm):
    """Every edge's residual (E,6) and its Jacobians (E,6,6) w.r.t. the
    perturbations of pose i and pose j, both at zero: one `jvp` per
    tangent direction of the 12 (xi_i, xi_j), vmapped over the directions,
    each direction set for every edge at once."""
    E = Ri.shape[0]
    z = torch.zeros((E, 12), dtype=Ri.dtype, device=Ri.device)

    def f(x):
        return _edge_res_perturbed(x[:, :6], x[:, 6:], Ri, pi, Rj, pj, Rm,
                                   pm)

    def column(t):
        return jvp(f, (z,), (t.expand(E, 12),))[1]

    J = vmap(column, out_dims=-1)(
        torch.eye(12, dtype=Ri.dtype, device=Ri.device))  # (E,6,12)
    return f(z), J[..., :6], J[..., 6:]


def _gn_body(damping: float, state, _):
    """One GN iteration. The state is (R, p, edges i, edges j, R_meas,
    p_meas, edge weights): the poses change, the rest comes back as it
    went in. No output."""
    Rc, pc, ei, ej, R_meas, p_meas, w = state
    K = Rc.shape[0]
    D = 6 * K
    dev = Rc.device
    eye = torch.eye(D, dtype=Rc.dtype, device=dev)
    gauge = torch.arange(D, device=dev) < 6
    res, Ji, Jj = _edge_terms(Rc[ei], pc[ei], Rc[ej], pc[ej], R_meas, p_meas)
    res = res * w[:, None]
    Ji = Ji * w[:, None, None]
    Jj = Jj * w[:, None, None]

    H = torch.zeros((K, K, 6, 6), dtype=Rc.dtype, device=dev)
    H = H.index_put((ei, ei), torch.einsum("eai,eaj->eij", Ji, Ji),
                    accumulate=True)
    H = H.index_put((ej, ej), torch.einsum("eai,eaj->eij", Jj, Jj),
                    accumulate=True)
    H = H.index_put((ei, ej), torch.einsum("eai,eaj->eij", Ji, Jj),
                    accumulate=True)
    H = H.index_put((ej, ei), torch.einsum("eai,eaj->eij", Jj, Ji),
                    accumulate=True)
    b = torch.zeros((K, 6), dtype=Rc.dtype, device=dev)
    b = b.index_add(0, ei, -torch.einsum("eai,ea->ei", Ji, res))
    b = b.index_add(0, ej, -torch.einsum("eai,ea->ei", Jj, res))

    Hd = H.permute(0, 2, 1, 3).reshape(D, D) + damping * eye
    Hd = torch.where(gauge[:, None] | gauge[None, :], 1e6 * eye, Hd)
    bd = torch.where(gauge, torch.zeros_like(b.reshape(-1)), b.reshape(-1))
    dx = cho_solve_sym(0.5 * (Hd + Hd.T), bd).reshape(K, 6)
    return (rodrigues(dx[:, :3]) @ Rc, pc + dx[:, 3:], ei, ej, R_meas,
            p_meas, w), ()


# the reference's jitted solve: one StepGraph per damping, the one Python
# constant its body reads (each keeps a graph per graph shape), kept for
# the life of the process
_RUNS: dict = {}


@full_f32()
def pose_graph_solve(R: torch.Tensor, p: torch.Tensor,
                     edges_i: torch.Tensor, edges_j: torch.Tensor,
                     R_meas: torch.Tensor, p_meas: torch.Tensor,
                     edge_valid: torch.Tensor = None,
                     iters: int = 10, damping: float = 1e-4,
                     graph: Optional[bool] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """R (K,3,3), p (K,3); edges_* (E,) indices; R_meas/p_meas (E,3,3)/(E,3),
    all on one device. Node 0 is gauge-fixed. Returns optimised (R, p)
    after exactly `iters` GN steps (nothing is read back to the host). On
    a CUDA device the steps replay a captured graph (`graph=None`);
    `graph=False` is the eager loop."""
    dev = R.device
    ei = edges_i.long()
    w = (torch.ones(ei.shape[0], dtype=R.dtype, device=dev)
         if edge_valid is None else edge_valid.to(R.dtype))
    state = (R, p, ei, edges_j.long(), R_meas, p_meas, w)
    if wants_graph(graph, dev):
        run = _RUNS.get(damping)
        if run is None:
            run = _RUNS[damping] = StepGraph(partial(_gn_body, damping))
        run = run.run
    else:
        run = partial(run_eager, partial(_gn_body, damping))
    (Rc, pc, *_), _ = run(state, steps_of(iters, dev))
    return Rc, pc
