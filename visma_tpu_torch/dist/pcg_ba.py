"""Matrix-free distributed PCG on the Schur-reduced camera system (port of
visma_tpu/dist/pcg_ba.py).

The dense distributed path (sharded_ba.py) reduces the full (6K)^2
system every GN step. This solver never materializes S: each rank keeps
its landmark shard's Schur building blocks (Hpp/Hpl/Hll_inv partials,
ba/gauss_newton.py:build_blocks) and the reduced system is solved by
preconditioned conjugate gradients where one S@v product is

    local:  u = Hpp_loc v  -  Hpl (Hll^-1 (Hpl^T v))     [batched einsums]
    comm:   Sv = all_reduce(u)                           [6K floats]

Preconditioner: block-Jacobi with the exact 6x6 diagonal blocks of S (one
(K,6,6) all_reduce per GN step). Gauge fixing, Levenberg damping, floor
and the monocular scale-anchor prior are applied after the reduction
(replicated), matching build_reduced_system's dense construction in
operator form. Per GN step: one (K,6,6) and one (K,6) all_reduce,
`cg_iters` of (6K,), and one of the cost.

The reference runs the CG as a `lax.scan` inside the shard_map'd step,
inside its LM scan, jitted and cached per (mesh, iters, cg_iters)
(`_jitted_pcg_solver`, pcg_ba.py:116-178). Here, where the mesh captures
(`Mesh.graphed`), the whole matrix-free GN step is the body of the LM
loop's `StepGraph`, cached per (mesh, cg_iters): the Schur pieces, the
`cg_iters` CG iterations unrolled into the capture, the
back-substitution, the update and the cost's all_reduce, so one replay is
one GN step. The matvec's closure over Hpp, Hpl and Hll_inv is safe in a
replay because the step makes those tensors itself.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import torch

from visma_tpu_torch.ba.gauss_newton import (_apply, backsub_landmarks,
                                             build_blocks, total_cost)
from visma_tpu_torch.ba.problem import BaProblem
from visma_tpu_torch.dist.mesh import Mesh
from visma_tpu_torch.dist.sharded_ba import (_gather, _lm_loop,
                                             _shard_problem, lm_runner)
from visma_tpu_torch.utils.misc import full_f32, inv_ex

_GAUGE_W = 1e6


def _guard(x: torch.Tensor) -> torch.Tensor:
    """x with |x| < 1e-20 replaced by 1e-20 (pcg_ba.py:120, :124)."""
    return torch.where(torch.abs(x) < 1e-20, torch.full_like(x, 1e-20), x)


def _schur_pieces(prob_shard: BaProblem, damping, scale_weight, mesh: Mesh):
    """Everything one GN step needs, built from the local landmark shard.

    Returns (matvec, Minv (K,6,6), b (6K,), aux) where matvec is the
    replicated-in/replicated-out S@v operator (one all_reduce a call)."""
    K = prob_shard.num_poses
    dev = prob_shard.R.device
    Hpp, bp, Hll_inv, Hpl, bl = build_blocks(prob_shard, damping)

    T1 = torch.einsum("lkij,ljm->lkim", Hpl, Hll_inv)        # (L,K,6,3)

    # exact diagonal blocks of S: D_k = Hpp_k - sum_l T1_lk Hpl_lk^T
    D = mesh.all_reduce(Hpp - torch.einsum("lkim,lkjm->kij", T1, Hpl))

    # rhs
    b_local = bp - torch.einsum("lkim,lm->ki", T1, bl)        # (K,6)
    b = mesh.all_reduce(b_local).reshape(-1)

    # replicated extras: damping * diag, floor, gauge, scale prior
    diagD = torch.diagonal(D, dim1=-2, dim2=-1)               # (K,6)
    diagS = diagD.reshape(-1)                                 # (6K,)
    floor = 1e-6 * torch.max(torch.abs(diagS)) + 1e-8
    gauge = torch.arange(6 * K, device=dev) < 6
    notg = ~gauge

    # scale-anchor prior on the last pose's position rows (the
    # construction of build_reduced_system)
    anchor = torch.linalg.norm(prob_shard.p[-1] - prob_shard.p[0])
    dvec = prob_shard.p[K - 1] - prob_shard.p[0]
    dn = torch.clamp(torch.linalg.norm(dvec), min=1e-9)
    e = dvec / dn
    base = 6 * (K - 1) + 3
    rows = torch.arange(base, base + 3, device=dev)

    b = torch.where(gauge, torch.zeros_like(b), b)
    b = b.index_add(0, rows, scale_weight * e * (anchor - dn))

    add_diag = damping * diagS + floor                        # (6K,)

    def matvec(v):
        """S @ v with gauge rows/cols pinned to _GAUGE_W * I."""
        vm = torch.where(notg, v, torch.zeros_like(v))
        vk = vm.reshape(K, 6)
        u = torch.einsum("kij,kj->ki", Hpp, vk)
        a = torch.einsum("lkij,ki->lj", Hpl, vk)              # (L,3)
        c = torch.einsum("lij,lj->li", Hll_inv, a)
        u = u - torch.einsum("lkij,lj->ki", Hpl, c)
        Sv = mesh.all_reduce(u).reshape(-1)
        Sv = Sv + add_diag * vm
        Sv = Sv.index_add(0, rows, scale_weight * e
                          * torch.dot(e, vm[base:base + 3]))
        Sv = torch.where(notg, Sv, torch.zeros_like(Sv))      # gauge cols
        return torch.where(gauge, _GAUGE_W * v, Sv)           # gauge rows

    # block-Jacobi preconditioner with the same extras folded in
    Dd = D + torch.diag_embed(damping * diagD + floor)
    Dd[K - 1, 3:, 3:] += scale_weight * torch.outer(e, e)
    Dd[0] = torch.eye(6, dtype=D.dtype, device=dev) * _GAUGE_W  # gauge block
    # inv_ex: the reference's inverse does not check its result, and a
    # check would read it back to the host
    Minv = inv_ex(Dd)                                         # (K,6,6)
    return matvec, Minv, b, (Hll_inv, Hpl, bl)


def _pcg(matvec, Minv, b, iters: int):
    """Fixed-iteration preconditioned CG (replicated vectors; the only
    communication is the all_reduce inside matvec). Returns x (the
    reference also returns the |r| history, which no caller reads)."""
    def precond(r):
        return torch.einsum("kij,kj->ki", Minv, r.reshape(-1, 6)).reshape(-1)

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    for _ in range(iters):
        Ap = matvec(p)
        alpha = rz / _guard(torch.dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / _guard(rz)
        p = z + beta * p
        rz = rz_new
    return x


@full_f32()
def _pcg_step(shard: BaProblem, damping, mesh: Mesh, cg_iters: int):
    """The matrix-free GN step on this rank's shard. Returns (new shard,
    cost over the mesh)."""
    matvec, Minv, b, aux = _schur_pieces(shard, damping, 1e6, mesh)
    dxp = _pcg(matvec, Minv, b, cg_iters)
    dxl = backsub_landmarks(aux, dxp)
    new = _apply(shard, dxp, dxl)
    return new, mesh.all_reduce(total_cost(new))


def pcg_ba_solve(prob: BaProblem, mesh: Mesh, iters: int = 10,
                 cg_iters: int = 25, damping: float = 1e-3,
                 graph: Optional[bool] = None
                 ) -> Tuple[BaProblem, torch.Tensor]:
    """Distributed LM loop with the matrix-free PCG inner solver.

    Same acceptance logic and gauge/prior construction as
    sharded_ba_solve; communication per GN step is one (K,6,6) + one (K,6)
    all_reduce plus cg_iters (K,6) ones and the cost's: O(K), not O(K^2).
    graph: None replays a captured graph a GN step where the mesh captures
    (`Mesh.graphed`), False is the eager loop."""
    shard, L = _shard_problem(prob, mesh)
    run = lm_runner(mesh, ("pcg", cg_iters),
                    partial(_pcg_step, mesh=mesh, cg_iters=cg_iters), graph)
    sol, hist = _lm_loop(run, shard, total_cost(prob), damping, iters)
    return _gather(sol, prob, L, mesh), hist
