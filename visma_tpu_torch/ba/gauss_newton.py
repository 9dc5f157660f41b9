"""Gauss-Newton BA with Schur-complement landmark marginalisation (port of
visma_tpu/ba/gauss_newton.py).

All per-landmark algebra is batched (L, ...) einsums; the reduced camera
system is assembled as (K,K,6,6) blocks; the only sequential parts are the
dense (6K x 6K) Cholesky and the GN outer loop of exactly `iters` steps,
whose accept/reject is a `torch.where` on the device, so a solve on the
card queues without waiting for the host. The landmark axis L is the axis
a distributed solver shards: `build_blocks`, `build_reduced_system` and
`backsub_landmarks` are its per-shard pieces.

The reference jits `ba_step` and runs the LM loop as a jitted
`lax.scan`. Here, on a CUDA device, `ba_step` replays a `CallGraph` and
`ba_solve` a `StepGraph` a GN step (`utils.graphs`: two eager warm-up
steps, one capture per problem shape, then a replay a step; a later solve
of the same shapes replays from its first step). `graph=False` gives the
eager step and the eager loop, the same arithmetic. Every tensor a step
reads comes in through the graph's buffers, none from a closure: the
replay of a cached graph reads its buffers by address.

Robustness: Huber weights with a hard trim on the pixel residual;
Levenberg damping; gauge fixed by freezing pose 0; monocular scale pinned by
a prior on the longest baseline. Products run at full float32 precision
(`full_f32`), the reference's `Precision.HIGHEST`.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import torch

from visma_tpu_torch.ba.problem import BaProblem
from visma_tpu_torch.geom.rotations import hat, rodrigues
from visma_tpu_torch.utils.graphs import (CallGraph, StepGraph, run_eager,
                                          wants_graph)
from visma_tpu_torch.utils.misc import (cho_solve, cholesky_or_nan,
                                        full_f32, inv_ex)


def _reproject(prob: BaProblem):
    """Camera-frame points and masked residuals of every (landmark, pose)
    pair: (r (L,K,2), Xc (L,K,3), z (L,K), diff = X - p (L,K,3))."""
    fx, fy, cx, cy = prob.intr.unbind()
    Rt = prob.R.transpose(-1, -2)                           # (K,3,3)
    diff = prob.X[:, None, :] - prob.p[None, :, :]          # (L,K,3)
    Xc = torch.einsum("kij,lkj->lki", Rt, diff)             # (L,K,3)
    z = torch.where(torch.abs(Xc[..., 2]) < 1e-6,
                    torch.full_like(Xc[..., 2], 1e-6), Xc[..., 2])
    pred = torch.stack([fx * Xc[..., 0] / z + cx,
                        fy * Xc[..., 1] / z + cy], dim=-1)
    r = (prob.obs - pred) * prob.mask[..., None]
    return r, Xc, z, diff


def _residual_jacobians(prob: BaProblem):
    """Vectorised residuals + Jacobians for every (landmark, pose) pair.

    r (L,K,2); Jp (L,K,2,6) w.r.t. pose error [dtheta(world), dp];
    Jl (L,K,2,3) w.r.t. landmark. Masked pairs are zeroed.
    """
    fx, fy = prob.intr[0], prob.intr[1]
    r, Xc, z, diff = _reproject(prob)
    zero = torch.zeros_like(z)
    Jproj = torch.stack([
        torch.stack([fx / z, zero, -fx * Xc[..., 0] / z ** 2], dim=-1),
        torch.stack([zero, fy / z, -fy * Xc[..., 1] / z ** 2], dim=-1),
    ], dim=-2)                                              # (L,K,2,3)
    Jproj = Jproj * prob.mask[..., None, None]

    # dXc/dtheta_k = R_k^T hat(X - p_k); dXc/dp_k = -R_k^T; dXc/dX = R_k^T
    Rt = prob.R.transpose(-1, -2)
    dXc_dth = torch.einsum("kij,lkjm->lkim", Rt, hat(diff))  # (L,K,3,3)
    Jth = torch.einsum("lkab,lkbc->lkac", Jproj, dXc_dth)
    Jl = torch.einsum("lkab,kbc->lkac", Jproj, Rt)          # (L,K,2,3)
    Jp = torch.cat([Jth, -Jl], dim=-1)                      # (L,K,2,6)
    return r, Jp, Jl


def _huber_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    """Huber IRLS weights with a hard trim: residuals beyond 5*delta are
    gross outliers (w=0); pure Huber leaves 80 px outliers pulling with
    weight delta/r, which biases pose and scale."""
    nrm = torch.linalg.norm(r, dim=-1)
    w = torch.where(nrm <= delta, torch.ones_like(nrm),
                    delta / torch.clamp(nrm, min=1e-9))
    return torch.where(nrm > 5.0 * delta, torch.zeros_like(w), w)


def build_blocks(prob: BaProblem, damping, huber_delta: float = 5.0):
    """Per-shard Schur building blocks: Hpp (K,6,6) per-pose Hessian
    partial, bp (K,6), Hll_inv (L,3,3), Hpl (L,K,6,3), bl (L,3). Sums over
    the landmark axis are partial on a landmark shard. `Hll_inv` comes from
    `utils.misc.inv_ex`, which does not check its result on the host."""
    r, Jp, Jl = _residual_jacobians(prob)
    w = _huber_weights(r, huber_delta) * prob.mask          # (L,K)

    Jp_w = Jp * w[..., None, None]
    Jl_w = Jl * w[..., None, None]
    Hpp = torch.einsum("lkai,lkaj->kij", Jp_w, Jp)
    bp = torch.einsum("lkai,lka->ki", Jp_w, r)
    eye3 = torch.eye(3, dtype=Jl.dtype, device=Jl.device)
    Hll = torch.einsum("lkai,lkaj->lij", Jl_w, Jl) + (damping + 1e-6) * eye3
    bl = torch.einsum("lkai,lka->li", Jl_w, r)
    Hpl = torch.einsum("lkai,lkaj->lkij", Jp_w, Jl)         # (L,K,6,3)
    Hll_inv = inv_ex(Hll)                                   # (L,3,3)
    return Hpp, bp, Hll_inv, Hpl, bl


def build_reduced_system(prob: BaProblem, damping, huber_delta: float = 5.0,
                         scale_anchor=None, scale_weight: float = 1e6):
    """Schur-reduce landmarks. Returns (S (6K,6K), b (6K,), aux) where aux
    carries what back-substitution needs (Hll_inv, Hpl, bl).

    scale_anchor: target ||p_last - p0|| closing the monocular scale gauge
    (reprojection cost is invariant to scaling the scene about the fixed
    pose 0; without this prior the solver random-walks along that null
    direction)."""
    K = prob.num_poses
    dev = prob.R.device
    Hpp, bp, Hll_inv, Hpl, bl = build_blocks(prob, damping, huber_delta)

    # S = Hpp(diag) - sum_l Hpl Hll^-1 Hpl^T  (full (K,K) block structure)
    T1 = torch.einsum("lkij,ljm->lkim", Hpl, Hll_inv)       # (L,K,6,3)
    S_off = torch.einsum("lkim,lqjm->kqij", T1, Hpl)        # (K,K,6,6)
    ar = torch.arange(K, device=dev)
    S = (-S_off).index_put((ar, ar), Hpp, accumulate=True)
    b = bp - torch.einsum("lkim,lm->ki", T1, bl)            # (K,6)

    n = 6 * K
    S_dense = S.permute(0, 2, 1, 3).reshape(n, n)
    # Levenberg damping on the camera system + gauge fixing of pose 0. The
    # additive floor scales with the matrix: f32 roundoff in the Schur
    # einsums perturbs eigenvalues by ~eps * ||S||, which drives weakly
    # constrained directions slightly negative and kills the Cholesky.
    diag = torch.diagonal(S_dense)
    floor = 1e-6 * torch.max(torch.abs(diag)) + 1e-8
    eye = torch.eye(n, dtype=S_dense.dtype, device=dev)
    S_dense = S_dense + damping * torch.diag(diag) + floor * eye
    idx = torch.arange(n, device=dev)
    gauge = idx < 6
    S_dense = torch.where(gauge[:, None] | gauge[None, :], 1e6 * eye, S_dense)
    b_dense = torch.where(gauge, torch.zeros_like(b.reshape(-1)),
                          b.reshape(-1))

    if scale_anchor is not None:
        # prior residual: scale_anchor - ||p_last - p0||, anchored on the
        # LONGEST baseline (pose K-1) so initialisation noise perturbs the
        # pinned scale least. Jacobian w.r.t. p_last = e.
        dvec = prob.p[K - 1] - prob.p[0]
        dn = torch.clamp(torch.linalg.norm(dvec), min=1e-9)
        e = dvec / dn
        rows = torch.arange(6 * (K - 1) + 3, 6 * K, device=dev)
        S_dense = S_dense.index_put((rows[:, None], rows[None, :]),
                                    scale_weight * torch.outer(e, e),
                                    accumulate=True)
        b_dense = b_dense.index_put((rows,),
                                    scale_weight * e * (scale_anchor - dn),
                                    accumulate=True)
    return S_dense, b_dense, (Hll_inv, Hpl, bl)


def backsub_landmarks(aux, dxp: torch.Tensor) -> torch.Tensor:
    """dxl_l = Hll^-1 (bl - Hpl^T dxp)."""
    Hll_inv, Hpl, bl = aux
    K = Hpl.shape[1]
    rhs = bl - torch.einsum("lkij,ki->lj", Hpl, dxp.reshape(K, 6))
    return torch.einsum("lij,lj->li", Hll_inv, rhs)


def _apply(prob: BaProblem, dxp: torch.Tensor, dxl: torch.Tensor
           ) -> BaProblem:
    d = dxp.reshape(prob.num_poses, 6)
    return prob.replace(R=rodrigues(d[:, :3]) @ prob.R, p=prob.p + d[:, 3:],
                        X=prob.X + dxl)


def total_cost(prob: BaProblem, huber_delta: float = 5.0) -> torch.Tensor:
    """Huber cost of the reprojection residuals, a 0-d tensor."""
    r = _reproject(prob)[0]
    nrm = torch.linalg.norm(r, dim=-1)
    quad = 0.5 * nrm ** 2
    lin = huber_delta * (nrm - 0.5 * huber_delta)
    return torch.sum(torch.where(nrm <= huber_delta, quad, lin) * prob.mask)


def cho_solve_sym(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve S x = b for a symmetric positive definite S through its upper
    Cholesky factor (`jax.scipy.linalg.cho_factor`'s default), without a
    host sync: a failed factorisation gives NaN, as the reference's does.
    The solve is on cuSOLVER for CUDA tensors (`utils.misc.cho_solve`)."""
    U = cholesky_or_nan(S, upper=True)
    return cho_solve(b[:, None], U, upper=True)[:, 0]


@full_f32()
def _step(prob: BaProblem, damping, scale_anchor=None
          ) -> Tuple[BaProblem, torch.Tensor]:
    """The eager damped GN step: (new problem, new cost)."""
    S, b, aux = build_reduced_system(prob, damping, scale_anchor=scale_anchor)
    dxp = cho_solve_sym(0.5 * (S + S.T), b)
    dxl = backsub_landmarks(aux, dxp)
    new = _apply(prob, dxp, dxl)
    return new, total_cost(new)


def _step_call(prob: BaProblem, damping, *anchor):
    """The step as `_STEP` captures it: what changes, not the observations
    (the caller's problem keeps them)."""
    new, cost = _step(prob, damping, *anchor)
    return new.R, new.p, new.X, cost


# the reference's `jax.jit` of ba_step (visma_tpu/ba/gauss_newton.py:162):
# one graph per problem shape and anchor or none
_STEP = CallGraph(_step_call)


def ba_step(prob: BaProblem, damping, scale_anchor=None,
            graph: Optional[bool] = None) -> Tuple[BaProblem, torch.Tensor]:
    """One damped GN step; returns (new problem, new cost). `damping` is a
    number or a 0-d tensor (a number becomes a 0-d tensor of the problem's
    dtype on its device, made there: no copy from the host). On a CUDA
    device the step replays a captured graph (`graph=None`; its first call
    for a shape is eager, the second captures); `graph=False` is the eager
    step."""
    dev = prob.R.device
    lam = damping if isinstance(damping, torch.Tensor) else torch.full(
        (), damping, dtype=prob.R.dtype, device=dev)
    anchor = () if scale_anchor is None else (scale_anchor,)
    if not wants_graph(graph, dev):
        return _step(prob, lam, *anchor)
    R, p, X, cost = _STEP(prob, lam, *anchor)
    return prob.replace(R=R, p=p, X=X), cost


def _lm_body(state, _):
    """One step of the reference's LM scan (`_ba_run`, gauss_newton.py:
    176-194): accept a step that lowers the cost, else raise the damping.
    The state is (problem, damping, cost, scale anchor); the observations,
    mask, intrinsics and anchor come back as they went in, so a graph
    never copies them. The output is the cost after the step."""
    cur, lam, cost, anchor = state
    cand, cand_cost = _step(cur, lam, anchor)
    better = cand_cost < cost
    cur = cur.replace(R=torch.where(better, cand.R, cur.R),
                      p=torch.where(better, cand.p, cur.p),
                      X=torch.where(better, cand.X, cur.X))
    lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-6),
                      torch.clamp(lam * 4.0, max=1e2))
    cost = torch.where(better, cand_cost, cost)
    return (cur, lam, cost, anchor), cost


# the reference's jitted `_ba_run`: its body reads no Python constant, so
# one StepGraph serves every solve (it keeps a graph per problem shape)
_RUN = StepGraph(_lm_body)


def steps_of(iters: int, device) -> torch.Tensor:
    """The scan's empty per-step input of an LM loop of `iters` steps."""
    return torch.empty((iters, 0), device=device)


@full_f32()
def ba_solve(prob: BaProblem, iters: int = 10, damping: float = 1e-3,
             graph: Optional[bool] = None) -> Tuple[BaProblem, torch.Tensor]:
    """LM-flavoured loop (the reference's `_ba_run`): accept a step that
    reduces the cost, else raise the damping. Damping halves on accept
    (floor 1e-6) and quadruples on reject (cap 1e2).

    Returns (solution, cost history (iters,)). Exactly `iters` steps, each
    accepted or rejected by `torch.where` on the device: nothing is read
    back to the host. On a CUDA device the steps replay a captured graph
    (`graph=None`); `graph=False` is the eager loop."""
    dev = prob.R.device
    state = (prob, torch.full((), damping, dtype=torch.float32, device=dev),
             total_cost(prob), torch.linalg.norm(prob.p[-1] - prob.p[0]))
    run = _RUN.run if wants_graph(graph, dev) else partial(run_eager,
                                                           _lm_body)
    (sol, _, _, _), hist = run(state, steps_of(iters, dev))
    return prob.replace(R=sol.R, p=sol.p, X=sol.X), hist
