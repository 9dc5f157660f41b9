"""In-state SLAM landmarks on top of the MSCKF core (port of
visma_tpu/filter/slam.py; see the reference module for the method:
delayed initialization from the Q1 rows of the feature Jacobian's QR, a
per-frame update from one fresh observation, Schmidt/consider mode).

Everything is fixed-shape: L = cfg.num_slam slots, empty slots carry id -1
and exact-zero covariance rows and columns. The reference's per-slot
`vmap`s become batched tensor ops, its `dynamic_update_slice`s at a traced
slot become `torch.where` over masks, so nothing reads a value back to the
host.

Parity notes (each pinned in tests/test_torch_slam.py):
  * `jnp.argmax(eq, axis=1)` (slam.py:60) and `jnp.argmin(live)` (:170, the
    first empty slot) take the first extremum: the masks are cast to int
    before `torch.argmax` / `torch.argmin`, which also return the first.
  * The gate's (L, 2, 2) solves use `torch.linalg.solve_ex`, which returns
    NaN for a singular system where `torch.linalg.solve` would raise; a NaN
    Mahalanobis distance fails the gate as it does in the reference.
  * The promote step's QR (`mode="complete"`) has free column signs; every
    quantity it feeds (R1^-1 Q1^T, R1^-1 R1^-T, |diag R1|) is invariant to
    them.
"""
from __future__ import annotations

import torch

from visma_tpu_torch.filter.config import FilterConfig
from visma_tpu_torch.filter.state import FilterState
from visma_tpu_torch.filter.triangulate import _safe_z, project
from visma_tpu_torch.filter.update import (apply_correction,
                                           feature_jacobians,
                                           zero_landmark_gain)
from visma_tpu_torch.geom.rotations import hat
from visma_tpu_torch.utils.misc import cho_solve, cholesky_or_nan


def in_state(lm_ids: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(F,) bool: which of `ids` are live SLAM landmarks."""
    live = lm_ids >= 0
    return torch.any((ids[None, :] == lm_ids[:, None]) & live[:, None],
                     dim=0)


def _slam_jacobian(cfg: FilterConfig, X, Rc, pc):
    """Residual prediction and the (L, 2, D) Jacobian of each landmark's
    projection into the newest clone (slam.py:62-90)."""
    L = cfg.num_slam
    c0 = 15 + 6 * (cfg.window - 1)   # newest clone error columns
    s0 = cfg.slam_idx
    Rt = Rc.T
    dX = X - pc[None]
    Xc = torch.einsum("ij,lj->li", Rt, dX)
    pred = project(cfg, Xc)

    z = _safe_z(Xc[:, 2])
    zero = torch.zeros_like(z)
    Jp = torch.stack([
        torch.stack([cfg.fx / z, zero, -cfg.fx * Xc[:, 0] / z ** 2], -1),
        torch.stack([zero, cfg.fy / z, -cfg.fy * Xc[:, 1] / z ** 2], -1),
    ], dim=-2)                                           # (L,2,3)

    # dXc/dtheta_c = R^T hat(X - p); dXc/dp_c = -R^T; dXc/dX = R^T
    Hth = torch.einsum("lab,lbc->lac", Jp,
                       torch.einsum("ij,ljk->lik", Rt, hat(dX)))
    Hf = torch.einsum("lab,bc->lac", Jp, Rt)
    Hp = -Hf
    # landmark l owns columns [s0 + 3l, s0 + 3l + 3): a block diagonal
    # written with where (not a product, which would spread NaN)
    own = torch.eye(L, dtype=torch.bool, device=X.device)
    Hl = torch.where(own[:, None, :, None], Hf[:, :, None, :],
                     torch.zeros((), dtype=Hf.dtype, device=X.device))
    H = torch.cat([torch.zeros((L, 2, c0), dtype=Hf.dtype, device=X.device),
                   Hth, Hp,
                   torch.zeros((L, 2, s0 - c0 - 6), dtype=Hf.dtype,
                               device=X.device),
                   Hl.reshape(L, 2, 3 * L)], dim=-1)
    return Xc, pred, H


def slam_update(cfg: FilterConfig, state: FilterState, ids, xp,
                valid) -> FilterState:
    """Per-frame EKF update from this frame's observations of in-state
    landmarks, plus the slot lifecycle (missed counting and drops).

    ids (F,), xp (F, 2), valid (F,): the frame's raw feature observations.
    The newest clone (slot M-1) is the measuring camera (slam.py:43-138).
    """
    L = cfg.num_slam
    M, D = cfg.window, cfg.dim
    s0 = cfg.slam_idx
    dev = state.P.device

    live = state.lm_ids >= 0
    eq = (state.lm_ids[:, None] == ids[None, :]) & valid[None, :] \
        & live[:, None]
    seen = torch.any(eq, dim=1)
    obs = xp[torch.argmax(eq.to(torch.int32), dim=1)]     # (L,2)

    Xc, pred, H = _slam_jacobian(cfg, state.lm_xw, state.win_R[M - 1],
                                 state.win_p[M - 1])
    depth_ok = (Xc[:, 2] > cfg.min_depth) & (Xc[:, 2] < cfg.max_depth)
    r = obs - pred                                         # (L,2)

    # per-landmark chi-square gate: a batch of (2, 2) solves
    P = state.P
    use = seen & depth_ok & torch.isfinite(r).all(dim=1)
    eye2 = torch.eye(2, dtype=P.dtype, device=dev)
    S2 = H @ P @ H.transpose(-1, -2) + cfg.pixel_noise ** 2 * eye2
    m2 = torch.sum(r * torch.linalg.solve_ex(S2, r[..., None])[0][..., 0],
                   dim=-1)
    use = use & (m2 < cfg.slam_chi2_scale * 2.0)

    r = torch.where(use[:, None], r, torch.zeros_like(r))
    H = torch.where(use[:, None, None], H, torch.zeros_like(H))
    rbig = r.reshape(-1)
    Hbig = H.reshape(-1, D)                                # (2L, D)

    S = Hbig @ P @ Hbig.T \
        + cfg.pixel_noise ** 2 * torch.eye(2 * L, dtype=P.dtype, device=dev)
    K = cho_solve((P @ Hbig.T).T, cholesky_or_nan(0.5 * (S + S.T))).T
    if cfg.schmidt:
        # consider states: zero gain on the whole landmark block; the
        # Joseph form below stays a valid covariance update for any gain
        K = zero_landmark_gain(cfg, K)
    dx = K @ rbig

    eye = torch.eye(D, dtype=P.dtype, device=dev)
    IKH = eye - K @ Hbig
    P_new = IKH @ P @ IKH.T + cfg.pixel_noise ** 2 * (K @ K.T)
    P_new = 0.5 * (P_new + P_new.T)

    any_used = torch.any(use)
    dx = torch.where(any_used, dx, torch.zeros_like(dx))
    P_new = torch.where(any_used, P_new, P)
    state = apply_correction(cfg, state, dx).replace(P=P_new)

    # lifecycle: missed counters and drops
    zero_i = torch.zeros_like(state.lm_missed)
    missed = torch.where(live & seen, zero_i,
                         torch.where(live, state.lm_missed + 1, zero_i))
    drop = live & (missed > cfg.slam_max_missed)
    lm_ids = torch.where(drop, torch.full_like(state.lm_ids, -1),
                         state.lm_ids)
    # decorrelate freed slots: zero their covariance rows/columns
    keep_row = torch.cat([torch.ones(s0, dtype=torch.bool, device=dev),
                          (~drop)[:, None].expand(L, 3).reshape(-1)])
    P2 = torch.where(keep_row[:, None] & keep_row[None, :], state.P,
                     torch.zeros((), dtype=P.dtype, device=dev))
    return state.replace(lm_ids=lm_ids, lm_missed=missed, P=P2)


def _put_block(P, row0, Pfx, Pff):
    """The three `dynamic_update_slice`s of slam.py:192-196 at a slot
    chosen on the device: rows [row0, row0+3) <- Pfx, the same columns <-
    Pfx^T, their crossing <- Pff, in that order."""
    D = P.shape[0]
    k = torch.arange(D, device=P.device) - row0
    inb = (k >= 0) & (k < 3)
    kc = torch.clamp(k, 0, 2)
    rows = Pfx[kc]                          # (D, D): row i = Pfx[i - row0]
    Pn = torch.where(inb[:, None], rows, P)
    Pn = torch.where(inb[None, :], rows.T, Pn)
    return torch.where(inb[:, None] & inb[None, :], Pff[kc][:, kc], Pn)


def slam_promote(cfg: FilterConfig, state: FilterState, cand_X, cand_obs,
                 cand_mask, cand_ids, cand_ok):
    """Promote up to max_promote candidate tracks into empty landmark slots
    by delayed initialization (slam.py:141-209).

    cand_X (C, 3), cand_obs (C, M, 2), cand_mask (C, M), cand_ids (C,),
    cand_ok (C,) with C = cfg.max_promote, pre-ranked. Candidates go in
    order: later ones see earlier ones' cross-covariances. The Jacobians
    and their QR depend only on the clone window, which promotion does not
    change, so they are computed for all candidates at once. Returns
    (state, done (C,) bool: which candidates promoted).
    """
    s0 = cfg.slam_idx
    sig2 = cfg.pixel_noise ** 2
    L = cfg.num_slam
    dev = state.P.device
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    slots = torch.arange(L, device=dev)

    r, Hx, Hf = feature_jacobians(cfg, cand_X, cand_obs, cand_mask,
                                  state.win_R, state.win_p)
    Q, Rf = torch.linalg.qr(Hf, mode="complete")
    Q1, R1 = Q[..., :3], Rf[..., :3, :]
    r1_ok = torch.amin(torch.abs(torch.diagonal(R1, dim1=-2, dim2=-1)),
                       dim=-1) > cfg.slam_min_r1
    H1 = Q1.transpose(-1, -2) @ Hx                       # (C,3,D)
    r1 = (Q1.transpose(-1, -2) @ r[..., None])[..., 0]   # (C,3)

    done = []
    for i in range(cfg.max_promote):
        fid, ok = cand_ids[i], cand_ok[i]
        live = state.lm_ids >= 0
        slot = torch.argmin(live.to(torch.int32))          # first empty slot
        ok = ok & ~torch.all(live) & ~torch.any((state.lm_ids == fid) & live)
        ok = ok & r1_ok[i]
        R1s = torch.where(ok, R1[i], eye3)                 # keep solve posed
        Minv = torch.linalg.solve_triangular(R1s, eye3, upper=True)

        P = state.P
        A = -(Minv @ H1[i])
        Pfx = A @ P                                        # (3,D)
        Pff = Pfx @ A.T + sig2 * (Minv @ Minv.T)
        Xn = cand_X[i] + Minv @ r1[i]
        ok = ok & torch.isfinite(Xn).all() & torch.isfinite(Pfx).all() \
            & (torch.diagonal(Pff) > 0).all()

        Pn = _put_block(P, s0 + 3 * slot, Pfx, Pff)
        Pn = 0.5 * (Pn + Pn.T)
        at = (slots == slot) & ok
        state = state.replace(
            P=torch.where(ok, Pn, P),
            lm_ids=torch.where(at, fid, state.lm_ids),
            lm_xw=torch.where(at[:, None], Xn[None], state.lm_xw),
            lm_missed=torch.where(at, torch.zeros_like(state.lm_missed),
                                  state.lm_missed))
        done.append(ok)
    return state, (torch.stack(done) if done
                   else torch.zeros(0, dtype=torch.bool, device=dev))
