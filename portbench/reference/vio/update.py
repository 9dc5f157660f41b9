# Frozen copy of visma_tpu_torch/filter/update.py at 43be5d3; imports point into
# portbench.reference.vio. Part of the benchmark's plain reference.
"""MSCKF measurement update (port of visma_tpu/filter/update.py).

Per-feature functions take a leading feature axis U where the reference
vmaps. Masked rows are exact zeros in (H, r) as in the reference, so they
pass through the orthonormal projections as information-free no-ops.

The reference factors outside any Pallas kernel (`jnp.linalg.qr`,
`cho_factor` / `cho_solve`), so the port calls `torch.linalg.qr`,
`torch.linalg.cholesky_ex` and `torch.cholesky_solve` (on cuSOLVER, which
a CUDA graph captures: `utils.misc.cho_solve`). A failed Cholesky
factor is turned into NaN, which is what the reference's factor returns, so
the gates and the health check see the same thing.
"""
from __future__ import annotations

import torch

from portbench.reference.vio.config import FilterConfig
from portbench.reference.vio.state import FilterState
from portbench.reference.vio.triangulate import _safe_z, project, triangulate
from portbench.reference.vio.rotations import hat, rodrigues
from portbench.reference.vio.misc import (cho_solve, cholesky_or_nan,
                                      device_constant)


@device_constant
def _clone_placement(M: int, D: int, device: torch.device) -> torch.Tensor:
    """Constant (M, 6, D) one-hot: E[m, j, 15 + 6m + j] = 1, the clone rows
    of the identity."""
    return torch.eye(D, dtype=torch.float32,
                     device=device)[15:15 + 6 * M].reshape(M, 6, D)


def feature_jacobians(cfg: FilterConfig, X, obs, mask, win_R, win_p):
    """Residual + Jacobians over the window for features X (U, 3) with
    obs (U, M, 2), mask (U, M).

    Returns r (U, 2M), Hx (U, 2M, D), Hf (U, 2M, 3); masked rows are zero.
    """
    M, D = cfg.window, cfg.dim
    U = X.shape[0]
    Rt = win_R.transpose(-1, -2)                         # (M,3,3) cam<-world
    dXw = X[:, None, :] - win_p                          # (U,M,3)
    Xc = torch.einsum("mij,umj->umi", Rt, dXw)
    pred = project(cfg, Xc)
    maskf = mask.to(torch.float32)
    r = (obs - pred) * maskf[..., None]

    z = _safe_z(Xc[..., 2])
    zero = torch.zeros_like(z)
    Jp = torch.stack([
        torch.stack([cfg.fx / z, zero, -cfg.fx * Xc[..., 0] / z ** 2], -1),
        torch.stack([zero, cfg.fy / z, -cfg.fy * Xc[..., 1] / z ** 2], -1),
    ], dim=-2)                                           # (U,M,2,3)
    Jp = Jp * maskf[..., None, None]

    # dXc/dtheta = R^T hat(X - p); dXc/dp = -R^T ; dXc/dX = R^T
    dXc_dth = torch.einsum("mij,umjk->umik", Rt, hat(dXw))
    Htheta = torch.einsum("umab,umbc->umac", Jp, dXc_dth)
    Hf = torch.einsum("umab,mbc->umac", Jp, Rt)
    Hp = -Hf

    blocks = torch.cat([Htheta, Hp], dim=-1)             # (U,M,2,6)
    Hx = torch.einsum("umab,mbd->umad", blocks,
                      _clone_placement(M, D, X.device))
    return (r.reshape(U, 2 * M), Hx.reshape(U, 2 * M, D),
            Hf.reshape(U, 2 * M, 3))


def nullspace_project(r, Hx, Hf):
    """Left-nullspace projection of the landmark Jacobian by three explicit
    Householder reflections (update.py:71-96), batched over features.

    r (U, n), Hx (U, n, D), Hf (U, n, 3) -> (N^T r (U, n-3), N^T Hx)."""
    n = Hf.shape[-2]
    A = Hf
    B = torch.cat([r[..., None], Hx], dim=-1)
    rows = torch.arange(n, device=Hf.device)
    for k in range(3):
        x = torch.where(rows >= k, A[..., k], torch.zeros_like(A[..., k]))
        nx = torch.linalg.norm(x, dim=-1)
        sign = torch.where(x[..., k] >= 0, 1.0, -1.0)
        v = torch.where(rows == k, x + (sign * nx)[..., None], x)
        vtv = torch.sum(v * v, dim=-1)
        beta = torch.where(vtv > 1e-20, 2.0 / torch.clamp(vtv, min=1e-20),
                           torch.zeros_like(vtv))[..., None, None]
        vA = torch.einsum("un,unc->uc", v, A)
        vB = torch.einsum("un,unc->uc", v, B)
        A = A - beta * (v[..., :, None] * vA[..., None, :])
        B = B - beta * (v[..., :, None] * vB[..., None, :])
    return B[..., 3:, 0], B[..., 3:, 1:]


def chi2_gate(cfg: FilterConfig, r_proj, H_proj, P, dof_scale: float = 8.0):
    """Mahalanobis gate per feature: r_proj (U, n), H_proj (U, n, D).
    Returns (U,) bool, True = accept."""
    n = r_proj.shape[-1]
    S = H_proj @ P @ H_proj.transpose(-1, -2)
    S = S + cfg.pixel_noise ** 2 * torch.eye(n, dtype=S.dtype,
                                             device=S.device)
    sol = cho_solve(r_proj[..., None], cholesky_or_nan(S))[..., 0]
    m2 = torch.sum(r_proj * sol, dim=-1)
    return m2 < dof_scale * n


def msckf_update(cfg: FilterConfig, state: FilterState,
                 sel_obs, sel_mask, sel_valid):
    """Batched MSCKF update over selected features (update.py:113-189).

    sel_obs (U, M, 2), sel_mask (U, M), sel_valid (U,). Returns
    (new_state, used (U,), rejected (U,), X (U, 3)).
    """
    D = cfg.dim
    U = sel_obs.shape[0]
    sel_mask = sel_mask & state.win_valid[None, :]

    X, tri_ok, _err = triangulate(cfg, sel_obs, sel_mask, state.win_R,
                                  state.win_p)
    candidate = sel_valid & (torch.sum(sel_mask, dim=1) >= cfg.min_track_obs)
    use = candidate & tri_ok

    r, Hx, Hf = feature_jacobians(cfg, X, sel_obs, sel_mask, state.win_R,
                                  state.win_p)
    rp, Hp = nullspace_project(r, Hx, Hf)

    gate = chi2_gate(cfg, rp, Hp, state.P)
    finite = torch.isfinite(rp).all(dim=1) & \
        torch.isfinite(Hp.reshape(U, -1)).all(dim=1)
    use = use & gate & finite
    rejected = candidate & ~use

    # where, not multiply: NaN * 0 = NaN
    rp = torch.where(use[:, None], rp, torch.zeros_like(rp))
    Hp = torch.where(use[:, None, None], Hp, torch.zeros_like(Hp))

    rbig = rp.reshape(-1)
    Hbig = Hp.reshape(-1, D)
    Qc, Rc = torch.linalg.qr(Hbig, mode="reduced")
    rc = Qc.T @ rbig

    P = state.P
    eye = torch.eye(D, dtype=P.dtype, device=P.device)
    S = Rc @ P @ Rc.T + cfg.pixel_noise ** 2 * eye
    L = cholesky_or_nan(0.5 * (S + S.T))
    PHt = P @ Rc.T
    K = cho_solve(PHt.T, L).T
    if cfg.num_slam and cfg.schmidt:
        # Schmidt/consider landmarks: zero gain on the landmark block in
        # every update, not only the landmark update (filter/slam.py)
        K = zero_landmark_gain(cfg, K)
    dx = K @ rc

    IKH = eye - K @ Rc
    P_new = IKH @ P @ IKH.T + cfg.pixel_noise ** 2 * (K @ K.T)
    P_new = 0.5 * (P_new + P_new.T)

    any_used = torch.any(use)
    dx = torch.where(any_used, dx, torch.zeros_like(dx))
    P_new = torch.where(any_used, P_new, P)

    state = apply_correction(cfg, state, dx).replace(P=P_new)
    return state, use, rejected, X


def zero_landmark_gain(cfg: FilterConfig, K: torch.Tensor) -> torch.Tensor:
    """`K.at[cfg.slam_idx:].set(0.0)`: zero the landmark rows of a gain."""
    rows = torch.arange(K.shape[0], device=K.device)
    return torch.where((rows >= cfg.slam_idx)[:, None],
                       torch.zeros((), dtype=K.dtype, device=K.device), K)


def apply_correction(cfg: FilterConfig, state: FilterState,
                     dx: torch.Tensor) -> FilterState:
    """Inject the error-state correction dx into the nominal state
    (update.py:192-222)."""
    M = cfg.window
    R = rodrigues(dx[0:3]) @ state.R
    dwin = dx[15:15 + 6 * M].reshape(M, 6)
    state = state.replace(
        R=R, p=state.p + dx[3:6], v=state.v + dx[6:9],
        bg=state.bg + dx[9:12], ba=state.ba + dx[12:15],
        win_R=rodrigues(dwin[:, :3]) @ state.win_R,
        win_p=state.win_p + dwin[:, 3:])

    # calibration tail (right-perturbation on R_bc)
    if cfg.estimate_extrinsics:
        c = cfg.ext_idx
        state = state.replace(
            R_bc=state.R_bc @ rodrigues(dx[c:c + 3]),
            p_bc=state.p_bc + dx[c + 3:c + 6])
    if cfg.estimate_td:
        state = state.replace(td=state.td + dx[cfg.td_idx])
    if cfg.num_slam:
        s = cfg.slam_idx
        state = state.replace(
            lm_xw=state.lm_xw + dx[s:s + 3 * cfg.num_slam].reshape(-1, 3))
    return state
