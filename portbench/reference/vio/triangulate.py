# Frozen copy of visma_tpu_torch/filter/triangulate.py at 43be5d3; imports point into
# portbench.reference.vio. Part of the benchmark's plain reference.
"""Multi-view feature triangulation (port of visma_tpu/filter/triangulate.py).

The reference writes one feature and vmaps; here every function takes any
leading batch shape on `obs` (..., M, 2) / `mask` (..., M) against one
window `win_R` (M, 3, 3) / `win_p` (M, 3).
"""
from __future__ import annotations

import torch

from portbench.reference.vio.config import FilterConfig


def backproject(cfg: FilterConfig, xp: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> unit-norm camera rays (..., 3)."""
    x = (xp[..., 0] - cfg.cx) / cfg.fx
    y = (xp[..., 1] - cfg.cy) / cfg.fy
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)


def project(cfg: FilterConfig, Xc: torch.Tensor) -> torch.Tensor:
    """Camera points (..., 3) -> pixels (..., 2)."""
    z = _safe_z(Xc[..., 2])
    return torch.stack([cfg.fx * Xc[..., 0] / z + cfg.cx,
                        cfg.fy * Xc[..., 1] / z + cfg.cy], dim=-1)


def solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form (..., 3, 3) @ x = (..., 3) solve via the adjugate, with
    the reference's sign-preserving determinant clamp (triangulate.py:31-66)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    safe = torch.where(det < 0, torch.clamp(det, max=-1e-20),
                       torch.clamp(det, min=1e-20))
    inv_det = 1.0 / safe
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c01 * b1 + c02 * b2) * inv_det
    x1 = (c10 * b0 + c11 * b1 + c12 * b2) * inv_det
    x2 = (c20 * b0 + c21 * b1 + c22 * b2) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)


def triangulate_linear(cfg: FilterConfig, obs, mask, win_R, win_p):
    """Midpoint method. Returns (X (..., 3), ok (...,) bool)."""
    eye = torch.eye(3, dtype=torch.float32, device=obs.device)
    d = torch.einsum("mij,...mj->...mi", win_R, backproject(cfg, obs))
    w = mask.to(torch.float32)
    Pm = eye - d[..., :, None] * d[..., None, :]
    Pm = Pm * w[..., None, None]
    A = torch.sum(Pm, dim=-3) + 1e-6 * eye
    b = torch.einsum("...mij,mj->...i", Pm, win_p)
    X = solve3x3(A, b)
    norm = torch.linalg.norm(X, dim=-1)
    bounded = (norm < 1e3) & torch.isfinite(X).all(dim=-1)
    X = torch.where(bounded[..., None], X, torch.zeros_like(X))
    ok = (torch.sum(w, dim=-1) >= 2) & bounded
    return X, ok


def _reproj_residuals(cfg: FilterConfig, X, obs, mask, win_R, win_p):
    Xc = torch.einsum("mji,...mj->...mi", win_R, X[..., None, :] - win_p)
    pred = project(cfg, Xc)
    r = (pred - obs) * mask[..., None]
    return r, Xc


def triangulate(cfg: FilterConfig, obs, mask, win_R, win_p,
                gn_iters: int = 3):
    """Linear init + GN refinement. Returns (X, ok, mean_reproj_err)."""
    X, ok = triangulate_linear(cfg, obs, mask, win_R, win_p)
    eye = torch.eye(3, dtype=torch.float32, device=obs.device)
    Rt = win_R.transpose(-1, -2)
    maskf = mask.to(torch.float32)
    for _ in range(gn_iters):
        r, Xc = _reproj_residuals(cfg, X, obs, mask, win_R, win_p)
        z = _safe_z(Xc[..., 2])
        zero = torch.zeros_like(z)
        # d pred / d Xc, (..., M, 2, 3)
        Jc = torch.stack([
            torch.stack([cfg.fx / z, zero, -cfg.fx * Xc[..., 0] / z ** 2], -1),
            torch.stack([zero, cfg.fy / z, -cfg.fy * Xc[..., 1] / z ** 2], -1),
        ], dim=-2)
        J = torch.einsum("...mab,mbc->...mac", Jc, Rt)
        J = J * maskf[..., None, None]
        H = torch.einsum("...mai,...maj->...ij", J, J) + 1e-4 * eye
        g = torch.einsum("...mai,...ma->...i", J, r)
        dX = torch.clamp(solve3x3(H, g), -100.0, 100.0)
        X = X - dX

    r, Xc = _reproj_residuals(cfg, X, obs, mask, win_R, win_p)
    n = torch.clamp(torch.sum(mask, dim=-1), min=1)
    err = torch.sum(torch.linalg.norm(r, dim=-1), dim=-1) / n
    z = torch.where(mask, Xc[..., 2], torch.ones_like(Xc[..., 2]))
    depth_ok = ((z > cfg.min_depth).all(dim=-1)
                & (z < cfg.max_depth).all(dim=-1))
    ok = ok & depth_ok & (err < cfg.max_reproj_error) \
        & torch.isfinite(X).all(dim=-1)
    return X, ok, err
