# Frozen copy of visma_tpu_torch/geom/rotations.py at 43be5d3; imports point into
# portbench.reference.vio. Part of the benchmark's plain reference.
"""Rotation maps and matrix differential calculus (port of
visma_tpu/geom/rotations.py).

`hat`, `vee`, `rodrigues` and the log map `invrodrigues` take any leading
batch shape; the analytic Jacobians `rodrigues_jac` / `invrodrigues_jac`
take one rotation, as the reference's do (`torch.func.vmap` them for a
batch). Vectorisation is row-major throughout, as in the reference: for
f: R^3 -> R^{3x3}, J[3*i+j, k] = d f[i,j] / d w[k]. Small-angle branches are
`torch.where` selections over safe operands, so `torch.func.jacfwd` sees no
NaN. The reference's HIGHEST-precision helpers `mm` / `einsum_hp` become
plain float32 `@` / `torch.einsum`: on the GPU a float32 matmul stays float32
as long as TF32 is off, which this module enforces.
"""
from __future__ import annotations

import torch

# The GPU form of the reference's HIGHEST-precision rule: TF32
# keeps ~3 decimal digits, which destroys pose chains and covariances.
# The reference computes at the configuration's float32 (TF32 off);
# `portbench.reference.precision` turns TF32 on for the control only.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SMALL_ANGLE = 1e-6
SMALL_TRACE = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: w (...,3) -> skew matrix (...,3,3)."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
    ], dim=-2)


def vee(R: torch.Tensor) -> torch.Tensor:
    """Inverse of hat up to symmetrization: R (...,3,3) -> (...,3)."""
    return torch.stack([R[..., 2, 1] - R[..., 1, 2],
                        R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], dim=-1)


def _safe_norm(w: torch.Tensor, eps: float):
    """Norm with a bounded sqrt argument on the small branch: (norm, is_small)."""
    sq = torch.sum(w * w, dim=-1)
    is_small = sq < eps * eps
    return torch.sqrt(torch.where(is_small, torch.ones_like(sq), sq)), is_small


def rodrigues(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (...,3) -> rotation matrix (...,3,3), with the reference's
    small-angle limit (rotations.py:134-148)."""
    th, is_small = _safe_norm(w, SMALL_ANGLE)
    W = hat(w)
    W2 = W @ W
    sin_c = torch.where(is_small, torch.ones_like(th), torch.sin(th) / th)
    cos_c = torch.where(is_small, torch.full_like(th, 0.5),
                        (1.0 - torch.cos(th)) / (th * th))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + sin_c[..., None, None] * W + cos_c[..., None, None] * W2


def invrodrigues(R: torch.Tensor) -> torch.Tensor:
    """Log map: rotation matrix (...,3,3) -> axis-angle (...,3), accurate
    away from an angle of pi (rotations.py:182-198)."""
    tmp = 0.5 * (torch.diagonal(R, dim1=-2, dim2=-1).sum(-1) - 1.0)
    is_small = tmp > 1.0 - SMALL_TRACE
    th = torch.acos(torch.clamp(tmp, -1.0 + 1e-7, 1.0 - 1e-7))
    coef = torch.where(is_small, torch.full_like(th, 0.5),
                       0.5 * th / torch.sin(th))
    return coef[..., None] * vee(R)


def dhat(dtype=torch.float32, device=None) -> torch.Tensor:
    """Constant 9x3 Jacobian of hat (row-major vec): d vec(hat(w)) / d w.
    Column k is vec(hat(e_k)), since hat is linear."""
    return hat(torch.eye(3, dtype=dtype, device=device)).reshape(3, 9).T


def dvee(dtype=torch.float32, device=None) -> torch.Tensor:
    """Constant 3x9 Jacobian of vee (row-major vec of R). Column 3a+b is
    vee(E_ab), since vee is linear."""
    return vee(torch.eye(9, dtype=dtype, device=device).reshape(9, 3, 3)).T


def dAt_dA(n: int = 3, m: int = 3, dtype=torch.float32,
           device=None) -> torch.Tensor:
    """Jacobian of transpose under row-major vec: vec(A^T) = D @ vec(A) for
    A (n, m). Row j*n+i of D is one-hot at column i*m+j."""
    rows = torch.arange(m * n, device=device)
    cols = (rows % n) * m + rows // n
    return torch.eye(n * m, dtype=dtype, device=device)[cols]


def dAB_dA(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """d vec(A@B) / d vec(A), row-major vec: kron(I_N, B^T), (N*P, N*M)."""
    N, M = A.shape
    P = B.shape[1]
    eye = torch.eye(N, dtype=A.dtype, device=A.device)
    return torch.kron(eye, B.T.contiguous().to(A.dtype)).reshape(N * P, N * M)


def dAB_dB(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """d vec(A@B) / d vec(B), row-major vec: kron(A, I_P), (N*P, M*P)."""
    N, M = A.shape
    P = B.shape[1]
    eye = torch.eye(P, dtype=A.dtype, device=A.device)
    return torch.kron(A, eye).reshape(N * P, M * P)


def rodrigues_jac(w: torch.Tensor):
    """Rodrigues with its analytic Jacobian (rotations.py:151-180).

    Returns (R (3,3), dR_dw (9,3), row-major vec of R). One rotation; vmap
    for a batch. Below SMALL_ANGLE: R = I + hat(w), J = dhat."""
    th, is_small = _safe_norm(w, SMALL_ANGLE)
    inv_th = 1.0 / th
    u = w * inv_th
    U = hat(u)
    U2 = U @ U
    sin_th, cos_th = torch.sin(th), torch.cos(th)

    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    R_big = eye + sin_th * U + (1.0 - cos_th) * U2
    R = torch.where(is_small, eye + hat(w), R_big)

    D = dhat(w.dtype, w.device)
    dR_du = sin_th * D + (1.0 - cos_th) * ((dAB_dA(U, U) + dAB_dB(U, U)) @ D)
    du_dw = inv_th * (eye - torch.outer(u, u))
    dR_dth = (U * cos_th + U2 * sin_th).reshape(9, 1)
    J_big = dR_du @ du_dw + dR_dth @ u.reshape(1, 3)
    return R, torch.where(is_small, D, J_big)


def invrodrigues_jac(R: torch.Tensor):
    """Log map with its analytic 3x9 Jacobian (row-major vec of R),
    rotations.py:201-228. One rotation; vmap for a batch. Near the identity:
    w = vee(R)/2, J = dvee/2."""
    tmp = 0.5 * (torch.trace(R) - 1.0)
    v = vee(R)
    is_small = tmp > 1.0 - SMALL_TRACE
    Dv = dvee(R.dtype, R.device)

    tmp_c = torch.clamp(tmp, -1.0 + 1e-7, 1.0 - 1e-7)
    th = torch.acos(tmp_c)
    inv_sin = 1.0 / torch.sin(th)
    u = 0.5 * v * inv_sin
    w = torch.where(is_small, 0.5 * v, th * u)

    # dth_dR = -1/sqrt(1-tmp^2) * 0.5 * vec(I)
    dtmp_dR = 0.5 * torch.eye(3, dtype=R.dtype, device=R.device).reshape(9)
    denom = torch.sqrt(torch.clamp(1.0 - tmp_c * tmp_c, min=1e-12))
    dth_dR = (-1.0 / denom) * dtmp_dR
    du_dR = 0.5 * (Dv * inv_sin - torch.outer(
        v, (torch.cos(th) * inv_sin * inv_sin) * dth_dR))
    J_big = torch.outer(u, dth_dR) + th * du_dR
    return w, torch.where(is_small, 0.5 * Dv, J_big)


def project_so3(R: torch.Tensor) -> torch.Tensor:
    """Project approximate rotation(s) (...,3,3) onto SO(3) by SVD, with the
    reference's sign fix U diag(1, 1, det(U V^T)) V^T, so that an input of
    negative determinant still gives a proper rotation (rotations.py:231)."""
    U, _, Vt = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vt)
    S = torch.cat([torch.ones_like(R[..., :2, 0]), det[..., None]], dim=-1)
    return (U * S[..., None, :]) @ Vt
