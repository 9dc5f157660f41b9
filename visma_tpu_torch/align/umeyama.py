"""Closed-form point-set alignment (port of visma_tpu/align/umeyama.py).

`umeyama` reproduces Eigen::umeyama as the reference's "4DoF" estimator
uses it (constrained_ICP.cpp:25-37: the full Umeyama solution);
`umeyama_4dof` is the gravity-constrained closed form (yaw + translation
[+ scale]). Both take tensors on any device and return a (4, 4) tensor on
it. The 3x3 SVD and determinants are `torch.linalg`'s; the rotation
U diag(1, 1, d) V^T does not depend on the SVD's sign choices.
"""
from __future__ import annotations

import torch

from visma_tpu_torch.utils.misc import full_f32


def _weights(src: torch.Tensor, weights):
    if weights is None:
        weights = torch.ones(src.shape[0], dtype=src.dtype, device=src.device)
    return weights / torch.clamp(torch.sum(weights), min=1e-12)


@full_f32()
def umeyama(src: torch.Tensor, dst: torch.Tensor, weights=None,
            with_scaling: bool = False) -> torch.Tensor:
    """Least-squares similarity transform dst ~ c R src + t.

    src, dst: (N, 3); weights: optional (N,) nonneg. Returns (4, 4).
    """
    w = _weights(src, weights)
    mu_s = torch.sum(src * w[:, None], dim=0)
    mu_d = torch.sum(dst * w[:, None], dim=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = (dc * w[:, None]).T @ sc                         # (3,3)
    U, S, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    one = torch.ones((), dtype=cov.dtype, device=cov.device)
    Dg = torch.stack([one, one, d])
    R = (U * Dg) @ Vt
    var_s = torch.sum(w * torch.sum(sc * sc, dim=1))
    c = (torch.sum(S * Dg) / torch.clamp(var_s, min=1e-12)
         if with_scaling else one)
    t = mu_d - c * R @ mu_s
    return _se3(c * R, t)


def _se3(A: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=A.dtype,
                          device=A.device)
    return torch.cat([torch.cat([A, t[:, None]], dim=1), bottom], dim=0)


@full_f32()
def umeyama_4dof(src: torch.Tensor, dst: torch.Tensor, weights=None,
                 gravity_axis: int = 2,
                 with_scaling: bool = False) -> torch.Tensor:
    """Gravity-constrained alignment: rotation restricted to yaw about the
    gravity axis, by the 2-D Umeyama problem in the horizontal plane.
    Returns (4, 4)."""
    w = _weights(src, weights)
    mu_s = torch.sum(src * w[:, None], dim=0)
    mu_d = torch.sum(dst * w[:, None], dim=0)
    sc = src - mu_s
    dc = dst - mu_d

    ax = [i for i in range(3) if i != gravity_axis]
    cov = (dc[:, ax] * w[:, None]).T @ sc[:, ax]
    # R(theta) = [[cos, -sin], [sin, cos]] maximising sum w d2^T R s2
    theta = torch.atan2(cov[1, 0] - cov[0, 1], cov[0, 0] + cov[1, 1])
    c2, s2 = torch.cos(theta), torch.sin(theta)
    R = torch.eye(3, dtype=src.dtype, device=src.device)
    R[ax[0], ax[0]] = c2
    R[ax[0], ax[1]] = -s2
    R[ax[1], ax[0]] = s2
    R[ax[1], ax[1]] = c2

    scale = 1.0
    if with_scaling:
        var_s = torch.sum(w * torch.sum(sc * sc, dim=1))
        num = torch.sum(w * torch.sum(dc * (sc @ R.T), dim=1))
        scale = num / torch.clamp(var_s, min=1e-12)
    t = mu_d - scale * R @ mu_s
    return _se3(scale * R, t)
