"""Closed-form point-set alignment (port of visma_tpu/align/umeyama.py).

`umeyama` reproduces Eigen::umeyama as the reference's "4DoF" estimator
uses it (constrained_ICP.cpp:25-37: the full Umeyama solution);
`umeyama_4dof` is the gravity-constrained closed form (yaw + translation
[+ scale]). Both take tensors on any device and return a (4, 4) tensor on
it. The rotation U diag(1, 1, d) V^T of the 3x3 covariance's SVD is
`eig3.umeyama_rotation`'s: on a CUDA device `eig3.kabsch_rotation`, in
float64 tensor ops that read nothing back to the host (`torch.linalg.svd`
cannot be captured into a CUDA graph, and ICP's iteration is), on the CPU
LAPACK's float32 SVD, as the reference computes it.
"""
from __future__ import annotations

import torch

from visma_tpu_torch.align.eig3 import umeyama_rotation
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
    # trace(R^T cov) = sum(S diag(1, 1, d))
    R, trace = umeyama_rotation(cov)
    if with_scaling:
        var_s = torch.sum(w * torch.sum(sc * sc, dim=1))
        c = trace / torch.clamp(var_s, min=1e-12)
    else:
        c = torch.ones((), dtype=cov.dtype, device=cov.device)
    t = mu_d - c * R @ mu_s
    return _se3(c * R, t)


def _se3(A: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    # made on the device: a capture forbids a copy from the host
    bottom = torch.eye(4, dtype=A.dtype, device=A.device)[3:]
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
