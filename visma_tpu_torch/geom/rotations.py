"""Rotation maps (port of visma_tpu/geom/rotations.py).

What the filter and the SE(3) types need: `hat`, `vee`, `_safe_norm`,
`rodrigues` (rotations.py:40-150) and the log map `invrodrigues`
(rotations.py:182-198). The reference's HIGHEST-precision helpers `mm` /
`einsum_hp` become plain float32 `@` / `torch.einsum`: on the GPU a float32
matmul stays float32 as long as TF32 is off, which this module enforces.
"""
from __future__ import annotations

import torch

# The GPU form of the reference's HIGHEST-precision rule (CLAUDE.md): TF32
# keeps ~3 decimal digits, which destroys pose chains and covariances.
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
