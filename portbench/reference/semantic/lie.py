# Frozen copy of visma_tpu_torch/geom/lie.py at 43be5d3; the rotations it
# uses come from the reference's copy. Part of the benchmark's plain reference.
"""SO(3)/SE(3) group types on tensors (port of visma_tpu/geom/lie.py).

Both types carry arbitrary leading batch dimensions, which broadcast in
`@`. The reference registers them as pytrees for jit/vmap; here they are
plain frozen dataclasses of tensors, and a batch axis is written out.
Products are float32 `@`/`einsum` with TF32 off (geom/rotations.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from portbench.reference.vio import rotations as rot


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (...,3,3) x (...,3) -> (...,3)."""
    return torch.einsum("...ij,...j->...i", M, v)


@dataclass(frozen=True)
class SO3:
    """Rotation group element(s); wraps a (...,3,3) matrix."""

    R: torch.Tensor

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32,
                 device=None) -> "SO3":
        eye = torch.eye(3, dtype=dtype, device=device)
        return cls(eye.expand(*batch_shape, 3, 3))

    @classmethod
    def exp(cls, w: torch.Tensor) -> "SO3":
        return cls(rot.rodrigues(w))

    @classmethod
    def from_matrix(cls, R: torch.Tensor) -> "SO3":
        return cls(R)

    @classmethod
    def fit(cls, R_approx: torch.Tensor) -> "SO3":
        """Project approximate rotation(s) onto SO(3) (lie.py:52)."""
        return cls(rot.project_so3(R_approx))

    def __matmul__(self, other):
        if isinstance(other, SO3):
            return SO3(self.R @ other.R)
        return self.act(other)

    def act(self, v: torch.Tensor) -> torch.Tensor:
        """Rotate point(s) v with shape (...,3)."""
        return _mv(self.R, v)

    def inv(self) -> "SO3":
        return SO3(self.R.transpose(-1, -2))

    def log(self) -> torch.Tensor:
        return rot.invrodrigues(self.R)

    def matrix(self) -> torch.Tensor:
        return self.R

    @property
    def shape(self):
        return self.R.shape[:-2]


@dataclass(frozen=True)
class SE3:
    """Rigid transform(s): rotation (...,3,3) + translation (...,3)."""

    R: torch.Tensor
    t: torch.Tensor

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32,
                 device=None) -> "SE3":
        eye = torch.eye(3, dtype=dtype, device=device)
        return cls(eye.expand(*batch_shape, 3, 3),
                   torch.zeros((*batch_shape, 3), dtype=dtype, device=device))

    @classmethod
    def from_matrix3x4(cls, G: torch.Tensor) -> "SE3":
        """(...,3,4) row-major [R|t], the vlslam gwc convention."""
        return cls(G[..., :3, :3], G[..., :3, 3])

    @classmethod
    def from_matrix(cls, G: torch.Tensor) -> "SE3":
        """(...,4,4) homogeneous matrix."""
        return cls(G[..., :3, :3], G[..., :3, 3])

    @classmethod
    def from_Rt(cls, R, t: torch.Tensor) -> "SE3":
        """From a rotation (an SO3 or a (...,3,3) tensor) and t (...,3)."""
        return cls(R.R if isinstance(R, SO3) else R, t)

    @classmethod
    def exp(cls, xi: torch.Tensor) -> "SE3":
        """SE(3) exponential. xi = (..., 6) as [rho, w] (trans, rot)."""
        rho, w = xi[..., :3], xi[..., 3:]
        return cls(rot.rodrigues(w), _mv(_left_jacobian(w), rho))

    def __matmul__(self, other):
        if isinstance(other, SE3):
            return SE3(self.R @ other.R, _mv(self.R, other.t) + self.t)
        return self.act(other)

    def act(self, v: torch.Tensor) -> torch.Tensor:
        return _mv(self.R, v) + self.t

    def inv(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(Rt, -_mv(Rt, self.t))

    def log(self) -> torch.Tensor:
        """Tangent (...,6) as [rho, w]."""
        w = rot.invrodrigues(self.R)
        rho = _mv(_left_jacobian_inv(w), self.t)
        return torch.cat([rho, w], dim=-1)

    def so3(self) -> SO3:
        return SO3(self.R)

    @property
    def translation(self) -> torch.Tensor:
        return self.t

    def matrix3x4(self) -> torch.Tensor:
        return torch.cat([self.R, self.t[..., :, None]], dim=-1)

    def matrix(self) -> torch.Tensor:
        G34 = self.matrix3x4()
        bottom = torch.zeros_like(G34[..., :1, :])
        bottom[..., 0, 3] = 1.0
        return torch.cat([G34, bottom], dim=-2)

    @property
    def shape(self):
        return self.R.shape[:-2]


def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V(w) = I + B*hat(w) + C*hat(w)^2 with
    B = (1-cos th)/th^2, C = (th - sin th)/th^3 and their series near 0."""
    th2 = torch.sum(w * w, dim=-1)
    small = th2 < rot.SMALL_ANGLE ** 2
    th2s = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2s)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2s)
    C = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th - torch.sin(th)) / (th2s * th))
    W = rot.hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + B[..., None, None] * W + C[..., None, None] * (W @ W)


def _left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of the left Jacobian:
    I - hat(w)/2 + D*hat(w)^2, D = (1 - th/2 cot(th/2)) / th^2."""
    th2 = torch.sum(w * w, dim=-1)
    small = th2 < rot.SMALL_ANGLE ** 2
    th2s = torch.where(small, torch.ones_like(th2), th2)
    half = 0.5 * torch.sqrt(th2s)
    cot_term = half * torch.cos(half) / torch.sin(half)
    D = torch.where(small, 1.0 / 12.0 + th2 / 720.0, (1.0 - cot_term) / th2s)
    W = rot.hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye - 0.5 * W + D[..., None, None] * (W @ W)
