"""Lie-group geometry (port of visma_tpu/geom)."""

from visma_tpu_torch.geom.lie import SE3, SO3
from visma_tpu_torch.geom.rotations import hat, invrodrigues, rodrigues, vee

__all__ = ["hat", "invrodrigues", "rodrigues", "vee", "SO3", "SE3"]
