"""Geometry for the VIO slice (port of visma_tpu/geom)."""

from visma_tpu_torch.geom.rotations import hat, rodrigues, vee

__all__ = ["hat", "rodrigues", "vee"]
