"""Lie-group geometry (port of visma_tpu/geom)."""

from visma_tpu_torch.geom.lie import SE3, SO3
from visma_tpu_torch.geom.rotations import (dAB_dA, dAB_dB, dAt_dA, dhat,
                                            dvee, hat, invrodrigues,
                                            invrodrigues_jac, project_so3,
                                            rodrigues, rodrigues_jac, vee)

__all__ = [
    "hat", "vee", "dhat", "dvee", "dAt_dA", "dAB_dA", "dAB_dB",
    "rodrigues", "rodrigues_jac", "invrodrigues", "invrodrigues_jac",
    "project_so3", "SO3", "SE3",
]
