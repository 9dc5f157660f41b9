"""Utilities for the VIO slice (port of visma_tpu/utils)."""

from visma_tpu_torch.utils.misc import (DivergenceError, finite_tree,
                                        resolve_device)

__all__ = ["DivergenceError", "finite_tree", "resolve_device"]
