"""Auxiliary utilities (port of part of visma_tpu/utils)."""

from visma_tpu_torch.utils.misc import (DivergenceError, finite_tree,
                                        resolve_device)
from visma_tpu_torch.utils.platform import configure_platform
from visma_tpu_torch.utils.timer import Timer, device_trace

__all__ = ["DivergenceError", "finite_tree", "resolve_device",
           "configure_platform", "Timer", "device_trace"]
