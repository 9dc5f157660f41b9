"""Auxiliary utilities (port of visma_tpu/utils; reference parity:
core/utils.{h,cpp})."""

from visma_tpu_torch.utils.misc import (DivergenceError, any_nan,
                                        bilinear_sample, finite_tree,
                                        generate_random_color_map,
                                        random_matrix, random_vector,
                                        resolve_device)
from visma_tpu_torch.utils.platform import configure_platform
from visma_tpu_torch.utils.term import TermColor
from visma_tpu_torch.utils.timer import Timer, device_trace

__all__ = ["Timer", "TermColor", "any_nan", "random_matrix", "random_vector",
           "generate_random_color_map", "bilinear_sample",
           "DivergenceError", "finite_tree", "resolve_device",
           "configure_platform", "device_trace"]
