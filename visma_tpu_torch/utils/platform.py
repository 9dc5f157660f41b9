"""Platform set-up for CLI entry points (port of
visma_tpu/utils/platform.py).

The reference picks a JAX platform from an environment variable. The port
has one rule instead (`utils.misc.resolve_device`): the CUDA card unless the
caller names a device, and an error where a card is wanted and none exists.
No environment switch hides a missing card.
"""
from __future__ import annotations

import torch

from visma_tpu_torch.utils.misc import resolve_device


def configure_platform(device=None) -> torch.device:
    """Resolve the device a tool runs on and turn TF32 off for matrix
    products and convolutions: the GPU form of the reference's
    HIGHEST-precision rule for the filter algebra."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return resolve_device(device)
