"""Image pyramids (port of visma_tpu/frontend/pyramid.py)."""
from __future__ import annotations

from typing import List

import torch


def build_pyramid(image: torch.Tensor, levels: int = 3) -> List[torch.Tensor]:
    """Grayscale (H, W) -> `levels` images, level 0 full resolution.

    Each level is the 2x2 mean of the one above with VALID flooring of odd
    sizes (pyramid.py:23): 500 rows give 500, 250, 125, 62. The four taps
    are added in row-major order and scaled by 0.25, as the reference's
    reduce_window does.
    """
    img = image.to(torch.float32)
    pyr = [img]
    for _ in range(levels - 1):
        h, w = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
        a = img[:h, :w]
        img = (((a[0::2, 0::2] + a[0::2, 1::2]) + a[1::2, 0::2])
               + a[1::2, 1::2]) * 0.25
        pyr.append(img)
    return pyr
