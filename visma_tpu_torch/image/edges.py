"""Frontend gradient stencils (port of visma_tpu/image/edges.py:151-208).

With the NMS and the border/threshold mask in frontend/detect.py these
are the plain PyTorch twin of the corner-score kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def sobel_gradients(image: torch.Tensor):
    """(H, W) image -> (gx, gy), same shape, zero padding, Sobel / 8."""
    img = image.to(torch.float32)
    H, W = img.shape
    xp = F.pad(img, (1, 1, 1, 1))

    def s(dy, dx):
        return xp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    east_west = s(0, 1) - s(0, -1)
    ne_nw = s(-1, 1) - s(-1, -1)
    se_sw = s(1, 1) - s(1, -1)
    gx = (ne_nw + 2.0 * east_west + se_sw) / 8.0
    south_north = s(1, 0) - s(-1, 0)
    gy = ((s(1, -1) - s(-1, -1)) + 2.0 * south_north
          + (s(1, 1) - s(-1, 1))) / 8.0
    return gx, gy


def _box_sum(x: torch.Tensor, window: int) -> torch.Tensor:
    """Separable zero-padded `window` x `window` box sum: rows first, taps
    added in order."""
    r = window // 2
    H, W = x.shape
    v = F.pad(x, (0, 0, r, r))
    acc = v[0:H]
    for k in range(1, window):
        acc = acc + v[k:k + H]
    h = F.pad(acc, (r, r, 0, 0))
    out = h[:, 0:W]
    for k in range(1, window):
        out = out + h[:, k:k + W]
    return out


def shi_tomasi_response(image: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Min-eigenvalue corner response 0.5 (A + C - sqrt((A - C)^2 + 4 B^2))
    of the box-summed structure tensor."""
    gx, gy = sobel_gradients(image)
    a, b, c = gx * gx, gx * gy, gy * gy
    A, B, C = _box_sum(a, window), _box_sum(b, window), _box_sum(c, window)
    disc = torch.sqrt(torch.clamp((A - C) ** 2 + 4.0 * B * B, min=0.0))
    return 0.5 * (A + C - disc)
