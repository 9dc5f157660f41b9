"""Edge maps and gradient stencils (port of visma_tpu/image/edges.py).

`depth_edge` is the renderer's edge map (reference parity:
render/shaders/edge_detection.frag): on linear metric depth, the mean of
four opposite-pair absolute differences in the 3x3 neighbourhood, a soft
threshold [0.05, 0.10], 0 on background and within 5 px of the border. On
a CUDA tensor it launches the hand-written kernel `csrc/depth_edge.cu`
(the port of the TPU kernel edges.py::_edge_kernel); on a CPU tensor it
runs `depth_edge_plain`. The reference's XLA form shifts with a wrapping
roll and its kernel pads with zeros; both mask the 5-px border, so they
agree everywhere, and the port pads with zeros.

The Sobel half (edges.py:151-208), with the NMS and the border/threshold
mask in frontend/detect.py, is the plain PyTorch twin of the corner-score
kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from visma_tpu_torch import _kernels

THRESH_LOW = 0.05   # edge_detection.frag:14
THRESH_HIGH = 0.10  # edge_detection.frag:15
BORDER = 5          # edge_detection.frag:43-44


def linearize_gl_depth(z: torch.Tensor, z_near: float,
                       z_far: float) -> torch.Tensor:
    """GL depth-buffer value in [0,1] -> metric depth; z==1 (far plane /
    background) -> -1 (edge_detection.frag:33-36)."""
    lin = 2.0 * z_near * z_far / (z_far + z_near
                                  - (2.0 * z - 1.0) * (z_far - z_near))
    return torch.where(z == 1.0, torch.full_like(lin, -1.0), lin)


def soft_threshold(value: torch.Tensor, lo: float = THRESH_LOW,
                   hi: float = THRESH_HIGH) -> torch.Tensor:
    """<lo -> 0, >=hi -> 1, else linear ramp (edge_detection.frag:22-26)."""
    return torch.clamp((value - lo) / (hi - lo), 0.0, 1.0)


def depth_edge_plain(depth: torch.Tensor, lo: float = THRESH_LOW,
                     hi: float = THRESH_HIGH) -> torch.Tensor:
    """Plain PyTorch twin of the depth-edge kernel: depth (..., H, W)
    linear metric depth, background <= 0 or non-finite."""
    depth = depth.to(torch.float32)
    H, W = depth.shape[-2:]
    v = torch.where(torch.isfinite(depth) & (depth > 0), depth,
                    torch.full_like(depth, -1.0))
    vp = F.pad(v, (1, 1, 1, 1))

    def s(dy, dx):
        return vp[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    # delta = .25*(|W-E| + |S-N| + |NW-SE| + |SW-NE|), added in this order
    delta = 0.25 * (torch.abs(s(0, -1) - s(0, 1))
                    + torch.abs(s(1, 0) - s(-1, 0))
                    + torch.abs(s(-1, -1) - s(1, 1))
                    + torch.abs(s(1, -1) - s(-1, 1)))
    out = soft_threshold(delta, lo, hi)
    row = torch.arange(H, device=depth.device)[:, None]
    col = torch.arange(W, device=depth.device)[None, :]
    inside = ((col >= BORDER) & (col <= W - 1 - BORDER)
              & (row >= BORDER) & (row <= H - 1 - BORDER))
    return torch.where((v > 0) & inside, out, torch.zeros_like(out))


def depth_edge(depth: torch.Tensor, lo: float = THRESH_LOW,
               hi: float = THRESH_HIGH) -> torch.Tensor:
    """Edge map in [0, 1] from linear depth (..., H, W); background: <= 0
    or inf. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (one launch for the whole batch) or raises."""
    if depth.device.type == "cpu":
        return depth_edge_plain(depth, lo, hi)
    if depth.dim() < 2:
        raise ValueError("depth_edge kernel: needs a (..., H, W) tensor")
    d = depth.to(torch.float32).contiguous()
    _kernels.require_cuda("depth_edge", d)
    H, W = d.shape[-2:]
    B = d.numel() // max(H * W, 1)
    if d.numel() == 0:
        raise ValueError("depth_edge kernel: empty input")
    out = torch.empty_like(d)
    rc = _kernels.library().vt_depth_edge(
        d.data_ptr(), out.data_ptr(), B, H, W, float(lo), float(hi - lo),
        BORDER, _kernels.vec4(W, d, out), _kernels.stream_of(d))
    _kernels.check(rc, "depth_edge")
    depth_edge.launches += 1
    return out


depth_edge.launches = 0


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
