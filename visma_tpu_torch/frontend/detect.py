"""Corner detection: Shi-Tomasi response + NMS + grid-distributed top-k
(port of visma_tpu/frontend/detect.py).

`corner_score` is the masked, NMS'd score map. On a CUDA tensor it launches
the hand-written kernel `csrc/corner_score.cu` (the port of the TPU kernel
detect.py::_score_kernel); on a CPU tensor it runs `corner_score_plain`,
which follows the reference's `_corner_score_xla`. The two agree everywhere
in the frame to float32 rounding. `detect_features` is plain PyTorch on top
of the score map.

Parity traps (pinned in tests/test_torch_frontend.py):
  * the per-cell argmax keeps the LAST maximal linear index
    (detect.py:166-180): the max of the masked linear index;
  * `lax.top_k` returns ties lowest index first (detect.py:192):
    `torch.topk` promises no order, so a stable descending sort is used.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from visma_tpu_torch import _kernels
from visma_tpu_torch.image.edges import shi_tomasi_response

_HALO = 4  # sobel (1) + 5x5 box (2) + NMS (1)


def corner_score_plain(image: torch.Tensor, window: int = 5,
                       border: int = 8,
                       min_response: float = 1e-4) -> torch.Tensor:
    """Plain PyTorch twin of the corner-score kernel (detect.py:129-140)."""
    resp = shi_tomasi_response(image, window=window)
    neigh = F.max_pool2d(resp[None, None], 3, stride=1, padding=1)[0, 0]
    H, W = resp.shape
    row = torch.arange(H, device=resp.device)[:, None]
    col = torch.arange(W, device=resp.device)[None, :]
    inside = ((row >= border) & (row < H - border)
              & (col >= border) & (col < W - border))
    keep = (resp >= neigh) & inside & (resp > min_response)
    return torch.where(keep, resp, torch.zeros_like(resp))


def corner_score(image: torch.Tensor, window: int = 5, border: int = 8,
                 min_response: float = 1e-4) -> torch.Tensor:
    """Masked NMS'd Shi-Tomasi score map of a (H, W) image.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (window 5 only) or raises.
    """
    if image.device.type == "cpu":
        return corner_score_plain(image, window, border, min_response)
    if window != 5:
        raise ValueError(f"corner_score kernel: window must be 5, got {window}")
    if border < _HALO:
        raise ValueError(f"corner_score kernel: border must be >= {_HALO}")
    img = image.to(torch.float32).contiguous()
    _kernels.require_cuda("corner_score", img)
    H, W = img.shape
    if H == 0 or W == 0:
        raise ValueError("corner_score kernel: empty image")
    out = torch.empty_like(img)
    lib = _kernels.library()
    rc = lib.vt_corner_score(img.data_ptr(), out.data_ptr(), H, W, border,
                             min_response, _kernels.stream_of(img))
    _kernels.check(rc, "corner_score")
    corner_score.launches += 1
    return out


corner_score.launches = 0


def detect_features(image: torch.Tensor, max_features: int = 64,
                    cell: int = 16, border: int = 8,
                    min_response: float = 1e-4,
                    occupied: torch.Tensor = None):
    """Detect up to `max_features` corners, at most one per `cell` square.

    image (H, W); occupied: optional (H//cell, W//cell) bool of cells to
    skip. Returns (xy (N, 2) f32 pixel coords, score (N,), valid (N,)).
    """
    H, W = image.shape
    score = corner_score(image, 5, border, min_response)

    gh, gw = H // cell, W // cell
    Hc, Wc = gh * cell, gw * cell
    sc = score[:Hc, :Wc]
    cellmax = sc.reshape(gh, cell, gw, cell).amax(dim=(1, 3))
    up = cellmax.repeat_interleave(cell, 0).repeat_interleave(cell, 1)
    dev = image.device
    row = torch.arange(Hc, dtype=torch.int32, device=dev)[:, None]
    col = torch.arange(Wc, dtype=torch.int32, device=dev)[None, :]
    lin = torch.where((sc == up) & (sc > 0), row * Wc + col,
                      torch.full_like(row * Wc + col, -1))
    cell_idx = lin.reshape(gh, cell, gw, cell).amax(dim=(1, 3))

    idx_flat = cell_idx.reshape(-1)
    best_score = torch.clamp(cellmax, min=0.0).reshape(-1)
    zero = torch.zeros_like(best_score)
    best_score = torch.where(idx_flat >= 0, best_score, zero)
    if occupied is not None:
        best_score = torch.where(occupied.reshape(-1), zero, best_score)

    cy = torch.clamp(idx_flat, min=0) // Wc
    cx = torch.clamp(idx_flat, min=0) % Wc

    k = min(max_features, gh * gw)
    order = torch.sort(best_score, descending=True, stable=True).indices[:k]
    top_score = best_score[order]
    xy = torch.stack([cx[order], cy[order]], dim=-1).to(torch.float32)
    valid = top_score > 0
    if k < max_features:
        pad = max_features - k
        xy = F.pad(xy, (0, 0, 0, pad))
        top_score = F.pad(top_score, (0, pad))
        valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool,
                                              device=dev)])
    return xy, top_score, valid
