"""Corner detection: Shi-Tomasi response + NMS + grid-distributed top-k
(port of visma_tpu/frontend/detect.py).

`corner_score` is the masked, NMS'd score map; `corner_cells` also picks
the best corner of each detection cell. On a CUDA tensor each is one
launch of the hand-written kernel `csrc/corner_score.cu` (the port of the
TPU kernel detect.py::_score_kernel, with the cell pick in its epilogue);
on a CPU tensor they run `corner_score_plain` and `cell_best_plain`, which
follow the reference's `_corner_score_xla` and its per-cell reduce_windows.
The two agree everywhere in the frame to float32 rounding, and the picks
exactly. `detect_features` orders the cells' picks in plain PyTorch.

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


def cell_best_plain(score: torch.Tensor, cell: int):
    """Per `cell` x `cell` square of score[:Hc, :Wc] (Hc, Wc the multiples
    of `cell`): the best score, 0 where no pixel is > 0, and the LAST
    maximal linear index row * Wc + col among pixels > 0, or -1
    (detect.py:166-180 of the reference). Returns ((gh, gw) float32,
    (gh, gw) int32)."""
    H, W = score.shape
    gh, gw = H // cell, W // cell
    Hc, Wc = gh * cell, gw * cell
    sc = score[:Hc, :Wc]
    cellmax = sc.reshape(gh, cell, gw, cell).amax(dim=(1, 3))
    up = cellmax.repeat_interleave(cell, 0).repeat_interleave(cell, 1)
    dev = score.device
    row = torch.arange(Hc, dtype=torch.int32, device=dev)[:, None]
    col = torch.arange(Wc, dtype=torch.int32, device=dev)[None, :]
    lin = torch.where((sc == up) & (sc > 0), row * Wc + col,
                      torch.full_like(row * Wc + col, -1))
    cell_idx = lin.reshape(gh, cell, gw, cell).amax(dim=(1, 3))
    best = torch.where(cell_idx >= 0, torch.clamp(cellmax, min=0.0),
                       torch.zeros_like(cellmax))
    return best, cell_idx


def _check_kernel_args(image, window, border):
    if window != 5:
        raise ValueError(f"corner_score kernel: window must be 5, got {window}")
    if border < _HALO:
        raise ValueError(f"corner_score kernel: border must be >= {_HALO}")
    img = image.to(torch.float32).contiguous()
    _kernels.require_cuda("corner_score", img)
    if img.dim() != 2 or img.numel() == 0:
        raise ValueError("corner_score kernel: needs a non-empty (H, W) image")
    return img


def _launch(img, border, min_response, cells=None, cell=0, outs=(None,) * 3):
    H, W = img.shape
    out = torch.empty_like(img)
    ptr = (lambda t: None if t is None else t.data_ptr())
    rc = _kernels.library().vt_corner_score(
        img.data_ptr(), out.data_ptr(), H, W, border, min_response,
        ptr(cells), cell, *map(ptr, outs), _kernels.vec4(W, img, out),
        _kernels.stream_of(img))
    _kernels.check(rc, "corner_score")
    corner_score.launches += 1
    return out


def corner_score(image: torch.Tensor, window: int = 5, border: int = 8,
                 min_response: float = 1e-4) -> torch.Tensor:
    """Masked NMS'd Shi-Tomasi score map of a (H, W) image.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (window 5 only) or raises.
    """
    if image.device.type == "cpu":
        return corner_score_plain(image, window, border, min_response)
    return _launch(_check_kernel_args(image, window, border), border,
                   min_response)


corner_score.launches = 0   # launches of the K1 kernel, by either entry


def corner_cells(image: torch.Tensor, cell: int, window: int = 5,
                 border: int = 8, min_response: float = 1e-4):
    """The score map and the best corner of each `cell` x `cell` square.

    Returns (score (H, W), best (gh, gw) float32, idx (gh, gw) int32, xy
    (gh, gw, 2) float32): `cell_best_plain` of the map, and the pixel
    (col, row) of each pick ((0, 0) where a cell has none). A CPU tensor
    takes the plain versions; a CUDA tensor is one launch of the kernel,
    which computes the map and the picks together, or raises."""
    if cell < 1:
        raise ValueError(f"corner_cells: cell must be >= 1, got {cell}")
    H, W = image.shape
    gh, gw = H // cell, W // cell
    if image.device.type == "cpu":
        score = corner_score_plain(image, window, border, min_response)
        best, idx = cell_best_plain(score, cell)
        flat = torch.clamp(idx, min=0)
        xy = torch.stack([flat % (gw * cell), flat // (gw * cell)],
                         dim=-1).to(torch.float32)
        return score, best, idx, xy
    img = _check_kernel_args(image, window, border)
    dev = img.device
    best = torch.empty((gh, gw), dtype=torch.float32, device=dev)
    idx = torch.empty((gh, gw), dtype=torch.int32, device=dev)
    xy = torch.empty((gh, gw, 2), dtype=torch.float32, device=dev)
    if gh * gw == 0:
        return _launch(img, border, min_response), best, idx, xy
    # packed (score bits, index + 1) per cell and a count of finished blocks
    scratch = torch.empty(gh * gw + 1, dtype=torch.int64, device=dev)
    score = _launch(img, border, min_response, scratch, cell,
                    (best, idx, xy))
    return score, best, idx, xy


def detect_features(image: torch.Tensor, max_features: int = 64,
                    cell: int = 16, border: int = 8,
                    min_response: float = 1e-4,
                    occupied: torch.Tensor = None):
    """Detect up to `max_features` corners, at most one per `cell` square.

    image (H, W); occupied: optional (H//cell, W//cell) bool of cells to
    skip. Returns (xy (N, 2) f32 pixel coords, score (N,), valid (N,)).
    """
    _, best, _, cell_xy = corner_cells(image, cell, 5, border, min_response)
    best_score = best.reshape(-1)
    if occupied is not None:
        best_score = torch.where(occupied.reshape(-1),
                                 torch.zeros_like(best_score), best_score)
    k = min(max_features, best_score.shape[0])
    order = torch.sort(best_score, descending=True, stable=True).indices[:k]
    top_score = best_score[order]
    xy = cell_xy.reshape(-1, 2)[order]
    valid = top_score > 0
    if k < max_features:
        pad = max_features - k
        xy = F.pad(xy, (0, 0, 0, pad))
        top_score = F.pad(top_score, (0, pad))
        valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool,
                                              device=image.device)])
    return xy, top_score, valid
