"""The VIO frontend, batched over frames: pyramid, Shi-Tomasi corners with
one pick a grid cell, pyramidal Lucas-Kanade with the forward-backward
gate, and the tracker's replenishment.

A rewrite with a leading batch axis of the plain versions in
visma_tpu_torch at 43be5d3: `frontend/pyramid.py::build_pyramid`,
`image/edges.py` (`sobel_gradients`, `_box_sum`, `shi_tomasi_response`),
`frontend/detect.py` (`corner_score_plain`, `cell_best_plain`,
`detect_features`), `frontend/klt_fused.py` (`lk_level_plain`,
`lk_track_plain` and their helpers) and `frontend/tracker.py`
(`occupied_cells`, `FeatureTracker.init`, `_step_impl`). Every operation
keeps their order of arithmetic; the batch axis is what lets the reference
take the tracker's step for every frame of a sequence at once, each from
the state the program handed back for the frame before. Part of the
benchmark's plain reference.

Arithmetic runs in the images' dtype: float32 for the reference, bfloat16
for the precision control.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F


def build_pyramid(images: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """(B, H, W) -> `levels` images, each the 2x2 mean of the one above
    with odd sizes floored."""
    img = images
    pyr = [img]
    for _ in range(levels - 1):
        h, w = img.shape[-2] // 2 * 2, img.shape[-1] // 2 * 2
        a = img[:, :h, :w]
        img = (((a[:, 0::2, 0::2] + a[:, 0::2, 1::2]) + a[:, 1::2, 0::2])
               + a[:, 1::2, 1::2]) * 0.25
        pyr.append(img)
    return pyr


def _sobel(img: torch.Tensor):
    H, W = img.shape[-2:]
    xp = F.pad(img, (1, 1, 1, 1))

    def s(dy, dx):
        return xp[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    gx = ((s(-1, 1) - s(-1, -1)) + 2.0 * (s(0, 1) - s(0, -1))
          + (s(1, 1) - s(1, -1))) / 8.0
    gy = ((s(1, -1) - s(-1, -1)) + 2.0 * (s(1, 0) - s(-1, 0))
          + (s(1, 1) - s(-1, 1))) / 8.0
    return gx, gy


def _box_sum(x: torch.Tensor, window: int) -> torch.Tensor:
    r = window // 2
    H, W = x.shape[-2:]
    v = F.pad(x, (0, 0, r, r))
    acc = v[:, 0:H]
    for k in range(1, window):
        acc = acc + v[:, k:k + H]
    h = F.pad(acc, (r, r, 0, 0))
    out = h[:, :, 0:W]
    for k in range(1, window):
        out = out + h[:, :, k:k + W]
    return out


def corner_score(img: torch.Tensor, window: int = 5, border: int = 8,
                 min_response: float = 1e-4) -> torch.Tensor:
    """Masked, NMS'd Shi-Tomasi response of (B, H, W) images."""
    gx, gy = _sobel(img)
    A = _box_sum(gx * gx, window)
    Bm = _box_sum(gx * gy, window)
    C = _box_sum(gy * gy, window)
    disc = torch.sqrt(torch.clamp((A - C) ** 2 + 4.0 * Bm * Bm, min=0.0))
    resp = 0.5 * (A + C - disc)
    neigh = F.max_pool2d(resp[:, None], 3, stride=1, padding=1)[:, 0]
    H, W = resp.shape[-2:]
    row = torch.arange(H, device=img.device)[:, None]
    col = torch.arange(W, device=img.device)[None, :]
    inside = ((row >= border) & (row < H - border)
              & (col >= border) & (col < W - border))
    keep = (resp >= neigh) & inside & (resp > min_response)
    return torch.where(keep, resp, torch.zeros_like(resp))


def cell_best(score: torch.Tensor, cell: int):
    """Per cell: the best score (0 without a pixel > 0) and the last
    maximal linear index row * Wc + col among pixels > 0, or -1."""
    B, H, W = score.shape
    gh, gw = H // cell, W // cell
    Hc, Wc = gh * cell, gw * cell
    sc = score[:, :Hc, :Wc]
    cellmax = sc.reshape(B, gh, cell, gw, cell).amax(dim=(2, 4))
    up = cellmax.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    row = torch.arange(Hc, dtype=torch.int32, device=score.device)[:, None]
    col = torch.arange(Wc, dtype=torch.int32, device=score.device)[None, :]
    lin = row * Wc + col
    lin = torch.where((sc == up) & (sc > 0), lin, torch.full_like(lin, -1))
    idx = lin.reshape(B, gh, cell, gw, cell).amax(dim=(2, 4))
    best = torch.where(idx >= 0, torch.clamp(cellmax, min=0.0),
                       torch.zeros_like(cellmax))
    return best, idx


def detect(img: torch.Tensor, max_features: int, cell: int,
           occupied: torch.Tensor = None):
    """Up to `max_features` corners a frame, one a cell, best first (ties
    lowest cell first). Returns (xy (B, K, 2), valid (B, K))."""
    B, H, W = img.shape
    gw = W // cell
    best, idx = cell_best(corner_score(img), cell)
    flat = torch.clamp(idx, min=0)
    cell_xy = torch.stack([flat % (gw * cell), flat // (gw * cell)],
                          dim=-1).to(img.dtype).reshape(B, -1, 2)
    score = best.reshape(B, -1)
    if occupied is not None:
        score = torch.where(occupied.reshape(B, -1), torch.zeros_like(score),
                            score)
    k = min(max_features, score.shape[1])
    order = torch.sort(score, dim=1, descending=True, stable=True).indices
    order = order[:, :k]
    top = torch.gather(score, 1, order)
    xy = torch.gather(cell_xy, 1, order[..., None].expand(B, k, 2))
    valid = top > 0
    if k < max_features:
        pad = max_features - k
        xy = F.pad(xy, (0, 0, 0, pad))
        valid = F.pad(valid, (0, pad))
    return xy, valid


def _window_origin(centers, win: int, H: int, W: int):
    x0 = torch.clamp(torch.floor(centers[..., 0]).to(torch.int32) - win // 2,
                     0, W - win)
    y0 = torch.clamp(torch.floor(centers[..., 1]).to(torch.int32) - win // 2,
                     0, H - win)
    return torch.stack([x0, y0], dim=-1)


def _taps(s):
    n = torch.floor(s)
    w0 = torch.clamp(1.0 - torch.abs(s - n), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(s - (n + 1.0)), min=0.0)
    return n.to(torch.int64), w0, w1


def _sample_patch(img, org, sy, sx, win: int, size: int):
    """(B, K, size, size) bilinear patches of (B, H, W) images, starting at
    window-local (sy, sx) (B, K) inside the windows at org (B, K, 2)."""
    ny, wy0, wy1 = _taps(sy)
    nx, wx0, wx1 = _taps(sx)
    ar = torch.arange(size, device=img.device)
    iy = ny[..., None] + ar
    ix = nx[..., None] + ar
    oy = org[..., 1].to(torch.int64)[..., None]
    ox = org[..., 0].to(torch.int64)[..., None]
    r0 = (oy + torch.clamp(iy, max=win - 1))[..., :, None]
    r1 = (oy + torch.clamp(iy + 1, max=win - 1))[..., :, None]
    c0 = (ox + torch.clamp(ix, max=win - 1))[..., None, :]
    c1 = (ox + torch.clamp(ix + 1, max=win - 1))[..., None, :]
    b = torch.arange(img.shape[0], device=img.device)[:, None, None, None]
    wy0, wy1 = wy0[..., None, None], wy1[..., None, None]
    v0 = wy0 * img[b, r0, c0] + wy1 * img[b, r1, c0]
    v1 = wy0 * img[b, r0, c1] + wy1 * img[b, r1, c1]
    return wx0[..., None, None] * v0 + wx1[..., None, None] * v1


def _lk_level(imgT, imgI, orgT, orgI, stT, sI0, win: int, radius: int,
              iters: int):
    """One level for (B, K) features; stT / sI0 (2, B, K) (row, col)."""
    m = 2 * radius + 1
    ty = torch.clamp(stT[0], 1.0, win - m - 1.0)
    tx = torch.clamp(stT[1], 1.0, win - m - 1.0)
    Tp = _sample_patch(imgT, orgT, ty - 1.0, tx - 1.0, win, m + 2)
    T = Tp[..., 1:1 + m, 1:1 + m]
    Tx = 0.5 * (Tp[..., 1:1 + m, 2:2 + m] - Tp[..., 1:1 + m, 0:m])
    Ty = 0.5 * (Tp[..., 2:2 + m, 1:1 + m] - Tp[..., 0:m, 1:1 + m])
    Gxx = torch.sum(Tx * Tx, dim=(-2, -1))
    Gxy = torch.sum(Tx * Ty, dim=(-2, -1))
    Gyy = torch.sum(Ty * Ty, dim=(-2, -1))
    det = Gxx * Gyy - Gxy * Gxy
    ok = det > 1e-6
    inv_det = torch.where(ok, 1.0 / torch.clamp(det, min=1e-12),
                          torch.zeros_like(det))
    lim = win - m - 1e-4
    s0y, s0x = sI0[0], sI0[1]
    uy = torch.zeros_like(s0y)
    ux = torch.zeros_like(s0x)
    for _ in range(iters):
        I = _sample_patch(imgI, orgI, torch.clamp(s0y + uy, 0.0, lim),
                          torch.clamp(s0x + ux, 0.0, lim), win, m)
        e = I - T
        bx = torch.sum(Tx * e, dim=(-2, -1))
        by = torch.sum(Ty * e, dim=(-2, -1))
        dx = inv_det * (Gyy * bx - Gxy * by)
        dy = inv_det * (-Gxy * bx + Gxx * by)
        uy, ux = uy - dy, ux - dx
    I = _sample_patch(imgI, orgI, torch.clamp(s0y + uy, 0.0, lim),
                      torch.clamp(s0x + ux, 0.0, lim), win, m)
    res = torch.sqrt(torch.mean((I - T) ** 2, dim=(-2, -1)))
    return torch.stack([uy, ux]), res, ok


def _starts(pts, r: int, org):
    """(2, B, K) (row, col) patch starts of points (B, K, 2) in windows."""
    s = pts - r - org.to(pts.dtype)
    return torch.stack([s[..., 1], s[..., 0]])


def _level_windows(pyr, levels: int, radius: int, win: int):
    out = []
    for lv in range(levels):
        Hl, Wl = pyr[lv].shape[-2:]
        wl = min(win, Hl - Hl % 8 or Hl, Wl - Wl % 8 or Wl)
        if wl < 2 * radius + 4:
            if lv == 0:
                raise ValueError(f"level-0 window {wl} too small")
            wl = 0
        out.append((Hl, Wl, wl))
    return out


def lk_track(prev_pyr, cur_pyr, pts, valid, radius: int = 5, iters: int = 8,
             levels: int = 3, max_residual: float = 12.0,
             fb_thresh: float = 1.0, win: int = 24):
    """Track pts (B, K, 2) from prev to cur: the levels coarse to fine, the
    forward-backward pass and the gates. Returns (new_pts, ok)."""
    H, W = cur_pyr[0].shape[-2:]
    r = radius
    d = torch.zeros_like(pts)
    ok = valid
    lvl0 = None
    for lv in range(levels - 1, -1, -1):
        Hl, Wl, wl = _level_windows(prev_pyr, levels, r, win)[lv]
        if wl == 0:
            continue
        scale = 2.0 ** lv
        pts_l = pts / scale
        est = pts_l + d / scale
        orgP = _window_origin(pts_l, wl, Hl, Wl)
        orgC = _window_origin(est, wl, Hl, Wl)
        u, res, ok_l = _lk_level(prev_pyr[lv], cur_pyr[lv], orgP, orgC,
                                 _starts(pts_l, r, orgP),
                                 _starts(est, r, orgC), wl, r, iters)
        d = (est + torch.stack([u[1], u[0]], dim=-1) - pts_l) * scale
        ok = ok & ok_l
        if lv == 0:
            lvl0 = (orgP, orgC, res, wl)
    new_pt = pts + d
    orgP0, orgC0, res0, wl0 = lvl0
    v, _, _ = _lk_level(cur_pyr[0], prev_pyr[0], orgC0, orgP0,
                        _starts(new_pt, r, orgC0), _starts(pts, r, orgP0),
                        wl0, r, iters)
    fb_err = torch.sqrt(v[0] ** 2 + v[1] ** 2)
    inb = ((new_pt[..., 0] >= r + 1) & (new_pt[..., 0] < W - r - 1)
           & (new_pt[..., 1] >= r + 1) & (new_pt[..., 1] < H - r - 1))
    ok = ok & inb & (res0 < max_residual) & (fb_err < fb_thresh) \
        & torch.isfinite(new_pt).all(dim=-1)
    return torch.where(ok[..., None], new_pt, pts), ok


def _occupied(pos, ok, cell: int, gh: int, gw: int):
    """(B, gh, gw): cells holding a tracked feature, the highest slot of a
    cell deciding."""
    B, K = ok.shape
    cx = torch.clamp((pos[..., 0] / cell).to(torch.int32), 0, gw - 1)
    cy = torch.clamp((pos[..., 1] / cell).to(torch.int32), 0, gh - 1)
    flat = (cy * gw + cx).long()
    slot = torch.arange(K, device=pos.device).expand(B, K)
    winner = torch.full((B, gh * gw), -1, dtype=torch.int64,
                        device=pos.device)
    winner = winner.scatter_reduce(1, flat, slot, "amax", include_self=True)
    occ = (winner >= 0) & torch.gather(ok, 1, torch.clamp(winner, min=0))
    return occ.reshape(B, gh, gw)


def tracker_init(images, max_features: int, cell: int):
    """(ids (B, K) int32, pos (B, K, 2), next_id (B,) int32) of the first
    frame: its detections, numbered in order."""
    xy, valid = detect(images, max_features, cell)
    K = max_features
    ar = torch.arange(K, dtype=torch.int32, device=images.device)
    ids = torch.where(valid, ar, torch.full_like(ar, -1))
    nxt = torch.full((images.shape[0],), K, dtype=torch.int32,
                     device=images.device)
    return ids, xy, nxt


def tracker_step(prev_pyr, cur_pyr, ids, pos, next_id, cell: int,
                 levels: int, radius: int = 5):
    """One tracked frame for B independent (previous state, frame) pairs:
    ids (B, K) int32, pos (B, K, 2), next_id (B,). Returns (ids, pos,
    next_id) after the frame."""
    i32 = torch.int32
    B, K = ids.shape
    image = cur_pyr[0]
    live = ids >= 0
    new_pos, ok = lk_track(prev_pyr, cur_pyr, pos, live, radius=radius,
                           levels=levels)
    ok = ok & live
    ids = torch.where(ok, ids, torch.full_like(ids, -1))
    H, W = image.shape[-2:]
    gh, gw = H // cell, W // cell
    occ = _occupied(new_pos, ok, cell, gh, gw)
    det_xy, det_valid = detect(image, K, cell, occupied=occ)
    empty = ids < 0
    empty_rank = torch.cumsum(empty.to(i32), dim=1, dtype=i32) - 1
    det_rank = torch.cumsum(det_valid.to(i32), dim=1, dtype=i32) - 1
    n_det = torch.sum(det_valid, dim=1, dtype=i32)
    take = empty & (empty_rank < n_det[:, None])
    Fn = det_xy.shape[1]
    rank_idx = torch.where(det_valid, det_rank, torch.full_like(det_rank,
                                                                Fn - 1))
    src_val = torch.arange(Fn, dtype=i32, device=ids.device) \
        * det_valid.to(i32)
    feat_for_rank = torch.zeros((B, Fn), dtype=i32, device=ids.device)
    feat_for_rank = feat_for_rank.scatter_reduce(
        1, rank_idx.long(), src_val, "amax", include_self=True)
    src = torch.gather(feat_for_rank, 1,
                       torch.clamp(empty_rank, 0, Fn - 1).long()).long()
    ids = torch.where(take, next_id[:, None] + empty_rank, ids)
    pos = torch.where(take[..., None],
                      torch.gather(det_xy, 1, src[..., None].expand(B, K, 2)),
                      new_pos)
    next_id = next_id + torch.sum(take.to(i32), dim=1, dtype=i32)
    return ids, pos, next_id
