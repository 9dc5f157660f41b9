"""Pyramidal inverse-compositional Lucas-Kanade tracking, windowed (port of
visma_tpu/frontend/klt.py). Plain PyTorch: the reference has no TPU kernel
here, so neither has the port.

The reference cuts one (win x win) window per feature out of each pyramid
level with one-hot selection matmuls and samples patches inside the windows
with two-tap bilinear weight matrices, because per-feature random access is
slow on a TPU. A one-hot product only selects, so the port indexes the
level images directly and keeps the arithmetic:

  * a window's origin is round(centre) - win//2, clipped to the image
    (klt.py:173-174), round half to even;
  * a patch start inside a window is clamped to [0, win - m - 1e-4]
    (klt.py:193), so samples clamp to the window: a feature that moved
    further fails the residual / forward-backward gates;
  * a sample is (1-fy) row + fy next row first, then (1-fx) column + fx
    next column (klt.py:209-212).

`track_features` is the windowed tracker (win 40), the JAX package's default
off the TPU; `track_features_gather` is its per-feature oracle with
per-patch border clamping. The tracker's default path is the fused one
(frontend/klt_fused.py, kernel lk_track).
"""
from __future__ import annotations

import torch


def _extract_origins(centers: torch.Tensor, win: int, H: int, W: int):
    """(K, 2) int64 (x0, y0) origins of win x win windows around (K, 2)
    centres: round(centre) - win//2, clipped to the image."""
    x0 = torch.clamp(torch.round(centers[:, 0]).long() - win // 2, 0, W - win)
    y0 = torch.clamp(torch.round(centers[:, 1]).long() - win // 2, 0, H - win)
    return torch.stack([x0, y0], dim=-1)


def _taps(off: torch.Tensor, m: int, win: int):
    """First tap (K,) int64 and fraction (K, 1, 1) of a window-local patch
    start `off` (K,), clamped so both taps stay inside the window."""
    off = torch.clamp(off, 0.0, win - m - 1e-4)
    o = torch.floor(off)
    return o.long(), (off - o)[:, None, None]


def _sample_windows(img: torch.Tensor, org: torch.Tensor,
                    off_xy: torch.Tensor, m: int, win: int) -> torch.Tensor:
    """(K, m, m) bilinear patches; patch pixel (i, j) sits at window
    coordinate (off_y + i, off_x + j) of the window at `org` in `img`."""
    oy, fy = _taps(off_xy[:, 1], m, win)
    ox, fx = _taps(off_xy[:, 0], m, win)
    ar = torch.arange(m, device=img.device)
    r0 = ((org[:, 1] + oy)[:, None] + ar)[:, :, None]
    c0 = ((org[:, 0] + ox)[:, None] + ar)[:, None, :]
    # rows first, then columns
    P0 = (1.0 - fy) * img[r0, c0] + fy * img[r0 + 1, c0]
    P1 = (1.0 - fy) * img[r0, c0 + 1] + fy * img[r0 + 1, c0 + 1]
    return (1.0 - fx) * P0 + fx * P1


def _solve_level(sample_T, sample_I, guess, iters):
    """Inverse-compositional LK given two patch samplers: sample_T(sx, sy)
    -> template patches at pts_l shifted by whole pixels (sx, sy),
    sample_I(d) -> search patches at pts_l + d (K, 2). Returns (d (K, 2),
    residual (K,), ok (K,))."""
    T = sample_T(0, 0)
    Tx = 0.5 * (sample_T(1, 0) - sample_T(-1, 0))
    Ty = 0.5 * (sample_T(0, 1) - sample_T(0, -1))
    Gxx = torch.sum(Tx * Tx, dim=(1, 2))
    Gxy = torch.sum(Tx * Ty, dim=(1, 2))
    Gyy = torch.sum(Ty * Ty, dim=(1, 2))
    det = Gxx * Gyy - Gxy * Gxy
    ok = det > 1e-6
    inv_det = torch.where(ok, 1.0 / torch.clamp(det, min=1e-12),
                          torch.zeros_like(det))
    d = guess
    for _ in range(iters):
        e = sample_I(d) - T
        bx = torch.sum(Tx * e, dim=(1, 2))
        by = torch.sum(Ty * e, dim=(1, 2))
        dx = inv_det * (Gyy * bx - Gxy * by)
        dy = inv_det * (-Gxy * bx + Gxx * by)
        d = d - torch.stack([dx, dy], dim=-1)
    res = torch.sqrt(torch.mean((sample_I(d) - T) ** 2, dim=(1, 2)))
    return d, res, ok


def _track_level_batched(imgP, orgP, imgC, orgC, pts_l, guess, radius, iters,
                         win):
    """One pyramid level for all features: templates from the windows at
    orgP in imgP, samples from the windows at orgC in imgC (klt.py:215-253).
    pts_l (K, 2) at this level's scale; guess (K, 2)."""
    m = 2 * radius + 1
    orgPf, orgCf = orgP.to(torch.float32), orgC.to(torch.float32)
    offT = pts_l - radius - orgPf   # template top-left, window coordinates

    def sample_T(sx, sy):
        # the shift added column by column: a tensor made of [sx, sy] would
        # be a host-to-device copy, which a CUDA graph capture refuses
        shifted = torch.stack([offT[:, 0] + sx, offT[:, 1] + sy], dim=-1)
        return _sample_windows(imgP, orgP, shifted, m, win)

    def sample_I(d):
        return _sample_windows(imgC, orgC, pts_l + d - radius - orgCf, m,
                               win)

    return _solve_level(sample_T, sample_I, guess, iters)


def track_features(prev_pyr, cur_pyr, pts: torch.Tensor, valid: torch.Tensor,
                   radius: int = 5, iters: int = 8, levels: int = 3,
                   max_residual: float = 12.0, fb_thresh: float = 1.0,
                   win: int = 40):
    """Track `pts` (N, 2) from the prev to the cur pyramid (windowed LK).

    Returns (new_pts (N, 2), still_valid (N,)). Validity requires LK
    convergence at every level, an in-bounds result, a residual below
    `max_residual` (intensity units) and a forward-backward error below
    `fb_thresh` pixels.

    win: per-feature window size; its margin (win/2 - radius - 1) bounds
    how far a level's refinement may move beyond the coarse-level guess.
    """
    H, W = cur_pyr[0].shape
    r = radius
    m = 2 * r + 1
    d = torch.zeros_like(pts)
    ok = valid
    for lv in range(levels - 1, -1, -1):
        scale = 2.0 ** lv
        Hl, Wl = prev_pyr[lv].shape
        wl = min(win, (Hl // 8) * 8 or Hl, (Wl // 8) * 8 or Wl)
        if wl < m + 1:
            raise ValueError(f"level-{lv} window {wl} too small for radius "
                             f"{r}: need at least {m + 1}")
        pts_l = pts / scale
        orgP = _extract_origins(pts_l, wl, Hl, Wl)
        orgC = _extract_origins(pts_l + d / scale, wl, Hl, Wl)
        dl, _res, ok_l = _track_level_batched(
            prev_pyr[lv], orgP, cur_pyr[lv], orgC, pts_l, d / scale, r, iters,
            wl)
        d = dl * scale
        ok = ok & ok_l
    new_pt = pts + d
    # after the loop: pts_l == pts, and orgP / orgC / wl are level 0's

    # forward-backward check at level 0: template from cur at new_pt,
    # iterate sampling prev, in the windows already placed
    db, _, _ = _track_level_batched(cur_pyr[0], orgC, prev_pyr[0], orgP,
                                    new_pt, -d, r, iters, wl)
    fb_err = torch.linalg.norm(db + d, dim=-1)

    I = _sample_windows(cur_pyr[0], orgC,
                        new_pt - r - orgC.to(torch.float32), m, wl)
    Tp = _sample_windows(prev_pyr[0], orgP,
                         pts - r - orgP.to(torch.float32), m, wl)
    res0 = torch.sqrt(torch.mean((I - Tp) ** 2, dim=(1, 2)))

    inb = ((new_pt[:, 0] >= r + 1) & (new_pt[:, 0] < W - r - 1)
           & (new_pt[:, 1] >= r + 1) & (new_pt[:, 1] < H - r - 1))
    ok = ok & inb & (res0 < max_residual) & (fb_err < fb_thresh) \
        & torch.isfinite(new_pt).all(dim=-1)
    return torch.where(ok[:, None], new_pt, pts), ok


# ---------------------------------------------------------------------------
# Per-feature oracle (klt.py:38-157): every patch clamps to the image itself
# ---------------------------------------------------------------------------

def _sample_patches(img: torch.Tensor, centers: torch.Tensor, radius: int,
                    margin: int = 0):
    """interp(i0, j0) -> (K, m, m) bilinear patches around `centers` (K, 2),
    from one (2r + 2 + 2 margin)^2 slice per feature whose origin slides
    inward at the border (klt.py:38-90). (i0, j0) = (margin, margin) is the
    centred patch; other offsets shift it by whole pixels."""
    H, W = img.shape
    r = radius
    n = 2 * r + 2 + 2 * margin
    m = 2 * r + 1
    x0 = torch.clamp(torch.floor(centers[:, 0]) - r - margin, 0, W - n)
    y0 = torch.clamp(torch.floor(centers[:, 1]) - r - margin, 0, H - n)
    fx = torch.clamp(centers[:, 0] - r - margin - x0, 0.0, 1.0)[:, None, None]
    fy = torch.clamp(centers[:, 1] - r - margin - y0, 0.0, 1.0)[:, None, None]
    ar = torch.arange(m, device=img.device)
    rows = (y0.long()[:, None] + ar)[:, :, None]
    cols = (x0.long()[:, None] + ar)[:, None, :]

    def interp(i0, j0):
        rr, cc = rows + i0, cols + j0
        return (img[rr, cc] * (1 - fx) * (1 - fy)
                + img[rr, cc + 1] * fx * (1 - fy)
                + img[rr + 1, cc] * (1 - fx) * fy
                + img[rr + 1, cc + 1] * fx * fy)

    return interp


def _track_level(prev_img, cur_img, pts_prev, guess, radius, iters):
    """One pyramid level of the oracle for all features (klt.py:93-117)."""
    interp = _sample_patches(prev_img, pts_prev, radius, margin=1)

    def sample_T(sx, sy):
        return interp(1 + sy, 1 + sx)

    def sample_I(d):
        return _sample_patches(cur_img, pts_prev + d, radius)(0, 0)

    return _solve_level(sample_T, sample_I, guess, iters)


def track_features_gather(prev_pyr, cur_pyr, pts: torch.Tensor,
                          valid: torch.Tensor, radius: int = 5,
                          iters: int = 8, levels: int = 3,
                          max_residual: float = 12.0,
                          fb_thresh: float = 1.0):
    """The per-feature tracker the reference keeps as its test oracle: same
    contract as `track_features`, no windows."""
    H, W = cur_pyr[0].shape
    d = torch.zeros_like(pts)
    ok = valid
    for lv in range(levels - 1, -1, -1):
        scale = 2.0 ** lv
        dl, _res, ok_l = _track_level(prev_pyr[lv], cur_pyr[lv], pts / scale,
                                      d / scale, radius, iters)
        d = dl * scale
        ok = ok & ok_l
    new_pt = pts + d

    db, _, _ = _track_level(cur_pyr[0], prev_pyr[0], new_pt, -d, radius,
                            iters)
    fb_err = torch.linalg.norm(db + d, dim=-1)

    I = _sample_patches(cur_pyr[0], new_pt, radius)(0, 0)
    Tp = _sample_patches(prev_pyr[0], pts, radius)(0, 0)
    res0 = torch.sqrt(torch.mean((I - Tp) ** 2, dim=(1, 2)))

    r = radius
    inb = ((new_pt[:, 0] >= r + 1) & (new_pt[:, 0] < W - r - 1)
           & (new_pt[:, 1] >= r + 1) & (new_pt[:, 1] < H - r - 1))
    ok = ok & inb & (res0 < max_residual) & (fb_err < fb_thresh) \
        & torch.isfinite(new_pt).all(dim=-1)
    return torch.where(ok[:, None], new_pt, pts), ok
