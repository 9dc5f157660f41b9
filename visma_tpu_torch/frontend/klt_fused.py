"""Pyramidal Lucas-Kanade with one kernel launch per level (port of
visma_tpu/frontend/klt_fused.py).

`lk_level` solves one pyramid level of inverse-compositional LK for all K
features. On CUDA tensors it launches the hand-written kernel
`csrc/lk_level.cu` (the port of the TPU kernel klt_fused.py::_lk_level_kernel),
one launch per call; on CPU tensors it runs `lk_level_plain`.

Both read the level images directly. The reference first cuts a win x win
window per feature out of each level with one-hot matmuls
(`_extract_windows_klast`, a TPU gather workaround) and samples it with hat
taps; inside the window hat taps are two-tap bilinear, so the port keeps the
window semantics without the copy:
  * a window's origin is clip(floor(c) - win//2, 0, dim - win) (:81-82);
  * a level's window is wl = min(win, Hl - Hl%8 or Hl, Wl - Wl%8 or Wl)
    (:222), and a level with wl < 2r+4 is skipped (:223-227);
  * the template start is clamped to [1, win-m-1] (:135-136) and the sample
    start to [0, win-m-1e-4] (:150-155), in window coordinates.
The tracker takes these fused semantics with win = 24, the TPU's setting,
unless it is asked for the windowed tracker (frontend/klt.py, win 40).
"""
from __future__ import annotations

import torch

from visma_tpu_torch import _kernels


def window_origin(centers: torch.Tensor, win: int, H: int, W: int):
    """(K, 2) int32 (x0, y0) origins of win x win windows around (K, 2)
    centres (klt_fused.py:81-82)."""
    x0 = torch.clamp(torch.floor(centers[:, 0]).to(torch.int32) - win // 2,
                     0, W - win)
    y0 = torch.clamp(torch.floor(centers[:, 1]).to(torch.int32) - win // 2,
                     0, H - win)
    return torch.stack([x0, y0], dim=-1)


def _taps(s: torch.Tensor):
    """First tap and the two hat weights of a start s (K,)."""
    n = torch.floor(s)
    w0 = torch.clamp(1.0 - torch.abs(s - n), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(s - (n + 1.0)), min=0.0)
    return n.to(torch.int64), w0, w1


def _sample_patch(img, org, sy, sx, win: int, size: int):
    """(K, size, size) bilinear patches starting at window-local (sy, sx)
    inside the windows at `org`: rows first, then columns, weights from the
    start (the reference's hat taps); zero-weight taps are clamped to the
    window's last row / column."""
    ny, wy0, wy1 = _taps(sy)
    nx, wx0, wx1 = _taps(sx)
    ar = torch.arange(size, device=img.device)
    iy = ny[:, None] + ar
    ix = nx[:, None] + ar
    oy = org[:, 1].to(torch.int64)[:, None]
    ox = org[:, 0].to(torch.int64)[:, None]
    r0 = (oy + torch.clamp(iy, max=win - 1))[:, :, None]
    r1 = (oy + torch.clamp(iy + 1, max=win - 1))[:, :, None]
    c0 = (ox + torch.clamp(ix, max=win - 1))[:, None, :]
    c1 = (ox + torch.clamp(ix + 1, max=win - 1))[:, None, :]
    wy0, wy1 = wy0[:, None, None], wy1[:, None, None]
    v0 = wy0 * img[r0, c0] + wy1 * img[r1, c0]
    v1 = wy0 * img[r0, c1] + wy1 * img[r1, c1]
    return wx0[:, None, None] * v0 + wx1[:, None, None] * v1


def lk_level_plain(imgT, imgI, orgT, orgI, stT, sI0, win: int,
                   radius: int = 5, iters: int = 8):
    """Plain PyTorch twin of the LK level kernel; see `lk_level`."""
    m = 2 * radius + 1
    ty = torch.clamp(stT[0], 1.0, win - m - 1.0)
    tx = torch.clamp(stT[1], 1.0, win - m - 1.0)
    Tp = _sample_patch(imgT, orgT, ty - 1.0, tx - 1.0, win, m + 2)
    T = Tp[:, 1:1 + m, 1:1 + m]
    Tx = 0.5 * (Tp[:, 1:1 + m, 2:2 + m] - Tp[:, 1:1 + m, 0:m])
    Ty = 0.5 * (Tp[:, 2:2 + m, 1:1 + m] - Tp[:, 0:m, 1:1 + m])

    Gxx = torch.sum(Tx * Tx, dim=(1, 2))
    Gxy = torch.sum(Tx * Ty, dim=(1, 2))
    Gyy = torch.sum(Ty * Ty, dim=(1, 2))
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
        bx = torch.sum(Tx * e, dim=(1, 2))
        by = torch.sum(Ty * e, dim=(1, 2))
        dx = inv_det * (Gyy * bx - Gxy * by)
        dy = inv_det * (-Gxy * bx + Gxx * by)
        uy, ux = uy - dy, ux - dx

    I = _sample_patch(imgI, orgI, torch.clamp(s0y + uy, 0.0, lim),
                      torch.clamp(s0x + ux, 0.0, lim), win, m)
    res = torch.sqrt(torch.mean((I - T) ** 2, dim=(1, 2)))
    return torch.stack([uy, ux]), res, ok


def lk_level(imgT, imgI, orgT, orgI, stT, sI0, win: int, radius: int = 5,
             iters: int = 8):
    """One LK level for K features.

    imgT / imgI (H, W) f32: the level image the templates / samples come
    from. orgT / orgI (K, 2) int32: (x0, y0) window origins. stT (2, K):
    template start (row, col) inside the template window; sI0 (2, K):
    sample start inside the search window for u = 0.
    Returns (u (2, K) = (uy, ux), res (K,), ok (K,) bool).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    once or raises.
    """
    if win < 2 * radius + 4:
        raise ValueError(f"window {win} too small for radius {radius}: need "
                         f"win >= 2*radius+4 = {2 * radius + 4}")
    if imgT.device.type == "cpu":
        return lk_level_plain(imgT, imgI, orgT, orgI, stT, sI0, win, radius,
                              iters)
    if (2 * radius + 1) ** 2 > 1024:
        raise ValueError(f"lk_level kernel: radius {radius} needs more than "
                         "1024 threads per block")
    if imgT.shape != imgI.shape or imgT.dtype != torch.float32 \
            or imgI.dtype != torch.float32:
        raise ValueError("lk_level kernel: imgT and imgI must be float32 of "
                         "one shape")
    orgT = orgT.to(torch.int32).contiguous()
    orgI = orgI.to(torch.int32).contiguous()
    stT = stT.to(torch.float32).contiguous()
    sI0 = sI0.to(torch.float32).contiguous()
    imgT, imgI = imgT.contiguous(), imgI.contiguous()
    _kernels.require_cuda("lk_level", imgT, imgI, orgT, orgI, stT, sI0)
    K = orgT.shape[0]
    if orgI.shape != (K, 2) or stT.shape != (2, K) or sI0.shape != (2, K):
        raise ValueError("lk_level kernel: expected orgT/orgI (K, 2) and "
                         "stT/sI0 (2, K)")
    u = torch.empty((2, K), dtype=torch.float32, device=imgT.device)
    stat = torch.empty((2, K), dtype=torch.float32, device=imgT.device)
    if K == 0:
        return u, stat[0], stat[1] > 0.5
    lib = _kernels.library()
    rc = lib.vt_lk_level(imgT.data_ptr(), imgI.data_ptr(), imgT.shape[0],
                         imgT.shape[1],
                         orgT.data_ptr(), orgI.data_ptr(), stT.data_ptr(),
                         sI0.data_ptr(), u.data_ptr(), stat.data_ptr(), K,
                         win, radius, iters, _kernels.stream_of(imgT))
    _kernels.check(rc, "lk_level")
    lk_level.launches += 1
    return u, stat[0], stat[1] > 0.5


lk_level.launches = 0


def _starts(pts: torch.Tensor, r: int, org: torch.Tensor) -> torch.Tensor:
    """(2, K) (row, col) patch starts of points (K, 2) inside windows."""
    return (pts - r - org.to(torch.float32)).T.flip(0).contiguous()


def track_features_fused(prev_pyr, cur_pyr, pts: torch.Tensor,
                         valid: torch.Tensor, radius: int = 5,
                         iters: int = 8, levels: int = 3,
                         max_residual: float = 12.0, fb_thresh: float = 1.0,
                         win: int = 24):
    """Track `pts` (K, 2) from the prev to the cur pyramid; same gates as
    the reference (klt_fused.py:202-255): convergence at every level,
    in-bounds, residual and forward-backward. Returns (new_pts, ok)."""
    H, W = cur_pyr[0].shape
    r = radius
    d = torch.zeros_like(pts)
    ok = valid
    lvl0 = None
    for lv in range(levels - 1, -1, -1):
        scale = 2.0 ** lv
        Hl, Wl = prev_pyr[lv].shape
        wl = min(win, Hl - Hl % 8 or Hl, Wl - Wl % 8 or Wl)
        if wl < 2 * r + 4:
            if lv == 0:
                raise ValueError(
                    f"level-0 window {wl} too small for radius {r}")
            continue  # level too small to host the patch: skip refinement
        pts_l = pts / scale
        est = pts_l + d / scale
        orgP = window_origin(pts_l, wl, Hl, Wl)
        orgC = window_origin(est, wl, Hl, Wl)
        u, res, ok_l = lk_level(prev_pyr[lv], cur_pyr[lv], orgP, orgC,
                                _starts(pts_l, r, orgP), _starts(est, r, orgC),
                                wl, r, iters)
        d = (est + torch.stack([u[1], u[0]], dim=-1) - pts_l) * scale
        ok = ok & ok_l
        if lv == 0:
            lvl0 = (orgP, orgC, res, wl)
    new_pt = pts + d
    orgP0, orgC0, res0, wl0 = lvl0

    # forward-backward: template from cur at new_pt, iterate sampling prev
    v, _, _ = lk_level(cur_pyr[0], prev_pyr[0], orgC0, orgP0,
                       _starts(new_pt, r, orgC0), _starts(pts, r, orgP0),
                       wl0, r, iters)
    fb_err = torch.sqrt(v[0] ** 2 + v[1] ** 2)

    inb = ((new_pt[:, 0] >= r + 1) & (new_pt[:, 0] < W - r - 1)
           & (new_pt[:, 1] >= r + 1) & (new_pt[:, 1] < H - r - 1))
    ok = ok & inb & (res0 < max_residual) & (fb_err < fb_thresh) \
        & torch.isfinite(new_pt).all(dim=-1)
    return torch.where(ok[:, None], new_pt, pts), ok
