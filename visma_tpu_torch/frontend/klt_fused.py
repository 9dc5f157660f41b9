"""Pyramidal Lucas-Kanade with one kernel launch per tracked frame (port of
visma_tpu/frontend/klt_fused.py).

`track_features_fused` tracks K features through the pyramid. On CUDA
tensors it is one launch of `lk_track` (kernel `vt_lk_track` of
`csrc/lk_level.cu`): a thread block a feature walks the levels coarse to
fine, then the forward-backward pass and the gates. On CPU tensors it runs
`lk_track_plain`, the same schedule in PyTorch over `lk_level_plain`.

`lk_level` solves one pyramid level alone (kernel `vt_lk_level`, the port
of the TPU kernel klt_fused.py::_lk_level_kernel; on CPU tensors
`lk_level_plain`). The tracker no longer calls it; it stays as the entry
that holds the kernel's solve against the plain one level by level.

All of them read the level images directly. The reference first cuts a
win x win window per feature out of each level with one-hot matmuls
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

import ctypes

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
    _check_block("lk_level", radius, win)
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


_kernels.counted(lk_level)


_SCRATCH_FLOATS = 2 * 3 * 32    # two reduction buffers of 3 sums x 32 warps


def _check_block(name: str, radius: int, win: int) -> None:
    """One thread a template pixel, and the patch and the search window in
    shared memory: raise on a radius or window the block cannot hold."""
    m = 2 * radius + 1
    if m * m > 1024:
        raise ValueError(f"{name} kernel: radius {radius} needs more than "
                         "1024 threads per block")
    if 4 * (_SCRATCH_FLOATS + (m + 2) ** 2 + win * win) > 48 * 1024:
        raise ValueError(f"{name} kernel: window {win} with radius {radius} "
                         "needs more than 48 KB of shared memory")


def _starts(pts: torch.Tensor, r: int, org: torch.Tensor) -> torch.Tensor:
    """(2, K) (row, col) patch starts of points (K, 2) inside windows."""
    return (pts - r - org.to(torch.float32)).T.flip(0).contiguous()


MAX_LEVELS = 8


def level_windows(pyr, levels: int, radius: int, win: int):
    """Per level 0..levels-1 of a pyramid, (Hl, Wl, wl): the level's window
    wl = min(win, Hl - Hl%8 or Hl, Wl - Wl%8 or Wl), or 0 for a level too
    small to host the patch (wl < 2r+4), which the tracker skips. Level 0
    too small raises."""
    out = []
    for lv in range(levels):
        Hl, Wl = pyr[lv].shape
        wl = min(win, Hl - Hl % 8 or Hl, Wl - Wl % 8 or Wl)
        if wl < 2 * radius + 4:
            if lv == 0:
                raise ValueError(
                    f"level-0 window {wl} too small for radius {radius}")
            wl = 0
        out.append((Hl, Wl, wl))
    return out


class LkLevels(ctypes.Structure):
    """The level table `vt_lk_track` takes by value (csrc/lk_level.cu):
    per-level image pointers of the two pyramids, sizes, and the level's
    window (0 = skipped)."""
    _fields_ = [("prev", ctypes.c_void_p * MAX_LEVELS),
                ("cur", ctypes.c_void_p * MAX_LEVELS),
                ("H", ctypes.c_int * MAX_LEVELS),
                ("W", ctypes.c_int * MAX_LEVELS),
                ("wl", ctypes.c_int * MAX_LEVELS),
                ("n", ctypes.c_int)]


def pack_levels(prev_pyr, cur_pyr, levels: int, radius: int,
                win: int) -> LkLevels:
    """The level table of two pyramids (lists of contiguous float32 (Hl, Wl)
    tensors, equal shapes level by level). The table holds raw pointers:
    the pyramids must outlive the launch that reads it."""
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"lk_track: 1 to {MAX_LEVELS} levels, got {levels}")
    if len(prev_pyr) < levels or len(cur_pyr) < levels:
        raise ValueError(f"lk_track: pyramids shorter than {levels} levels")
    table = LkLevels()
    table.n = levels
    for lv, (Hl, Wl, wl) in enumerate(
            level_windows(prev_pyr, levels, radius, win)):
        p, c = prev_pyr[lv], cur_pyr[lv]
        if p.shape != c.shape or p.dtype != torch.float32 \
                or c.dtype != torch.float32 or p.device != c.device \
                or not (p.is_contiguous() and c.is_contiguous()):
            raise ValueError(
                f"lk_track: level {lv} must be two contiguous float32 "
                "images of one shape on one device")
        table.prev[lv], table.cur[lv] = p.data_ptr(), c.data_ptr()
        table.H[lv], table.W[lv], table.wl[lv] = Hl, Wl, wl
    return table


def lk_track_plain(prev_pyr, cur_pyr, pts: torch.Tensor, valid: torch.Tensor,
                   radius: int = 5, iters: int = 8, levels: int = 3,
                   max_residual: float = 12.0, fb_thresh: float = 1.0,
                   win: int = 24):
    """Plain PyTorch twin of the track kernel; see `lk_track`. One
    `lk_level_plain` a level and one for the forward-backward pass, with
    the level algebra between them in float32."""
    H, W = cur_pyr[0].shape
    r = radius
    d = torch.zeros_like(pts)
    ok = valid
    lvl0 = None
    windows = level_windows(prev_pyr, levels, r, win)
    for lv in range(levels - 1, -1, -1):
        Hl, Wl, wl = windows[lv]
        if wl == 0:
            continue  # level too small to host the patch: skip refinement
        scale = 2.0 ** lv
        pts_l = pts / scale
        est = pts_l + d / scale
        orgP = window_origin(pts_l, wl, Hl, Wl)
        orgC = window_origin(est, wl, Hl, Wl)
        u, res, ok_l = lk_level_plain(prev_pyr[lv], cur_pyr[lv], orgP, orgC,
                                      _starts(pts_l, r, orgP),
                                      _starts(est, r, orgC), wl, r, iters)
        d = (est + torch.stack([u[1], u[0]], dim=-1) - pts_l) * scale
        ok = ok & ok_l
        if lv == 0:
            lvl0 = (orgP, orgC, res, wl)
    new_pt = pts + d
    orgP0, orgC0, res0, wl0 = lvl0

    # forward-backward: template from cur at new_pt, iterate sampling prev
    v, _, _ = lk_level_plain(cur_pyr[0], prev_pyr[0], orgC0, orgP0,
                             _starts(new_pt, r, orgC0),
                             _starts(pts, r, orgP0), wl0, r, iters)
    fb_err = torch.sqrt(v[0] ** 2 + v[1] ** 2)

    inb = ((new_pt[:, 0] >= r + 1) & (new_pt[:, 0] < W - r - 1)
           & (new_pt[:, 1] >= r + 1) & (new_pt[:, 1] < H - r - 1))
    ok = ok & inb & (res0 < max_residual) & (fb_err < fb_thresh) \
        & torch.isfinite(new_pt).all(dim=-1)
    return torch.where(ok[:, None], new_pt, pts), ok


def lk_track(prev_pyr, cur_pyr, pts: torch.Tensor, valid: torch.Tensor,
             radius: int = 5, iters: int = 8, levels: int = 3,
             max_residual: float = 12.0, fb_thresh: float = 1.0,
             win: int = 24):
    """A whole tracked frame for K features: the levels coarse to fine, the
    forward-backward pass and the gates (convergence at every level,
    in-bounds, residual, forward-backward error, finiteness).

    prev_pyr / cur_pyr: pyramids, level 0 first, (Hl, Wl) f32; pts (K, 2)
    f32 (x, y); valid (K,) bool. Returns (new_pts (K, 2), ok (K,) bool);
    a feature that is not ok keeps its old position.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    once or raises.
    """
    if pts.device.type == "cpu":
        return lk_track_plain(prev_pyr, cur_pyr, pts, valid, radius, iters,
                              levels, max_residual, fb_thresh, win)
    _check_block("lk_track", radius, win)
    table = pack_levels(prev_pyr, cur_pyr, levels, radius, win)
    K = pts.shape[0]
    if pts.shape != (K, 2) or pts.dtype != torch.float32 \
            or valid.shape != (K,) or valid.dtype != torch.bool:
        raise ValueError("lk_track kernel: expected pts (K, 2) float32 and "
                         "valid (K,) bool")
    _kernels.require_cuda("lk_track", pts, valid, *prev_pyr[:levels])
    new_pts = torch.empty_like(pts)
    ok = torch.empty_like(valid)
    if K == 0:
        return new_pts, ok
    rc = _kernels.library().vt_lk_track(
        ctypes.byref(table), pts.data_ptr(), valid.data_ptr(),
        new_pts.data_ptr(), ok.data_ptr(), K, radius, iters, max_residual,
        fb_thresh, _kernels.stream_of(pts))
    _kernels.check(rc, "lk_track")
    lk_track.launches += 1
    return new_pts, ok


_kernels.counted(lk_track)


def track_features_fused(prev_pyr, cur_pyr, pts: torch.Tensor,
                         valid: torch.Tensor, radius: int = 5,
                         iters: int = 8, levels: int = 3,
                         max_residual: float = 12.0, fb_thresh: float = 1.0,
                         win: int = 24):
    """Track `pts` (K, 2) from the prev to the cur pyramid; same gates as
    the reference (klt_fused.py:202-255): convergence at every level,
    in-bounds, residual and forward-backward. Returns (new_pts, ok). One
    `lk_track` launch on CUDA tensors, `lk_track_plain` on CPU tensors."""
    return lk_track(prev_pyr, cur_pyr, pts, valid, radius, iters, levels,
                    max_residual, fb_thresh, win)
