# Frozen copy, at 43be5d3, of the ATAN table build of
# visma_tpu_torch/image/undistort.py (`_solve_output_K_atan`, `_nudge`,
# `_remap_grid_atan`) and of `bilinear_remap_plain` with its helpers from
# visma_tpu_torch/image/remap.py. Part of the benchmark's plain reference:
# it works the undistortion table out again from the calibration.
"""Corvis ATAN undistortion: the output camera, the remap table and the
bilinear gather through it."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def absolute(calib: dict) -> Tuple[float, float, float, float]:
    """Pixel-unit intrinsics of a relative ATAN calibration with the
    LSD-SLAM -0.5 shift (undistorter.cpp:200-203)."""
    return (calib["fx"] * calib["in_cols"], calib["fy"] * calib["in_rows"],
            calib["cx"] * calib["in_cols"] - 0.5,
            calib["cy"] * calib["in_rows"] - 0.5)


class _Model:
    """The attributes `_solve_output_K_atan` reads from the port's
    AtanModel."""

    def __init__(self, calib: dict):
        self.fx, self.fy = calib["fx"], calib["fy"]
        self.cx, self.cy, self.s = calib["cx"], calib["cy"], calib["s"]
        self.in_rows, self.in_cols = calib["in_rows"], calib["in_cols"]
        self._abs = absolute(calib)

    def absolute(self):
        return self._abs


def _solve_output_K_atan(model: _Model, mode: str, out_rows: int,
                         out_cols: int) -> Tuple[float, float, float, float]:
    """Reference crop/full output-K solving (undistorter.cpp:216-308), in
    float64 on the host."""
    fx, fy, cx, cy = model.absolute()
    dist = model.s
    in_w, in_h = model.in_cols, model.in_rows
    out_w, out_h = out_cols, out_rows
    d2t = 2.0 * np.tan(dist / 2.0)

    if dist == 0:
        ofx = model.fx * out_w
        ofy = model.fy * out_h
        ocx = model.cx * out_w - 0.5
        ocy = model.cy * out_h - 0.5
    elif mode == "crop":
        left_r = cx / fx
        right_r = (in_w - 1 - cx) / fx
        top_r = cy / fy
        bottom_r = (in_h - 1 - cy) / fy
        tl, tr = np.tan(left_r * dist) / d2t, np.tan(right_r * dist) / d2t
        tt, tb = np.tan(top_r * dist) / d2t, np.tan(bottom_r * dist) / d2t
        ofy = fy * ((top_r + bottom_r) / (tt + tb)) * (out_h / in_h)
        ocy = (tt / top_r) * ofy * cy / fy
        ofx = fx * ((left_r + right_r) / (tl + tr)) * (out_w / in_w)
        ocx = (tl / left_r) * ofx * cx / fx
    elif mode == "full":
        left_r = cx / fx
        right_r = (in_w - 1 - cx) / fx
        top_r = cy / fy
        bottom_r = (in_h - 1 - cy) / fy
        tl_r = np.hypot(left_r, top_r)
        tr_r = np.hypot(right_r, top_r)
        bl_r = np.hypot(left_r, bottom_r)
        br_r = np.hypot(right_r, bottom_r)
        t_tl = np.tan(tl_r * dist) / d2t
        t_tr = np.tan(tr_r * dist) / d2t
        t_bl = np.tan(bl_r * dist) / d2t
        t_br = np.tan(br_r * dist) / d2t
        hor = max(br_r, tr_r) + max(bl_r, tl_r)
        vert = max(tr_r, tl_r) + max(bl_r, br_r)
        t_hor = max(t_br, t_tr) + max(t_bl, t_tl)
        t_vert = max(t_tr, t_tl) + max(t_bl, t_br)
        ofy = fy * (vert / t_vert) * (out_h / in_h)
        ocy = max(t_tl / tl_r, t_tr / tr_r) * ofy * cy / fy
        ofx = fx * (hor / t_hor) * (out_w / in_w)
        ocx = max(t_bl / bl_r, t_tl / tl_r) * ofx * cx / fx
    else:
        raise ValueError(f"unknown mode {mode}")
    return float(ofx), float(ofy), float(ocx), float(ocy)


def _nudge(ix: np.ndarray, iy: np.ndarray, in_w: int, in_h: int):
    """'Rounding resistant' border nudges (undistorter.cpp:332-336).

    The C++ last line `if (iy == in_height-1) ix = ...` writes ix where iy
    was clearly intended; like the JAX package this nudges iy.
    """
    f32 = np.float32
    ix = np.where(ix == 0, f32(0.01), ix)
    iy = np.where(iy == 0, f32(0.01), iy)
    ix = np.where(ix == in_w - 1, f32(in_w - 1.01), ix)
    iy = np.where(iy == in_h - 1, f32(in_h - 1.01), iy)
    return ix, iy


def _remap_grid_atan(fx_abs, fy_abs, cx_abs, cy_abs, ofx, ofy, ocx, ocy,
                     d2t, s, out_rows, out_cols, in_w, in_h) -> np.ndarray:
    """(out_rows, out_cols, 2) float32 table of source (x, y), -1 where the
    source falls outside the input frame. Built once per calibration on the
    host; every scalar and every step is float32, as the reference's jitted
    function computes it."""
    f32 = np.float32
    fx_abs, fy_abs, cx_abs, cy_abs, ofx, ofy, ocx, ocy, d2t, s = (
        f32(v) for v in (fx_abs, fy_abs, cx_abs, cy_abs, ofx, ofy, ocx, ocy,
                         d2t, s))
    y = np.arange(out_rows, dtype=f32)[:, None]
    x = np.arange(out_cols, dtype=f32)[None, :]
    ix = np.broadcast_to((x - ocx) / ofx, (out_rows, out_cols))
    iy = np.broadcast_to((y - ocy) / ofy, (out_rows, out_cols))
    r = np.sqrt(ix * ix + iy * iy)
    safe_r = np.where(r == 0, f32(1.0), r)
    if s == 0:
        fac = np.ones_like(r)
    else:
        fac = np.where(r == 0, f32(1.0),
                       np.arctan(safe_r * d2t) / (s * safe_r))
    sx = fx_abs * fac * ix + cx_abs
    sy = fy_abs * fac * iy + cy_abs
    sx, sy = _nudge(sx, sy, in_w, in_h)
    valid = (sx > 0) & (sy > 0) & (sx < in_w - 1) & (sy < in_h - 1)
    return np.stack([np.where(valid, sx, f32(-1.0)),
                     np.where(valid, sy, f32(-1.0))], axis=-1)


def corvis_table(calib: dict):
    """(K (3, 3) float64 of the undistorted output camera, table (out_rows,
    out_cols, 2) float32 of source (x, y), -1 where invalid), built on the
    host as the reference builds it (undistorter.cpp:193-374)."""
    model = _Model(calib)
    ofx, ofy, ocx, ocy = _solve_output_K_atan(
        model, calib["mode"], calib["out_rows"], calib["out_cols"])
    fx, fy, cx, cy = model.absolute()
    d2t = 2.0 * np.tan(model.s / 2.0)
    table = _remap_grid_atan(fx, fy, cx, cy, ofx, ofy, ocx, ocy, d2t,
                             model.s, calib["out_rows"], calib["out_cols"],
                             model.in_cols, model.in_rows)
    K = np.array([[ofx, 0, ocx], [0, ofy, ocy], [0, 0, 1]], np.float64)
    return K, table


def _layout(image: torch.Tensor, remap: torch.Tensor):
    """(lead, H, W, C, chan): the batch shape, the frame size, the channel
    count and whether `image` has a channel axis."""
    if remap.dim() != 3 or remap.shape[-1] != 2:
        raise ValueError(f"remap table must be (oh, ow, 2), got "
                         f"{tuple(remap.shape)}")
    chan = image.dim() >= 3 and image.shape[-1] in (1, 2, 3, 4)
    if image.dim() < (3 if chan else 2):
        raise ValueError(f"image must be (..., H, W) or (..., H, W, C), got "
                         f"{tuple(image.shape)}")
    if chan:
        *lead, H, W, C = image.shape
    else:
        *lead, H, W = image.shape
        C = 1
    if H < 2 or W < 2:
        raise ValueError(f"bilinear_remap needs a frame of at least 2x2, "
                         f"got {H}x{W}")
    return tuple(lead), H, W, C, chan


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def _taps(remap: torch.Tensor, H: int, W: int):
    """(x0, y0, valid, fx, fy): the clamped top-left tap of every table
    entry and its fractions, in the kernel's float32 arithmetic."""
    remap = remap.to(torch.float32)
    sx, sy = remap[..., 0], remap[..., 1]
    x0f = torch.clamp(torch.nan_to_num(torch.floor(sx), nan=0.0), 0, W - 2)
    y0f = torch.clamp(torch.nan_to_num(torch.floor(sy), nan=0.0), 0, H - 2)
    return (x0f, y0f, sx >= 0, torch.clamp(sx - x0f, 0.0, 1.0),
            torch.clamp(sy - y0f, 0.0, 1.0))


def bilinear_remap_plain(image: torch.Tensor,
                         remap: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the remap kernel: see the module docstring."""
    lead, H, W, C, chan = _layout(image, remap)
    oh, ow = remap.shape[:2]
    x0f, y0f, valid, fx, fy = _taps(remap, H, W)
    fx, fy = fx[..., None], fy[..., None]
    fxy = fx * fy

    flat = image.to(torch.float32).reshape(-1, H * W, C)
    base = (y0f.long() * W + x0f.long()).reshape(-1)

    def tap(offset):
        return flat[:, base + offset].reshape(-1, oh, ow, C)

    p00, p01, p10, p11 = tap(0), tap(1), tap(W), tap(W + 1)
    # reference weights in the reference's order (remap.py:49-54)
    out = (fxy * p11 + (fy - fxy) * p10 + (fx - fxy) * p01
           + (1.0 - fx - fy + fxy) * p00)
    out = torch.where(valid[..., None], out, torch.zeros_like(out))
    if _is_integer(image.dtype):
        out = torch.clamp(torch.round(out), 0, 255)  # round: half to even
    out = out.to(image.dtype)
    return out.reshape(*lead, oh, ow, C) if chan else out.reshape(*lead, oh,
                                                                 ow)
