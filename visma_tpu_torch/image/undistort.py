"""Camera undistortion: ATAN (PTAM/FOV) and OpenCV radial-tangential models
(port of visma_tpu/image/undistort.py).

Reference parity: src/undistorter.cpp (UndistorterPTAM table build
:193-374, output-K solving for crop/full :216-308, UndistorterOpenCV
:467-575, format sniffing :34-80). The remap *table* is built once per
calibration on the host and then lives on the device; per-frame undistortion is one batched
bilinear gather (visma_tpu_torch.image.remap, kernel
csrc/bilinear_remap.cu).

Conventions match the reference exactly:
* calibration text files carry fx, fy, cx, cy in *relative* units
  (multiples of image size) with the LSD-SLAM -0.5 pixel-center shift;
* invalid output pixels (source falls outside the input frame) get map
  value -1 and sample to 0;
* the "rounding resistant" nudges at exact borders (undistorter.cpp:332-336)
  are reproduced, with the divergence the JAX package documents at its
  _nudge: the last line nudges iy, which the C++ clearly intended, not ix.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from visma_tpu_torch.image.remap import bilinear_remap
from visma_tpu_torch.utils.misc import resolve_device

# The hardcoded Corvis ATAN calibration used by example/undistort_images.cpp:22-28
# (fx, fy, cx, cy, s) relative; 600x960 raw -> 600x960 crop, of which the
# central 500 rows are kept (the example crops 50 px top+bottom, :51-52).
CORVIS_ATAN_CALIB = dict(
    fx=0.561859, fy=0.901540, cx=0.491896, cy=0.512629,
    s=0.709402, in_rows=600, in_cols=960, mode="crop", out_rows=600,
    out_cols=960, final_rows=500, crop_top=50,
)


@dataclass(frozen=True)
class AtanModel:
    """PTAM/FOV camera model (UndistorterPTAM).

    Relative-coordinate calibration [fx, fy, cx, cy, s]; distortion
    r_d = atan(r_u * 2 tan(s/2)) / s on the undistorted radius.
    """

    fx: float
    fy: float
    cx: float
    cy: float
    s: float
    in_rows: int
    in_cols: int

    def absolute(self) -> Tuple[float, float, float, float]:
        """Pixel-unit intrinsics with the LSD-SLAM -0.5 shift
        (undistorter.cpp:200-203)."""
        return (
            self.fx * self.in_cols,
            self.fy * self.in_rows,
            self.cx * self.in_cols - 0.5,
            self.cy * self.in_rows - 0.5,
        )

    def distort_radius_factor(self, r: torch.Tensor) -> torch.Tensor:
        """fac(r) = atan(r * 2 tan(s/2)) / (s * r), ==1 when r or s == 0
        (undistorter.cpp:326-327)."""
        if self.s == 0:
            return torch.ones_like(r)
        d2t = 2.0 * np.tan(self.s / 2.0)
        safe_r = torch.where(r == 0, torch.ones_like(r), r)
        fac = torch.arctan(safe_r * d2t) / (self.s * safe_r)
        return torch.where(r == 0, torch.ones_like(r), fac)


@dataclass(frozen=True)
class RadTanModel:
    """OpenCV radial-tangential model (UndistorterOpenCV): k1, k2, p1, p2."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float
    k2: float
    p1: float
    p2: float
    in_rows: int
    in_cols: int

    def absolute(self) -> Tuple[float, float, float, float]:
        """Relative calibrations (cx<1) scale by image size WITHOUT the
        -0.5 shift (undistorter.cpp:525-539); absolute ones pass through."""
        if self.cx < 1.0:
            return (self.fx * self.in_cols, self.fy * self.in_rows,
                    self.cx * self.in_cols, self.cy * self.in_rows)
        return (self.fx, self.fy, self.cx, self.cy)

    def distort_normalized(self, x, y):
        r2 = x * x + y * y
        radial = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
        xd = x * radial + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        yd = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return xd, yd


def _solve_output_K_atan(model: AtanModel, mode: str, out_rows: int,
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


def _build_remap_atan(model: AtanModel, ofx, ofy, ocx, ocy, out_rows: int,
                      out_cols: int) -> np.ndarray:
    fx, fy, cx, cy = model.absolute()
    d2t = 2.0 * np.tan(model.s / 2.0)
    return _remap_grid_atan(fx, fy, cx, cy, ofx, ofy, ocx, ocy, d2t, model.s,
                            out_rows, out_cols, model.in_cols, model.in_rows)


def _build_remap_radtan(model: RadTanModel, mode: str, out_rows: int,
                        out_cols: int):
    """OpenCV-model table: getOptimalNewCameraMatrix + inverse-distortion map
    (undistorter.cpp:548-558). Uses cv2 host-side (table build is one-time)."""
    import cv2

    fx, fy, cx, cy = model.absolute()
    K_in = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    dist = np.array([model.k1, model.k2, model.p1, model.p2], np.float32)
    alpha = 1 if mode == "full" else 0
    K_new, _ = cv2.getOptimalNewCameraMatrix(
        K_in, dist, (model.in_cols, model.in_rows), alpha,
        (out_cols, out_rows), centerPrincipalPoint=False)
    mapx, mapy = cv2.initUndistortRectifyMap(
        K_in, dist, None, K_new, (out_cols, out_rows), cv2.CV_32FC1)
    invalid = ((mapx < 0) | (mapy < 0) | (mapx > model.in_cols - 1)
               | (mapy > model.in_rows - 1))
    mapx = np.where(invalid, -1.0, mapx)
    mapy = np.where(invalid, -1.0, mapy)
    return K_new, np.stack([mapx, mapy], axis=-1).astype(np.float32)


class Undistorter:
    """Remap-table undistorter; per-frame work is one device gather.

    Mirrors the reference Undistorter class family: `K` is the output
    intrinsics (absolute pixels, numpy float64), `remap` the
    (out_h, out_w, 2) float32 source coordinate table on `device` with -1
    marking invalid pixels. device: None means the CUDA card (raises
    without one); pass "cpu" to run on the CPU.
    """

    def __init__(self, model, mode: str = "crop",
                 out_rows: Optional[int] = None,
                 out_cols: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.in_rows, self.in_cols = model.in_rows, model.in_cols
        self.out_rows = out_rows or model.in_rows
        self.out_cols = out_cols or model.in_cols
        self.mode = mode

        if isinstance(model, AtanModel):
            ofx, ofy, ocx, ocy = (
                _solve_output_K_atan(model, mode, self.out_rows, self.out_cols)
                if mode in ("crop", "full")
                else model.absolute()
            )
            self.K = np.array(
                [[ofx, 0, ocx], [0, ofy, ocy], [0, 0, 1]], np.float64)
            table = _build_remap_atan(model, ofx, ofy, ocx, ocy,
                                      self.out_rows, self.out_cols)
        elif isinstance(model, RadTanModel):
            self.K, table = _build_remap_radtan(
                model, mode, self.out_rows, self.out_cols)
        else:
            raise TypeError(type(model))
        self.remap = torch.as_tensor(table, device=self.device)

    @classmethod
    def from_table(cls, model, mode: str, out_rows: int, out_cols: int, K,
                   remap, device=None) -> "Undistorter":
        """An undistorter around a table that was built elsewhere (for
        example the JAX package's, through `convert`)."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.model = model
        self.in_rows, self.in_cols = model.in_rows, model.in_cols
        self.out_rows, self.out_cols, self.mode = out_rows, out_cols, mode
        self.K = np.array(K, np.float64)
        self.remap = torch.as_tensor(np.array(remap, np.float32),
                                     device=self.device)
        return self

    def __call__(self, image) -> torch.Tensor:
        """Undistort one image or a batch (leading dims allowed): one
        `bilinear_remap` through the table."""
        return bilinear_remap(torch.as_tensor(image, device=self.device),
                              self.remap)


def undistorter_from_file(path: str, device=None) -> Undistorter:
    """Calibration-file factory with format sniffing: 8 floats on line 1 ->
    OpenCV model, else ATAN (undistorter.cpp:34-80). File layout:
    line1 calib, line2 'in_w in_h', line3 mode, line4 'out_w out_h'."""
    with open(path) as fp:
        lines = [fp.readline().strip() for _ in range(4)]
    vals = lines[0].split()
    in_w, in_h = (int(v) for v in lines[1].split()[:2])
    mode = lines[2]
    out_w, out_h = (int(v) for v in lines[3].split()[:2])
    if len(vals) >= 8:
        m = RadTanModel(*[float(v) for v in vals[:8]], in_rows=in_h,
                        in_cols=in_w)
    else:
        m = AtanModel(*[float(v) for v in vals[:5]], in_rows=in_h,
                      in_cols=in_w)
    return Undistorter(m, mode=mode, out_rows=out_h, out_cols=out_w,
                       device=device)


def corvis_undistorter(device=None) -> Undistorter:
    """The hardcoded Corvis rig undistorter (example/undistort_images.cpp)."""
    c = CORVIS_ATAN_CALIB
    m = AtanModel(c["fx"], c["fy"], c["cx"], c["cy"], c["s"],
                  in_rows=c["in_rows"], in_cols=c["in_cols"])
    return Undistorter(m, mode=c["mode"], out_rows=c["out_rows"],
                       out_cols=c["out_cols"], device=device)
