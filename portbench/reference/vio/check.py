"""The plain reference's readings of a VIO run.

Everything here is worked out again from what the benchmark made (the raw
frames, the calibration, the IMU, the first pose, the feeds); the program's
outputs are read only to be judged:

* `undistort`: the Corvis table from the calibration and the bilinear
  gather through its rows, the program's K6 stage;
* `tracker_gaps`: the tracker's step for every frame at once, each from the
  state (ids, pixels) the program handed back for the frame before, and
  the first frame's detections (K1's picks, K2's tracks);
* `filter_run` and `pose_gaps`: the MSCKF frame by frame over the
  observations the program handed back (or the recorded feed), against the
  program's trajectory.

`control_run` is the control: the same reference a precision below the
configuration's float32, put in the program's place: the filter's matrix
products in TF32 (`filter_run(..., precision="control")`), the frontend's
elementwise arithmetic in bfloat16 (it has no matrix product for TF32 to
touch).
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from portbench.reference.vio import frontend
from portbench.reference.vio.config import FilterConfig
from portbench.reference.vio.msckf import _frame_step
from portbench.reference.vio.state import init_state
from portbench.reference.vio.undistort import (bilinear_remap_plain,
                                               corvis_table)


@contextlib.contextmanager
def matmul_precision(precision: str):
    """TF32 matrix products inside the block for the control, float32
    (TF32 off) otherwise."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    on = precision == "control"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def undistort(raw: torch.Tensor, calib: dict) -> torch.Tensor:
    """(N, final_rows, cols) uint8: the raw frames through the rows the
    configuration keeps of the Corvis table."""
    _, table = corvis_table(calib)
    top = calib["crop_top"]
    sliced = torch.as_tensor(table[top:top + calib["final_rows"]],
                             device=raw.device)
    return bilinear_remap_plain(raw, sliced)


def cropped_camera(calib: dict) -> np.ndarray:
    """K (3, 3) of the undistorted frame after the crop."""
    K, _ = corvis_table(calib)
    K = K.copy()
    K[1, 2] -= calib["crop_top"]
    return K


def filter_config(fcfg: dict, K: np.ndarray, cls=FilterConfig):
    return cls(window=fcfg["window"], max_tracks=fcfg["max_tracks"],
               max_updates=fcfg["max_updates"], fx=float(K[0, 0]),
               fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
               pixel_noise=fcfg["pixel_noise"])


def _next_ids(init_ids, obs_ids, K: int):
    """The tracker's next free id before each step: one past the largest
    id handed out so far (ids are handed out in order from K)."""
    seen = torch.cat([init_ids[None], obs_ids[:-1]]).to(torch.int64)
    top = torch.cummax(seen.amax(dim=1), dim=0).values + 1
    return torch.clamp(top, min=K).to(torch.int32)


def tracker_gaps(images: torch.Tensor, init_ids, init_pos, obs_ids, obs_xp,
                 front: dict, chunk: int = 40) -> Dict[str, float]:
    """images (N, H, W) float32: the reference's undistorted frames.
    init_ids / init_pos: the tracker's state after the first frame; obs_ids
    (N-1, K), obs_xp (N-1, K, 2): after each later frame, as handed back.
    Returns {"track_id_mismatch": slots whose id differs from the
    reference's step, over all frames and the first frame's detections,
    "track_px_gap": the largest pixel gap of a live slot both agree on}."""
    K, cell, levels = front["max_tracks"], front["cell"], front["levels"]
    N = images.shape[0]
    ids0, pos0, _ = frontend.tracker_init(images[:1], K, cell)
    mismatch = int((ids0[0] != init_ids).sum())
    live = (ids0[0] >= 0) & (ids0[0] == init_ids)
    gap = float((pos0[0] - init_pos).abs().amax(-1)[live].max()) \
        if bool(live.any()) else 0.0
    prev_ids = torch.cat([init_ids[None], obs_ids[:-1]])
    prev_pos = torch.cat([init_pos[None], obs_xp[:-1]])
    nxt = _next_ids(init_ids, obs_ids, K)
    for a in range(0, N - 1, chunk):
        b = min(a + chunk, N - 1)
        pyr = frontend.build_pyramid(images[a:b + 1], levels)
        ids, pos, _ = frontend.tracker_step(
            [p[:-1] for p in pyr], [p[1:] for p in pyr], prev_ids[a:b],
            prev_pos[a:b], nxt[a:b], cell, levels)
        mismatch += int((ids != obs_ids[a:b]).sum())
        same = (ids >= 0) & (ids == obs_ids[a:b])
        if bool(same.any()):
            d = (pos - obs_xp[a:b]).abs().amax(-1)[same]
            gap = max(gap, float(d.max()))
    return {"track_id_mismatch": float(mismatch), "track_px_gap": gap}


def filter_run(cfg, R0, p0, v0, frames: Dict[str, torch.Tensor],
               precision: str = "float32"):
    """The MSCKF frame by frame over frames {gyro, accel, dts, ids, xp,
    valid} (leading axis: frames). Returns (p (n, 3), R (n, 3, 3))."""
    dev = frames["ids"].device
    with matmul_precision(precision):
        state = init_state(cfg, R0=R0, p0=p0, v0=v0, device=dev)
        ps, Rs = [], []
        for t in range(frames["ids"].shape[0]):
            state = _frame_step(cfg, state, {k: v[t]
                                             for k, v in frames.items()})
            ps.append(state.p)
            Rs.append(state.R)
    return torch.stack(ps), torch.stack(Rs)


def pose_gaps(p, R, p_ref, R_ref) -> Dict[str, float]:
    """{"pos_gap_m": largest position gap, "rot_gap_rad": largest angle of
    R^T R_ref} over the frames; a non-finite pose reads inf."""
    p, R = p.to(p_ref.device, torch.float64), R.to(p_ref.device,
                                                    torch.float64)
    dp = torch.linalg.vector_norm(p - p_ref.double(), dim=-1)
    M = R.transpose(-1, -2) @ R_ref.double()
    c = (M.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    w = torch.stack([M[..., 2, 1] - M[..., 1, 2], M[..., 0, 2] - M[..., 2, 0],
                     M[..., 1, 0] - M[..., 0, 1]], dim=-1) / 2.0
    ang = torch.atan2(torch.linalg.vector_norm(w, dim=-1), c)
    bad = ~(torch.isfinite(dp) & torch.isfinite(ang))
    if bool(bad.any()):
        return {"pos_gap_m": float("inf"), "rot_gap_rad": float("inf")}
    return {"pos_gap_m": float(dp.max()), "rot_gap_rad": float(ang.max())}


def ate(p, p_true) -> float:
    """RMSE of the positions (n, 3) against the truth, in metres."""
    d = np.asarray(p, np.float64) - np.asarray(p_true, np.float64)
    e = float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))
    return e if np.isfinite(e) else float("inf")


def control_run(images: torch.Tensor, cfg, front: dict, R0, p0, v0,
                imu: Dict[str, torch.Tensor]):
    """The reference in the program's place, a precision below: the
    tracker sequentially in bfloat16, the filter with TF32 products.
    Returns what the program would hand back: (init_ids, init_pos, obs_ids,
    obs_xp, obs_valid, p, R)."""
    K, cell, levels = front["max_tracks"], front["cell"], front["levels"]
    x = images.to(torch.bfloat16)
    ids, pos, nxt = frontend.tracker_init(x[:1], K, cell)
    init_ids, init_pos = ids[0], pos[0].float()
    prev = frontend.build_pyramid(x[:1], levels)
    out_ids, out_pos = [], []
    for t in range(1, x.shape[0]):
        cur = frontend.build_pyramid(x[t:t + 1], levels)
        ids, pos, nxt = frontend.tracker_step(prev, cur, ids, pos, nxt, cell,
                                              levels)
        out_ids.append(ids[0])
        out_pos.append(pos[0].float())
        prev = cur
    obs_ids, obs_xp = torch.stack(out_ids), torch.stack(out_pos)
    frames = dict(imu, ids=obs_ids, xp=obs_xp, valid=obs_ids >= 0)
    p, R = filter_run(cfg, R0, p0, v0, frames, precision="control")
    return init_ids, init_pos, obs_ids, obs_xp, obs_ids >= 0, p, R
