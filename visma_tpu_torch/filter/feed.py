"""The port's own copy of visma_tpu/filter/feed.py (numpy only).

Pack a vlslam Dataset + IMU stream into fixed-shape per-frame arrays for
Msckf.run (host-side, numpy). Feature observations use the dataset's ids
and pixel coords; IMU samples between consecutive frames are right-aligned
into `imu_per_frame` slots with dt=0 padding.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from visma_tpu_torch.filter.config import FilterConfig
from visma_tpu_torch.proto import Dataset


def pack_frames(cfg: FilterConfig, dataset: Dataset,
                imu: Optional[Dict[str, np.ndarray]] = None,
                max_feats: Optional[int] = None,
                ts: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Returns {gyro (N,S,3), accel (N,S,3), dts (N,S), ids (N,F), xp
    (N,F,2), valid (N,F), ts (N,)}.

    imu=None is the vision-only path (cfg.use_imu=False): gyro/accel stay
    zero and the full inter-frame interval lands in the last dts slot, so
    sum(dts) — all propagate_cv consumes — is exact.

    ts: optional (N,) frame stamps overriding the packets' raw stamps —
    callers that normalize stamp units (VISMA packets stamp microseconds;
    IMU npz files stamp seconds) MUST pass the normalized timeline here,
    or the IMU-window selection below matches against the wrong units and
    silently selects zero samples per frame.
    """
    N = len(dataset.packets)
    S = cfg.imu_per_frame
    F = max_feats or cfg.max_tracks
    ts_frames = (np.asarray([p.ts for p in dataset.packets], np.float64)
                 if ts is None else np.asarray(ts, np.float64))
    if len(ts_frames) != N:
        raise ValueError(f"ts override has {len(ts_frames)} stamps for "
                         f"{N} packets")

    out = {
        "gyro": np.zeros((N, S, 3), np.float32),
        "accel": np.zeros((N, S, 3), np.float32),
        "dts": np.zeros((N, S), np.float32),
        "ids": np.full((N, F), -1, np.int32),
        "xp": np.zeros((N, F, 2), np.float32),
        "valid": np.zeros((N, F), bool),
        "ts": np.zeros(N, np.float64),
    }

    imu_ts = imu["ts"] if imu is not None else None
    if imu_ts is not None and N > 1:
        # stamp-unit sanity: the IMU timeline must overlap the frame
        # timeline (microsecond frames vs second IMU stamps select zero
        # samples everywhere and silently freeze propagation)
        if imu_ts[-1] <= ts_frames[0] or imu_ts[0] > ts_frames[-1]:
            raise ValueError(
                "IMU timeline does not overlap frame stamps "
                f"(imu [{imu_ts[0]:.3f}, {imu_ts[-1]:.3f}] vs frames "
                f"[{ts_frames[0]:.3f}, {ts_frames[-1]:.3f}]) — "
                "check stamp units (seconds vs microseconds)")
    prev_t = ts_frames[0]
    for i, p in enumerate(dataset.packets):
        out["ts"][i] = ts_frames[i]
        if i > 0 and imu is None:
            out["dts"][i, -1] = ts_frames[i] - prev_t
        elif i > 0:
            # epsilon guards against float drift between frame stamps
            # (k / fps) and sample stamps (k * spf * dt)
            sel = (imu_ts > prev_t + 1e-9) & (imu_ts <= ts_frames[i] + 1e-9)
            idxs = np.nonzero(sel)[0][:S]
            n = len(idxs)
            if n:
                out["gyro"][i, :n] = imu["gyro"][idxs]
                out["accel"][i, :n] = imu["accel"][idxs]
                t_edges = np.concatenate([[prev_t], imu_ts[idxs]])
                out["dts"][i, :n] = np.diff(t_edges)
        prev_t = ts_frames[i]

        feats = p.features[:F]
        for j, f in enumerate(feats):
            out["ids"][i, j] = f.id
            if len(f.xp) >= 2:
                out["xp"][i, j] = f.xp[:2]
            out["valid"][i, j] = True
    return out
