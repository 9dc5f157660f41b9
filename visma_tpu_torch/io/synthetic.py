"""Synthetic VISMA-format sequence generator.

Produces wire-compatible `dataset` / `*.edge` / `*.bbox` / `*.png` files
from a known smooth trajectory, plus the raw IMU measurements the upstream
VIO consumed (not part of the vlslam format; returned separately). This is
the test/benchmark substrate: golden-file tests decode what we encode, and
the MSCKF filter must recover the generating trajectory (SURVEY.md §4).

Trajectory model: camera orbits the scene on a smooth closed curve with
look-at orientation; landmarks are uniform in a box; feature tracks follow
the proto lifecycle INITIALIZING -> READY -> INSTATE -> GOODDROP/REJECT
(vlslam.proto:11-19).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from visma_tpu_torch.proto import (
    BoundingBox, BoundingBoxList, CameraInfo, Dataset, EdgeMap, Feature,
    FeatureStatus, Packet,
)


@dataclass
class SyntheticConfig:
    num_frames: int = 60
    num_landmarks: int = 200
    rows: int = 480
    cols: int = 640
    fx: float = 400.0
    fy: float = 400.0
    cx: float = 320.0
    cy: float = 240.0
    radius: float = 2.5
    height: float = 1.2
    angular_rate: float = 0.35  # rad/s of the orbit
    chirp: float = 0.0          # rad/s^2: orbit rate grows linearly in t,
                                # breaking the constant-rate orbit's
                                # time-shift symmetry (needed to make the
                                # camera-IMU time offset observable)
    fps: float = 30.0
    imu_rate: float = 200.0
    pixel_noise: float = 0.0
    gravity: float = 9.81
    seed: int = 0


def _look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Camera-to-world rotation with +z forward (CV convention)."""
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)  # columns are camera axes in world


def make_trajectory(cfg: SyntheticConfig, t_shift: float = 0.0):
    """Returns (ts (N,), gwc (N,3,4) float64) camera-to-world poses.

    t_shift samples the poses at ts + t_shift while keeping the returned
    stamps at ts — i.e. a camera whose stamps lag its true capture time by
    t_shift (camera-IMU time offset simulation)."""
    ts = np.arange(cfg.num_frames) / cfg.fps
    tt = ts + t_shift
    th = cfg.angular_rate * tt + 0.5 * cfg.chirp * tt * tt
    eye = np.stack(
        [cfg.radius * np.cos(th), cfg.radius * np.sin(th),
         cfg.height + 0.1 * np.sin(2.3 * th)], axis=1)
    target = np.zeros(3)
    up = np.array([0.0, 0.0, 1.0])
    gwc = np.zeros((cfg.num_frames, 3, 4))
    for i in range(cfg.num_frames):
        R = _look_at(eye[i], target, up)
        gwc[i, :, :3] = R
        gwc[i, :, 3] = eye[i]
    return ts, gwc


def make_landmarks(cfg: SyntheticConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed)
    pts = rng.uniform(-1.0, 1.0, size=(cfg.num_landmarks, 3))
    pts[:, 2] = rng.uniform(0.0, 2.0, size=cfg.num_landmarks)
    return pts


def project(gwc: np.ndarray, X: np.ndarray, cfg: SyntheticConfig):
    """Project world points into frame with pose gwc (3,4).

    Returns (xp (M,2), depth (M,), valid (M,) bool)."""
    R, t = gwc[:, :3], gwc[:, 3]
    Xc = (X - t) @ R  # R^T @ (X - t) rowwise
    z = Xc[:, 2]
    valid = z > 0.1
    zs = np.where(valid, z, 1.0)
    u = cfg.fx * Xc[:, 0] / zs + cfg.cx
    v = cfg.fy * Xc[:, 1] / zs + cfg.cy
    valid &= (u >= 0) & (u < cfg.cols) & (v >= 0) & (v < cfg.rows)
    return np.stack([u, v], axis=1), z, valid


def imu_from_poses(Rs: np.ndarray, pos: np.ndarray, dt: float,
                   gravity: float = 9.81, v0: np.ndarray = None):
    """Discrete-consistent IMU synthesis from an arbitrary pose sequence.

    Measurement j covers (t_j, t_{j+1}] so that the filter's exact discrete
    integrator reproduces (Rs, pos) sample-for-sample. Returns
    {gyro (S-1,3), accel (S-1,3), v0 (3,)}.
    """
    from scipy.spatial.transform import Rotation

    S = len(Rs)
    if v0 is None:
        v0 = (pos[1] - pos[0]) / dt
    g_world = np.array([0.0, 0.0, -gravity])
    gyro = np.zeros((S - 1, 3))
    accel = np.zeros((S - 1, 3))
    v = np.asarray(v0, np.float64).copy()
    for i in range(S - 1):
        gyro[i] = Rotation.from_matrix(Rs[i].T @ Rs[i + 1]).as_rotvec() / dt
        a_w = 2.0 * (pos[i + 1] - pos[i] - v * dt) / (dt * dt)
        accel[i] = Rs[i].T @ (a_w - g_world)
        v = v + a_w * dt
    return {"gyro": gyro, "accel": accel, "v0": np.asarray(v0, np.float64)}


def make_imu(cfg: SyntheticConfig,
             accel_noise: float = 0.0, gyro_noise: float = 0.0,
             accel_bias: float = 0.0, gyro_bias: float = 0.0,
             samples_per_frame: int = 8):
    """Synthesize body-frame IMU samples along the trajectory.

    Discrete-consistent construction: the samples are defined so that the
    filter's exact discrete integrator
        R' = R expm(hat(w dt));  v' = v + (R a + g) dt;
        p' = p + v dt + 0.5 (R a + g) dt^2
    reproduces the closed-form trajectory *exactly* (up to float roundoff)
    at every sample, and samples are aligned with frame times
    (dt = 1 / (fps * samples_per_frame)). This makes the synthetic world a
    clean oracle: with zero injected noise, the only filter errors are its
    own numerics.

    Returns {ts (S,), gyro (S,3), accel (S,3), R (S,3,3), pos (S,3),
    v0 (3,), samples_per_frame}.
    """
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(cfg.seed + 1)
    spf = samples_per_frame
    dt = 1.0 / (cfg.fps * spf)
    S = (cfg.num_frames - 1) * spf + 1
    ts = np.arange(S) * dt
    th = cfg.angular_rate * ts + 0.5 * cfg.chirp * ts * ts

    r, w = cfg.radius, cfg.angular_rate
    pos = np.stack([r * np.cos(th), r * np.sin(th),
                    cfg.height + 0.1 * np.sin(2.3 * th)], axis=1)
    vel0 = np.array([-r * w * np.sin(0.0), r * w * np.cos(0.0),
                     0.1 * 2.3 * w * np.cos(0.0)])

    Rs = np.zeros((S, 3, 3))
    up = np.array([0.0, 0.0, 1.0])
    for i in range(S):
        Rs[i] = _look_at(pos[i], np.zeros(3), up)

    # gyro: R_{k+1} = R_k expm(hat(w_k dt)) exactly
    gyro = np.zeros((S, 3))
    for i in range(S - 1):
        gyro[i] = Rotation.from_matrix(Rs[i].T @ Rs[i + 1]).as_rotvec() / dt
    gyro[-1] = gyro[-2]

    # accel: world acceleration consistent with the discrete position
    # recursion given v_k; a_w[k] = 2 (p_{k+1} - p_k - v_k dt) / dt^2
    g_world = np.array([0.0, 0.0, -cfg.gravity])
    accel = np.zeros((S, 3))
    v = vel0.copy()
    for i in range(S - 1):
        a_w = 2.0 * (pos[i + 1] - pos[i] - v * dt) / (dt * dt)
        accel[i] = Rs[i].T @ (a_w - g_world)
        v = v + a_w * dt
    accel[-1] = accel[-2]

    gyro += gyro_bias + gyro_noise * rng.standard_normal(gyro.shape)
    accel += accel_bias + accel_noise * rng.standard_normal(accel.shape)

    # measurement j covers the interval (ts[j], ts[j+1]] and is stamped at
    # the interval END, matching the filter feed convention (pack_frames
    # selects stamps in (t_prev_frame, t_frame]).
    return {"ts": ts[1:], "gyro": gyro[:-1], "accel": accel[:-1],
            "ts_state": ts, "R": Rs, "pos": pos,
            "v0": vel0, "samples_per_frame": spf}


def make_dataset(cfg: SyntheticConfig, t_shift: float = 0.0) -> Dataset:
    """Build the vlslam Dataset message with lifecycle-correct features.

    t_shift: observations/poses taken at ts + t_shift but stamped ts
    (see make_trajectory) — the camera-IMU time-offset test fixture."""
    rng = np.random.default_rng(cfg.seed + 2)
    ts, gwc = make_trajectory(cfg, t_shift)
    X = make_landmarks(cfg)
    first_seen = np.full(cfg.num_landmarks, -1, np.int64)

    packets = []
    for i in range(cfg.num_frames):
        xp, depth, valid = project(gwc[i], X, cfg)
        if cfg.pixel_noise > 0:
            xp = xp + cfg.pixel_noise * rng.standard_normal(xp.shape)
        feats = []
        for j in np.nonzero(valid)[0]:
            if first_seen[j] < 0:
                first_seen[j] = i
            age = i - first_seen[j]
            if age == 0:
                status = FeatureStatus.INITIALIZING
            elif age == 1:
                status = FeatureStatus.READY
            else:
                status = FeatureStatus.INSTATE
            feats.append(Feature(id=int(j), status=status, xp=xp[j],
                                 xw=X[j]))
        packets.append(Packet(
            ts=float(ts[i]),
            gwc=gwc[i].reshape(-1),
            features=feats,
            # wg: gravity alignment — identity-ish wobble for realism
            wg=np.array([0.001 * np.sin(i * 0.1), 0.001 * np.cos(i * 0.1)]),
        ))

    cam = CameraInfo(rows=cfg.rows, cols=cfg.cols,
                     parameters=np.array([cfg.fx, cfg.fy, cfg.cx, cfg.cy]))
    return Dataset(description="visma_tpu synthetic sequence",
                   camera=cam, packets=packets)


def write_sequence(dataroot: str, cfg: Optional[SyntheticConfig] = None,
                   write_images: bool = False,
                   write_edges: bool = True,
                   write_bboxes: bool = True) -> Dataset:
    """Write a full VISMA-layout sequence directory."""
    cfg = cfg or SyntheticConfig()
    os.makedirs(dataroot, exist_ok=True)
    ds = make_dataset(cfg)
    with open(os.path.join(dataroot, "dataset"), "wb") as fp:
        fp.write(ds.encode())

    rng = np.random.default_rng(cfg.seed + 3)
    for i, p in enumerate(ds.packets):
        stamp = f"{1520535100000000 + int(round(p.ts * 1e6)):d}"
        if write_edges:
            edge = np.zeros((cfg.rows // 4, cfg.cols // 4), np.float32)
            for f in p.features[:32]:
                u, v = int(f.xp[0] / 4), int(f.xp[1] / 4)
                if 0 <= v < edge.shape[0] and 0 <= u < edge.shape[1]:
                    edge[v, u] = 1.0
            em = EdgeMap(rows=edge.shape[0], cols=edge.shape[1],
                         data=edge.ravel())
            with open(os.path.join(dataroot, stamp + ".edge"), "wb") as fp:
                fp.write(em.encode())
        if write_bboxes:
            bl = BoundingBoxList(bounding_boxes=[
                BoundingBox(top_left_x=float(rng.uniform(0, cfg.cols / 2)),
                            top_left_y=float(rng.uniform(0, cfg.rows / 2)),
                            bottom_right_x=float(rng.uniform(cfg.cols / 2, cfg.cols)),
                            bottom_right_y=float(rng.uniform(cfg.rows / 2, cfg.rows)),
                            scores=np.array([0.9], np.float32),
                            class_name="chair", shape_id="chair_0001")])
            with open(os.path.join(dataroot, stamp + ".bbox"), "wb") as fp:
                fp.write(bl.encode())
        if write_images:
            import cv2

            img = rng.integers(0, 255, (cfg.rows, cfg.cols, 3), np.uint8)
            for f in p.features:
                cv2.circle(img, (int(f.xp[0]), int(f.xp[1])), 2,
                           (255, 255, 255), -1)
            cv2.imwrite(os.path.join(dataroot, stamp + ".png"), img)
    return ds
