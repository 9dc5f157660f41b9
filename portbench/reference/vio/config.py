# Frozen copy of visma_tpu_torch/filter/config.py at 43be5d3; imports point into
# portbench.reference.vio. Part of the benchmark's plain reference.
"""Filter configuration: a copy of visma_tpu/filter/config.py.

The reference's `visma_tpu.filter` package imports jax, so the port carries
its own copy of the dataclass. Field names, defaults and derived indices
are the reference's; `has_extrinsics` compares without numpy.
"""
from __future__ import annotations

from dataclasses import dataclass


def _close(a: float, b: float) -> bool:
    # numpy.allclose's default rule: |a - b| <= atol + rtol * |b|
    return abs(a - b) <= 1e-8 + 1e-5 * abs(b)


@dataclass(frozen=True)
class FilterConfig:
    # capacities (static shapes)
    window: int = 10          # M camera pose clones
    max_tracks: int = 64      # K feature slots
    max_updates: int = 32     # features consumed per update step
    imu_per_frame: int = 8    # max IMU samples between consecutive frames

    # camera
    fx: float = 400.0
    fy: float = 400.0
    cx: float = 320.0
    cy: float = 240.0

    # IMU noise (continuous-time densities)
    gyro_noise: float = 1.2e-3      # rad/s/sqrt(Hz)
    accel_noise: float = 8e-3       # m/s^2/sqrt(Hz)
    gyro_bias_walk: float = 1e-5
    accel_bias_walk: float = 1e-4

    # measurement noise (pixels)
    pixel_noise: float = 1.0

    # priors (stddev)
    init_att_std: float = 1e-3
    init_pos_std: float = 1e-6
    init_vel_std: float = 1e-2
    init_bg_std: float = 1e-3
    init_ba_std: float = 1e-2

    gravity: float = 9.81

    # vision-only fallback: constant-velocity / constant-attitude process
    # model instead of IMU mechanization
    use_imu: bool = True
    cv_rot_noise: float = 0.05   # rad/sqrt(s) attitude random walk
    cv_vel_noise: float = 0.5    # m/s/sqrt(s) velocity random walk

    # camera-IMU extrinsics T_bc (camera frame expressed in body frame)
    cam_R_bc: tuple = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
    cam_p_bc: tuple = (0.0, 0.0, 0.0)

    @property
    def has_extrinsics(self) -> bool:
        eye = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
        same_R = all(_close(a, b) for ra, rb in zip(self.cam_R_bc, eye)
                     for a, b in zip(ra, rb))
        same_p = all(_close(a, 0.0) for a in self.cam_p_bc)
        return not (same_R and same_p)

    # online calibration error states (extrinsics: 6, time offset: 1)
    estimate_extrinsics: bool = False
    estimate_td: bool = False
    init_ext_att_std: float = 0.03   # rad
    init_ext_pos_std: float = 0.03   # m
    init_td_std: float = 0.02        # s
    td0: float = 0.0                 # initial time-offset estimate (s)

    # update gating
    min_track_obs: int = 3
    max_reproj_error: float = 30.0  # px, triangulation sanity gate
    min_depth: float = 0.05
    max_depth: float = 50.0

    # hybrid MSCKF + SLAM landmarks (filter/slam.py)
    num_slam: int = 0
    schmidt: bool = False
    max_promote: int = 2
    slam_max_missed: int = 10
    slam_chi2_scale: float = 8.0
    slam_min_r1: float = 1e-3

    @property
    def dim(self) -> int:
        """Error-state dimension: 15 IMU + 6 per clone + calibration
        + 3 per SLAM landmark slot."""
        return (15 + 6 * self.window + 6 * self.estimate_extrinsics
                + 1 * self.estimate_td + 3 * self.num_slam)

    @property
    def ext_idx(self) -> int:
        """First column of the extrinsics error block."""
        return 15 + 6 * self.window

    @property
    def td_idx(self) -> int:
        """Column of the time-offset error."""
        return 15 + 6 * self.window + 6 * self.estimate_extrinsics

    @property
    def slam_idx(self) -> int:
        """First column of the SLAM landmark block."""
        return (15 + 6 * self.window + 6 * self.estimate_extrinsics
                + 1 * self.estimate_td)
