"""BA problem container: fixed-shape masked observation tables (port of
visma_tpu/ba/problem.py)."""
from __future__ import annotations

from dataclasses import dataclass, replace as _replace

import numpy as np
import torch

from visma_tpu_torch.filter.state import register_pytree
from visma_tpu_torch.utils.misc import as_f32, resolve_device


@dataclass(frozen=True)
class BaProblem:
    """Poses: world<-camera (R (K,3,3), p (K,3)); landmarks X (L,3);
    observations obs (L,K,2) pixels with mask (L,K) bool; intrinsics
    (fx,fy,cx,cy) as a (4,) tensor. Pose 0 is gauge-fixed. All float32 on
    one device. A pytree node (its fields in this order), so that a
    captured solver's buffers (`utils.graphs`) hold it."""

    R: torch.Tensor
    p: torch.Tensor
    X: torch.Tensor
    obs: torch.Tensor
    mask: torch.Tensor
    intr: torch.Tensor

    @property
    def num_poses(self):
        return self.R.shape[0]

    @property
    def num_landmarks(self):
        return self.X.shape[0]

    def replace(self, **kw) -> "BaProblem":
        return _replace(self, **kw)


register_pytree(BaProblem)


def make_problem(R, p, X, obs, mask, fx, fy, cx, cy,
                 device=None) -> BaProblem:
    """A BaProblem from arrays (numpy or tensors) on `device` (None means
    the CUDA card, as every entry point of the port)."""
    dev = resolve_device(device)
    return BaProblem(
        R=as_f32(R, dev), p=as_f32(p, dev), X=as_f32(X, dev),
        obs=as_f32(obs, dev),
        mask=torch.as_tensor(mask, dtype=torch.bool, device=dev),
        intr=torch.tensor([float(v) for v in (fx, fy, cx, cy)],
                          dtype=torch.float32, device=dev))


def synthetic_ba_problem(num_poses=8, num_landmarks=64, noise_px=1.0,
                         pose_noise=0.02, seed=0, device=None):
    """Perturbed synthetic problem + ground truth for tests/benches. The
    arrays are made with numpy exactly as the reference makes them, so the
    problem is the reference's bit for bit."""
    from visma_tpu_torch.io.synthetic import SyntheticConfig, \
        make_landmarks, make_trajectory, project

    cfg = SyntheticConfig(num_frames=num_poses, num_landmarks=num_landmarks,
                          seed=seed)
    _, gwc = make_trajectory(cfg)
    X = make_landmarks(cfg)
    rng = np.random.default_rng(seed + 1)

    obs = np.zeros((num_landmarks, num_poses, 2), np.float32)
    mask = np.zeros((num_landmarks, num_poses), bool)
    for k in range(num_poses):
        xp, _, valid = project(gwc[k], X, cfg)
        obs[:, k] = xp + noise_px * rng.standard_normal((num_landmarks, 2))
        mask[:, k] = valid

    R_noisy = gwc[:, :, :3].copy()
    p_noisy = gwc[:, :, 3].copy()
    from scipy.spatial.transform import Rotation

    for k in range(1, num_poses):  # pose 0 = gauge
        R_noisy[k] = R_noisy[k] @ Rotation.from_rotvec(
            rng.normal(scale=pose_noise, size=3)).as_matrix()
        p_noisy[k] += rng.normal(scale=pose_noise, size=3)
    X_noisy = X + rng.normal(scale=pose_noise, size=X.shape)

    prob = make_problem(R_noisy, p_noisy, X_noisy, obs, mask,
                        cfg.fx, cfg.fy, cfg.cx, cfg.cy, device=device)
    truth = {"R": gwc[:, :, :3], "p": gwc[:, :, 3], "X": X}
    return prob, truth
