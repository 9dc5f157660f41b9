"""Close the VIO -> BA loop: build a BaProblem from real pipeline outputs
(port of visma_tpu/ba/from_vio.py: the same host numpy, only the problem
lands on the caller's device and the solution is read back from it).

The reference's data model is tracklets: every Packet carries per-feature
pixel observations with lifecycle status (vlslam.proto:21-36), produced by
the upstream VIO whose sliding-window filter consumed them online. Batch
bundle adjustment over the SAME observations (BASELINE config 5:
"distributed BA + pose graph, all sequences") sees the whole sequence at
once where the MSCKF saw only its clone window — so BA is the natural
trajectory-refinement stage after a VIO pass.

This module rebuilds the batch problem from what a run actually produced:

  - per-frame raw feature observations (ids, xp, valid) — either the
    feature feed's packed arrays (filter/feed.pack_frames) or the image
    frontend's tracker outputs (VioPipeline.run's obs_ids/obs_xp/obs_valid);
  - the filter's per-frame pose estimates (outs["R"], outs["p"], body
    frame) and the camera-IMU extrinsics.

Assembly is host-side numpy (it runs once per sequence; the solve is the
device part). Keyframes are a stride subsample plus the last frame; landmarks
are the ids with enough keyframe observations, initialized by linear
midpoint triangulation from the ESTIMATED camera poses — no ground truth
anywhere.

refine_trajectory() maps the solved keyframe camera poses back to body
poses and distributes the per-keyframe corrections to in-between frames by
interpolating the correction in exponential coordinates, so the full
trajectory benefits, not only the keyframes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from visma_tpu_torch.ba.problem import BaProblem, make_problem


def select_keyframes(n_frames: int, stride: int) -> np.ndarray:
    """Stride subsample that always includes frame 0 and the last frame
    (the longest baseline anchors the scale prior; ba/gauss_newton.py)."""
    kf = np.arange(0, n_frames, max(stride, 1))
    if kf[-1] != n_frames - 1:
        kf = np.append(kf, n_frames - 1)
    return kf


def _camera_poses(R: np.ndarray, p: np.ndarray, R_bc, p_bc):
    """Body world<-body (N,3,3)/(N,3) -> camera world<-camera."""
    R_bc = np.eye(3) if R_bc is None else np.asarray(R_bc, np.float64)
    p_bc = np.zeros(3) if p_bc is None else np.asarray(p_bc, np.float64)
    Rc = np.einsum("nij,jk->nik", np.asarray(R, np.float64), R_bc)
    pc = np.asarray(p, np.float64) + np.einsum(
        "nij,j->ni", np.asarray(R, np.float64), p_bc)
    return Rc, pc


def _triangulate(Rc, pc, obs, mask, intr):
    """Batched linear midpoint triangulation from estimated poses.

    Rays d_lk = Rc_k @ normalize(K^-1 [u, v, 1]); X_l solves
    sum_k (I - d d^T) (X - pc_k) = 0 (ridge-regularized). Returns
    (X (L,3), ok (L,)) with ok requiring positive depth in every
    observing view and a sane ray residual."""
    fx, fy, cx, cy = intr
    u = (obs[..., 0] - cx) / fx
    v = (obs[..., 1] - cy) / fy
    rays_c = np.stack([u, v, np.ones_like(u)], axis=-1)        # (L,K,3)
    rays_c /= np.linalg.norm(rays_c, axis=-1, keepdims=True)
    d = np.einsum("kij,lkj->lki", Rc, rays_c)                  # (L,K,3)

    m = mask[..., None, None]                                  # (L,K,1,1)
    P = (np.eye(3)[None, None] - d[..., :, None] * d[..., None, :]) * m
    A = P.sum(axis=1) + 1e-9 * np.eye(3)[None]                 # (L,3,3)
    b = np.einsum("lkij,kj->li", P, pc)                        # (L,3)
    X = np.linalg.solve(A, b[..., None])[..., 0]

    # depth in each observing camera must be positive
    diff = X[:, None, :] - pc[None, :, :]                      # (L,K,3)
    depth = np.einsum("lki,lki->lk", diff, d)
    ok = np.all((depth > 1e-3) | ~mask, axis=1)
    # conditioning: smallest eigenvalue of A measures parallax
    ok &= np.linalg.eigvalsh(A)[:, 0] > 1e-4
    return X, ok


def ba_problem_from_vio(
    obs_ids: np.ndarray, obs_xp: np.ndarray, obs_valid: np.ndarray,
    R: np.ndarray, p: np.ndarray,
    intr: Tuple[float, float, float, float],
    R_bc=None, p_bc=None, stride: int = 4, min_obs: int = 3,
    max_landmarks: int = 512, device=None,
) -> Tuple[Optional[BaProblem], Dict]:
    """Build a BaProblem from a VIO run's raw observations + pose estimates.

    obs_ids (N,F) int, obs_xp (N,F,2), obs_valid (N,F): per-frame feature
    observations (feed arrays or VioPipeline.run outputs). R (N,3,3) /
    p (N,3): the filter's body pose estimates. intr: (fx, fy, cx, cy).
    R_bc/p_bc: camera-IMU extrinsics (identity by default). device: where
    the problem lands (None means the CUDA card).

    Returns (problem, info) with info = {"kf" (K,), "ids" (L,)}; problem
    is None when fewer than 8 landmarks survive (degenerate run).
    """
    obs_ids = np.asarray(obs_ids)
    obs_xp = np.asarray(obs_xp)
    obs_valid = np.asarray(obs_valid)
    N = obs_ids.shape[0]
    kf = select_keyframes(N, stride)
    K = len(kf)

    Rc_all, pc_all = _camera_poses(R, p, R_bc, p_bc)
    Rc, pc = Rc_all[kf], pc_all[kf]

    # id -> column of (obs, mask) over keyframes
    ids_kf = np.where(obs_valid[kf], obs_ids[kf], -1)          # (K,F)
    flat = ids_kf.ravel()
    uniq, inv = np.unique(flat[flat >= 0], return_inverse=True)
    counts = np.bincount(inv, minlength=len(uniq))
    keep = counts >= min_obs
    cand = uniq[keep]
    if len(cand) > max_landmarks:
        order = np.argsort(-counts[keep], kind="stable")
        cand = cand[order[:max_landmarks]]
        cand = np.sort(cand)
    if len(cand) < 8:
        return None, {"kf": kf, "ids": cand}

    L = len(cand)
    col = {int(i): l for l, i in enumerate(cand)}
    obs = np.zeros((L, K, 2), np.float32)
    mask = np.zeros((L, K), bool)
    for k in range(K):
        row_ids = ids_kf[k]
        for f in np.nonzero(row_ids >= 0)[0]:
            l = col.get(int(row_ids[f]))
            if l is not None:
                obs[l, k] = obs_xp[kf[k], f]
                mask[l, k] = True

    X, ok = _triangulate(Rc, pc, obs, mask, intr)
    # drop landmarks that failed triangulation (masked problem rows must
    # be exact zeros per the repo convention — filter them out instead)
    if not ok.all():
        obs, mask, X, cand = obs[ok], mask[ok], X[ok], cand[ok]
    if len(cand) < 8:
        return None, {"kf": kf, "ids": cand}

    prob = make_problem(Rc, pc, X, obs, mask, *intr, device=device)
    return prob, {"kf": kf, "ids": cand}


def refine_trajectory(solved: BaProblem, info: Dict, R: np.ndarray,
                      p: np.ndarray, R_bc=None, p_bc=None):
    """Write the BA solution back over the FULL trajectory.

    solved: the optimized BaProblem (keyframe camera poses); R/p: the
    filter's body estimates for every frame. Keyframes take the BA pose
    exactly; frames between keyframes apply the interpolation (in
    exponential coordinates) of the two neighboring keyframe corrections
    T_corr = T_ba * T_est^-1 — corrections are smooth and small, so the
    first-order interpolation is accurate where BA itself is.

    Returns (R_new (N,3,3), p_new (N,3)) body poses.
    """
    from scipy.spatial.transform import Rotation

    R_bc_m = np.eye(3) if R_bc is None else np.asarray(R_bc, np.float64)
    p_bc_m = np.zeros(3) if p_bc is None else np.asarray(p_bc, np.float64)
    kf = np.asarray(info["kf"])
    R = np.asarray(R, np.float64)
    p = np.asarray(p, np.float64)
    N = R.shape[0]

    # solved camera poses -> body poses at keyframes
    Rc = solved.R.cpu().numpy().astype(np.float64)
    pc = solved.p.cpu().numpy().astype(np.float64)
    Rb_kf = np.einsum("kij,lj->kil", Rc, R_bc_m)               # Rc @ R_bc^T
    pb_kf = pc - np.einsum("kij,j->ki", Rb_kf, p_bc_m)

    # per-keyframe correction in exponential coordinates
    phi = np.zeros((len(kf), 3))
    dt = np.zeros((len(kf), 3))
    for j, k in enumerate(kf):
        R_corr = Rb_kf[j] @ R[k].T
        phi[j] = Rotation.from_matrix(R_corr).as_rotvec()
        dt[j] = pb_kf[j] - R_corr @ p[k]

    R_new = R.copy()
    p_new = p.copy()
    for t in range(N):
        j = np.searchsorted(kf, t, side="right") - 1
        if kf[j] == t or j == len(kf) - 1:
            phi_t, dt_t = phi[j], dt[j]
        else:
            w = (t - kf[j]) / float(kf[j + 1] - kf[j])
            phi_t = (1 - w) * phi[j] + w * phi[j + 1]
            dt_t = (1 - w) * dt[j] + w * dt[j + 1]
        Rc_t = Rotation.from_rotvec(phi_t).as_matrix()
        R_new[t] = Rc_t @ R[t]
        p_new[t] = Rc_t @ p[t] + dt_t
    return R_new.astype(np.float32), p_new.astype(np.float32)
