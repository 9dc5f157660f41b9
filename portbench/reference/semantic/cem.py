"""One settled frame of the semantic mapper, plainly: the fused CEM of
every object from the frame's start poses.

Frozen copies, at 43be5d3, of visma_tpu_torch/semantic/cem.py
(`cem_n_elite`, `_sigma6`, `_roi_origins`, `_crop`, `_others_index`,
`_raster_score_grouped`, `_render_score_nS`, `_draw`, `_cem_fused_body`),
of visma_tpu_torch/semantic/mapper.py (`_aabb_corners`, `_compose_dg`, the
footprint test of `SemanticMapper._footprints_may_overlap`) and of
visma_tpu_torch/render/likelihood.py's `occlusion_aware_edge_score`, over
the reference's rasterizer and edge score. Profiler ranges left out. Part
of the benchmark's plain reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from portbench.reference.semantic.lie import SE3
from portbench.reference.semantic.raster import render_roi
from portbench.reference.semantic.score import (edge_distance_transform,
                                                edge_score_plain)

CEM_TAU = 10.0
CEM_ELITE_FRAC = 0.25


def cem_n_elite(samples: int, elite_frac: float = CEM_ELITE_FRAC) -> int:
    return max(2, int(samples * elite_frac))


def _sigma6(init_sigma, n: int) -> np.ndarray:
    """(rot, trans) sigmas -> (n, 6) tangent sigmas [trans x3, rot x3]."""
    return np.tile(np.concatenate([np.full(3, init_sigma[1]),
                                   np.full(3, init_sigma[0])]
                                  ).astype(np.float32), (n, 1))


def _roi_origins(t_cm: torch.Tensor, intr, roi) -> torch.Tensor:
    """Window top-left (x0, y0) per object: centered on the projected
    object origin (rounded half to even), clipped inside the image. t_cm
    (n,3) camera-frame object centers; returns (n,2) float32 with integral
    values."""
    z = torch.clamp(t_cm[:, 2], min=1e-3)
    u = intr.fx * t_cm[:, 0] / z + intr.cx
    v = intr.fy * t_cm[:, 1] / z + intr.cy
    ox = torch.clamp(torch.round(u - roi[1] / 2), 0, intr.cols - roi[1])
    oy = torch.clamp(torch.round(v - roi[0] / 2), 0, intr.rows - roi[0])
    return torch.stack([ox, oy], dim=1).to(torch.float32)


def _crop(img: torch.Tensor, origins: torch.Tensor, roi) -> torch.Tensor:
    """Windows of (roi[0], roi[1]) at global top-lefts origins (n,2) =
    (x0, y0), gathered on the device (no value is read back): img (H,W)
    gives every window from the one image, img (n,H,W) window i from
    image i. Returns (n, roi[0], roi[1])."""
    dev = img.device
    org = origins.to(torch.long)
    rows = org[:, 1, None] + torch.arange(roi[0], device=dev)      # (n,Hr)
    cols = org[:, 0, None] + torch.arange(roi[1], device=dev)      # (n,Wr)
    if img.dim() == 2:
        return img[rows[:, :, None], cols[:, None, :]]
    idx = torch.arange(img.shape[0], device=dev)[:, None, None]
    return img[idx, rows[:, :, None], cols[:, None, :]]


def _others_index(n: int, device) -> torch.Tensor:
    """For each of n objects the indices of the other n-1, flattened to
    n*(n-1), on the device (cached: building it copies from the host)."""
    return torch.as_tensor(
        np.array([[j for j in range(n) if j != i] for i in range(n)]),
        device=device).reshape(-1)


def _raster_score_grouped(Cs, mesh_idx, flat, org, occ_w, dt_w, obs_w,
                          obs_mass, intr, roi, tau, n, S, radius: int = 2):
    """ROI raster + score over n*S hypotheses: all windows of the
    iteration in one launch, then one batched score per object against its
    own occluder / dt / evidence windows. Returns (n, S) scores."""
    mi_all = torch.repeat_interleave(mesh_idx, S)
    d = render_roi(Cs, flat, mi_all, org, intr, roi)
    return occlusion_aware_edge_score(
            d.reshape(n, S, roi[0], roi[1]), occ_w, dt_w, obs_w, tau=tau,
            obs_mass=obs_mass, radius=radius)


def _render_score_nS(Cs, mesh_idx, mean_R, mean_t, xi, occ, dt, obs, intr,
                     tau, roi=None, origins=None, occ_poses=None, radius=2):
    """Render + score all (n, S) hypotheses of n objects. Returns
    (hyp34 (n,S,3,4), scores (n,S)).

    Cs: face corners of the padded mesh stack; mesh_idx (n,); mean_R
    (n,3,3), mean_t (n,3); xi (n,S,6) tangent perturbations
    (RIGHT-multiplied); occ (n,H,W) per-track occluder depth or None for
    no occluders; dt/obs (H,W).

    roi (Hr,Wr) + origins (n,2): render and score each object's hypotheses
    inside a fixed-size screen window instead of the full frame. Exact for
    footprints inside the window (chamfer mass lives on rendered pixels;
    the coverage denominator stays the global edge mass).

    occ_poses (n,3,4), ROI path only: instead of cropping a precomputed
    full-frame occluder z-buffer, render each track's occluders (the other
    n-1 objects at these frame-start poses) directly into its window:
    n*(n-1) window renders in one launch. Identical values: a windowed
    render equals the full-frame render cropped at the same origin."""
    n, S = xi.shape[:2]
    hyp = SE3(mean_R[:, None], mean_t[:, None]) @ SE3.exp(xi)      # (n,S)
    poses = hyp.matrix3x4()
    flat = poses.reshape(n * S, 3, 4)
    if roi is None:
        raise ValueError("the reference renders the settled windows only")
    org = torch.repeat_interleave(origins, S, dim=0)               # (n*S, 2)
    obs_mass = torch.sum(obs)
    dt_w = _crop(dt, origins, roi)
    obs_w = _crop(obs, origins, roi)
    if occ_poses is not None and n > 1:
        oi = _others_index(n, xi.device)                           # n*(n-1)
        od = render_roi(Cs, occ_poses[oi], mesh_idx[oi],
                        torch.repeat_interleave(origins, n - 1, dim=0), intr,
                        roi)
        occ_w = od.reshape(n, n - 1, roi[0], roi[1]).amin(dim=1)
    elif occ is not None:
        occ_w = _crop(occ, origins, roi)
    else:
        occ_w = None
    scores = _raster_score_grouped(Cs, mesh_idx, flat, org, occ_w, dt_w,
                                   obs_w, obs_mass, intr, roi, tau, n, S,
                                   radius=radius)
    return poses, scores


def _draw(generator, shape, device) -> torch.Tensor:
    """Standard-normal draws of the fused body, from the generator."""
    return torch.randn(shape, dtype=torch.float32, device=device,
                       generator=generator)


def _cem_fused_body(Cs, mesh_idx, R0, t0, sig0, occ, obs, generator, intr,
                    tau, iters, samples, n_elite, roi=None, occ_poses=None,
                    radius=2, noise=None):
    """The whole batched CEM on the device: sampling, render, score, elite
    refit and best-pose tracking, `iters` iterations with no host read.
    roi: optional (Hr, Wr) screen window per object, recentered on the
    current mean's projected center every iteration. noise: optional
    (iters, n, samples, 6) standard-normal draws used instead of the
    generator. Returns (best_pose (n,3,4), best_score (n,))."""
    n = R0.shape[0]
    dev = R0.device
    # sweeps sized to the truncation: chamfer takes min(dt, tau), so any
    # pixel farther than the propagation radius reads as big -> tau
    dt = edge_distance_transform(obs, iters=int(tau) + 6)
    idx = torch.arange(n, device=dev)

    mean_R, mean_t, sig = R0, t0, sig0
    best_pose = torch.cat([R0, t0[:, :, None]], dim=2)
    best_score = torch.full((n,), float("inf"), dtype=torch.float32,
                            device=dev)
    for it in range(iters):
        # plain normal sampling, not antithetic pairs: antithetic elites
        # cancel in the mean refit and stall the CEM
        z = (_draw(generator, (n, samples, 6), dev) if noise is None
             else noise[it])
        xi = z * sig[:, None, :]
        xi[:, 0] = 0.0  # always include the current mean
        # ...and the best-so-far pose, expressed in the current mean's
        # tangent: re-anchors the search when the mean wanders and makes
        # the best score monotone by construction
        mean = SE3(mean_R, mean_t)
        xi[:, 1] = (mean.inv() @ SE3.from_matrix3x4(best_pose)).log()
        origins = None if roi is None else _roi_origins(mean_t, intr, roi)
        hyp34, scores = _render_score_nS(
            Cs, mesh_idx, mean_R, mean_t, xi, occ, dt, obs, intr, tau,
            roi=roi, origins=origins, occ_poses=occ_poses, radius=radius)
        order = torch.argsort(scores, dim=1, stable=True)
        top = order[:, 0]
        top_score = scores[idx, top]
        better = top_score < best_score
        best_pose = torch.where(better[:, None, None], hyp34[idx, top],
                                best_pose)
        best_score = torch.minimum(best_score, top_score)

        elite = xi[idx[:, None], order[:, :n_elite]]               # (n,E,6)
        sig = elite.std(dim=1, unbiased=False) * 1.1 + 1e-4
        step = mean @ SE3.exp(elite.mean(dim=1))
        mean_R, mean_t = step.R, step.t
    return best_pose, best_score


def occlusion_aware_edge_score(rendered_depth: torch.Tensor,
                               occluder_depth: Optional[torch.Tensor],
                               dt: torch.Tensor,
                               observed_edges: torch.Tensor,
                               tau: float = 10.0, radius: int = 2,
                               coverage_weight: float = 5.0,
                               obs_mass: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Score pose hypotheses of objects in a multi-object scene.

    rendered_depth (..., B, H, W): hypothesis depth renders of an object;
    occluder_depth (..., H, W): joint z-buffer of all other objects at
    their current poses (+inf where none; None for no occluders at all,
    which scores the same as an all-inf buffer); dt, observed_edges
    (..., H, W), or (H, W) for every object.
    The leading dimensions, when present, index objects. Edges are taken
    on the composited min-depth, so the occluding contour between an
    object and its occluders is rendered where the real depth
    discontinuity is; edges attributable only to the occluders (constant
    across hypotheses) are subtracted, so they neither add chamfer mass
    nor fake coverage. obs_mass None: each object's own evidence mass.
    One `edge_score` call for all objects."""
    lead = rendered_depth.shape[:-3]
    B, H, W = rendered_depth.shape[-3:]

    def objects(t):
        return t if t.dim() == 2 else t.reshape(-1, H, W)

    scores = edge_score_plain(
        rendered_depth.reshape(-1, B, H, W),
        None if occluder_depth is None
        else occluder_depth.reshape(-1, H, W),
        objects(dt), objects(observed_edges), tau=tau, radius=radius,
        coverage_weight=coverage_weight, obs_mass=obs_mass)
    return scores.reshape(*lead, B)


def _aabb_corners(lo, hi) -> np.ndarray:
    return np.array([[x, y, z] for x in (lo[0], hi[0])
                     for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])


def _compose_dg(dG34: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """pose_cm' = dG @ pose_cm for a (n,3,4) stack; dG34 (3,4) is the
    relative camera transform G'_cw @ G (float32 products, TF32 off)."""
    Rp = torch.einsum("ij,njk->nik", dG34[:, :3], poses[:, :, :3])
    tp = torch.einsum("ij,nj->ni", dG34[:, :3], poses[:, :, 3]) + dG34[:, 3]
    return torch.cat([Rp, tp[:, :, None]], dim=2)


def footprints_may_overlap(intr, aabbs, poses_cm: np.ndarray, names,
                           sigma) -> bool:
    """`SemanticMapper._footprints_may_overlap` with the mapper's camera
    and model AABBs passed in."""
    s_rot, s_trans = sigma
    rects = []
    for pose, name in zip(poses_cm, names):
        lo, hi = aabbs.get(
            name, (np.full(3, -1.0), np.full(3, 1.0)))
        half_diag = 0.5 * float(np.linalg.norm(np.asarray(hi) - lo))
        margin = 3.0 * (s_trans + s_rot * half_diag)
        pc = _aabb_corners(lo, hi) @ np.asarray(pose[:3, :3]).T \
            + pose[:3, 3]
        z = pc[:, 2]
        if np.any(z <= 0.1):
            return True          # degenerate: be conservative
        u = intr.fx * pc[:, 0] / z + intr.cx
        v = intr.fy * pc[:, 1] / z + intr.cy
        mpx = max(intr.fx, intr.fy) * margin / float(z.min())
        rects.append((u.min() - mpx, u.max() + mpx,
                      v.min() - mpx, v.max() + mpx))
    for i in range(len(rects)):
        for j in range(i + 1, len(rects)):
            a, b = rects[i], rects[j]
            if a[0] <= b[1] and b[0] <= a[1] \
                    and a[2] <= b[3] and b[2] <= a[3]:
                return True
    return False
