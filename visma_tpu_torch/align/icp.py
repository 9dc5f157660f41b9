"""Iterative closest point (port of visma_tpu/align/icp.py; Open3D
RegistrationICP parity: evaluation.cpp:260-271, annotation.cpp:45-57).

Point-to-point (Umeyama inner solve) and point-to-plane (damped 6-dof
solve) variants; correspondences by brute-force nearest neighbours with a
max_distance gate; a fixed iteration count, a Python loop where the
reference scans. Reports `fitness` (inlier fraction) and `inlier_rmse` as
Open3D defines them.

A padded target (a voxel grid's fixed-capacity output) is compacted to its
valid points before the loop. Padded points have an infinite distance and
are never a neighbour, and compaction keeps the valid points' order, so
every nearest neighbour, and with it the transformation, fitness, rmse and
correspondence count, is the padded run's (tests/test_torch_align.py
holds both against the reference). It keeps each of the loop's neighbour
searches from scanning the padding.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from visma_tpu_torch.align.nn import nearest_neighbors, rows_per_chunk
from visma_tpu_torch.align.umeyama import umeyama
from visma_tpu_torch.filter.msckf import top_k_stable
from visma_tpu_torch.geom.rotations import rodrigues
from visma_tpu_torch.utils.misc import as_f32, full_f32, resolve_device


@dataclass
class IcpResult:
    transformation: np.ndarray  # (4,4)
    fitness: float
    inlier_rmse: float
    correspondences: int


@full_f32()
def _estimate_normals(points: torch.Tensor, valid, k: int = 12,
                      chunk: int = 512) -> torch.Tensor:
    """PCA normals from the k nearest valid points (for point-to-plane),
    chunked over queries. The k nearest are `lax.top_k`'s: ties lowest
    index first (a stable sort). A normal's sign is arbitrary (`eigh`);
    point-to-plane ICP does not depend on it."""
    r2 = torch.sum(points * points, dim=1)
    r2 = torch.where(valid, r2, torch.full_like(r2, float("inf")))
    out = []
    for qc in torch.split(points, rows_per_chunk(chunk, points.shape[0],
                                                 points.device)):
        q2 = torch.sum(qc * qc, dim=1)
        d2 = q2[:, None] + r2[None, :] - 2.0 * qc @ points.T
        _, idx = top_k_stable(-d2, k)
        neigh = points[idx]                       # (chunk,k,3)
        c = neigh - neigh.mean(dim=1, keepdim=True)
        cov = torch.einsum("nki,nkj->nij", c, c)
        out.append(torch.linalg.eigh(cov)[1][..., 0])   # smallest eigenvector
    return torch.cat(out)


def _transform(T, pts):
    return pts @ T[:3, :3].T + T[:3, 3]


@full_f32()
def _icp_core(src, src_valid, dst, dst_valid, dst_normals, T0,
              max_distance: float, max_iters: int, point_to_plane: bool):
    """(T, fitness, rmse, inliers) after max_iters steps (icp.py:66-104)."""
    max_d2 = max_distance * max_distance
    T = T0
    for _ in range(max_iters):
        cur = _transform(T, src)
        idx, d2 = nearest_neighbors(cur, dst, dst_valid)
        w = (d2 < max_d2) & src_valid
        tgt = dst[idx]
        if point_to_plane:
            n = dst_normals[idx]
            r = torch.sum((tgt - cur) * n, dim=1)
            J = torch.cat([torch.linalg.cross(cur, n), n], dim=1)  # (N,6)
            Jw = J * w.to(torch.float32)[:, None]
            H = Jw.T @ J
            # Levenberg damping keeps null-space directions (in-plane
            # motion on planar scenes) from exploding
            H = H + (1e-3 * torch.trace(H) / 6.0 + 1e-8) \
                * torch.eye(6, dtype=H.dtype, device=H.device)
            xi = torch.linalg.solve(H, Jw.T @ r)
            dT = torch.eye(4, dtype=T.dtype, device=T.device)
            dT[:3, :3] = rodrigues(xi[:3])
            dT[:3, 3] = xi[3:]
            T = dT @ T
        else:
            T = umeyama(cur, tgt, weights=w.to(torch.float32)) @ T

    cur = _transform(T, src)
    _, d2 = nearest_neighbors(cur, dst, dst_valid)
    inlier = (d2 < max_d2) & src_valid
    n_in = torch.sum(inlier)
    n_src = torch.clamp(torch.sum(src_valid), min=1)
    fitness = n_in / n_src
    rmse = torch.sqrt(torch.sum(torch.where(inlier, d2, torch.zeros_like(d2)))
                      / torch.clamp(n_in, min=1))
    return T, fitness, rmse, n_in


def icp(source, target, max_distance: float, init=None,
        max_iters: int = 30, point_to_plane: bool = False,
        source_valid=None, target_valid=None, device=None) -> IcpResult:
    """Align source onto target: (N, 3) / (M, 3) numpy arrays or tensors.
    Runs on the CUDA card unless `device` says otherwise."""
    dev = resolve_device(device)
    src = as_f32(source, dev)
    dst = as_f32(target, dev)
    sv = (torch.ones(src.shape[0], dtype=torch.bool, device=dev)
          if source_valid is None else torch.as_tensor(source_valid,
                                                       device=dev))
    dv = (torch.ones(dst.shape[0], dtype=torch.bool, device=dev)
          if target_valid is None else torch.as_tensor(target_valid,
                                                       device=dev))
    if bool(dv.any()) and not bool(dv.all()):
        dst, dv = dst[dv], dv[dv]
    T0 = (torch.eye(4, dtype=torch.float32, device=dev) if init is None
          else as_f32(init, dev))
    normals = (_estimate_normals(dst, dv) if point_to_plane
               else torch.zeros_like(dst))
    T, fit, rmse, n = _icp_core(src, sv, dst, dv, normals, T0,
                                float(max_distance), max_iters,
                                point_to_plane)
    return IcpResult(transformation=T.cpu().numpy(), fitness=float(fit),
                     inlier_rmse=float(rmse), correspondences=int(n))
