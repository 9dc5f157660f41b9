"""Iterative closest point (port of visma_tpu/align/icp.py; Open3D
RegistrationICP parity: evaluation.cpp:260-271, annotation.cpp:45-57).

Point-to-point (Umeyama inner solve) and point-to-plane (damped 6-dof
solve) variants; correspondences by brute-force nearest neighbours with a
max_distance gate; a fixed iteration count. Reports `fitness` (inlier
fraction) and `inlier_rmse` as Open3D defines them.

The reference jits the loop and scans its body over `max_iters`
(visma_tpu/align/icp.py:66-104). Here one iteration is `_icp_body`, and on
a CUDA device `icp` replays it as a captured CUDA graph
(`utils.graphs.StepGraph`: two eager iterations, one capture, then a replay
an iteration); `graph=False` is the eager loop over the same body, equal
to the graph bit for bit. The graphs live in an LRU by variant and shape
(`_RUNS`, at most `_CACHE_SIZE`), and `max_distance` enters as a 0-d
tensor, so one graph serves every threshold and every initial pose. The
body reads nothing back to the host: on the card the Umeyama rotation is
`eig3.kabsch_rotation` and the damped solve `torch.linalg.solve_ex` (the
checked `svd` and `solve` read their status back, which a capture
forbids). The PCA normals of point-to-plane (`_estimate_normals`, the
reference's jitted `lax.map`) replay a StepGraph over query chunks the
same way, with `eig3.sym3_eigh` in place of `eigh` on the card. A graph
keeps a private memory pool after the call returns (the annotate tool's
5,000 x 54,830 ICP 1,722 MB on the H100); `release_graphs()` frees them.

A padded target (a voxel grid's fixed-capacity output) is compacted to its
valid points before the loop. Padded points have an infinite distance and
are never a neighbour, and compaction keeps the valid points' order, so
every nearest neighbour, and with it the transformation, fitness, rmse and
correspondence count, is the padded run's (tests/test_torch_align.py
holds both against the reference). It keeps each of the loop's neighbour
searches from scanning the padding.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np
import torch

from visma_tpu_torch.align.eig3 import sym3_eigvecs
from visma_tpu_torch.align.nn import map_rows, nearest_neighbors, pad_chunks
from visma_tpu_torch.align.umeyama import umeyama
from visma_tpu_torch.filter.msckf import top_k_stable
from visma_tpu_torch.geom.rotations import rodrigues
from visma_tpu_torch.utils.graphs import loop_runner, steps_of
from visma_tpu_torch.utils.misc import as_f32, full_f32, resolve_device

# the loops' StepGraphs by (loop, variant, shapes). A graph keeps a private
# memory pool that holds its distance tiles: on the H100 80 MB for the
# evaluate tool's 8,192 x 812 ICP and 22 MB for its normals, 682-1,722 MB
# for the annotate tool's 5,000 x 21,676-54,830 sweeps. Two entries hold a
# point-to-plane call's normals and iterations, or one sweep's shape and
# the next's; an older shape is dropped
_RUNS: OrderedDict = OrderedDict()
_CACHE_SIZE = 2


def release_graphs() -> None:
    """Drop the cached ICP and normal graphs with their memory pools
    (`torch.cuda.empty_cache()` then returns the memory to the card)."""
    _RUNS.clear()


@dataclass
class IcpResult:
    transformation: np.ndarray  # (4,4)
    fitness: float
    inlier_rmse: float
    correspondences: int


def _normals_body(k: int, state, qc):
    """One query chunk of `_estimate_normals`: the PCA normal of each
    query's k nearest valid points. The state (points, their masked
    squared norms) comes back as it went in."""
    points, r2 = state
    q2 = torch.sum(qc * qc, dim=1)
    d2 = q2[:, None] + r2[None, :] - 2.0 * qc @ points.T
    _, idx = top_k_stable(-d2, k)
    neigh = points[idx]                           # (chunk,k,3)
    c = neigh - neigh.mean(dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", c, c)
    # the smallest eigenvalue's eigenvector
    return state, sym3_eigvecs(cov)[..., 0]


@full_f32()
def _estimate_normals(points: torch.Tensor, valid, k: int = 12,
                      chunk: int = 512,
                      graph: Optional[bool] = None) -> torch.Tensor:
    """PCA normals from the k nearest valid points (for point-to-plane),
    chunked over queries: the reference's jitted `lax.map`, a StepGraph
    over the chunks on a CUDA device (`graph=False`: the eager loop). The
    k nearest are `lax.top_k`'s: ties lowest index first (a stable sort).
    A normal's sign is arbitrary (the reference's `eigh`; here
    `eig3.sym3_eigvecs`); point-to-plane ICP does not depend on it."""
    r2 = torch.sum(points * points, dim=1)
    r2 = torch.where(valid, r2, torch.full_like(r2, float("inf")))
    rows = map_rows(chunk, points.shape[0], points.shape[0], points.device)
    run = loop_runner(_RUNS, ("normals", k, points.shape[0], rows),
                      partial(_normals_body, k), graph, points.device,
                      _CACHE_SIZE)
    _, normals = run((points, r2), pad_chunks(points, rows))
    return normals.reshape(-1, 3)[:points.shape[0]]


def _transform(T, pts):
    return pts @ T[:3, :3].T + T[:3, 3]


def _icp_body(point_to_plane: bool, state, _):
    """One ICP iteration, a step of the reference's scan
    (visma_tpu/align/icp.py:70-89). The state is (T, src, src_valid, dst,
    dst_valid, dst_normals, max_d2); all but T come back as they went in,
    so a graph reads none of the caller's tensors by address. No
    output."""
    T, src, src_valid, dst, dst_valid, dst_normals, max_d2 = state
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
        xi = torch.linalg.solve_ex(H, Jw.T @ r)[0]
        dT = torch.eye(4, dtype=T.dtype, device=T.device)
        dT[:3, :3] = rodrigues(xi[:3])
        dT[:3, 3] = xi[3:]
        T = dT @ T
    else:
        T = umeyama(cur, tgt, weights=w.to(torch.float32)) @ T
    return (T, src, src_valid, dst, dst_valid, dst_normals, max_d2), ()


@full_f32()
def _icp_core(src, src_valid, dst, dst_valid, dst_normals, T0,
              max_distance: float, max_iters: int, point_to_plane: bool,
              graph: Optional[bool] = None):
    """(T, fitness, rmse, inliers) after max_iters iterations
    (icp.py:66-104): the iterations through `loop_runner` (a StepGraph's
    replays on a CUDA device, `graph=False` the eager loop), the final
    correspondence pass after them. `max_distance ** 2` is rounded to
    float32 once, a 0-d tensor made on the device, and both the loop and
    the final pass compare with it."""
    dev = src.device
    max_d2 = torch.full((), max_distance * max_distance, dtype=torch.float32,
                        device=dev)
    state = (T0, src, src_valid, dst, dst_valid, dst_normals, max_d2)
    run = loop_runner(_RUNS, ("icp", point_to_plane, src.shape[0],
                              dst.shape[0]),
                      partial(_icp_body, point_to_plane), graph, dev,
                      _CACHE_SIZE)
    T = run(state, steps_of(max_iters, dev))[0][0] if max_iters else T0

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
        source_valid=None, target_valid=None, device=None,
        graph: Optional[bool] = None) -> IcpResult:
    """Align source onto target: (N, 3) / (M, 3) numpy arrays or tensors.
    Runs on the CUDA card unless `device` says otherwise. On a CUDA device
    the iterations (and point-to-plane's normals) replay captured graphs
    (`graph=None`); `graph=False` runs the eager loop, `graph=True` on
    the CPU the graphs' buffers without capture."""
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
    normals = (_estimate_normals(dst, dv, graph=graph) if point_to_plane
               else torch.zeros_like(dst))
    T, fit, rmse, n = _icp_core(src, sv, dst, dv, normals, T0,
                                float(max_distance), max_iters,
                                point_to_plane, graph=graph)
    return IcpResult(transformation=T.cpu().numpy(), fitness=float(fit),
                     inlier_rmse=float(rmse), correspondences=int(n))
