"""Annotation-tool alignment primitives (port of
visma_tpu/align/annotation.py; reference parity: src/annotation.cpp, the
procedure that produced the ground-truth alignment.json files).

`register_model_to_scene` tries `num_yaw` yaw hypotheses, runs ICP from
each and keeps the fit with the most correspondences (annotation.cpp:29-64),
the hypotheses looped on the host as in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from visma_tpu_torch.align.icp import IcpResult, icp
from visma_tpu_torch.align.voxel import voxel_downsample
from visma_tpu_torch.utils.misc import as_f32, resolve_device


def find_plane_normal(points: np.ndarray) -> np.ndarray:
    """PCA floor normal (reference geometry.h:18-26); numpy."""
    pts = np.asarray(points, np.float64)
    c = pts - pts.mean(axis=0)
    _, _, Vt = np.linalg.svd(c / np.sqrt(len(pts)), full_matrices=False)
    n = Vt[2]
    return n / np.linalg.norm(n)


def register_model_to_scene(model_pts: np.ndarray, scene_pts: np.ndarray,
                            num_yaw: int = 24, max_distance: float = 0.02,
                            voxel: float = 0.01,
                            point_to_plane: bool = False,
                            gravity_axis: int = 2, device=None,
                            graph: Optional[bool] = None
                            ) -> Tuple[np.ndarray, IcpResult]:
    """Center both clouds, try `num_yaw` initial yaws, ICP each, keep the
    fit with most correspondences (cfg/tool.json's operating point: voxel
    0.01, 24 yaws, 0.02 threshold). Runs on the CUDA card unless `device`
    says otherwise. Every yaw's ICP has the same shapes: on the card the
    first captures its iteration and the rest replay it (`graph`: `icp`'s).

    Returns (T_scene_model (4, 4), best IcpResult).
    """
    dev = resolve_device(device)
    scene_ds, scene_valid = voxel_downsample(as_f32(scene_pts, dev), voxel)
    scene_np = scene_ds.cpu().numpy()
    sv = scene_valid.cpu().numpy()

    model_c = model_pts.mean(axis=0)
    scene_c = (scene_np[sv]).mean(axis=0)

    best: IcpResult = None
    best_T = np.eye(4)
    ax = [i for i in range(3) if i != gravity_axis]
    for k in range(num_yaw):
        th = 2.0 * np.pi * k / num_yaw
        c, s = np.cos(th), np.sin(th)
        R = np.eye(3)
        R[ax[0], ax[0]], R[ax[0], ax[1]] = c, -s
        R[ax[1], ax[0]], R[ax[1], ax[1]] = s, c
        T0 = np.eye(4)
        T0[:3, :3] = R
        T0[:3, 3] = scene_c - R @ model_c

        res = icp(model_pts, scene_ds, max_distance, init=T0,
                  point_to_plane=point_to_plane, target_valid=scene_valid,
                  device=dev, graph=graph)
        if best is None or res.correspondences > best.correspondences:
            best, best_T = res, res.transformation
    return best_T, best
