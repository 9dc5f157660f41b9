"""Scene assembly from per-object meshes + poses (reference parity:
src/visualization.cpp:25-224 AssembleScene/AssembleResult/AssembleGroundTruth).
A copy of visma_tpu/eval/assembly.py, numpy only: the reference's `eval`
package imports jax."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def assemble_scene(models: Dict[int, dict],
                   alignment: Optional[np.ndarray] = None,
                   scene_points: Optional[np.ndarray] = None,
                   crop_points_in_boxes: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray],
                              Optional[np.ndarray]]:
    """models: id -> {"V": (n,3), "F": (m,3), "pose": (4,4) model_to_scene}.

    Places each mesh at alignment @ pose, concatenates, and returns
    (V, F, G poses list of (3,4), remaining_scene_points). When
    `crop_points_in_boxes` is set, scene points inside any object's AABB
    are removed (visualization.cpp:63-99 semantics).
    """
    A = np.eye(4) if alignment is None else np.asarray(alignment)
    Vs, Fs, Gs = [], [], []
    offset = 0
    keep = None if scene_points is None else np.ones(len(scene_points), bool)
    for oid in sorted(models.keys()):
        m = models[oid]
        T = A @ np.asarray(m["pose"])
        V = np.asarray(m["V"], np.float64) @ T[:3, :3].T + T[:3, 3]
        Vs.append(V)
        Fs.append(np.asarray(m["F"], np.int64) + offset)
        offset += len(V)
        Gs.append(T[:3, :4].copy())
        if keep is not None and crop_points_in_boxes:
            lo, hi = V.min(axis=0), V.max(axis=0)
            inside = np.all((scene_points >= lo) & (scene_points <= hi),
                            axis=1)
            keep &= ~inside
    V_all = np.concatenate(Vs, axis=0) if Vs else np.zeros((0, 3))
    F_all = np.concatenate(Fs, axis=0) if Fs else np.zeros((0, 3), np.int64)
    rem = scene_points[keep] if keep is not None else None
    return V_all, F_all, Gs, rem
