"""The semantic bench scene: ground truth and detections (numpy).

The scene of the reference's `bench.py::bench_semantic` (bench.py:170-255),
which lives inside that benchmark and has no module of its own there:
chairs and desks alternating on four slots 2.75-3.1 m in front of a
500x960 camera that strafes 1.5 cm a frame, yaws drawn from a seed, and a
detector that reports the projected ground-truth boxes under a class name
that matches no model, so that shape retrieval has to run. `chip_smoke.py`
and `visma_tpu_torch.profile_semantic` both drive the mapper on it.
"""
from __future__ import annotations

import numpy as np

from visma_tpu_torch.proto import BoundingBox, BoundingBoxList

# intrinsics of the bench camera (bench.py:170-171), as keyword arguments
# of render.camera.Intrinsics
BENCH_INTRINSICS = dict(fx=486.405, fy=535.401, cx=469.199, cy=257.916,
                        rows=500, cols=960, z_near=0.05, z_far=8.0)
SLOTS = ((-1.5, 2.75), (-0.65, 3.1), (0.65, 3.1), (1.5, 2.75))


def bench_scene(n_frames: int, m_objects: int = 4, seed: int = 3):
    """Returns (names, T_gt, yaw_gt, gwc_at, poses): the model name of
    each object, its (4,4) model->world pose and yaw, the (3,4)
    camera->world pose of frame i as a function, and the model->camera
    poses of every frame, (n_frames, m_objects, 3, 4) float32."""
    from scipy.spatial.transform import Rotation

    names = (["chair", "desk"] * ((m_objects + 1) // 2))[:m_objects]
    rng = np.random.default_rng(seed)
    T_gt, yaw_gt = [], []
    for k in range(m_objects):
        yaw = rng.uniform(-0.6, 0.6)
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("y", yaw).as_matrix()
        x, z = SLOTS[k % len(SLOTS)]
        T[:3, 3] = [x, rng.uniform(-0.1, 0.1), z]
        T_gt.append(T)
        yaw_gt.append(yaw)

    def gwc_at(i):
        return np.hstack([np.eye(3), np.array([[0.015 * i], [0.0], [0.0]])])

    poses = np.empty((n_frames, m_objects, 3, 4), np.float32)
    for i in range(n_frames):
        G = np.eye(4)
        G[:3, :4] = gwc_at(i)
        G_cw = np.linalg.inv(G)
        poses[i] = np.stack([(G_cw @ T)[:3, :4] for T in T_gt])
    return names, T_gt, yaw_gt, gwc_at, poses


def gt_detections(aabbs, intr, names, yaw_gt, poses) -> BoundingBoxList:
    """Detector output for one frame (bench.py:235-255): the boxes of the
    projected ground-truth AABBs (aabbs: name -> (lo, hi)) at the
    model->camera poses (m,3,4), a class name matching no database model,
    and a 12-bin azimuth distribution peaked at the true yaw."""
    boxes = []
    for k, name in enumerate(names):
        lo, hi = aabbs[name]
        corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
        pc = corners @ poses[k, :3, :3].T + poses[k, :3, 3]
        u = intr.fx * pc[:, 0] / pc[:, 2] + intr.cx
        v = intr.fy * pc[:, 1] / pc[:, 2] + intr.cy
        nbins = 12
        tb = int(round(yaw_gt[k] / (2 * np.pi) * nbins)) % nbins
        ap = np.full(nbins, 0.02)
        ap[tb] = 0.5
        ap[(tb + 1) % nbins] = ap[(tb - 1) % nbins] = 0.15
        boxes.append(BoundingBox(
            top_left_x=float(u.min()), top_left_y=float(v.min()),
            bottom_right_x=float(u.max()), bottom_right_y=float(v.max()),
            scores=np.array([0.9], np.float32), class_name="furniture",
            azimuth_prob=ap.astype(np.float32)))
    return BoundingBoxList(bounding_boxes=boxes)
