"""The cluttered room made from a seed: objects on the configuration's
slots (a front row and a row behind it, in its gaps), the order in which
the detector first reports them, and each frame's detections.

The meshes, the camera's strafe, the edge evidence and the detector's box
of one object are `portbench.scenes.semantic`'s: chairs and desks
alternating, yaw and height drawn from the seed as there, the projected
ground-truth boxes under a class name no model has with a 12-bin azimuth
prior. From an object's first detection on, every frame's box list holds
it; the list keeps the order of first detection.
"""
from __future__ import annotations

import numpy as np

from portbench.scenes import semantic


def objects(slots, seed: int):
    """(names, T_wm (n, 4, 4) model->world, yaws) of one object a slot
    ((x, z) in metres), chairs and desks alternating, each object's yaw and
    then its height drawn from the seed, slot by slot."""
    rng = np.random.default_rng(seed)
    n = len(slots)
    names = (["chair", "desk"] * ((n + 1) // 2))[:n]
    T, yaws = [], []
    for x, z in slots:
        yaw = rng.uniform(-0.6, 0.6)
        M = np.eye(4)
        M[:3, :3] = semantic._yaw(yaw)
        M[:3, 3] = [x, rng.uniform(-0.1, 0.1), z]
        T.append(M)
        yaws.append(yaw)
    return names, np.stack(T), np.array(yaws)


def first_detections(n: int, first: int, every: int, seed: int) -> list:
    """The frame of each object's first detection: `first` objects at
    frame 0, then one new object every `every` frames, in an order drawn
    from the seed."""
    order = np.random.default_rng(seed).permutation(n)
    frame = np.empty(n, np.int64)
    for k, obj in enumerate(order):
        frame[obj] = 0 if k < first else (k - first + 1) * every
    return frame.tolist()


def detection_lists(aabbs, intr, names, yaws, T_wm, gwcs, first: list,
                    frames: int, make_box) -> list:
    """The box lists of frames 0 .. frames - 1 (objects in the order of
    their first detection), each box made by make_box(x0, y0, x1, y1,
    azimuth prior); the boxes of each distinct camera pose are projected
    once."""
    order = sorted(range(len(names)), key=lambda k: (first[k], k))
    per_pose = [semantic.detections(aabbs, intr, names, yaws,
                                    semantic.model_to_camera(T_wm, g))
                for g in gwcs]
    out = []
    for t in range(frames):
        dets = per_pose[semantic.path_index(t, len(gwcs))]
        out.append([make_box(*dets[k]) for k in order if first[k] <= t])
    return out
