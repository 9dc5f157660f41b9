"""The semantic scene made from a seed: the furniture meshes, the objects'
poses, the camera's strafe, the detections, and the edge evidence of each
distinct camera pose.

Frozen copies, at 43be5d3, of the mesh generators of
visma_tpu_torch/io/procedural.py (the office chair and the desk: 5,016 and
5,148 faces) and of the scene of visma_tpu_torch/io/synthetic_semantic.py
(`bench_scene`, `gt_detections`; bench.py:170-255): chairs and desks
alternating on four slots 2.75-3.1 m in front of a 500x960 camera, yaws and
heights drawn from the seed, a detector that reports the projected boxes
under a class name no model has, so that shape retrieval runs. The camera
strafes 1.5 cm a frame, back and forth over a bounded path, so that every
object stays in view. The evidence is the depth edges of the ground truth,
rendered on the device by the plain reference's rasterizer.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.semantic import raster, score

SLOTS = ((-1.5, 2.75), (-0.65, 3.1), (0.65, 3.1), (1.5, 2.75))


def _grid_plane(n: int):
    """Unit-square subdivision: verts ((n+1)^2, 2) in [0,1]^2, faces
    (2n^2, 3) with consistent winding."""
    u = np.linspace(0.0, 1.0, n + 1)
    uu, vv = np.meshgrid(u, u, indexing="ij")
    V = np.stack([uu.ravel(), vv.ravel()], axis=1)
    idx = np.arange((n + 1) * (n + 1)).reshape(n + 1, n + 1)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[:-1, 1:].ravel()
    d = idx[1:, 1:].ravel()
    F = np.concatenate([np.stack([a, b, d], 1), np.stack([a, d, c], 1)])
    return V.astype(np.float64), F.astype(np.int64)


def box_mesh(sx: float, sy: float, sz: float, subdiv: int = 1,
             center=(0.0, 0.0, 0.0)):
    """Axis-aligned box of full extents (sx, sy, sz), each face an
    n x n grid: 12*subdiv^2 triangles."""
    P, Fp = _grid_plane(subdiv)
    parts_V, parts_F = [], []
    half = np.array([sx, sy, sz]) / 2.0
    # (fixed axis, sign, u axis, v axis); windings flip with the sign
    for ax, sign in [(0, -1), (0, 1), (1, -1), (1, 1), (2, -1), (2, 1)]:
        ua, va = [i for i in range(3) if i != ax]
        V = np.zeros((len(P), 3))
        V[:, ua] = (P[:, 0] - 0.5) * 2 * half[ua]
        V[:, va] = (P[:, 1] - 0.5) * 2 * half[va]
        V[:, ax] = sign * half[ax]
        F = Fp if sign > 0 else Fp[:, ::-1]
        parts_V.append(V)
        parts_F.append(F)
    return merge_meshes([(v, f) for v, f in zip(parts_V, parts_F)],
                        offset=np.asarray(center, np.float64))


def cylinder_mesh(radius: float, height: float, segments: int = 24,
                  stacks: int = 4, center=(0.0, 0.0, 0.0)):
    """Closed y-axis cylinder: 2*segments*stacks side triangles +
    2*segments cap triangles."""
    th = np.arange(segments) * (2 * np.pi / segments)
    ring = np.stack([np.cos(th) * radius, np.zeros(segments),
                     np.sin(th) * radius], 1)
    ys = np.linspace(-height / 2, height / 2, stacks + 1)
    V = np.concatenate([ring + np.array([0.0, y, 0.0]) for y in ys])
    F = []
    for s in range(stacks):
        base0, base1 = s * segments, (s + 1) * segments
        for i in range(segments):
            j = (i + 1) % segments
            F.append([base0 + i, base1 + i, base1 + j])
            F.append([base0 + i, base1 + j, base0 + j])
    nb = len(V)
    V = np.concatenate([V, [[0.0, -height / 2, 0.0]],
                        [[0.0, height / 2, 0.0]]])
    top0 = stacks * segments
    for i in range(segments):
        j = (i + 1) % segments
        F.append([nb, i, j])                       # bottom cap
        F.append([nb + 1, top0 + j, top0 + i])     # top cap
    return merge_meshes([(V, np.asarray(F, np.int64))],
                        offset=np.asarray(center, np.float64))


def merge_meshes(parts, offset=None):
    """parts: list of (V, F). Concatenates with reindexed faces."""
    Vs, Fs, base = [], [], 0
    for V, F in parts:
        V = np.asarray(V, np.float64)
        if offset is not None:
            V = V + offset
        Vs.append(V)
        Fs.append(np.asarray(F, np.int64) + base)
        base += len(V)
    return (np.concatenate(Vs).astype(np.float32),
            np.concatenate(Fs).astype(np.int32))


def desk_mesh():
    """Office desk, 1.2 x 0.74 x 0.6 m: subdivided top, three cylindrical
    legs on the right/back, and a drawer pedestal (with three proud drawer
    fronts) filling the left side — no yaw symmetry whatsoever. ~5.3k
    faces (the aeron's class). Origin at floor center, +y up."""
    parts = []
    top_h = 0.72
    parts.append(box_mesh(1.2, 0.04, 0.6, subdiv=16,
                          center=(0.0, top_h - 0.02, 0.0)))
    # drawer pedestal, left side
    parts.append(box_mesh(0.38, 0.66, 0.52, subdiv=9,
                          center=(-0.38, 0.37, 0.0)))
    for k in range(3):
        parts.append(box_mesh(0.34, 0.18, 0.03, subdiv=2,
                              center=(-0.38, 0.17 + 0.21 * k, 0.275)))
    # two right legs + one back crossbar leg (asymmetric count)
    for z in (-0.26, 0.26):
        parts.append(cylinder_mesh(0.025, 0.70, segments=20, stacks=7,
                                   center=(0.55, 0.35, z)))
    parts.append(cylinder_mesh(0.02, 0.70, segments=20, stacks=7,
                               center=(0.0, 0.35, -0.27)))
    V, F = merge_meshes(parts)
    V[:, 1] -= (top_h / 2)           # center vertically like the aeron
    return V, F


def office_chair_mesh():
    """Procedural office-chair stand-in (~5.5k faces) for environments
    where the reference aeron OBJ is absent: contoured seat, tilted
    asymmetric backrest, column, five-spoke base. Origin mid-height."""
    parts = []
    seat_h = 0.46
    parts.append(box_mesh(0.48, 0.06, 0.46, subdiv=13,
                          center=(0.0, seat_h, 0.0)))
    # backrest, tilted back 12 deg, plus an off-center lumbar pad
    Vb, Fb = box_mesh(0.46, 0.55, 0.05, subdiv=10)
    a = np.radians(12.0)
    R = np.array([[1, 0, 0],
                  [0, np.cos(a), -np.sin(a)],
                  [0, np.sin(a), np.cos(a)]])
    Vb = Vb @ R.T + np.array([0.0, seat_h + 0.33, -0.24])
    parts.append((Vb, Fb))
    parts.append(box_mesh(0.18, 0.12, 0.04, subdiv=3,
                          center=(0.08, seat_h + 0.18, -0.21)))
    # one armrest only (right): breaks left-right symmetry
    parts.append(box_mesh(0.05, 0.02, 0.3, subdiv=4,
                          center=(0.27, seat_h + 0.2, 0.0)))
    parts.append(box_mesh(0.05, 0.2, 0.04, subdiv=4,
                          center=(0.27, seat_h + 0.1, 0.12)))
    parts.append(cylinder_mesh(0.03, 0.36, segments=24, stacks=6,
                               center=(0.0, seat_h - 0.21, 0.0)))
    for k in range(5):
        th = 2 * np.pi * k / 5
        Vl, Fl = box_mesh(0.3, 0.04, 0.05, subdiv=4,
                          center=(0.15, 0.0, 0.0))
        Ry = np.array([[np.cos(th), 0, np.sin(th)],
                       [0, 1, 0],
                       [-np.sin(th), 0, np.cos(th)]])
        Vl = Vl @ Ry.T + np.array([0.0, 0.05, 0.0])
        parts.append((Vl, Fl))
    V, F = merge_meshes(parts)
    V[:, 1] -= 0.5                   # origin at mid-height like the aeron
    return V, F


def mesh_db():
    """{name: (V (N, 3) float32, F (T, 3) int32)}: the chair, the desk."""
    return {"chair": office_chair_mesh(), "desk": desk_mesh()}


def _yaw(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def objects(n: int, seed: int):
    """(names, T_wm (n, 4, 4) model->world, yaws): chairs and desks
    alternating on the slots, yaw and height drawn from the seed."""
    rng = np.random.default_rng(seed)
    names = (["chair", "desk"] * ((n + 1) // 2))[:n]
    T, yaws = [], []
    for k in range(n):
        yaw = rng.uniform(-0.6, 0.6)
        M = np.eye(4)
        M[:3, :3] = _yaw(yaw)
        x, z = SLOTS[k % len(SLOTS)]
        M[:3, 3] = [x, rng.uniform(-0.1, 0.1), z]
        T.append(M)
        yaws.append(yaw)
    return names, np.stack(T), np.array(yaws)


def strafe(distinct: int, step: float):
    """(distinct, 3, 4) camera->world poses: the camera 1 strafe step
    further along x at each distinct pose."""
    g = np.zeros((distinct, 3, 4))
    g[:, :, :3] = np.eye(3)
    g[:, 0, 3] = step * np.arange(distinct)
    return g


def path_index(i: int, distinct: int) -> int:
    """The distinct pose of frame i on the back-and-forth path."""
    period = 2 * (distinct - 1)
    j = i % period
    return j if j < distinct else period - j


def model_to_camera(T_wm: np.ndarray, gwc: np.ndarray) -> np.ndarray:
    """(n, 3, 4) float32 model->camera poses seen from gwc (3, 4)."""
    G = np.eye(4)
    G[:3, :4] = gwc
    G_cw = np.linalg.inv(G)
    return np.stack([(G_cw @ T)[:3, :4] for T in T_wm]).astype(np.float32)


def evidence(Cs: torch.Tensor, mesh_idx, T_wm, gwcs, intr) -> torch.Tensor:
    """(distinct, H, W) float32 edge maps on the device: the depth edges of
    the objects' joint z-buffer at each camera pose."""
    dev = Cs.device
    n = len(mesh_idx)
    poses = torch.as_tensor(np.stack([model_to_camera(T_wm, g)
                                      for g in gwcs]), device=dev)
    mi = torch.as_tensor(np.asarray(mesh_idx), device=dev).repeat(len(gwcs))
    d = raster.render_frames(Cs, poses.reshape(-1, 3, 4), mi, intr)
    d = d.reshape(len(gwcs), n, intr.rows, intr.cols).amin(dim=1)
    return score.depth_edge_plain(d)


def detections(aabbs, intr, names, yaws, poses_cm):
    """Detector output for one frame, as (x0, y0, x1, y0, azimuth (12,))
    tuples: the boxes of the projected ground-truth AABBs and a 12-bin
    azimuth distribution peaked at the true yaw."""
    out = []
    for k, name in enumerate(names):
        lo, hi = aabbs[name]
        corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
        pc = corners @ poses_cm[k, :3, :3].T + poses_cm[k, :3, 3]
        u = intr.fx * pc[:, 0] / pc[:, 2] + intr.cx
        v = intr.fy * pc[:, 1] / pc[:, 2] + intr.cy
        nbins = 12
        tb = int(round(yaws[k] / (2 * np.pi) * nbins)) % nbins
        ap = np.full(nbins, 0.02)
        ap[tb] = 0.5
        ap[(tb + 1) % nbins] = ap[(tb - 1) % nbins] = 0.15
        out.append((float(u.min()), float(v.min()), float(u.max()),
                    float(v.max()), ap.astype(np.float32)))
    return out
