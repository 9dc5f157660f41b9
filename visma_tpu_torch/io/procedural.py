"""Procedural real-scale CAD-like meshes (metric units, y-up).

The semantic bench tracks REAL furniture-scale geometry: the reference's
own 5k-face CAD chair (misc/hermanmiller_aeron.obj, consumed by
example/render_depth.cpp and the papers' evaluation) plus a second
real-scale mesh. This module builds the second mesh — an office desk with
an off-center drawer pedestal (~5k faces, fully yaw-asymmetric) — and a
procedural office-chair stand-in used only when the reference mesh is not
on disk. Triangle counts are deliberately in the aeron's class so raster
cost in the bench reflects the real workload (24-face boxes are ~200x
lighter than the real substrate, and a box's square x-z cross-section
makes yaw unobservable).

All generators return (V (N,3) float32, F (T,3) int32) with centered
footprints so +y is up and the model origin is on the ground plane's
center axis, matching how the aeron is authored (centroid ~0).
"""
from __future__ import annotations

import numpy as np


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


def bench_mesh_db():
    """The semantic bench's mesh database: the reference's 5k-face CAD
    chair (misc/hermanmiller_aeron.obj — the mesh render_depth.cpp and the
    papers' evaluation use) when the environment variable VISMA_AERON_OBJ
    names a copy on disk, else the procedural stand-in; plus the
    procedural desk."""
    import os

    from visma_tpu_torch.io.mesh import load_mesh

    path = os.environ.get("VISMA_AERON_OBJ", "")
    if path and os.path.exists(path):
        chair = load_mesh(path)
    else:
        chair = office_chair_mesh()
    return {"chair": chair, "desk": desk_mesh()}
