"""The rasterizer's plain reference: depth windows and frames of meshes.

Frozen copies, at 43be5d3, of visma_tpu_torch/render/raster.py's triangle
setup (`_planes_from_screen`, `_planes_batched`, `_pack_chunks`,
`_prep_chunks_all`), its mesh stack (`sort_faces_morton`,
`pad_mesh_stack`, `face_corner_stack`) and of the plain pair evaluation
`chunk_raster_plain`: a pixel is inside a triangle iff its three edge
planes, each evaluated as (px*a + py*b) + c, are >= 0 and 1/far < 1/z <
1/near; the depth is the largest 1/z. `chunk_raster_plain` tests every
pixel of a window against every chunk; `_evaluate` tests the pixels of each
subtile against the chunks whose screen bbox reaches it, in batches, with
the same arithmetic a pixel: a pixel outside a chunk's bbox is inside none
of its triangles, and the maximum does not depend on the order, so the
two give the same bytes, about a hundred times faster.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

SUB_FRAME = 32     # subtile edge of full-frame renders
SUB_ROI = 16       # ... of ROI windows
CHUNK = 128        # triangles to a chunk
_BIG = 1e9
PAIRS = 1024       # (window, subtile, chunk) triples a batch


@dataclass(frozen=True)
class Intrinsics:
    """Pinhole camera of visma_tpu_torch/render/camera.py (CV convention,
    metric depth, +inf background)."""
    fx: float
    fy: float
    cx: float
    cy: float
    rows: int
    cols: int
    z_near: float = 0.05
    z_far: float = 5.0


def roi_intr(intr: Intrinsics, roi) -> Intrinsics:
    return Intrinsics(intr.fx, intr.fy, intr.cx, intr.cy, roi[0], roi[1],
                      intr.z_near, intr.z_far)


def _planes_from_screen(u, v, z, intr: Intrinsics):
    """Triangle setup on projected corners u, v, z (..., T, 3): planes
    (..., T, 12) as rows [a0,b0,c0, a1,b1,c1, a2,b2,c2, az,bz,cz], ok
    (..., T), and the screen bbox x0/x1/y0/y1 (..., T) with dead triangles
    pushed outside every tile. Degenerate or z-clipped triangles get the
    always-fail plane c0 = -1."""
    x0, y0, z0 = u[..., 0], v[..., 0], z[..., 0]
    x1, y1, z1 = u[..., 1], v[..., 1], z[..., 1]
    x2, y2, z2 = u[..., 2], v[..., 2], z[..., 2]

    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    zmin = torch.minimum(torch.minimum(z0, z1), z2)
    big_enough = area.abs() > 1e-12
    ok = (zmin > intr.z_near) & (zmin < intr.z_far) & big_enough
    zero, one = torch.zeros_like(area), torch.ones_like(area)
    inv_area = torch.where(ok, 1.0 / torch.where(big_enough, area, one), zero)

    def edge(xa, ya, xb, yb):
        # w(p) = (xb-xa)*(py-ya) - (yb-ya)*(px-xa)
        a = -(yb - ya)
        b = xb - xa
        c = (yb - ya) * xa - (xb - xa) * ya
        return a * inv_area, b * inv_area, c * inv_area

    a0, b0, c0 = edge(x1, y1, x2, y2)
    a1, b1, c1 = edge(x2, y2, x0, y0)
    a2, b2, c2 = edge(x0, y0, x1, y1)
    iz0 = torch.where(ok, 1.0 / torch.clamp(z0, min=1e-9), zero)
    iz1 = torch.where(ok, 1.0 / torch.clamp(z1, min=1e-9), zero)
    iz2 = torch.where(ok, 1.0 / torch.clamp(z2, min=1e-9), zero)
    az = a0 * iz0 + a1 * iz1 + a2 * iz2
    bz = b0 * iz0 + b1 * iz1 + b2 * iz2
    cz = c0 * iz0 + c1 * iz1 + c2 * iz2
    c0 = torch.where(ok, c0, -one)
    planes = torch.stack([a0, b0, c0, a1, b1, c1, a2, b2, c2, az, bz, cz], -1)

    big = torch.full_like(area, _BIG)
    bx0 = torch.where(ok, u.amin(-1), big)
    bx1 = torch.where(ok, u.amax(-1), -big)
    by0 = torch.where(ok, v.amin(-1), big)
    by1 = torch.where(ok, v.amax(-1), -big)
    return planes, ok, bx0, bx1, by0, by1


def _planes_batched(C, poses_cw, intr: Intrinsics, origins=None):
    """Batched triangle setup. C (B,T,3,3) model-frame face-corner
    positions; poses_cw (B,3,4); origins (B,2) optional screen-window
    top-lefts subtracted from the projected coordinates. Returns (planes
    (B,T,12), ok (B,T), bbox x0/x1/y0/y1 each (B,T))."""
    R = poses_cw[:, :, :3]
    t = poses_cw[:, :, 3]
    Vc = torch.einsum("bij,btkj->btki", R, C) + t[:, None, None, :]
    z = Vc[..., 2]
    safe_z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = intr.fx * Vc[..., 0] / safe_z + intr.cx
    v = intr.fy * Vc[..., 1] / safe_z + intr.cy
    if origins is not None:
        u = u - origins[:, 0][:, None, None]
        v = v - origins[:, 1][:, None, None]
    return _planes_from_screen(u, v, z, intr)


def _subtile_grid(intr: Intrinsics, sub_px: int):
    return -(-intr.rows // sub_px), -(-intr.cols // sub_px)


def _pack_chunks(planes, x0, x1, y0, y1, intr: Intrinsics, chunk: int,
                 sub_px: int):
    """Pad (B,T,...) triangle data to whole chunks and bin chunk bboxes
    against the subtile grid. Returns (planes (B,nc,chunk,12), a reshape of
    the triangle-major table and no copy, ids (B,nsub,nc) i32 with the
    hitting chunk ids first in ascending order, counts (B,nsub) i32)."""
    B, T = planes.shape[:2]
    pad = (-T) % chunk
    nc = (T + pad) // chunk
    dev = planes.device
    if pad:
        # the always-fail plane c0 = -1, built without a host value (an
        # indexed store of a scalar makes the host wait for the device)
        fail = -(torch.arange(12, device=dev) == 2).to(planes.dtype)
        planes = torch.cat([planes, fail.expand(B, pad, 12)], dim=1)

        def padv(a, value):
            return torch.nn.functional.pad(a, (0, pad), value=value)

        x0, x1 = padv(x0, _BIG), padv(x1, -_BIG)
        y0, y1 = padv(y0, _BIG), padv(y1, -_BIG)
    cx0 = x0.reshape(B, nc, chunk).amin(-1)
    cx1 = x1.reshape(B, nc, chunk).amax(-1)
    cy0 = y0.reshape(B, nc, chunk).amin(-1)
    cy1 = y1.reshape(B, nc, chunk).amax(-1)

    nsy, nsx = _subtile_grid(intr, sub_px)
    ty0 = (torch.arange(nsy, device=dev) * sub_px).to(planes.dtype)
    tx0 = (torch.arange(nsx, device=dev) * sub_px).to(planes.dtype)
    ov_x = (cx0[:, None, :] <= (tx0[None, :, None] + (sub_px - 1))) \
        & (cx1[:, None, :] >= tx0[None, :, None])               # (B,nsx,nc)
    ov_y = (cy0[:, None, :] <= (ty0[None, :, None] + (sub_px - 1))) \
        & (cy1[:, None, :] >= ty0[None, :, None])               # (B,nsy,nc)
    ov = (ov_y[:, :, None, :] & ov_x[:, None, :, :]).reshape(B, nsy * nsx, nc)
    # hitting chunk ids first, ascending; the kernel takes a maximum, so any
    # order of the list gives the same image
    score = ov.to(torch.int32) * (nc - torch.arange(nc, dtype=torch.int32,
                                                    device=dev))
    ids = torch.sort(score, dim=-1, descending=True, stable=True).indices
    counts = ov.sum(dim=-1, dtype=torch.int32)
    return planes.reshape(B, nc, chunk, 12), ids.to(torch.int32).contiguous(), counts.contiguous()


def _prep_chunks_all(C, poses_cw, intr: Intrinsics, chunk: int = CHUNK,
                     origins=None, sub_px: int = SUB_FRAME):
    """Kernel inputs for B poses: C (B,T,3,3) face corners -> (planes
    (B,nc,chunk,12), ids (B,nsub,nc) i32, counts (B,nsub) i32) over the
    (ceil(rows/sub_px), ceil(cols/sub_px)) subtile grid, row-major."""
    planes, _, x0, x1, y0, y1 = _planes_batched(C, poses_cw, intr,
                                                origins=origins)
    return _pack_chunks(planes, x0, x1, y0, y1, intr, chunk, sub_px)


def chunk_raster_plain(planes: torch.Tensor, intr: Intrinsics
                       ) -> torch.Tensor:
    """Plain PyTorch twin of the chunk-raster kernels: planes
    (B,nc,chunk,12) -> depth (B,H,W), +inf background. Every pixel against
    every chunk of its pose, one chunk at a time: each plane as
    (px*a + py*b) + c in that order, inside iff the three edge planes are
    >= 0 and 1/far < 1/z < 1/near, maximum inverse depth."""
    B, nc = planes.shape[:2]
    H, W = intr.rows, intr.cols
    dev = planes.device
    inv_near, inv_far = 1.0 / intr.z_near, 1.0 / intr.z_far
    px = torch.arange(W, dtype=torch.float32, device=dev).repeat(H)[:, None]
    py = torch.arange(H, dtype=torch.float32,
                      device=dev).repeat_interleave(W)[:, None]
    out = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    for b in range(B):
        best = torch.zeros(H * W, dtype=torch.float32, device=dev)
        for c in range(nc):
            p = planes[b, c]                                  # (chunk, 12)

            def plane(k):
                return px * p[:, 3 * k] + py * p[:, 3 * k + 1] \
                    + p[:, 3 * k + 2]

            iz = plane(3)
            inside = ((plane(0) >= 0) & (plane(1) >= 0) & (plane(2) >= 0)
                      & (iz > inv_far) & (iz < inv_near))
            best = torch.maximum(
                best, torch.where(inside, iz, torch.zeros_like(iz)).amax(1))
        out[b] = _inv_to_depth(best).reshape(H, W)
    return out


def _inv_to_depth(inv: torch.Tensor) -> torch.Tensor:
    return torch.where(inv > 0, 1.0 / torch.clamp(inv, min=1e-12),
                       torch.full_like(inv, float("inf")))


def sort_faces_morton(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Reorder faces by Morton code of their centroid (once per mesh), so
    that consecutive faces, and with them chunks, are spatially local."""
    V = np.asarray(V, np.float64)
    F = np.asarray(F, np.int64)
    cent = V[F].mean(axis=1)
    lo, hi = cent.min(0), cent.max(0)
    q = ((cent - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.uint64)

    def spread(x):
        x &= 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.asarray(F[np.argsort(code, kind="stable")], np.int32)


def pad_mesh_stack(meshes):
    """Stack meshes of different sizes into padded numpy arrays.

    meshes: list of (V (Ni,3), F (Ti,3)). Faces are Morton-sorted per
    mesh; V is zero-padded, F padded with degenerate [0,0,0] rows that the
    plane setup rejects (zero area). Returns (Vs (M,Vmax,3) f32, Fs
    (M,Tmax,3) i32)."""
    Vmax = max(len(V) for V, _ in meshes)
    Tmax = max(len(F) for _, F in meshes)
    Vs = np.zeros((len(meshes), Vmax, 3), np.float32)
    Fs = np.zeros((len(meshes), Tmax, 3), np.int32)
    for i, (V, F) in enumerate(meshes):
        V = np.asarray(V, np.float32)
        Vs[i, : len(V)] = V
        Fm = sort_faces_morton(V, np.asarray(F))
        Fs[i, : len(Fm)] = Fm
    return Vs, Fs


def face_corner_stack(Vs, Fs) -> np.ndarray:
    """(M,Vmax,3), (M,Tmax,3) -> per-face corner positions (M,Tmax,3,3),
    numpy in and out. Padded faces become three copies of vertex 0."""
    Vs = np.asarray(Vs)
    Fs = np.asarray(Fs)
    return np.stack([V[F] for V, F in zip(Vs, Fs)]).astype(np.float32)




def _evaluate(planes, ids, counts, intr: Intrinsics, sub_px: int):
    """`chunk_raster_plain` over the subtiles each chunk's bbox reaches:
    planes (B,nc,chunk,12), ids (B,nsub,nc), counts (B,nsub) as
    `_pack_chunks` gives them. Returns depth (B,H,W), +inf background."""
    B, nsub, nc = ids.shape
    H, W = intr.rows, intr.cols
    dev = planes.device
    nsy, nsx = _subtile_grid(intr, sub_px)
    inv_near, inv_far = 1.0 / intr.z_near, 1.0 / intr.z_far
    hit = torch.arange(nc, device=dev) < counts[..., None]
    b_i, s_i, k_i = hit.nonzero(as_tuple=True)
    c_i = ids[b_i, s_i, k_i].long()
    off = torch.arange(sub_px, device=dev)
    oy = off.repeat_interleave(sub_px).to(torch.float32)
    ox = off.repeat(sub_px).to(torch.float32)
    best = torch.zeros((B * nsub, sub_px * sub_px), dtype=torch.float32,
                       device=dev)
    for a in range(0, b_i.shape[0], PAIRS):
        b, st, c = b_i[a:a + PAIRS], s_i[a:a + PAIRS], c_i[a:a + PAIRS]
        p = planes[b, c]                                   # (T, chunk, 12)
        px = ((st % nsx) * sub_px).to(torch.float32)[:, None] + ox
        py = ((st // nsx) * sub_px).to(torch.float32)[:, None] + oy
        px, py = px[:, :, None], py[:, :, None]            # (T, P, 1)

        def plane(k):
            return px * p[:, None, :, 3 * k] + py * p[:, None, :, 3 * k + 1] \
                + p[:, None, :, 3 * k + 2]

        iz = plane(3)
        inside = ((plane(0) >= 0) & (plane(1) >= 0) & (plane(2) >= 0)
                  & (iz > inv_far) & (iz < inv_near))
        got = torch.where(inside, iz, torch.zeros_like(iz)).amax(2)
        best.scatter_reduce_(0, (b * nsub + st)[:, None].expand_as(got), got,
                             "amax")
    tiles = best.reshape(B, nsy, nsx, sub_px, sub_px).permute(0, 1, 3, 2, 4)
    depth = tiles.reshape(B, nsy * sub_px, nsx * sub_px)[:, :H, :W]
    return _inv_to_depth(depth)


def render_roi(Cs, poses_cw, mesh_idx, origins, intr: Intrinsics, roi):
    """Hypothesis b renders mesh mesh_idx[b] at poses_cw[b] (3,4) into the
    (roi[0], roi[1]) window whose top-left pixel is origins[b] = (x0, y0).
    Cs: `face_corner_stack` of the padded stack. (B, Hr, Wr) depth."""
    ri = roi_intr(intr, roi)
    planes, ids, counts = _prep_chunks_all(
        Cs[mesh_idx.long()], poses_cw, ri, CHUNK,
        origins=origins.to(torch.float32), sub_px=SUB_ROI)
    return _evaluate(planes, ids, counts, ri, SUB_ROI)


def render_frames(Cs, poses_cw, mesh_idx, intr: Intrinsics):
    """Full-frame depth (B, H, W) of mesh mesh_idx[b] at poses_cw[b]."""
    planes, ids, counts = _prep_chunks_all(
        Cs[mesh_idx.long()], poses_cw, intr, CHUNK, sub_px=SUB_FRAME)
    return _evaluate(planes, ids, counts, intr, SUB_FRAME)
