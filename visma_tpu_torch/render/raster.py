"""Triangle rasterizer: depth / mask / edge images from meshes (port of
visma_tpu/render/raster.py).

Plane-equation rasterization: for a triangle with screen vertices
p0, p1, p2 and signed area A, each normalized edge function w_i(p)/A and
the perspective-correct 1/z interpolant are affine in pixel coordinates,
so a pixel is inside iff three planes are >= 0 (both windings, no backface
culling, as the reference GL pipeline) and z-buffering is a maximum of
1/z. Faces are Morton-sorted once per mesh and processed in chunks of 128;
per image subtile the setup packs the id list of the chunks whose screen
bbox hits it; the kernel culls each hitting chunk's triangles against the
subtile with an exact corner test (`subtile_cull_plain` is its plain
version) and runs the pixel loop over the survivors only. The result is
exact: every triangle is considered for every subtile it touches.

Setup (`_planes_batched`, `_prep_chunks_all`) is plain PyTorch, batched
over poses. The pair evaluations run in the hand-written kernel
`csrc/chunk_raster.cu` on a CUDA tensor, through two wrappers:

  chunk_raster_frame    one pose, 32-px subtiles (full frames); the port
                        of the TPU kernel raster.py::_chunk_raster_kernel
  chunk_raster_batched  B poses in one launch, 16-px subtiles (ROI
                        windows); the port of
                        raster.py::_chunk_raster_kernel_batched

On a CPU tensor both take `chunk_raster_plain` (all pixels x all chunks,
the same plane arithmetic). Both return metric depth with +inf background,
cropped to the frame: the reference's separate inverse-depth stitch is
folded in.

What exists in the reference only for the TPU and has no counterpart
here: the (nc, nsub) transposed id layout and the 16-row padded plane
table (scalar-memory and sublane layouts; the port keeps ids (B, nsub, nc)
and 12 coefficients a triangle), the lane-major (B, nc, 12, 128) plane
table with a chunk's 128 triangles last (the port keeps the table
triangle-major, (B, nc, 128, 12), a reshape of what the triangle setup
makes: no transposing copy in the setup and none in the kernel), the
strip-shaped output blocks, and the executors that
close over the mesh stack as compile-time constants (`_chunked_exec`).
The XLA tile-binned path (`rasterize_depth`, `_raster_tiles`) was the
reference's CPU fallback with a fixed per-tile capacity; the port's CPU
path is the exact plain version instead.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from visma_tpu_torch import _kernels
from visma_tpu_torch.geom import rotations as _rot  # noqa: F401  (TF32 off)
from visma_tpu_torch.render.camera import Intrinsics
from visma_tpu_torch.utils.misc import resolve_device

SUB_FRAME = 32     # binning subtile edge of full-frame renders
SUB_ROI = 16       # ... of ROI windows: chunk bboxes (~30 px) waste less
CHUNK = 128        # triangles to a chunk
_BIG = 1e9


def _project(V: torch.Tensor, pose_cw: torch.Tensor, intr: Intrinsics):
    """V (N,3) model -> screen xy (N,2), camera z (N,). pose_cw (3,4)."""
    R, t = pose_cw[:, :3], pose_cw[:, 3]
    Vc = V @ R.T + t
    z = Vc[:, 2]
    safe_z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = intr.fx * Vc[:, 0] / safe_z + intr.cx
    v = intr.fy * Vc[:, 1] / safe_z + intr.cy
    return torch.stack([u, v], dim=-1), z


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


def _triangle_planes(xy, z, F, intr: Intrinsics):
    """Per-triangle planes (T, 12) and ok (T,) of one pose from projected
    vertices xy (N,2), z (N,) and faces F (T,3)."""
    F = F.long()
    p = xy[F]                                       # (T,3,2)
    planes, ok, *_ = _planes_from_screen(p[..., 0], p[..., 1], z[F], intr)
    return planes, ok


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


# ---------------------------------------------------------------------------
# The pair evaluations: kernel wrappers and their plain version
# ---------------------------------------------------------------------------

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


def warp_footprint(sub_px: int):
    """(rows, cols) of the pixel rectangle one warp of the raster kernels
    owns: a quarter of the subtile's rows by half of its columns."""
    return sub_px // 4, sub_px // 2


def subtile_cull_plain(planes: torch.Tensor, intr: Intrinsics,
                       sub_px) -> torch.Tensor:
    """Plain PyTorch twin of the kernels' coarse test: planes
    (B,nc,chunk,12) -> survivors (B,nsub,nc,chunk) bool over the row-major
    grid of sub_px-square subtiles, or of (rows, cols) rectangles where
    sub_px is a pair (the kernels apply the same test once more to each
    warp's `warp_footprint`). Each plane is evaluated as (px*a + py*b) + c,
    the pixel test's own expression, at the corner of the rectangle's pixel
    range that maximises it (px = x_lo if a < 0 else x_hi, py likewise); the
    1/z plane also at its minimising corner. A triangle survives iff its
    three edge maxima are >= 0, max 1/z > 1/far and min 1/z < 1/near.

    Rounded products and sums are monotone, so a corner value is the
    maximum over the rectangle's pixels of what the pixel test computes: no
    pixel of the rectangle accepts a culled triangle."""
    sub_y, sub_x = (sub_px, sub_px) if isinstance(sub_px, int) else sub_px
    nsy, nsx = -(-intr.rows // sub_y), -(-intr.cols // sub_x)
    dev = planes.device
    inv_near, inv_far = 1.0 / intr.z_near, 1.0 / intr.z_far
    ty = torch.arange(nsy, device=dev) * sub_y
    tx = torch.arange(nsx, device=dev) * sub_x

    def grid(lo, dim, along_x):
        hi = torch.clamp(lo + ((sub_x if along_x else sub_y) - 1),
                         max=dim - 1)
        lo, hi = lo.to(torch.float32), hi.to(torch.float32)
        if along_x:
            lo, hi = lo.repeat(nsy), hi.repeat(nsy)
        else:
            lo, hi = lo.repeat_interleave(nsx), hi.repeat_interleave(nsx)
        return lo[None, :, None, None], hi[None, :, None, None]

    x_lo, x_hi = grid(tx, intr.cols, True)
    y_lo, y_hi = grid(ty, intr.rows, False)

    def corner(k, want_max):
        a, b, c = (planes[:, None, :, :, 3 * k + j] for j in range(3))
        px = torch.where((a < 0) == want_max, x_lo, x_hi)
        py = torch.where((b < 0) == want_max, y_lo, y_hi)
        return px * a + py * b + c

    return ((corner(0, True) >= 0) & (corner(1, True) >= 0)
            & (corner(2, True) >= 0) & (corner(3, True) > inv_far)
            & (corner(3, False) < inv_near))


def _check_raster_args(name, planes, ids, counts, intr, sub_px):
    if planes.dtype != torch.float32 or ids.dtype != torch.int32 \
            or counts.dtype != torch.int32:
        raise ValueError(f"{name}: planes must be float32, ids and counts "
                         "int32")
    _kernels.require_cuda(name, planes, ids, counts)
    B, nc = planes.shape[:2]
    nsy, nsx = _subtile_grid(intr, sub_px)
    if planes.shape != (B, nc, CHUNK, 12) \
            or ids.shape != (B, nsy * nsx, nc) \
            or counts.shape != (B, nsy * nsx):
        raise ValueError(
            f"{name}: expected planes (B,nc,{CHUNK},12), ids "
            f"(B,{nsy * nsx},nc), counts (B,{nsy * nsx}); got "
            f"{tuple(planes.shape)}, {tuple(ids.shape)}, "
            f"{tuple(counts.shape)}")
    if B == 0 or nc == 0:
        raise ValueError(f"{name}: empty batch or mesh")
    if planes.data_ptr() % 16:
        raise ValueError(f"{name}: planes must be 16-byte aligned")
    return B, nc


def chunk_raster_frame(planes, ids, counts, intr: Intrinsics) -> torch.Tensor:
    """One pose over 32-px subtiles: planes (1,nc,128,12), ids
    (1,nsub,nc), counts (1,nsub) from `_prep_chunks_all(sub_px=32)` ->
    depth (H,W), +inf background. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if planes.device.type == "cpu":
        return chunk_raster_plain(planes, intr)[0]
    B, nc = _check_raster_args("chunk_raster_frame", planes, ids, counts,
                               intr, SUB_FRAME)
    if B != 1:
        raise ValueError("chunk_raster_frame: takes one pose")
    out = torch.empty((intr.rows, intr.cols), dtype=torch.float32,
                      device=planes.device)
    rc = _kernels.library().vt_chunk_raster_frame(
        planes.data_ptr(), ids.data_ptr(), counts.data_ptr(), out.data_ptr(),
        nc, intr.rows, intr.cols, 1.0 / intr.z_near, 1.0 / intr.z_far,
        _kernels.stream_of(planes))
    _kernels.check(rc, "chunk_raster_frame")
    chunk_raster_frame.launches += 1
    return out


_kernels.counted(chunk_raster_frame)


def chunk_raster_batched(planes, ids, counts, intr: Intrinsics
                         ) -> torch.Tensor:
    """B poses in one launch over 16-px subtiles, each pose from its own
    plane table and lists (`_prep_chunks_all(sub_px=16)`) -> depth
    (B,H,W), +inf background. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if planes.device.type == "cpu":
        return chunk_raster_plain(planes, intr)
    B, nc = _check_raster_args("chunk_raster_batched", planes, ids, counts,
                               intr, SUB_ROI)
    if B > 65535:
        raise ValueError("chunk_raster_batched: at most 65535 poses a launch")
    out = torch.empty((B, intr.rows, intr.cols), dtype=torch.float32,
                      device=planes.device)
    rc = _kernels.library().vt_chunk_raster_batched(
        planes.data_ptr(), ids.data_ptr(), counts.data_ptr(), out.data_ptr(),
        B, nc, intr.rows, intr.cols, 1.0 / intr.z_near, 1.0 / intr.z_far,
        _kernels.stream_of(planes))
    _kernels.check(rc, "chunk_raster_batched")
    chunk_raster_batched.launches += 1
    return out


_kernels.counted(chunk_raster_batched)


# ---------------------------------------------------------------------------
# Mesh preparation (host side, numpy)
# ---------------------------------------------------------------------------

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


def _roi_intr(intr: Intrinsics, roi) -> Intrinsics:
    return Intrinsics(fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy,
                      rows=roi[0], cols=roi[1],
                      z_near=intr.z_near, z_far=intr.z_far)


# ---------------------------------------------------------------------------
# Rasterizers
# ---------------------------------------------------------------------------

def _raster_frames(C, poses_cw, intr: Intrinsics, chunk: int):
    """Full-frame renders of B poses: batched setup, then one
    `chunk_raster_frame` launch a pose."""
    planes, ids, counts = _prep_chunks_all(C, poses_cw, intr, chunk,
                                           sub_px=SUB_FRAME)
    return torch.stack([
        chunk_raster_frame(planes[b:b + 1], ids[b:b + 1], counts[b:b + 1],
                           intr)
        for b in range(planes.shape[0])])


def rasterize_depth_chunked(V, F, poses_cw, intr: Intrinsics,
                            chunk: int = CHUNK) -> torch.Tensor:
    """Batched exact rasterizer of one mesh: V (N,3), F (T,3), poses_cw
    (B,3,4) -> depth (B,H,W) f32, +inf background. Pass F through
    sort_faces_morton for speed (the result is the same for any order)."""
    C = V[F.long()]
    return _raster_frames(C[None].expand(poses_cw.shape[0], -1, -1, -1),
                          poses_cw, intr, chunk)


def rasterize_depth_chunked_plain(V, F, poses_cw, intr: Intrinsics,
                                  chunk: int = CHUNK) -> torch.Tensor:
    """`rasterize_depth_chunked` through the plain pair evaluation."""
    C = V[F.long()]
    planes, _, _ = _prep_chunks_all(
        C[None].expand(poses_cw.shape[0], -1, -1, -1), poses_cw, intr, chunk,
        sub_px=SUB_FRAME)
    return chunk_raster_plain(planes, intr)


def rasterize_depth_chunked_multi(Cs, poses_cw, mesh_idx, intr: Intrinsics,
                                  chunk: int = CHUNK) -> torch.Tensor:
    """Chunked rasterizer over a stack of padded meshes: hypothesis b
    renders mesh mesh_idx[b] at poses_cw[b]. Cs (M,Tmax,3,3) is
    `face_corner_stack` of the padded stack as a tensor."""
    return _raster_frames(Cs[mesh_idx.long()], poses_cw, intr, chunk)


def rasterize_depth_chunked_multi_plain(Cs, poses_cw, mesh_idx,
                                        intr: Intrinsics,
                                        chunk: int = CHUNK) -> torch.Tensor:
    """`rasterize_depth_chunked_multi` through the plain pair evaluation."""
    planes, _, _ = _prep_chunks_all(Cs[mesh_idx.long()], poses_cw, intr,
                                    chunk, sub_px=SUB_FRAME)
    return chunk_raster_plain(planes, intr)


def rasterize_depth_chunked_multi_roi(Cs, poses_cw, mesh_idx, origins,
                                      intr: Intrinsics, roi,
                                      chunk: int = CHUNK) -> torch.Tensor:
    """ROI-windowed chunked rasterizer: hypothesis b renders mesh
    mesh_idx[b] at poses_cw[b] into a (roi[0], roi[1]) window whose
    top-left global pixel is origins[b] = (x0, y0). All B windows go
    through one `chunk_raster_batched` launch.

    Equals the full-frame render cropped at the same window up to float
    roundoff (the planes are affine in pixel coordinates, and a window is a
    screen-space translation), for all geometry, whether or not it fits
    the window."""
    roi_intr = _roi_intr(intr, roi)
    planes, ids, counts = _prep_chunks_all(
        Cs[mesh_idx.long()], poses_cw, roi_intr, chunk,
        origins=origins.to(torch.float32), sub_px=SUB_ROI)
    return chunk_raster_batched(planes, ids, counts, roi_intr)


def rasterize_depth_chunked_multi_roi_plain(Cs, poses_cw, mesh_idx, origins,
                                            intr: Intrinsics, roi,
                                            chunk: int = CHUNK
                                            ) -> torch.Tensor:
    """`rasterize_depth_chunked_multi_roi` through the plain pair
    evaluation."""
    roi_intr = _roi_intr(intr, roi)
    planes, _, _ = _prep_chunks_all(
        Cs[mesh_idx.long()], poses_cw, roi_intr, chunk,
        origins=origins.to(torch.float32), sub_px=SUB_ROI)
    return chunk_raster_plain(planes, roi_intr)


def rasterize_depth_brute(V, F, pose_cw, intr: Intrinsics,
                          chunk: int = 8) -> torch.Tensor:
    """Correctness oracle: all pixels x all triangles by barycentric
    division (no planes, no binning), in triangle chunks. V (N,3), F
    (T,3), pose_cw (3,4) -> depth (H,W), +inf background."""
    H, W = intr.rows, intr.cols
    dev = V.device
    xy, z = _project(V, pose_cw, intr)
    F = F.long()
    yy, xx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    pxs = xx.reshape(-1).to(torch.float32)[None, :]
    pys = yy.reshape(-1).to(torch.float32)[None, :]
    inf = torch.tensor(float("inf"), device=dev)
    out = torch.full((H * W,), float("inf"), dtype=torch.float32, device=dev)
    for s in range(0, F.shape[0], chunk):
        Fc = F[s:s + chunk]
        p0, p1, p2 = xy[Fc[:, 0]], xy[Fc[:, 1]], xy[Fc[:, 2]]
        z0, z1, z2 = z[Fc[:, 0]], z[Fc[:, 1]], z[Fc[:, 2]]

        def edge(a, b):
            return ((b[:, 0] - a[:, 0])[:, None] * (pys - a[:, 1][:, None])
                    - (b[:, 1] - a[:, 1])[:, None] * (pxs - a[:, 0][:, None]))

        w0, w1, w2 = edge(p1, p2), edge(p2, p0), edge(p0, p1)
        area = ((p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1])
                - (p1[:, 1] - p0[:, 1]) * (p2[:, 0] - p0[:, 0]))[:, None]
        pos = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (area > 1e-12)
        neg = (w0 <= 0) & (w1 <= 0) & (w2 <= 0) & (area < -1e-12)
        zmin = torch.minimum(torch.minimum(z0, z1), z2)[:, None]
        inside = (pos | neg) & (zmin > intr.z_near)
        safe_area = torch.where(area.abs() < 1e-12, torch.ones_like(area),
                                area)
        invz = (w0 / safe_area / z0[:, None] + w1 / safe_area / z1[:, None]
                + w2 / safe_area / z2[:, None])
        d = 1.0 / torch.clamp(invz, min=1e-9)
        d = torch.where(inside & (d > intr.z_near) & (d < intr.z_far), d, inf)
        out = torch.minimum(out, d.amin(0))
    return out.reshape(H, W)


# ---------------------------------------------------------------------------
# Renderers
# ---------------------------------------------------------------------------

def _poses34(g_cm, device):
    g = torch.as_tensor(g_cm, dtype=torch.float32, device=device)
    if g.shape[-2:] == (4, 4):
        g = g[..., :3, :]
    return g.reshape(-1, 3, 4), tuple(g.shape[:-2])


class Renderer:
    """Drop-in equivalent of the reference Renderer
    (render/renderer.h:41-158): set camera and mesh once, then render
    depth / mask / edge per pose, with poses batched. `g_cm` maps model
    coordinates to camera coordinates."""

    def __init__(self, intr: Intrinsics, device=None):
        self.intr = intr
        self.device = resolve_device(device)
        self.V: Optional[torch.Tensor] = None
        self.F: Optional[torch.Tensor] = None

    def set_mesh(self, V, F):
        V = np.asarray(V, np.float32)
        self.V = torch.as_tensor(V, device=self.device)
        self.F = torch.as_tensor(sort_faces_morton(V, np.asarray(F)),
                                 device=self.device)

    def render_depth(self, g_cm) -> torch.Tensor:
        """g_cm: (...,3,4) or (...,4,4) model->camera. Returns (...,H,W)."""
        poses, batch = _poses34(g_cm, self.device)
        out = rasterize_depth_chunked(self.V, self.F, poses, self.intr)
        return out.reshape(*batch, self.intr.rows, self.intr.cols)

    def render_mask(self, g_cm) -> torch.Tensor:
        """uint8 mask: 255 where the mesh covers the pixel."""
        return (torch.isfinite(self.render_depth(g_cm)) * 255).to(torch.uint8)

    def render_edge(self, g_cm) -> torch.Tensor:
        """Edge image in [0,1] from the depth render."""
        from visma_tpu_torch.image.edges import depth_edge

        return depth_edge(self.render_depth(g_cm))


# The executors that semantic/ caches on a MultiMeshRenderer, by attribute
EXECUTOR_CACHES = ("_cem_exec_cache", "_retr_exec_cache", "_occ_exec_cache")


class MultiMeshRenderer:
    """Renderer over a database of meshes: every call takes a
    per-hypothesis mesh index, so one call renders hypothesis batches of
    different objects. Holds the padded stack on its device: Vs, Fs and
    the precomputed face corners Cs (no vertex gather per call)."""

    def __init__(self, intr: Intrinsics, device=None):
        self.intr = intr
        self.device = resolve_device(device)
        self.names: list = []
        self.Vs: Optional[torch.Tensor] = None
        self.Fs: Optional[torch.Tensor] = None
        self.Cs: Optional[torch.Tensor] = None

    def set_meshes(self, mesh_db) -> None:
        """mesh_db: {name: (V, F)} (insertion order fixes indices)."""
        self.names = list(mesh_db.keys())
        Vs, Fs = pad_mesh_stack([mesh_db[n] for n in self.names])
        self.set_stack(Vs, Fs)

    def set_stack(self, Vs, Fs, names=None) -> None:
        """Take an already padded, Morton-sorted stack (numpy).

        Drops the executors cached on this renderer (the fused CEM's, the
        retrieval's and the occluders'; semantic/cem.py,
        semantic/mapper.py): their graphs read the previous stack by
        address, and would keep rendering the old meshes (the reference's
        set_meshes, visma_tpu/render/raster.py:902-912)."""
        for cache in EXECUTOR_CACHES:
            self.__dict__.pop(cache, None)
        if names is not None:
            self.names = list(names)
        self.Vs = torch.as_tensor(np.asarray(Vs, np.float32),
                                  device=self.device)
        self.Fs = torch.as_tensor(np.asarray(Fs, np.int32),
                                  device=self.device)
        self.Cs = torch.as_tensor(face_corner_stack(Vs, Fs),
                                  device=self.device)

    def index(self, name: str) -> int:
        return self.names.index(name)

    def render_depth(self, g_cm, mesh_idx) -> torch.Tensor:
        """g_cm (...,3,4)/(...,4,4) model->camera; mesh_idx (...,) int:
        which database mesh each hypothesis renders. Returns (...,H,W)."""
        poses, batch = _poses34(g_cm, self.device)
        mi = torch.as_tensor(mesh_idx, device=self.device).reshape(-1)
        if mi.shape[0] == 1 and poses.shape[0] > 1:
            mi = mi.expand(poses.shape[0])
        out = rasterize_depth_chunked_multi(self.Cs, poses, mi, self.intr)
        return out.reshape(*batch, self.intr.rows, self.intr.cols)

    def render_mask(self, g_cm, mesh_idx) -> torch.Tensor:
        d = self.render_depth(g_cm, mesh_idx)
        return (torch.isfinite(d) * 255).to(torch.uint8)

    def render_edge(self, g_cm, mesh_idx) -> torch.Tensor:
        from visma_tpu_torch.image.edges import depth_edge

        return depth_edge(self.render_depth(g_cm, mesh_idx))
