"""Bilinear remap: the undistortion gather (port of visma_tpu/image/remap.py).

`bilinear_remap(image, remap)` samples `image` at the source coordinates of
a table `remap` (oh, ow, 2) of (x, y), with the reference's blend weights
(undistorter.cpp:429-432, the xxyy formulation) and its invalid mark: an
entry with `sx < 0` gives 0. On a CUDA tensor it launches the hand-written
kernel `csrc/bilinear_remap.cu` (the port of the TPU kernel
remap.py::_remap_tile_kernel, generalised to batches, channels and uint8 as
the reference's `bilinear_remap` is), once for the whole batch; on a CPU
tensor it runs `bilinear_remap_plain`, four flat gathers.

Shape rule, copied from the reference (remap.py:69): a last axis of size
1-4 on a tensor of three or more dimensions is the channel axis, so
`image` is (..., H, W) or (..., H, W, C) and every leading axis is batch.
A (B, H, W) batch whose W is 1-4 is therefore read as one (B, H) image of
W channels, as there.

Integer images (remap.py:56-58): the blend is rounded half to even, clipped
to [0, 255] and cast back. A NaN table entry is invalid (`NaN >= 0` is
false) and gives 0; its tap indices are clamped into the frame first.

The kernel works on output tiles (`remap_tiling`): a tile whose source box
fits a stage of shared memory is staged there once a frame, any other tile
gathers from device memory. `remap_footprint_plain` is the plain twin of
that choice: each tile's box and branch.
"""
from __future__ import annotations

import math

import torch

from visma_tpu_torch import _kernels


def _layout(image: torch.Tensor, remap: torch.Tensor):
    """(lead, H, W, C, chan): the batch shape, the frame size, the channel
    count and whether `image` has a channel axis."""
    if remap.dim() != 3 or remap.shape[-1] != 2:
        raise ValueError(f"remap table must be (oh, ow, 2), got "
                         f"{tuple(remap.shape)}")
    chan = image.dim() >= 3 and image.shape[-1] in (1, 2, 3, 4)
    if image.dim() < (3 if chan else 2):
        raise ValueError(f"image must be (..., H, W) or (..., H, W, C), got "
                         f"{tuple(image.shape)}")
    if chan:
        *lead, H, W, C = image.shape
    else:
        *lead, H, W = image.shape
        C = 1
    if H < 2 or W < 2:
        raise ValueError(f"bilinear_remap needs a frame of at least 2x2, "
                         f"got {H}x{W}")
    return tuple(lead), H, W, C, chan


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


STAGED, DIRECT = 0, 1     # a tile's branch in the kernel
TILE = (32, 64)           # output tile of one block: rows, columns


def remap_tiling(dtype: torch.dtype, C: int = 1):
    """((TILE_H, TILE_W), stage budget in bytes) of the kernel for an image
    of `dtype` (uint8, else float32) with C channels: a stage holds 4x
    (uint8) or 3x (float32) the tile's output bytes (csrc/bilinear_remap.cu
    `Cfg`)."""
    u8 = dtype == torch.uint8
    return TILE, (4 if u8 else 3) * TILE[0] * TILE[1] * C * (1 if u8 else 4)


def _taps(remap: torch.Tensor, H: int, W: int):
    """(x0, y0, valid, fx, fy): the clamped top-left tap of every table
    entry and its fractions, in the kernel's float32 arithmetic."""
    remap = remap.to(torch.float32)
    sx, sy = remap[..., 0], remap[..., 1]
    x0f = torch.clamp(torch.nan_to_num(torch.floor(sx), nan=0.0), 0, W - 2)
    y0f = torch.clamp(torch.nan_to_num(torch.floor(sy), nan=0.0), 0, H - 2)
    return (x0f, y0f, sx >= 0, torch.clamp(sx - x0f, 0.0, 1.0),
            torch.clamp(sy - y0f, 0.0, 1.0))


def remap_footprint_plain(remap: torch.Tensor, H: int, W: int, tile,
                          budget: int, *, C: int = 1, itemsize: int = 1,
                          aligned: bool = True, frames: int = 2):
    """Plain twin of the kernel's per-tile choice. remap (oh, ow, 2), source
    frame H x W of C channels of `itemsize` bytes; tile (TILE_H, TILE_W) and
    budget (bytes a stage) as `remap_tiling` gives them; aligned: the
    image's base is 16-byte aligned; frames: the call's batch size (a
    single frame has nothing to overlap its copy with and is gathered
    directly).

    Returns (boxes, branches) over the (ceil(oh/TILE_H), ceil(ow/TW)) tile
    grid: boxes int64 (..., 4) = (x_lo, y_lo, x_hi, y_hi), the inclusive
    source box of the tile's taps (x0, y0) to (x0 + 1, y0 + 1) over its
    valid entries ((0, 0, -1, -1) for a tile without one); branches int32,
    STAGED where the box's rows, 16-byte aligned and at the staged pitch
    (64 mod 128 bytes for one uint8 channel, else 0 mod 128), fit the
    budget, the row pitch W * C * itemsize is a multiple of 16 bytes and
    the batch has two frames or more, else DIRECT."""
    th, tw = tile
    x0f, y0f, valid, _, _ = _taps(remap, H, W)
    oh, ow = valid.shape
    ty, tx = -(-oh // th), -(-ow // tw)
    big = 1 << 40           # above any tap; exact through pad's float fill

    def tiles(v, fill):
        v = torch.where(valid, v.long(), torch.full_like(v, fill,
                                                         dtype=torch.long))
        v = torch.nn.functional.pad(v, (0, tx * tw - ow, 0, ty * th - oh),
                                    value=fill)
        return v.reshape(ty, th, tx, tw).transpose(1, 2).reshape(ty, tx, -1)

    x_lo = tiles(x0f, big).amin(-1)
    y_lo = tiles(y0f, big).amin(-1)
    x_hi = tiles(x0f, -2).amax(-1) + 1
    y_hi = tiles(y0f, -2).amax(-1) + 1
    any_ = y_hi >= 0
    zero = torch.zeros_like(x_lo)
    boxes = torch.stack([torch.where(any_, x_lo, zero),
                         torch.where(any_, y_lo, zero),
                         torch.where(any_, x_hi, zero - 1),
                         torch.where(any_, y_hi, zero - 1)], -1)
    cs = C * itemsize
    rows = torch.where(any_, y_hi + 1 - y_lo, zero)
    b0 = torch.where(any_, (x_lo * cs) // 16 * 16, zero)
    b1 = torch.where(any_, ((x_hi + 1) * cs + 15) // 16 * 16, zero)
    mod = 64 if cs == 1 else 0
    pitch = (b1 - b0) + (mod - (b1 - b0)) % 128
    fits = rows * pitch <= budget
    ok = aligned and (W * cs) % 16 == 0 and frames >= 2
    branches = torch.where(fits & ok, STAGED, DIRECT).to(torch.int32)
    return boxes, branches


def bilinear_remap_plain(image: torch.Tensor,
                         remap: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the remap kernel: see the module docstring."""
    lead, H, W, C, chan = _layout(image, remap)
    oh, ow = remap.shape[:2]
    x0f, y0f, valid, fx, fy = _taps(remap, H, W)
    fx, fy = fx[..., None], fy[..., None]
    fxy = fx * fy

    flat = image.to(torch.float32).reshape(-1, H * W, C)
    base = (y0f.long() * W + x0f.long()).reshape(-1)

    def tap(offset):
        return flat[:, base + offset].reshape(-1, oh, ow, C)

    p00, p01, p10, p11 = tap(0), tap(1), tap(W), tap(W + 1)
    # reference weights in the reference's order (remap.py:49-54)
    out = (fxy * p11 + (fy - fxy) * p10 + (fx - fxy) * p01
           + (1.0 - fx - fy + fxy) * p00)
    out = torch.where(valid[..., None], out, torch.zeros_like(out))
    if _is_integer(image.dtype):
        out = torch.clamp(torch.round(out), 0, 255)  # round: half to even
    out = out.to(image.dtype)
    return out.reshape(*lead, oh, ow, C) if chan else out.reshape(*lead, oh,
                                                                 ow)


def bilinear_remap(image: torch.Tensor, remap: torch.Tensor, *,
                   return_branches: bool = False):
    """Remap image(s) through a source-coordinate table.

    image: (..., H, W) or (..., H, W, C), any real dtype; remap: (oh, ow, 2)
    float, any slice of rows of a larger table included. Returns
    (..., oh, ow[, C]) of the image's dtype. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel once or raises. uint8 and
    float32 are the kernel's storage types; another dtype goes through the
    float32 kernel and is cast as the reference casts.

    return_branches (CUDA tensors only): returns (out, branches), the int32
    branch (STAGED or DIRECT) the kernel took in each output tile. Its
    plain twin is `remap_footprint_plain`.
    """
    if image.device.type == "cpu":
        if return_branches:
            raise ValueError("bilinear_remap: return_branches needs a CUDA "
                             "tensor; on the CPU call remap_footprint_plain")
        return bilinear_remap_plain(image, remap)
    lead, H, W, C, chan = _layout(image, remap)
    oh, ow = remap.shape[:2]
    native = image.dtype in (torch.uint8, torch.float32)
    img = image if native else image.to(torch.float32)
    if not img.is_contiguous():
        img = img.contiguous()
    table = remap
    if table.dtype != torch.float32 or not table.is_contiguous():
        table = table.to(torch.float32).contiguous()
    _kernels.require_cuda("bilinear_remap", img, table)
    B = math.prod(lead)
    if B == 0 or oh == 0 or ow == 0:
        raise ValueError("bilinear_remap kernel: empty input")
    out = torch.empty((*lead, oh, ow, C) if chan else (*lead, oh, ow),
                      dtype=img.dtype, device=img.device)
    branches = None
    if return_branches:
        (th, tw), _ = remap_tiling(img.dtype, C)
        branches = torch.full((-(-oh // th), -(-ow // tw)), -1,
                              dtype=torch.int32, device=img.device)
    rc = _kernels.library().vt_bilinear_remap(
        img.data_ptr(), table.data_ptr(), out.data_ptr(),
        None if branches is None else branches.data_ptr(), B, H, W, C, oh,
        ow, int(img.dtype == torch.uint8), _kernels.stream_of(img))
    _kernels.check(rc, "bilinear_remap")
    bilinear_remap.launches += 1
    if not native:
        if _is_integer(image.dtype):
            out = torch.clamp(torch.round(out), 0, 255)
        out = out.to(image.dtype)
    return (out, branches) if return_branches else out


_kernels.counted(bilinear_remap)
