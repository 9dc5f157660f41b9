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
"""
from __future__ import annotations

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


def bilinear_remap_plain(image: torch.Tensor,
                         remap: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the remap kernel: see the module docstring."""
    lead, H, W, C, chan = _layout(image, remap)
    oh, ow = remap.shape[:2]
    remap = remap.to(torch.float32)
    sx, sy = remap[..., 0], remap[..., 1]
    valid = sx >= 0

    x0f = torch.clamp(torch.nan_to_num(torch.floor(sx), nan=0.0), 0, W - 2)
    y0f = torch.clamp(torch.nan_to_num(torch.floor(sy), nan=0.0), 0, H - 2)
    fx = torch.clamp(sx - x0f, 0.0, 1.0)[..., None]
    fy = torch.clamp(sy - y0f, 0.0, 1.0)[..., None]
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


def bilinear_remap(image: torch.Tensor, remap: torch.Tensor) -> torch.Tensor:
    """Remap image(s) through a source-coordinate table.

    image: (..., H, W) or (..., H, W, C), any real dtype; remap: (oh, ow, 2)
    float, any slice of rows of a larger table included. Returns
    (..., oh, ow[, C]) of the image's dtype. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel once or raises. uint8 and
    float32 are the kernel's storage types; another dtype goes through the
    float32 kernel and is cast as the reference casts.
    """
    if image.device.type == "cpu":
        return bilinear_remap_plain(image, remap)
    lead, H, W, C, chan = _layout(image, remap)
    oh, ow = remap.shape[:2]
    native = image.dtype in (torch.uint8, torch.float32)
    img = (image if native else image.to(torch.float32)).contiguous()
    table = remap.to(torch.float32).contiguous()
    _kernels.require_cuda("bilinear_remap", img, table)
    B = 1
    for n in lead:
        B *= n
    if B == 0 or oh == 0 or ow == 0:
        raise ValueError("bilinear_remap kernel: empty input")
    out = torch.empty((*lead, oh, ow, C) if chan else (*lead, oh, ow),
                      dtype=img.dtype, device=img.device)
    rc = _kernels.library().vt_bilinear_remap(
        img.data_ptr(), table.data_ptr(), out.data_ptr(), B, H, W, C, oh, ow,
        int(img.dtype == torch.uint8), _kernels.stream_of(img))
    _kernels.check(rc, "bilinear_remap")
    bilinear_remap.launches += 1
    if native:
        return out
    if _is_integer(image.dtype):
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(image.dtype)


bilinear_remap.launches = 0
