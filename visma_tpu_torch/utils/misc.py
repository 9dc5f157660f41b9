"""Small utilities (port of visma_tpu/utils/misc.py; reference parity:
core/utils.h RandomMatrix/RandomVector :169-183, anynan :184-191,
BilinearSample :265-274, GenerateRandomColorMap), the health gates, and the
port's device rule."""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Dict

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point of the port runs on: the one asked for,
    else the CUDA card. Raises when a CUDA device is wanted and none
    exists; nothing carries on on the CPU unless `device="cpu"` was
    passed."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "visma_tpu_torch runs on a CUDA device and none is available; "
            "pass device=\"cpu\" to run on the CPU")
    return dev


@contextlib.contextmanager
def full_f32():
    """float32 matrix products at full float32 precision inside the block
    (and, as a decorator, inside the function), whatever the caller set: a
    `torch.set_float32_matmul_precision("high")` elsewhere would bring TF32
    back. The GPU form of the reference's `Precision.HIGHEST`."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def with_blocks(base: torch.Tensor, blocks) -> torch.Tensor:
    """`base` (..., R, C) with each (r0, c0, block (..., h, w)) written over
    rows [r0, r0+h) and columns [c0, c0+w), in order, out of place: a
    `torch.where` over the block's footprint, so a block with batch
    dimensions (or batched under `torch.func.vmap`) gives a batched result
    where an indexed store into `base` would be refused."""
    R, C = base.shape[-2:]
    out = base
    for r0, c0, blk in blocks:
        h, w = blk.shape[-2:]
        out = torch.where(_footprint(R, C, r0, c0, h, w, base.device),
                          torch.nn.functional.pad(
                              blk, (c0, C - c0 - w, r0, R - r0 - h)), out)
    return out


def device_constant(fn):
    """`fn` cached per arguments for the life of the process: a constant
    tensor made once per shape and device. It is never evicted, because a
    captured CUDA graph (`utils.graphs`) reads it by address on
    every replay: a bounded cache would free it, and the allocator would
    hand its memory to other tensors while the graph still reads it."""
    return functools.lru_cache(maxsize=None)(fn)


@device_constant
def _footprint(R: int, C: int, r0: int, c0: int, h: int, w: int,
               device: torch.device) -> torch.Tensor:
    """Constant (R, C) bool mask of rows [r0, r0+h) x columns [c0, c0+w),
    made once per shape and device."""
    rows = torch.arange(R, device=device)
    cols = torch.arange(C, device=device)
    return (((rows >= r0) & (rows < r0 + h))[:, None]
            & ((cols >= c0) & (cols < c0 + w))[None, :])


def cholesky_or_nan(S: torch.Tensor, upper: bool = False) -> torch.Tensor:
    """Cholesky factor of S (lower, or upper as `cho_factor` gives it), NaN
    where the factorisation fails, which is what the reference's factor
    returns; `cholesky_ex` reports the failure without a host sync."""
    L, info = torch.linalg.cholesky_ex(S, upper=upper)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


_LINALG_LIBRARY = threading.Lock()


@contextlib.contextmanager
def _on_cusolver():
    """PyTorch's preferred CUDA linear-algebra library set to cuSOLVER
    inside the block. PyTorch holds the preference process-wide: it is
    switched under a lock, so that no other caller here restores it in
    between."""
    with _LINALG_LIBRARY:
        prev = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("cusolver")
        try:
            yield
        finally:
            torch.backends.cuda.preferred_linalg_library(prev)


def cho_solve(B: torch.Tensor, L: torch.Tensor,
              upper: bool = False) -> torch.Tensor:
    """`torch.cholesky_solve(B, L, upper)`, on cuSOLVER for CUDA tensors.
    PyTorch's default gives a batched CUDA solve (the gate's per-feature
    solves, every solve under `Msckf.run_batched`'s vmap) to MAGMA, whose
    batched potrs allocates device memory itself, which a CUDA graph
    capture refuses; cuSOLVER's does not. The eager loops take the same
    library, so that a replayed graph and the eager loop agree bit for bit
    whatever a caller set process-wide. CPU tensors solve with LAPACK and
    touch nothing."""
    if not B.is_cuda:
        return torch.cholesky_solve(B, L, upper=upper)
    with _on_cusolver():
        return torch.cholesky_solve(B, L, upper=upper)


def inv_ex(A: torch.Tensor) -> torch.Tensor:
    """`torch.linalg.inv_ex(A)[0]`: the inverse of each matrix of A, not
    checked on the host (the reference's inverse does not check its
    result, and a check would read it back), on cuSOLVER / cuBLAS for CUDA
    tensors, under the same lock as `cho_solve`, so that a replayed graph
    and the eager loop take one library."""
    if not A.is_cuda:
        return torch.linalg.inv_ex(A)[0]
    with _on_cusolver():
        return torch.linalg.inv_ex(A)[0]


def as_f32(x, device) -> torch.Tensor:
    """A numpy array, list or tensor as a float32 tensor on `device`."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def tree_leaves(tree) -> list:
    """The leaves of nested dataclasses, dicts, tuples and lists in the
    order of `jax.tree_util.tree_flatten` on the reference's types:
    dataclass fields in declaration order (the port's states are frozen
    dataclasses in the reference's field order), dicts by sorted key,
    tuples and lists in order, None with no leaf."""
    if tree is None:
        return []
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in tree_leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def random_matrix(n: int, m: int, scale: float = 1.0, seed: int = 0
                  ) -> np.ndarray:
    return (np.random.default_rng(seed).random((n, m)) * 2 - 1) * scale


def random_vector(n: int, scale: float = 1.0, seed: int = 0) -> np.ndarray:
    return random_matrix(n, 1, scale, seed)[:, 0]


def any_nan(x) -> bool:
    """True when a float tensor or numpy array among the leaves of `x`
    (nested dataclasses, dicts, tuples, lists) holds a NaN or an infinity.
    A host-side check: it reads the answer back; `finite_tree` is the
    variant that stays on the device."""
    for leaf in tree_leaves(x):
        if not isinstance(leaf, torch.Tensor) and hasattr(leaf, "dtype"):
            leaf = torch.as_tensor(np.asarray(leaf))
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                and not bool(torch.isfinite(leaf).all())):
            return True
    return False


def finite_tree(x) -> torch.Tensor:
    """All-finite reduction over the float tensors of a nested tuple / list /
    dict: one 0-d bool tensor on the tensors' device, computed without a
    host sync."""
    flags = [torch.isfinite(leaf).all() for leaf in tree_leaves(x)
             if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


class DivergenceError(RuntimeError):
    """Filter state went non-finite. Carries the first bad frame index so
    callers can recover from the last healthy checkpoint instead of
    exporting NaN poses."""

    def __init__(self, frame: int, detail: str = ""):
        self.frame = int(frame)
        super().__init__(
            f"filter state non-finite at frame {frame}"
            + (f" ({detail})" if detail else ""))


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample img (H,W) at (...,2) float pixel coords, the taps
    clipped to [0, W-2] x [0, H-2]."""
    H, W = img.shape
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.clamp(torch.floor(x), 0, W - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(y), 0, H - 2).to(torch.int64)
    fx, fy = x - x0, y - y0
    flat = img.reshape(-1)
    b = y0 * W + x0
    return (flat[b] * (1 - fx) * (1 - fy) + flat[b + 1] * fx * (1 - fy)
            + flat[b + W] * (1 - fx) * fy + flat[b + W + 1] * fx * fy)


def generate_random_color_map(n: int = 256, seed: int = 0
                              ) -> Dict[int, np.ndarray]:
    """id -> BGR color (reference GenerateRandomColorMap; label displays)."""
    rng = np.random.default_rng(seed)
    return {i: rng.integers(0, 255, 3).astype(np.uint8) for i in range(n)}
