# Frozen copy of the parts of visma_tpu_torch/utils/misc.py at 43be5d3 that
# the filter uses. Part of the benchmark's plain reference.
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import torch

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


def finite_tree(x) -> torch.Tensor:
    """All-finite reduction over the float tensors of a nested tuple / list /
    dict: one 0-d bool tensor on the tensors' device, computed without a
    host sync."""
    flags = [torch.isfinite(leaf).all() for leaf in tree_leaves(x)
             if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()
