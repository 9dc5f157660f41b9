"""Voxel-grid downsampling (port of visma_tpu/align/voxel.py; Open3D
VoxelDownSample semantics, evaluation.cpp:258).

Quantize to packed int32 voxel keys, sort them stably, average each run.
The reference's scatter-adds (`.at[seg].add(..., mode="drop")`) add a run's
points one after another from zero; `torch.segment_reduce` does the same,
one run at a time, on the CPU and on CUDA, so the means are the same bytes
from run to run (an `index_add_` on CUDA adds with atomics in an order
that changes). The output keeps the reference's fixed capacity and
validity mask.
"""
from __future__ import annotations

import torch

_INVALID_KEY = 2 ** 31 - 1


def voxel_downsample(points: torch.Tensor, voxel_size: float, valid=None,
                     max_out: int = 0):
    """points (N, 3) -> (out (K, 3), out_valid (K,)) with K = max_out or N.

    Each voxel's points average to one output point; voxels past K are
    dropped. Voxel indices clip to [-512, 511] (1024 voxels across).
    """
    N = points.shape[0]
    K = max_out or N
    dev = points.device
    if valid is None:
        valid = torch.ones(N, dtype=torch.bool, device=dev)

    vox = torch.clamp(torch.floor(points / voxel_size), -512, 511) \
        .to(torch.int32) + 512
    key = (vox[:, 0] << 20) | (vox[:, 1] << 10) | vox[:, 2]
    key = torch.where(valid, key, torch.full_like(key, _INVALID_KEY))

    k_sorted, order = torch.sort(key, stable=True)
    p_sorted = torch.where(valid[order][:, None], points[order],
                           torch.zeros((), dtype=points.dtype, device=dev))
    _, lengths = torch.unique_consecutive(k_sorted, return_counts=True)
    sums = torch.segment_reduce(p_sorted, "sum", lengths=lengths, axis=0)
    cnts = torch.segment_reduce(valid[order].to(torch.float32), "sum",
                                lengths=lengths, axis=0)
    n = min(K, sums.shape[0])
    out = torch.zeros((K, 3), dtype=points.dtype, device=dev)
    cnt = torch.zeros(K, dtype=torch.float32, device=dev)
    out[:n] = sums[:n]
    cnt[:n] = cnts[:n]
    return out / torch.clamp(cnt[:, None], min=1.0), cnt > 0
