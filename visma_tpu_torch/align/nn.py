"""Brute-force nearest neighbours (port of visma_tpu/align/nn.py).

Pairwise squared distances as ||q||^2 + ||r||^2 - 2 q.r, one matrix product
a chunk of queries, then the first minimum of each row (`jnp.argmin`'s rule,
which `torch.argmin` shares). The reference maps the chunks with `lax.map`;
here they are a Python loop. Each row's result depends on that row alone,
so the chunk size changes the number of launches, not the answer: on a
CUDA device the chunk grows until a chunk's distance tile holds
`CUDA_TILE_ELEMS` entries (256 MiB of float32).
"""
from __future__ import annotations

import torch

from visma_tpu_torch.utils.misc import full_f32

CUDA_TILE_ELEMS = 1 << 26


def rows_per_chunk(chunk: int, cols: int, device: torch.device) -> int:
    """The query rows a chunk takes: `chunk` on the CPU; on a CUDA device
    the largest multiple of `chunk` whose (rows, cols) tile stays within
    CUDA_TILE_ELEMS entries (at least `chunk`)."""
    if device.type != "cuda":
        return chunk
    return chunk * max(1, CUDA_TILE_ELEMS // max(chunk * cols, 1))


def map_rows(chunk: int, n: int, cols: int, device: torch.device) -> int:
    """The rows a chunk of a loop over n queries takes (`pad_chunks`):
    `rows_per_chunk`'s, but no more whole multiples of `chunk` than n
    queries fill, so that padding never outgrows the queries."""
    return min(rows_per_chunk(chunk, cols, device), -(-n // chunk) * chunk)


def pad_chunks(x: torch.Tensor, rows: int) -> torch.Tensor:
    """(N, ...) -> (ceil(N / rows), rows, ...), zero rows padding the last
    chunk: the reference's pad before its `lax.map` over chunks. Each
    row's result depends on that row alone, so the caller crops the
    padding's rows off the result."""
    pad = (-x.shape[0]) % rows
    if pad:
        x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
    return x.unflatten(0, (-1, rows))


@full_f32()
def nearest_neighbors(query: torch.Tensor, ref: torch.Tensor,
                      ref_valid=None, chunk: int = 2048):
    """For each query point, index + squared distance of the nearest ref
    point.

    query (N, 3), ref (M, 3); ref_valid optional (M,) bool (padded refs get
    an infinite distance). Returns (idx (N,) int64, d2 (N,) float32).
    """
    r2 = torch.sum(ref * ref, dim=1)
    if ref_valid is not None:
        r2 = torch.where(ref_valid, r2, torch.full_like(r2, float("inf")))
    rows = rows_per_chunk(chunk, ref.shape[0], query.device)
    idx, d2 = [], []
    for qc in torch.split(query, rows):
        q2 = torch.sum(qc * qc, dim=1)
        d = q2[:, None] + r2[None, :] - 2.0 * qc @ ref.T
        i = torch.argmin(d, dim=1)
        idx.append(i)
        d2.append(torch.clamp(torch.gather(d, 1, i[:, None])[:, 0], min=0.0))
    return torch.cat(idx), torch.cat(d2)
