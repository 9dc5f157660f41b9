"""Error metrics (port of visma_tpu/eval/metrics.py; reference parity:
include/geometry.h:80-180, evaluation.cpp:307-329).

Surface error is a chunked brute-force point-to-triangle distance in
PyTorch (the reference's is XLA code, no Pallas kernel). `_pm_dist_aos` is
the pairwise form and the exactness oracle; `_pm_dist`, the production
path, takes every region field from one (chunk, 3) @ (3, 4T) product and
re-evaluates the two best triangles exactly. The reference jits both and
maps the chunks with `lax.map` (visma_tpu/eval/metrics.py:105-219): here
each is an eager prologue (the per-triangle constants) and a loop over
query chunks, P padded to whole chunks and the result cropped. On a CUDA
device the loop replays one chunk captured into a CUDA graph
(`utils.graphs.StepGraph`, the constants its unchanged state; one graph
per triangle count and chunk, whatever the number of points, in an LRU of
`_CACHE_SIZE`); `graph=False` runs the same chunks eagerly. A row's result
depends on that row alone, so on a CUDA device the chunk grows
(`nn.map_rows`: 1024 rows times the whole multiples that keep a chunk's
(rows, T) field within `nn.CUDA_TILE_ELEMS` entries, 6144 rows against the
10,164-face bench scene, and no more than the points fill) without
changing the answer. Products run at full
float32 precision (`full_f32`: no TF32), the reference's
`Precision.HIGHEST`.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from visma_tpu_torch.align.nn import map_rows, pad_chunks
from visma_tpu_torch.eval.sampling import sample_mesh
from visma_tpu_torch.utils.graphs import loop_runner
from visma_tpu_torch.utils.misc import as_f32, full_f32, resolve_device


# the chunk loops' StepGraphs by (form, triangles, rows): each keeps a
# private pool that holds a chunk's fields, 6,956 MB at 6,144 rows x 10,164
# faces on the H100, for a replay 2% faster than the eager chunks (the loop
# is bound by its fields, not by launches), so only the most recently used
# is kept, and `release_graphs()` drops it
_RUNS: OrderedDict = OrderedDict()
_CACHE_SIZE = 1


def release_graphs() -> None:
    """Drop the cached surface-distance graph with its memory pool
    (`torch.cuda.empty_cache()` then returns the memory to the card)."""
    _RUNS.clear()


@dataclass
class ErrorMetric:
    mean: float
    std: float
    median: float
    min: float
    max: float

    def to_json(self) -> Dict[str, float]:
        """Key layout of the reference's save_metric (evaluation.cpp:339-345)."""
        return {"mean": self.mean, "std": self.std, "median": self.median,
                "min": self.min, "max": self.max}

    def scaled(self, s: float) -> "ErrorMetric":
        return ErrorMetric(self.mean * s, self.std * s, self.median * s,
                           self.min * s, self.max * s)


def compute_error_metric(errors: np.ndarray) -> ErrorMetric:
    """Matches reference ComputeErrorMetric (geometry.h:86-101) including
    the population std and the sorted[n >> 1] median; numpy."""
    e = np.asarray(errors, np.float64)
    if e.size == 0:
        return ErrorMetric(0.0, 0.0, 0.0, 0.0, 0.0)
    mean = float(e.mean())
    std = float(np.sqrt(np.maximum((e * e).mean() - mean * mean, 0.0)))
    srt = np.sort(e)
    return ErrorMetric(mean=mean, std=std, median=float(srt[len(srt) >> 1]),
                       min=float(e.min()), max=float(e.max()))


def _safe(x):
    return torch.where(torch.abs(x) < 1e-30, torch.full_like(x, 1e-30), x)


def _point_triangle_d2(p, a, b, c):
    """Squared distance point -> triangle, broadcast over leading dims
    (Ericson, Real-Time Collision Detection §5.1.5, branch-free)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = torch.sum(ab * ap, -1)
    d2 = torch.sum(ac * ap, -1)
    bp = p - b
    d3 = torch.sum(ab * bp, -1)
    d4 = torch.sum(ac * bp, -1)
    cp = p - c
    d5 = torch.sum(ab * cp, -1)
    d6 = torch.sum(ac * cp, -1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom_pl = torch.clamp(va + vb + vc, min=1e-30)
    v_face = vb / denom_pl
    w_face = vc / denom_pl

    # edge/vertex clamps
    zero = torch.zeros_like(d1)
    v_ab = torch.clamp(torch.where(d1 - d3 != 0, d1 / _safe(d1 - d3), zero),
                       0.0, 1.0)
    v_ac = torch.clamp(d2 / _safe(d2 - d6), 0.0, 1.0)
    v_bc = torch.clamp((d4 - d3) / _safe((d4 - d3) + (d5 - d6)), 0.0, 1.0)

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0) & ~in_a & ~in_b
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0) & ~in_a & ~in_c
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0) & ~in_b & ~in_c

    q = a + v_face[..., None] * ab + w_face[..., None] * ac
    q = torch.where(on_bc[..., None], b + v_bc[..., None] * (c - b), q)
    q = torch.where(on_ac[..., None], a + v_ac[..., None] * ac, q)
    q = torch.where(on_ab[..., None], a + v_ab[..., None] * ab, q)
    q = torch.where(in_c[..., None], c, q)
    q = torch.where(in_b[..., None], b, q)
    q = torch.where(in_a[..., None], a, q)
    return torch.sum((p - q) ** 2, -1)


def _chunk_map(form: str, body, consts, P, chunk: int, cols: int,
               graph: Optional[bool]) -> torch.Tensor:
    """`body` over P's chunks (`map_rows` rows against `cols` columns a
    query; P padded, the result cropped), the constants as the loop's
    unchanged state."""
    rows = map_rows(chunk, P.shape[0], cols, P.device)
    run = loop_runner(_RUNS, (form, consts[0].shape[0], rows), body, graph,
                      P.device, _CACHE_SIZE)
    _, out = run(consts, pad_chunks(P, rows))
    return out.reshape(-1)[:P.shape[0]]


def _aos_body(state, pc):
    A, B, C = state
    return state, torch.amin(_point_triangle_d2(pc[:, None, :], A[None],
                                                B[None], C[None]), dim=1)


def _pm_dist_aos(P, A, B, C, chunk: int = 1024,
                 graph: Optional[bool] = None) -> torch.Tensor:
    """Pairwise (chunk, T, 3) form: squared distance of each point of P to
    the nearest of the triangles (A, B, C). The exactness oracle."""
    return _chunk_map("aos", _aos_body, (A, B, C), P, chunk, 3 * A.shape[0],
                      graph)


def _soa_body(state, pc):
    """One chunk of `_pm_dist`: the region fields from one product, the
    exact re-evaluation of each point's two best triangles."""
    (A, B, C, M, a_ab, b_ab, c_ab, a_ac, b_ac, c_ac, aa, bb, cc, abab,
     acac, bcbc, nn, na, big, tri) = state
    T = A.shape[0]
    F4 = pc @ M                                          # (chunk, 4T)
    pab, pac, pa, pn = (F4[:, :T], F4[:, T:2 * T],
                        F4[:, 2 * T:3 * T], F4[:, 3 * T:])
    pp = torch.sum(pc * pc, 1, keepdim=True)
    d1, d3, d5 = pab - a_ab, pab - b_ab, pab - c_ab
    d2_, d4, d6 = pac - a_ac, pac - b_ac, pac - c_ac
    va = d3 * d6 - d5 * d4
    vb = d5 * d2_ - d1 * d6
    vc = d1 * d4 - d3 * d2_
    in_a = (d1 <= 0) & (d2_ <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0) & ~in_a & ~in_b
    on_ac = (vb <= 0) & (d2_ >= 0) & (d6 <= 0) & ~in_a & ~in_c
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0) & ~in_b & ~in_c
    dA = pp - 2 * pa + aa
    dB_ = pp - 2 * (pa + pab) + bb
    dC = pp - 2 * (pa + pac) + cc
    t1 = torch.clamp(d1 / _safe(d1 - d3), 0.0, 1.0)
    t2 = torch.clamp(d2_ / _safe(d2_ - d6), 0.0, 1.0)
    t3 = torch.clamp((d4 - d3) / _safe((d4 - d3) + (d5 - d6)), 0.0, 1.0)
    dAB = dA - 2 * t1 * d1 + t1 * t1 * abab
    dAC = dA - 2 * t2 * d2_ + t2 * t2 * acac
    dBC = dB_ - 2 * t3 * (d4 - d3) + t3 * t3 * bcbc
    dF = torch.where(nn > 1e-30, (pn - na) ** 2 / _safe(nn), big)
    d2_all = torch.where(on_bc, dBC, dF)
    d2_all = torch.where(on_ac, dAC, d2_all)
    d2_all = torch.where(on_ab, dAB, d2_all)
    d2_all = torch.where(in_c, dC, d2_all)
    d2_all = torch.where(in_b, dB_, d2_all)
    d2_all = torch.where(in_a, dA, d2_all)
    # exact re-evaluation of the two best candidates
    d2w = torch.clamp(d2_all, min=0.0)
    i = torch.argmin(d2w, dim=1)
    e1 = _point_triangle_d2(pc, A[i], B[i], C[i])
    d2w = torch.where(tri[None, :] == i[:, None],
                      torch.full_like(d2w, float("inf")), d2w)
    j = torch.argmin(d2w, dim=1)
    e2 = _point_triangle_d2(pc, A[j], B[j], C[j])
    return state, torch.minimum(e1, e2)


@full_f32()
def _pm_dist(P, A, B, C, chunk: int = 1024,
             graph: Optional[bool] = None) -> torch.Tensor:
    """Structure-of-arrays point-to-mesh squared distance (metrics.py:126).

    Every dot product of the region classification is affine in p, so the
    six region fields come from one (chunk, 3) @ (3, 4T) product (p.ab,
    p.ac, p.a, p.n) plus per-triangle constants; the two best triangles of
    each point are then re-evaluated with the exact pairwise formula. The
    pp - 2 p.a + aa form loses ~eps |p|^2 to cancellation, so triangles
    within ~|p| sqrt(eps) of the winner can swap rank: inputs are centred
    on the mesh centroid, and the reference documents a worst case of about
    1 mm near high-valence vertices (tests/test_eval.py:270).
    """
    center = torch.mean(A, dim=0)
    A, B, C = A - center, B - center, C - center
    ab, ac, bc = B - A, C - A, C - B
    nrm = torch.linalg.cross(ab, ac, dim=-1)
    M = torch.cat([ab.T, ac.T, A.T, nrm.T], dim=1)          # (3, 4T)
    T = A.shape[0]
    consts = (A, B, C, M,
              *(torch.sum(x * ab, 1) for x in (A, B, C)),
              *(torch.sum(x * ac, 1) for x in (A, B, C)),
              *(torch.sum(x * x, 1) for x in (A, B, C)),
              torch.sum(ab * ab, 1), torch.sum(ac * ac, 1),
              torch.sum(bc * bc, 1), torch.sum(nrm * nrm, 1),
              torch.sum(nrm * A, 1),
              torch.tensor(1e30, dtype=P.dtype, device=P.device),
              torch.arange(T, device=P.device))
    return _chunk_map("soa", _soa_body, consts, P - center, chunk, T, graph)


def point_mesh_distances(points: np.ndarray, V: np.ndarray, F: np.ndarray,
                         chunk: int = 1024, device=None) -> np.ndarray:
    """Unsigned distance of each point to the mesh surface (float64 numpy).
    Runs on the CUDA card unless `device` says otherwise."""
    dev = resolve_device(device)
    V = as_f32(V, dev)
    F = torch.as_tensor(np.asarray(F), dtype=torch.int64, device=dev)
    A, B, C = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    d2 = _pm_dist(as_f32(points, dev), A, B, C, chunk)
    return np.sqrt(d2.cpu().numpy().astype(np.float64))


def measure_surface_error(Vs, Fs, Vt, Ft, num_samples: int,
                          seed: int = 0, device=None) -> ErrorMetric:
    """Sample the source mesh, measure distances to the target mesh
    (geometry.h:118-141 semantics, AABB tree -> chunked brute force)."""
    pts = sample_mesh(Vs, Fs, num_samples, seed=seed)
    d = point_mesh_distances(pts, Vt, Ft, device=device)
    return compute_error_metric(d)


def measure_pose_error(Gs, Gt, dist_thresh: float = 0.5):
    """Translation + rotation error between matched object poses (numpy;
    geometry.h:148-180, with the reference's documented divergence: each
    source object's final best match is recorded once).

    Gs, Gt: lists of (3, 4) poses. Returns (translation ErrorMetric,
    rotation ErrorMetric [radians]).
    """
    t_err, r_err = [], []
    for Gsi in Gs:
        best, best_d = -1, dist_thresh
        for j, Gtj in enumerate(Gt):
            d = float(np.linalg.norm(Gtj[:3, 3] - Gsi[:3, 3]))
            if d < best_d:
                best_d, best = d, j
        if best >= 0:
            dR = Gt[best][:3, :3].T @ Gsi[:3, :3]
            angle = float(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
            t_err.append(best_d)
            r_err.append(angle)
    return compute_error_metric(np.asarray(t_err)), \
        compute_error_metric(np.asarray(r_err))
