"""Surface sampling (reference parity: geometry.h:29-64
SamplePointCloudFromMesh). A copy of visma_tpu/eval/sampling.py, numpy
only: the reference's `eval` package imports jax.

Area-weighted triangle selection + uniform barycentric sampling,
vectorized. Divergence documented: the reference samples barycentric
(a, b) uniform on the unit square without folding (geometry.h:55-57),
which puts half the samples OUTSIDE the triangle (on the parallelogram
extension); we fold (a, b) -> (1-a, 1-b) when a+b>1 to sample the triangle
uniformly — the intended behavior.
"""
from __future__ import annotations

import numpy as np


def sample_mesh(V: np.ndarray, F: np.ndarray, num_points: int,
                seed: int = 0) -> np.ndarray:
    """(num_points, 3) uniform samples on the surface."""
    V = np.asarray(V, np.float64)
    F = np.asarray(F, np.int64)
    v0, v1, v2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    total = area.sum()
    if total <= 0:
        return np.zeros((num_points, 3))
    rng = np.random.default_rng(seed)
    tri = rng.choice(len(F), size=num_points, p=area / total)
    a = rng.random(num_points)
    b = rng.random(num_points)
    flip = a + b > 1.0
    a = np.where(flip, 1.0 - a, a)
    b = np.where(flip, 1.0 - b, b)
    return (v0[tri] + a[:, None] * (v1[tri] - v0[tri])
            + b[:, None] * (v2[tri] - v0[tri]))
