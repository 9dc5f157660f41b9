"""Camera intrinsics and depth conventions for the renderer (port of
visma_tpu/render/camera.py).

CV convention throughout (+z forward, +y down, pixel (0,0) top left).
Metric depth with +inf background is the native output; `to_gl_depth`
converts to the GL nonlinear depth-buffer values the reference renderer
returns, for parity tests.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Intrinsics:
    fx: float
    fy: float
    cx: float
    cy: float
    rows: int
    cols: int
    z_near: float = 0.05
    z_far: float = 5.0

    @classmethod
    def from_K(cls, K, rows: int, cols: int, z_near: float = 0.05,
               z_far: float = 5.0) -> "Intrinsics":
        return cls(float(K[0][0]), float(K[1][1]), float(K[0][2]),
                   float(K[1][2]), rows, cols, z_near, z_far)


def to_gl_depth(depth: torch.Tensor, z_near: float,
                z_far: float) -> torch.Tensor:
    """Metric depth (+inf background) -> GL depth-buffer value in [0,1]
    (background -> 1.0), the inverse of image.edges.linearize_gl_depth."""
    z = torch.clamp(depth, z_near, z_far)
    a = (z_far + z_near) / (z_far - z_near)
    b = -2.0 * z_far * z_near / (z_far - z_near)
    gl = 0.5 * ((a + b / z) + 1.0)
    return torch.where(torch.isfinite(depth), gl, torch.ones_like(gl))
