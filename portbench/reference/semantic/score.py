"""The edge score's plain reference: depth edges, the distance transform
of the evidence, and the occlusion-aware truncated chamfer with coverage.

Frozen copies, at 43be5d3, of visma_tpu_torch/image/edges.py
(`soft_threshold`, `depth_edge_plain`) and of
visma_tpu_torch/render/likelihood.py (`edge_distance_transform`,
`chamfer_score`, `symmetric_edge_score`, `_score_args`,
`edge_score_plain`). Part of the benchmark's plain reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

THRESH_LOW = 0.05   # edge_detection.frag:14
THRESH_HIGH = 0.10  # edge_detection.frag:15
BORDER = 5          # edge_detection.frag:43-44


def soft_threshold(value: torch.Tensor, lo: float = THRESH_LOW,
                   hi: float = THRESH_HIGH) -> torch.Tensor:
    """<lo -> 0, >=hi -> 1, else linear ramp (edge_detection.frag:22-26)."""
    return torch.clamp((value - lo) / (hi - lo), 0.0, 1.0)


def depth_edge_plain(depth: torch.Tensor, lo: float = THRESH_LOW,
                     hi: float = THRESH_HIGH) -> torch.Tensor:
    """Plain PyTorch twin of the depth-edge kernel: depth (..., H, W)
    linear metric depth, background <= 0 or non-finite."""
    depth = depth.to(torch.float32)
    H, W = depth.shape[-2:]
    v = torch.where(torch.isfinite(depth) & (depth > 0), depth,
                    torch.full_like(depth, -1.0))
    vp = F.pad(v, (1, 1, 1, 1))

    def s(dy, dx):
        return vp[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    # delta = .25*(|W-E| + |S-N| + |NW-SE| + |SW-NE|), added in this order
    delta = 0.25 * (torch.abs(s(0, -1) - s(0, 1))
                    + torch.abs(s(1, 0) - s(-1, 0))
                    + torch.abs(s(-1, -1) - s(1, 1))
                    + torch.abs(s(1, -1) - s(-1, 1)))
    out = soft_threshold(delta, lo, hi)
    row = torch.arange(H, device=depth.device)[:, None]
    col = torch.arange(W, device=depth.device)[None, :]
    inside = ((col >= BORDER) & (col <= W - 1 - BORDER)
              & (row >= BORDER) & (row <= H - 1 - BORDER))
    return torch.where((v > 0) & inside, out, torch.zeros_like(out))


def edge_distance_transform(edges: torch.Tensor, threshold: float = 0.5,
                            iters: Optional[int] = None) -> torch.Tensor:
    """Approximate Euclidean distance transform of an edge map (H, W): a
    truncated 8-neighbour min-plus relaxation, d <- min(d, shift(d) + 1,
    diagonal shift + sqrt 2), `iters` sweeps (default 32), each sweep its
    eight shifts in the reference's order on the running d. `iters` bounds
    the propagation radius; scoring truncates distances anyway. Shifts
    take `big` = H + W from outside the frame."""
    H, W = edges.shape
    big = float(H + W)
    dp = torch.full((H + 2, W + 2), big, dtype=torch.float32,
                    device=edges.device)
    d = dp[1:-1, 1:-1]                      # a view: sweeps update dp in place
    d.copy_(torch.where(edges > threshold, 0.0, big))
    s2 = float(torch.sqrt(torch.tensor(2.0, dtype=torch.float32)))
    shifts = ((1, 0, 1.0), (-1, 0, 1.0), (0, 1, 1.0), (0, -1, 1.0),
              (1, 1, s2), (1, -1, s2), (-1, 1, s2), (-1, -1, s2))
    for _ in range(32 if iters is None else iters):
        for dy, dx, cost in shifts:
            # the neighbour at (row - dy, col - dx), as roll by (dy, dx)
            nb = dp[1 - dy:1 - dy + H, 1 - dx:1 - dx + W] + cost
            torch.minimum(d, nb, out=d)
    return d.clone()


def chamfer_score(rendered_edges: torch.Tensor, dt: torch.Tensor,
                  tau: float = 10.0) -> torch.Tensor:
    """Truncated-chamfer score for rendered edge map(s) (..., H, W) against
    an observed-edge distance transform (H, W) (or one broadcastable to the
    maps). Lower is better; returns (...) mean truncated distance over
    rendered edge pixels (tau when a hypothesis renders no edges)."""
    w = rendered_edges
    num = torch.sum(w * torch.clamp(dt, max=tau), dim=(-2, -1))
    den = torch.sum(w, dim=(-2, -1))
    return torch.where(den > 0, num / torch.clamp(den, min=1e-6),
                       torch.full_like(den, tau))


def symmetric_edge_score(rendered_edges: torch.Tensor, dt: torch.Tensor,
                         observed_edges: torch.Tensor, tau: float = 10.0,
                         radius: int = 2, coverage_weight: float = 5.0,
                         obs_mass: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Chamfer + coverage: penalize hypotheses whose renders leave observed
    edges unexplained. Coverage = fraction of observed edge mass within
    `radius` px of a rendered edge (a (2r+1)-square max-pool, padded with
    -inf as the reference's SAME window).

    obs_mass: pass the full-frame observed edge mass when dt and
    observed_edges are ROI windows: the coverage numerator is local to the
    rendered edges, but the denominator must stay global for window scores
    to equal full-frame scores."""
    base = chamfer_score(rendered_edges, dt, tau)
    H, W = rendered_edges.shape[-2:]
    k = 2 * radius + 1
    dil = F.max_pool2d(rendered_edges.reshape(-1, 1, H, W), k, stride=1,
                       padding=radius).reshape(rendered_edges.shape)
    denom = torch.sum(observed_edges) if obs_mass is None else obs_mass
    cov = torch.sum(torch.clamp(dil, max=1.0) * observed_edges,
                    dim=(-2, -1)) / torch.clamp(denom, min=1e-6)
    return base + coverage_weight * (1.0 - cov)


def _score_args(rendered_depth, occluder_depth, dt, observed_edges,
                radius):
    """Check edge_score's arguments: rendered_depth (n, S, H, W); the
    occluder windows (n, H, W) or None; dt and observed_edges (n, H, W) or
    (H, W). Raises ValueError. Returns (n, S, H, W)."""
    if rendered_depth.dim() != 4:
        raise ValueError("edge_score: rendered_depth must be (n, S, H, W), "
                         f"got {tuple(rendered_depth.shape)}")
    n, S, H, W = rendered_depth.shape
    if not 0 <= radius <= 2:
        raise ValueError(f"edge_score: radius must be 0, 1 or 2, got {radius}")
    if occluder_depth is not None and tuple(occluder_depth.shape) != (n, H, W):
        raise ValueError(f"edge_score: occluders {tuple(occluder_depth.shape)}"
                         f" do not match windows {(n, H, W)}")
    for name, t in (("dt", dt), ("observed_edges", observed_edges)):
        if tuple(t.shape) not in ((n, H, W), (H, W)):
            raise ValueError(f"edge_score: {name} {tuple(t.shape)} does not "
                             f"match windows {(n, H, W)}")
    return n, S, H, W


def edge_score_plain(rendered_depth: torch.Tensor,
                     occluder_depth: Optional[torch.Tensor],
                     dt: torch.Tensor, observed_edges: torch.Tensor,
                     tau: float = 10.0, radius: int = 2,
                     coverage_weight: float = 5.0,
                     obs_mass=None) -> torch.Tensor:
    """Plain PyTorch twin of the edge-score kernel: the composition of
    `depth_edge_plain`, the subtraction of the occluders' own edges and
    `symmetric_edge_score`. Arguments as `edge_score`."""
    _score_args(rendered_depth, occluder_depth, dt, observed_edges, radius)
    if occluder_depth is None:
        attributable = depth_edge_plain(rendered_depth)
    else:
        occ = occluder_depth.unsqueeze(-3)
        e_joint = depth_edge_plain(torch.minimum(rendered_depth, occ))
        e_occ = depth_edge_plain(occ)     # one stencil pass, broadcast below
        attributable = torch.clamp(e_joint - e_occ, min=0.0)
    if obs_mass is None:
        # each object's own evidence mass, as the reference's per-object call
        obs_mass = torch.sum(observed_edges, dim=(-2, -1)).reshape(-1, 1)
    elif not isinstance(obs_mass, torch.Tensor):
        obs_mass = torch.tensor(float(obs_mass), dtype=torch.float32,
                                device=rendered_depth.device)
    elif obs_mass.dim() > 0:
        obs_mass = obs_mass.reshape(-1, 1)
    return symmetric_edge_score(
        attributable, dt.unsqueeze(-3), observed_edges.unsqueeze(-3),
        tau=tau, radius=radius, coverage_weight=coverage_weight,
        obs_mass=obs_mass)
