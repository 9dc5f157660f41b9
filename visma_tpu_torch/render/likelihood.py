"""Edge-based object-pose likelihood evaluation (port of
visma_tpu/render/likelihood.py).

Render a batch of pose hypotheses -> depth -> edge maps, and score each
against the observed edge evidence: a truncated-chamfer likelihood on a
distance transform of the observed edges (mean truncated distance from
rendered edge pixels to the nearest observed edge), symmetrized with an
edge-coverage term. All of it is plain PyTorch, as it is plain XLA in the
reference; the edge maps come from the `depth_edge` kernel.

The scoring functions take any leading batch dimensions on the rendered
maps; `dt` and the observed edges broadcast against them, so one call
scores the windows of several objects, each against its own crop.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from visma_tpu_torch.image.edges import depth_edge


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


def occlusion_aware_edge_score(rendered_depth: torch.Tensor,
                               occluder_depth: Optional[torch.Tensor],
                               dt: torch.Tensor,
                               observed_edges: torch.Tensor,
                               tau: float = 10.0, radius: int = 2,
                               coverage_weight: float = 5.0,
                               obs_mass: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Score pose hypotheses of objects in a multi-object scene.

    rendered_depth (..., B, H, W): hypothesis depth renders of an object;
    occluder_depth (..., H, W): joint z-buffer of all other objects at
    their current poses (+inf where none; None for no occluders at all,
    which scores the same as an all-inf buffer); dt, observed_edges
    (..., H, W).
    The leading dimensions, when present, index objects. Edges are taken
    on the composited min-depth, so the occluding contour between an
    object and its occluders is rendered where the real depth
    discontinuity is; edges attributable only to the occluders (constant
    across hypotheses) are subtracted, so they neither add chamfer mass
    nor fake coverage."""
    if occluder_depth is None:
        attributable = depth_edge(rendered_depth)
    else:
        occ = occluder_depth.unsqueeze(-3)
        e_joint = depth_edge(torch.minimum(rendered_depth, occ))
        e_occ = depth_edge(occ)     # one stencil pass, broadcast below
        attributable = torch.clamp(e_joint - e_occ, min=0.0)
    return symmetric_edge_score(
        attributable, dt.unsqueeze(-3), observed_edges.unsqueeze(-3),
        tau=tau, radius=radius, coverage_weight=coverage_weight,
        obs_mass=obs_mass)


def scene_depth(renderers, poses_cm):
    """Joint z-buffer over N objects: renderers[i] (mesh set) at pose
    poses_cm[i] (3,4)/(4,4) model->camera. Returns (joint (H,W) depth with
    +inf background, per-object depth stack (N,H,W)). Per-object
    visibility masks are `(stack == joint) & isfinite(joint)`."""
    ds = torch.stack([r.render_depth(p) for r, p in zip(renderers, poses_cm)])
    return ds.amin(dim=0), ds


def score_hypotheses(renderer, g_cm, observed_edges: torch.Tensor,
                     tau: float = 10.0, dt_iters: int = 32) -> torch.Tensor:
    """Full likelihood pass: batch-render pose hypotheses and
    chamfer-score them against observed edges. renderer: a Renderer with
    its mesh set; g_cm (B,3,4) model->camera hypotheses; observed_edges
    (H, W) in [0,1]. Returns (B,) scores (lower = better)."""
    dt = edge_distance_transform(observed_edges, iters=dt_iters)
    return chamfer_score(renderer.render_edge(g_cm), dt, tau=tau)


__all__ = ["edge_distance_transform", "chamfer_score",
           "symmetric_edge_score", "occlusion_aware_edge_score",
           "scene_depth", "score_hypotheses"]
