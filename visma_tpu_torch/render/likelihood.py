"""Edge-based object-pose likelihood evaluation (port of
visma_tpu/render/likelihood.py).

Render a batch of pose hypotheses -> depth -> edge maps, and score each
against the observed edge evidence: a truncated-chamfer likelihood on a
distance transform of the observed edges (mean truncated distance from
rendered edge pixels to the nearest observed edge), symmetrized with an
edge-coverage term.

`edge_score` is the whole occlusion-aware score of a batch of depth
windows. On a CUDA tensor it is one call of the hand-written kernel
`vt_edge_score` (csrc/depth_edge.cu, which shares its stencil with
`depth_edge`); on a CPU tensor it runs `edge_score_plain`, the
composition of `depth_edge`, the max-pool and the reductions in plain
PyTorch. `occlusion_aware_edge_score` routes to it. The reference fuses
the same composition in XLA and has no kernel for it.

The scoring functions take any leading batch dimensions on the rendered
maps; `dt` and the observed edges broadcast against them, so one call
scores the windows of several objects, each against its own crop.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from visma_tpu_torch import _kernels
from visma_tpu_torch.image.edges import (BORDER, THRESH_HIGH, THRESH_LOW,
                                          depth_edge_plain)


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


def _object_windows(t: torch.Tensor):
    """A (n, H, W) or (H, W) float32 tensor as (contiguous tensor, stride
    between objects in elements): stride 0 for one window shared by all
    objects, also when the objects' dimension is an expanded view."""
    if t.dim() == 3 and t.stride(0) != 0 and t.shape[0] > 1:
        t = t.to(torch.float32).contiguous()
        return t, t.shape[-2] * t.shape[-1]
    one = t if t.dim() == 2 else t[0]
    return one.to(torch.float32).contiguous(), 0


def edge_score(rendered_depth: torch.Tensor,
               occluder_depth: Optional[torch.Tensor],
               dt: torch.Tensor, observed_edges: torch.Tensor,
               tau: float = 10.0, radius: int = 2,
               coverage_weight: float = 5.0, obs_mass=None) -> torch.Tensor:
    """Occlusion-aware edge score of hypothesis depth windows, lower is
    better.

    rendered_depth (n, S, H, W): S depth windows of each of n objects
    (background: <= 0, NaN or inf); occluder_depth (n, H, W): the joint
    depth of each object's occluders in its window (+inf where none), or
    None; dt, observed_edges (n, H, W), or (H, W) for all objects: the
    truncated distance transform of the evidence and the evidence itself;
    radius <= 2: the coverage dilation; obs_mass: the evidence mass that
    normalises the coverage (a number, a 0-d tensor or one value an
    object), None for each object's own `observed_edges` sum. Returns (n,
    S) scores.

    A CPU tensor takes the plain version; a CUDA tensor is one kernel call
    (two launches: the tiles' sums, then the scores) or raises."""
    n, S, H, W = _score_args(rendered_depth, occluder_depth, dt,
                             observed_edges, radius)
    if rendered_depth.device.type == "cpu":
        return edge_score_plain(rendered_depth, occluder_depth, dt,
                                observed_edges, tau, radius, coverage_weight,
                                obs_mass)
    if n * S == 0 or H * W == 0:
        raise ValueError("edge_score kernel: empty input")
    if n * S > 65535:
        raise ValueError(f"edge_score kernel: at most 65535 windows, got "
                         f"{n * S}")
    d = rendered_depth.to(torch.float32).contiguous()
    occ, occ_stride = (None, 0) if occluder_depth is None \
        else _object_windows(occluder_depth)
    dtw, dt_stride = _object_windows(dt)
    obw, obs_stride = _object_windows(observed_edges)
    if obs_mass is None:
        mass = torch.sum(obw, dim=(-2, -1)).reshape(-1)
        mass_stride, mass_value = (1 if obs_stride else 0), 0.0
    elif isinstance(obs_mass, torch.Tensor):
        mass = obs_mass.to(device=d.device, dtype=torch.float32).reshape(-1)
        if mass.numel() not in (1, n):
            raise ValueError(f"edge_score: obs_mass has {mass.numel()} "
                             f"values for {n} objects")
        mass = mass.contiguous()
        mass_stride, mass_value = (0 if mass.numel() == 1 else 1), 0.0
    else:
        mass, mass_stride, mass_value = None, 0, float(obs_mass)
    ins = [t for t in (d, occ, dtw, obw, mass) if t is not None]
    _kernels.require_cuda("edge_score", *ins)
    tiles = -(-H // 32) * -(-W // 64)
    partial = torch.empty((n * S, tiles, 3), dtype=torch.float32,
                          device=d.device)
    scores = torch.empty((n, S), dtype=torch.float32, device=d.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    rc = _kernels.library().vt_edge_score(
        d.data_ptr(), ptr(occ), occ_stride, dtw.data_ptr(), dt_stride,
        obw.data_ptr(), obs_stride, ptr(mass), mass_stride, mass_value,
        partial.data_ptr(), scores.data_ptr(), n, S, H, W, int(radius),
        THRESH_LOW, THRESH_HIGH - THRESH_LOW, BORDER, float(tau),
        float(coverage_weight),
        _kernels.vec4(W, *[t for t in (d, occ, dtw, obw) if t is not None]),
        _kernels.stream_of(d))
    _kernels.check(rc, "edge_score")
    edge_score.launches += 1
    return scores


_kernels.counted(edge_score)


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
    (..., H, W), or (H, W) for every object.
    The leading dimensions, when present, index objects. Edges are taken
    on the composited min-depth, so the occluding contour between an
    object and its occluders is rendered where the real depth
    discontinuity is; edges attributable only to the occluders (constant
    across hypotheses) are subtracted, so they neither add chamfer mass
    nor fake coverage. obs_mass None: each object's own evidence mass.
    One `edge_score` call for all objects."""
    lead = rendered_depth.shape[:-3]
    B, H, W = rendered_depth.shape[-3:]

    def objects(t):
        return t if t.dim() == 2 else t.reshape(-1, H, W)

    scores = edge_score(
        rendered_depth.reshape(-1, B, H, W),
        None if occluder_depth is None
        else occluder_depth.reshape(-1, H, W),
        objects(dt), objects(observed_edges), tau=tau, radius=radius,
        coverage_weight=coverage_weight, obs_mass=obs_mass)
    return scores.reshape(*lead, B)


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
           "symmetric_edge_score", "edge_score", "edge_score_plain",
           "occlusion_aware_edge_score",
           "scene_depth", "score_hypotheses"]
