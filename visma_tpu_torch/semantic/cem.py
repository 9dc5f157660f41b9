"""Cross-entropy-method SE(3) pose refinement by batched edge likelihood
(port of visma_tpu/semantic/cem.py).

Each iteration samples pose perturbations around the current mean in
se(3), renders and scores all of them in one batch, and refits the
sampling distribution to the elite fraction. The batched form refines all
objects jointly: per iteration one `chunk_raster_batched` launch renders
every object's hypothesis windows (and one more the occluder windows),
each after one `triangle_setup` call that builds its plane table and chunk
lists (on the card the kernel csrc/tri_setup.cu, two launches), and one
`edge_score` call scores them all: edges of the composited
windows minus the occluders' own, chamfer and coverage, in one kernel.
The loop stays on the device: nothing in it reads a value back to the
host.

What the reference has only for the TPU and the port has no counterpart
of: the pose-group cap (`_smem_group_cap`, the `G` of
`_raster_windows_batched` and `_raster_score_grouped`, set by the TPU's
scalar memory; here one launch takes every pose, so
`_raster_windows_batched` is `rasterize_depth_chunked_multi_roi` itself,
and the windows of an iteration are rendered and then scored in one
batch), and the choice between an unrolled loop and `fori_loop`.

The reference's jitted executors, cached on the renderer with the mesh
stack closed over, are here captured CUDA graphs (`utils.graphs.CallGraph`)
cached the same way: `fused_cem_executor` replays the whole fused CEM of
a call, `retrieval_executor` one detection's retrieval scores
(`retrieval_scores`), and `MultiMeshRenderer.set_stack` drops both caches
with the mesh stack they read by address.

Random numbers: the fused body draws from a `torch.Generator` on the
device, which cannot reproduce `jax.random`; its `noise` argument takes
the standard-normal draws from outside, so that a test can feed both
implementations the same numbers. The executor makes the same draws from
the generator before each replay, outside the graph, and hands them in as
`noise`: the graph and the eager body take the same numbers. The
host-refit oracle (`device_loop=False`) draws from
`numpy.random.default_rng(seed)` as the reference does, draw for draw.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from visma_tpu_torch.geom.lie import SE3
from visma_tpu_torch.render.likelihood import (edge_distance_transform,
                                               occlusion_aware_edge_score)
from visma_tpu_torch.render.raster import (
    rasterize_depth_chunked_multi, rasterize_depth_chunked_multi_roi)
from visma_tpu_torch.utils.graphs import CallGraph, wants_graph
from visma_tpu_torch.utils.misc import device_constant, resolve_device
from visma_tpu_torch.utils.trace import stage

# Shared CEM schedule constants: the mapper's async path and the defaults
# of refine_pose_cem_batched must agree (async == sync parity).
CEM_TAU = 10.0
CEM_ELITE_FRAC = 0.25


def cem_n_elite(samples: int, elite_frac: float = CEM_ELITE_FRAC) -> int:
    return max(2, int(samples * elite_frac))


def _sigma6(init_sigma, n: int) -> np.ndarray:
    """(rot, trans) sigmas -> (n, 6) tangent sigmas [trans x3, rot x3]."""
    return np.tile(np.concatenate([np.full(3, init_sigma[1]),
                                   np.full(3, init_sigma[0])]
                                  ).astype(np.float32), (n, 1))


def refine_pose_cem(renderer, observed_edges: torch.Tensor,
                    init_pose: np.ndarray,
                    iters: int = 6, samples: int = 64,
                    elite_frac: float = CEM_ELITE_FRAC,
                    init_sigma: Tuple[float, float] = (0.15, 0.08),
                    yaw_only: bool = False, seed: int = 0,
                    tau: float = CEM_TAU,
                    occluder_depth: Optional[torch.Tensor] = None,
                    ) -> Tuple[np.ndarray, float]:
    """Refine a (3,4) or (4,4) model->camera pose against observed edges
    with a single-mesh `Renderer` (host refit, one object).

    init_sigma: (rotation rad, translation m) initial sampling stddevs.
    yaw_only: restrict rotation sampling to the camera-Y axis.
    occluder_depth: optional (H, W) joint depth of all other scene objects;
    when given, hypotheses are scored occlusion-aware.
    Returns (refined (3,4) pose, best score)."""
    dev = renderer.device
    obs = torch.as_tensor(observed_edges, dtype=torch.float32, device=dev)
    dt = edge_distance_transform(obs)
    n_elite = cem_n_elite(samples, elite_frac)
    rng = np.random.default_rng(seed)

    mean = SE3.from_matrix3x4(torch.as_tensor(
        np.asarray(init_pose)[:3, :4], dtype=torch.float32, device=dev))
    sig = _sigma6(init_sigma, 1)[0]
    if yaw_only:
        sig[3] = sig[5] = 1e-4

    best_pose, best_score = mean.matrix3x4().cpu().numpy(), np.inf
    for _ in range(iters):
        xi = rng.standard_normal((samples, 6)).astype(np.float32) * sig
        xi[0] = 0.0  # always include the current mean
        # RIGHT-multiplied perturbations: rotations act about the model
        # frame (object center), not the camera origin
        hyps = (SE3(mean.R[None], mean.t[None])
                @ SE3.exp(torch.as_tensor(xi, device=dev))).matrix3x4()
        occ = None if occluder_depth is None else torch.as_tensor(
            occluder_depth, dtype=torch.float32, device=dev)
        scores = occlusion_aware_edge_score(renderer.render_depth(hyps), occ,
                                            dt, obs, tau=tau)
        scores = scores.cpu().numpy()

        order = np.argsort(scores)
        elite = xi[order[:n_elite]]
        if scores[order[0]] < best_score:
            best_score = float(scores[order[0]])
            best_pose = hyps[int(order[0])].cpu().numpy()

        mu = elite.mean(axis=0)
        sig = elite.std(axis=0) * 1.1 + 1e-4
        if yaw_only:
            sig[3] = sig[5] = 1e-4
        mean = mean @ SE3.exp(torch.as_tensor(mu, device=dev))

    return best_pose, best_score


# ---------------------------------------------------------------------------
# Batched multi-object CEM
# ---------------------------------------------------------------------------

def _se3_exp_np(xi: np.ndarray) -> np.ndarray:
    """Numpy SE(3) exp, (...,6) [rho, w] -> (...,4,4) in float64: the host
    mirror of geom.lie.SE3.exp for the host-refit oracle."""
    xi = np.asarray(xi, np.float64)
    rho, w = xi[..., :3], xi[..., 3:]
    th = np.linalg.norm(w, axis=-1, keepdims=True)[..., None]  # (...,1,1)
    K = np.zeros((*xi.shape[:-1], 3, 3))
    K[..., 0, 1], K[..., 0, 2] = -w[..., 2], w[..., 1]
    K[..., 1, 0], K[..., 1, 2] = w[..., 2], -w[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -w[..., 1], w[..., 0]
    K2 = K @ K
    eye = np.broadcast_to(np.eye(3), K.shape)
    small = th < 1e-6
    ths = np.where(small, 1.0, th)
    A = np.where(small, 1.0 - th**2 / 6.0, np.sin(ths) / ths)
    B = np.where(small, 0.5 - th**2 / 24.0, (1 - np.cos(ths)) / ths**2)
    C = np.where(small, 1.0 / 6.0 - th**2 / 120.0,
                 (ths - np.sin(ths)) / ths**3)
    R = eye + A * K + B * K2
    V = eye + B * K + C * K2
    t = (V @ rho[..., None])[..., 0]
    out = np.zeros((*xi.shape[:-1], 4, 4))
    out[..., :3, :3] = R
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def _roi_origins(t_cm: torch.Tensor, intr, roi) -> torch.Tensor:
    """Window top-left (x0, y0) per object: centered on the projected
    object origin (rounded half to even), clipped inside the image. t_cm
    (n,3) camera-frame object centers; returns (n,2) float32 with integral
    values."""
    z = torch.clamp(t_cm[:, 2], min=1e-3)
    u = intr.fx * t_cm[:, 0] / z + intr.cx
    v = intr.fy * t_cm[:, 1] / z + intr.cy
    ox = torch.clamp(torch.round(u - roi[1] / 2), 0, intr.cols - roi[1])
    oy = torch.clamp(torch.round(v - roi[0] / 2), 0, intr.rows - roi[0])
    return torch.stack([ox, oy], dim=1).to(torch.float32)


def _crop(img: torch.Tensor, origins: torch.Tensor, roi) -> torch.Tensor:
    """Windows of (roi[0], roi[1]) at global top-lefts origins (n,2) =
    (x0, y0), gathered on the device (no value is read back): img (H,W)
    gives every window from the one image, img (n,H,W) window i from
    image i. Returns (n, roi[0], roi[1])."""
    dev = img.device
    org = origins.to(torch.long)
    rows = org[:, 1, None] + torch.arange(roi[0], device=dev)      # (n,Hr)
    cols = org[:, 0, None] + torch.arange(roi[1], device=dev)      # (n,Wr)
    if img.dim() == 2:
        return img[rows[:, :, None], cols[:, None, :]]
    idx = torch.arange(img.shape[0], device=dev)[:, None, None]
    return img[idx, rows[:, :, None], cols[:, None, :]]


@device_constant
def _others_index(n: int, device) -> torch.Tensor:
    """For each of n objects the indices of the other n-1, flattened to
    n*(n-1), on the device (cached: building it copies from the host)."""
    return torch.as_tensor(
        np.array([[j for j in range(n) if j != i] for i in range(n)]),
        device=device).reshape(-1)


def _raster_score_grouped(Cs, mesh_idx, flat, org, occ_w, dt_w, obs_w,
                          obs_mass, intr, roi, tau, n, S, radius: int = 2):
    """ROI raster + score over n*S hypotheses: all windows of the
    iteration in one launch, then one batched score per object against its
    own occluder / dt / evidence windows. Returns (n, S) scores."""
    with stage("cem.raster", flat.device):
        mi_all = torch.repeat_interleave(mesh_idx, S)
        d = rasterize_depth_chunked_multi_roi(Cs, flat, mi_all, org, intr,
                                              roi)
    with stage("cem.score", flat.device):
        return occlusion_aware_edge_score(
            d.reshape(n, S, roi[0], roi[1]), occ_w, dt_w, obs_w, tau=tau,
            obs_mass=obs_mass, radius=radius)


def _render_score_nS(Cs, mesh_idx, mean_R, mean_t, xi, occ, dt, obs, intr,
                     tau, roi=None, origins=None, occ_poses=None, radius=2):
    """Render + score all (n, S) hypotheses of n objects. Returns
    (hyp34 (n,S,3,4), scores (n,S)).

    Cs: face corners of the padded mesh stack; mesh_idx (n,); mean_R
    (n,3,3), mean_t (n,3); xi (n,S,6) tangent perturbations
    (RIGHT-multiplied); occ (n,H,W) per-track occluder depth or None for
    no occluders; dt/obs (H,W).

    roi (Hr,Wr) + origins (n,2): render and score each object's hypotheses
    inside a fixed-size screen window instead of the full frame. Exact for
    footprints inside the window (chamfer mass lives on rendered pixels;
    the coverage denominator stays the global edge mass).

    occ_poses (n,3,4), ROI path only: instead of cropping a precomputed
    full-frame occluder z-buffer, render each track's occluders (the other
    n-1 objects at these frame-start poses) directly into its window:
    n*(n-1) window renders in one launch. Identical values: a windowed
    render equals the full-frame render cropped at the same origin."""
    n, S = xi.shape[:2]
    hyp = SE3(mean_R[:, None], mean_t[:, None]) @ SE3.exp(xi)      # (n,S)
    poses = hyp.matrix3x4()
    flat = poses.reshape(n * S, 3, 4)
    if roi is None:
        mi = torch.repeat_interleave(mesh_idx, S)
        depths = rasterize_depth_chunked_multi(Cs, flat, mi, intr)
        scores = occlusion_aware_edge_score(
            depths.reshape(n, S, intr.rows, intr.cols), occ,
            dt.expand(n, -1, -1), obs.expand(n, -1, -1), tau=tau,
            radius=radius, obs_mass=torch.sum(obs))
        return poses, scores

    org = torch.repeat_interleave(origins, S, dim=0)               # (n*S, 2)
    obs_mass = torch.sum(obs)
    dt_w = _crop(dt, origins, roi)
    obs_w = _crop(obs, origins, roi)
    if occ_poses is not None and n > 1:
        oi = _others_index(n, xi.device)                           # n*(n-1)
        with stage("cem.occluders", xi.device):
            od = rasterize_depth_chunked_multi_roi(
                Cs, occ_poses[oi], mesh_idx[oi],
                torch.repeat_interleave(origins, n - 1, dim=0), intr, roi)
            occ_w = od.reshape(n, n - 1, roi[0], roi[1]).amin(dim=1)
    elif occ is not None:
        occ_w = _crop(occ, origins, roi)
    else:
        occ_w = None
    scores = _raster_score_grouped(Cs, mesh_idx, flat, org, occ_w, dt_w,
                                   obs_w, obs_mass, intr, roi, tau, n, S,
                                   radius=radius)
    return poses, scores


def retrieval_scores(mrenderer, roi, hyps, mi, org1, dt, em, box):
    """Detection-driven shape retrieval in a window: render B (mesh, yaw)
    candidate windows at one shared origin org1 (2,) and score them
    against the window-cropped evidence, with coverage counted only
    inside box = (x0, y0, x1, y1), whose mask is built on the device.
    Returns (B,) scores."""
    return _retrieval_scores(mrenderer.Cs, mrenderer.intr, roi, hyps, mi,
                             org1, dt, em, box)


def _retrieval_scores(Cs, intr, roi, hyps, mi, org1, dt, em, box):
    B = hyps.shape[0]
    dev = hyps.device
    with stage("retrieve", dev):
        origins = org1[None].expand(B, 2)
        d = rasterize_depth_chunked_multi_roi(Cs, hyps, mi, origins, intr,
                                              roi)
        dt_w = _crop(dt, org1[None], roi)[0]
        em_w = _crop(em, org1[None], roi)[0]
        yy = org1[1] + torch.arange(roi[0], dtype=torch.float32,
                                    device=dev)[:, None]
        xx = org1[0] + torch.arange(roi[1], dtype=torch.float32,
                                    device=dev)[None, :]
        in_box = ((xx >= box[0]) & (xx < box[2])
                  & (yy >= box[1]) & (yy < box[3]))
        return occlusion_aware_edge_score(
            d, None, dt_w, torch.where(in_box, em_w, torch.zeros_like(em_w)))


def retrieval_executor(mrenderer, roi, B: int):
    """`retrieval_scores` of B candidates in (roi) windows as a captured
    CUDA graph replayed once a detection (a `utils.graphs.CallGraph` on the
    renderer's mesh stack; on the CPU its buffers without capture), cached
    on the renderer keyed by (roi, B) as the reference's executor
    (visma_tpu/semantic/cem.py:329-372) and dropped with the mesh stack.
    Called as `retrieval_scores` is, without its first two arguments; the
    box stays a tensor, so no detection's numbers are captured."""
    cache = mrenderer.__dict__.setdefault("_retr_exec_cache", {})
    k = (roi, B)
    if k not in cache:
        Cs, intr = mrenderer.Cs, mrenderer.intr
        cache[k] = CallGraph(
            lambda hyps, mi, org1, dt, em, box: _retrieval_scores(
                Cs, intr, roi, hyps, mi, org1, dt, em, box))
    return cache[k]


def _draw(generator, shape, device) -> torch.Tensor:
    """Standard-normal draws of the fused body, from the generator."""
    return torch.randn(shape, dtype=torch.float32, device=device,
                       generator=generator)


def _cem_fused_body(Cs, mesh_idx, R0, t0, sig0, occ, obs, generator, intr,
                    tau, iters, samples, n_elite, roi=None, occ_poses=None,
                    radius=2, noise=None):
    """The whole batched CEM on the device: sampling, render, score, elite
    refit and best-pose tracking, `iters` iterations with no host read.
    roi: optional (Hr, Wr) screen window per object, recentered on the
    current mean's projected center every iteration. noise: optional
    (iters, n, samples, 6) standard-normal draws used instead of the
    generator. Returns (best_pose (n,3,4), best_score (n,))."""
    n = R0.shape[0]
    dev = R0.device
    # sweeps sized to the truncation: chamfer takes min(dt, tau), so any
    # pixel farther than the propagation radius reads as big -> tau
    with stage("cem.edt", dev):
        dt = edge_distance_transform(obs, iters=int(tau) + 6)
    idx = torch.arange(n, device=dev)

    mean_R, mean_t, sig = R0, t0, sig0
    best_pose = torch.cat([R0, t0[:, :, None]], dim=2)
    best_score = torch.full((n,), float("inf"), dtype=torch.float32,
                            device=dev)
    for it in range(iters):
        with stage("cem.select", dev):
            # plain normal sampling, not antithetic pairs: antithetic
            # elites cancel in the mean refit and stall the CEM
            z = (_draw(generator, (n, samples, 6), dev) if noise is None
                 else noise[it])
            xi = z * sig[:, None, :]
            xi[:, 0] = 0.0  # always include the current mean
            # ...and the best-so-far pose, expressed in the current mean's
            # tangent: re-anchors the search when the mean wanders and
            # makes the best score monotone by construction
            mean = SE3(mean_R, mean_t)
            xi[:, 1] = (mean.inv() @ SE3.from_matrix3x4(best_pose)).log()
            origins = None if roi is None else _roi_origins(mean_t, intr,
                                                            roi)
        hyp34, scores = _render_score_nS(
            Cs, mesh_idx, mean_R, mean_t, xi, occ, dt, obs, intr, tau,
            roi=roi, origins=origins, occ_poses=occ_poses, radius=radius)
        with stage("cem.select", dev):
            order = torch.argsort(scores, dim=1, stable=True)
            top = order[:, 0]
            top_score = scores[idx, top]
            better = top_score < best_score
            best_pose = torch.where(better[:, None, None], hyp34[idx, top],
                                    best_pose)
            best_score = torch.minimum(best_score, top_score)

            elite = xi[idx[:, None], order[:, :n_elite]]           # (n,E,6)
            sig = elite.std(dim=1, unbiased=False) * 1.1 + 1e-4
            step = mean @ SE3.exp(elite.mean(dim=1))
            mean_R, mean_t = step.R, step.t
    return best_pose, best_score


OCC_MODES = ("poses", "depths", "none")


class _CemExecutor:
    """The fused CEM of one schedule as a captured CUDA graph (see
    `fused_cem_executor`)."""

    def __init__(self, mrenderer, tau, iters, samples, n_elite, roi,
                 occ_mode, radius):
        Cs, intr = mrenderer.Cs, mrenderer.intr
        self.iters, self.samples, self.occ_mode = iters, samples, occ_mode

        def body(mesh_idx, R0, t0, sig0, obs, noise, occ=None):
            return _cem_fused_body(
                Cs, mesh_idx, R0, t0, sig0,
                occ if occ_mode == "depths" else None, obs, None, intr, tau,
                iters, samples, n_elite, roi=roi,
                occ_poses=occ if occ_mode == "poses" else None,
                radius=radius, noise=noise)

        self.graph = CallGraph(body)

    def __call__(self, mesh_idx, R0, t0, sig0, obs, occ=None,
                 generator=None, noise=None):
        """(best poses (n,3,4), best scores (n,)) as `_cem_fused_body`
        returns them. occ: the occluder poses (n,3,4) for "poses", the
        occluder depths (n,H,W) for "depths", None for "none". The draws
        come from `generator` (`iters` calls of `_draw`, in the body's
        order) unless noise (iters, n, samples, 6) is given."""
        if (occ is None) != (self.occ_mode == "none"):
            raise ValueError(f"fused_cem_executor: occluders given to, or "
                             f"missing from, occ_mode {self.occ_mode!r}")
        if noise is None:
            shape = (R0.shape[0], self.samples, 6)
            noise = [_draw(generator, shape, R0.device)
                     for _ in range(self.iters)]
        else:
            noise = list(noise)
        args = (mesh_idx, R0, t0, sig0, obs, noise)
        return self.graph(*args) if occ is None else self.graph(*args, occ)


def fused_cem_executor(mrenderer, tau, iters, samples, n_elite, roi,
                       occ_mode, radius=2):
    """The fused CEM (`_cem_fused_body`) of one schedule as a captured CUDA
    graph replayed once a call (a `utils.graphs.CallGraph` on the
    renderer's mesh stack, keyed further by the number of objects and the
    device; on the CPU its buffers without capture). Cached on the
    renderer keyed by every static knob, as the reference's executor
    (visma_tpu/semantic/cem.py:508-551), and dropped with the mesh stack.
    occ_mode: "poses" (in-window occluder renders; requires roi),
    "depths" (precomputed occluder z-buffers) or "none"."""
    if occ_mode not in OCC_MODES:
        raise ValueError(f"fused_cem_executor: occ_mode {occ_mode!r} is "
                         f"not one of {OCC_MODES}")
    if occ_mode == "poses" and roi is None:
        raise ValueError("fused_cem_executor: occ_mode 'poses' requires roi")
    cache = mrenderer.__dict__.setdefault("_cem_exec_cache", {})
    k = (tau, iters, samples, n_elite, roi, occ_mode, radius)
    if k not in cache:
        cache[k] = _CemExecutor(mrenderer, tau, iters, samples, n_elite,
                                roi, occ_mode, radius)
    return cache[k]


def _cem_run(mrenderer, graphed, mesh_idx, R0, t0, sig0, occ, obs,
             generator, tau, iters, samples, n_elite, roi, occ_poses, radius,
             noise=None):
    """The fused CEM on the renderer's mesh stack, through its executor's
    graph when `graphed`, else the eager body; arguments as
    `_cem_fused_body`'s."""
    if not graphed:
        return _cem_fused_body(
            mrenderer.Cs, mesh_idx, R0, t0, sig0, occ, obs, generator,
            mrenderer.intr, tau, iters, samples, n_elite, roi=roi,
            occ_poses=occ_poses, radius=radius, noise=noise)
    mode = ("poses" if occ_poses is not None
            else "depths" if occ is not None else "none")
    run = fused_cem_executor(mrenderer, tau, iters, samples, n_elite, roi,
                             mode, radius)
    return run(mesh_idx, R0, t0, sig0, obs,
               occ=occ_poses if occ_poses is not None else occ,
               generator=generator, noise=noise)


def _clip_roi(roi, intr):
    """A window no larger than the frame; None when it is the frame."""
    if roi is None:
        return None
    roi = (min(int(roi[0]), intr.rows), min(int(roi[1]), intr.cols))
    return None if roi == (intr.rows, intr.cols) else roi


def refine_pose_cem_batched(mrenderer, observed_edges,
                            init_poses, mesh_idx,
                            iters: int = 6, samples: int = 48,
                            elite_frac: float = CEM_ELITE_FRAC,
                            init_sigma: Tuple[float, float] = (0.15, 0.08),
                            seed: int = 0, tau: float = CEM_TAU,
                            occluder_depths: Optional[torch.Tensor] = None,
                            device_loop: bool = True,
                            roi: Optional[Tuple[int, int]] = None,
                            occluder_poses=None, radius: int = 2,
                            noise: Optional[torch.Tensor] = None,
                            device=None, graph: Optional[bool] = None):
    """Jointly refine n (3,4)/(4,4) model->camera poses of n objects.

    mrenderer: MultiMeshRenderer with the mesh database set; mesh_idx (n,)
    database indices; occluder_depths optional (n,H,W).
    device_loop=True (default) runs the entire CEM on the device
    (`_cem_fused_body`) and returns tensors there, without reading them
    back; device_loop=False keeps the host-refit loop (numpy refit, numpy
    results), the test oracle for the fused path.
    roi: optional (Hr, Wr) per-object screen window, exact when each
    object's footprint + search radius fits the window.
    occluder_poses (n,3,4), ROI mode only: frame-start model->camera poses
    from which each track's occluder z-buffer is rendered inside its
    window per iteration; pass this instead of occluder_depths to avoid a
    separate full-frame occluder render.
    noise: optional (iters, n, samples, 6) standard-normal draws for the
    device loop. device: where to run, which must be where the renderer
    holds its meshes; None means the CUDA card, and raises without one.
    graph: how the device loop runs, as `utils.graphs.wants_graph` reads
    it: None replays `fused_cem_executor`'s graph on a CUDA device and
    runs the eager body on the CPU; True or False asks for the executor or
    the eager body.
    Returns (poses (n,3,4), scores (n,))."""
    dev = resolve_device(device)
    if dev.type != mrenderer.device.type:
        raise ValueError(f"refine_pose_cem_batched: device {dev} is not the "
                         f"renderer's {mrenderer.device}")
    intr = mrenderer.intr
    roi = _clip_roi(roi, intr)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    poses0 = f32(init_poses)[:, :3, :4]
    n = poses0.shape[0]
    if occluder_poses is not None and n == 1:
        occluder_poses = None       # a single object has no occluders
    if occluder_poses is not None and roi is None:
        raise ValueError("occluder_poses requires roi mode; pass "
                         "occluder_depths for full-frame refinement")
    obs = f32(observed_edges)
    mi = torch.as_tensor(mesh_idx, device=dev).to(torch.int64)
    occ_poses = None if occluder_poses is None else \
        f32(occluder_poses).reshape(n, -1, 4)[:, :3]
    occ = None if occluder_depths is None or occ_poses is not None \
        else f32(occluder_depths)
    n_elite = cem_n_elite(samples, elite_frac)
    if device_loop:
        gen = None
        if noise is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        return _cem_run(
            mrenderer, wants_graph(graph, dev), mi,
            poses0[:, :, :3].contiguous(), poses0[:, :, 3].contiguous(),
            f32(_sigma6(init_sigma, n)), occ, obs, gen, tau, iters, samples,
            n_elite, roi, occ_poses, radius, noise)

    dt = edge_distance_transform(obs)
    rng = np.random.default_rng(seed)
    init_np = poses0.cpu().numpy()
    mean_R = init_np[:, :, :3].copy()
    mean_t = init_np[:, :, 3].copy()
    sig = _sigma6(init_sigma, n)
    best_pose = init_np.copy()
    best_score = np.full(n, np.inf)
    for _ in range(iters):
        xi = rng.standard_normal((n, samples, 6)).astype(np.float32) \
            * sig[:, None, :]
        xi[:, 0] = 0.0  # always include the current means
        # the window is recentered on the current mean each iteration, as
        # in the fused body
        origins = None if roi is None else _roi_origins(f32(mean_t), intr,
                                                        roi)
        scores = _render_score_nS(
            mrenderer.Cs, mi, f32(mean_R), f32(mean_t), f32(xi), occ, dt,
            obs, intr, tau, roi=roi, origins=origins, occ_poses=occ_poses,
            radius=radius)[1].cpu().numpy()                        # (n,S)

        order = np.argsort(scores, axis=1)
        G_mean = np.zeros((n, 4, 4))
        G_mean[:, :3, :3] = mean_R
        G_mean[:, :3, 3] = mean_t
        G_mean[:, 3, 3] = 1.0
        hyp = np.einsum("nij,nsjk->nsik", G_mean, _se3_exp_np(xi))
        for i in range(n):
            top = order[i, 0]
            if scores[i, top] < best_score[i]:
                best_score[i] = float(scores[i, top])
                best_pose[i] = hyp[i, top, :3, :4]
            elite = xi[i, order[i, :n_elite]]
            mu = elite.mean(axis=0)
            sig[i] = elite.std(axis=0) * 1.1 + 1e-4
            step = G_mean[i] @ _se3_exp_np(mu)
            mean_R[i], mean_t[i] = step[:3, :3], step[:3, 3]

    return best_pose, best_score
