"""Diagnosis of the semantic bench scene (port of tools/diag_semantic.py):
each object's error split into its along-ray and lateral parts, and the
settled steady state's window timings, with the executors replayed from
their CUDA graphs and with the eager mapper (`graph=False`) on the same
frames. bench.py::bench_semantic's scene, with knobs.

    python -m visma_tpu_torch.tools.diag_semantic [--frames 27]
        [--roi 256 256] [--iters 3] [--samples 24] [--window 8]
        [--modes graph eager] [--device cpu]

Each mode starts a mapper with the four tracks placed near the ground
truth, steps `--warmup` frames, then times windows of `--window` frames,
each drained (`_sync_dev`) before the clock stops.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from visma_tpu_torch.tools.common import card_line
from visma_tpu_torch.utils.platform import configure_platform

NAMES = ["chair", "desk", "chair", "desk"]


def gwc_at(i: int) -> np.ndarray:
    return np.hstack([np.eye(3), np.array([[0.015 * i], [0.0], [0.0]])])


def scene():
    """(intr, mesh db, ground-truth model->world poses, the rng the track
    placements draw from next): the bench camera, chair and desk."""
    from scipy.spatial.transform import Rotation

    from visma_tpu_torch.io.procedural import bench_mesh_db
    from visma_tpu_torch.render import Intrinsics

    intr = Intrinsics(fx=486.405, fy=535.401, cx=469.199, cy=257.916,
                      rows=500, cols=960, z_near=0.05, z_far=8.0)
    rng = np.random.default_rng(3)
    slots = [(-1.5, 2.75), (-0.65, 3.1), (0.65, 3.1), (1.5, 2.75)]
    T_gt = []
    for k in range(4):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("y", rng.uniform(-0.6, 0.6)
                                        ).as_matrix()
        x, z = slots[k]
        T[:3, 3] = [x, rng.uniform(-0.1, 0.1), z]
        T_gt.append(T)
    return intr, bench_mesh_db(), T_gt, rng


def edge_frames(mapper, T_gt, n_frames: int) -> torch.Tensor:
    """The ground-truth edge map of every frame (n_frames, H, W)."""
    from visma_tpu_torch.image.edges import depth_edge

    all_poses = np.empty((n_frames, 4, 3, 4), np.float32)
    for i in range(n_frames):
        G = np.eye(4)
        G[:3, :4] = gwc_at(i)
        G_cw = np.linalg.inv(G)
        all_poses[i] = np.stack([(G_cw @ T)[:3, :4] for T in T_gt])
    mi = np.tile([mapper.mrenderer.index(n) for n in NAMES], (n_frames, 1))
    d = mapper.mrenderer.render_depth(torch.as_tensor(all_poses), mi)
    return depth_edge(torch.amin(d, dim=1))


def errors(mapper, T_gt, last: int) -> list:
    """Each object's error: |t|, its along-ray and lateral parts (the view
    ray at frame `last`), rotation in degrees."""
    from scipy.spatial.transform import Rotation

    out = []
    G = np.eye(4)
    G[:3, :4] = gwc_at(last)
    Gi = np.linalg.inv(G)
    for k in range(4):
        T = mapper.tracks[k].pose_wm
        dt_w = T[:3, 3] - T_gt[k][:3, 3]
        c_c = Gi[:3, :3] @ T_gt[k][:3, 3] + Gi[:3, 3]
        ray_w = G[:3, :3] @ (c_c / np.linalg.norm(c_c))
        along = float(np.dot(dt_w, ray_w))
        out.append({"object": k, "model": NAMES[k],
                    "t_m": float(np.linalg.norm(dt_w)), "along_ray_m": along,
                    "lateral_m": float(np.linalg.norm(dt_w - along * ray_w)),
                    "rot_deg": float(np.degrees(Rotation.from_matrix(
                        T[:3, :3] @ T_gt[k][:3, :3].T).magnitude()))})
    return out


def run_mode(graph: bool, device, args, log=print) -> dict:
    """One mapper over the scene: warm-up frames, drained windows, errors."""
    from scipy.spatial.transform import Rotation

    from visma_tpu_torch.semantic import SemanticMapper
    from visma_tpu_torch.semantic.mapper import ObjectTrack

    intr, db, T_gt, rng = scene()
    mapper = SemanticMapper(intr, db, cem_iters=5, cem_samples=48,
                            roi=tuple(args.roi), settle_age=2,
                            settled_iters=args.iters,
                            settled_samples=args.samples,
                            settled_sigma=tuple(args.sigma),
                            async_frames=args.async_frames,
                            coverage_radius=args.radius, device=device,
                            graph=graph)
    edges = edge_frames(mapper, T_gt, args.frames)
    for k in range(4):
        T0 = T_gt[k].copy()
        T0[:3, 3] += rng.uniform(-0.08, 0.08, 3)
        T0[:3, :3] = T0[:3, :3] @ Rotation.from_euler(
            "y", rng.uniform(-0.12, 0.12)).as_matrix()
        mapper.tracks[k] = ObjectTrack(oid=k, model_name=NAMES[k],
                                       pose_wm=T0)
    mapper._next_id = 4
    t0 = time.perf_counter()
    for i in range(args.warmup):
        mapper.step(gwc_at(i), edges[i])
    mapper._sync_dev()
    warm_s = time.perf_counter() - t0
    W, i, per_frame = args.window, args.warmup, []
    while i + W <= args.frames:
        t0 = time.perf_counter()
        for j in range(i, i + W):
            mapper.step(gwc_at(j), edges[j])
        mapper._sync_dev()
        per_frame.append((time.perf_counter() - t0) / W * 1e3)
        i += W
    mapper.finalize()
    res = {"mode": "graph" if graph else "eager", "warmup_s": warm_s,
           "window_ms_per_frame": per_frame,
           "errors": errors(mapper, T_gt, i - 1)}
    if per_frame:
        log(f"{res['mode']}: window ms/frame "
            f"{[round(x, 2) for x in per_frame]} (best {min(per_frame):.2f}"
            f" -> {1e3 / min(per_frame):.2f} fps)")
    for e in res["errors"]:
        log(f"  obj{e['object']} {e['model']:5s} |t|={e['t_m']:.4f} m "
            f"along-ray={e['along_ray_m']:+.4f} lateral={e['lateral_m']:.4f}"
            f" rot={e['rot_deg']:.2f} deg")
    return res


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=27)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--window", type=int, default=8,
                    help="settled measurement window (frames per rep)")
    ap.add_argument("--roi", type=int, nargs=2, default=[256, 256])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--samples", type=int, default=24)
    ap.add_argument("--sigma", type=float, nargs=2, default=[0.05, 0.03])
    ap.add_argument("--async-frames", type=int, default=16)
    ap.add_argument("--radius", type=int, default=2)
    ap.add_argument("--modes", nargs="+", default=["graph", "eager"],
                    choices=["graph", "eager"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = configure_platform(args.device)
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    log(card_line(dev))
    out = [run_mode(m == "graph", dev, args, log=log) for m in args.modes]
    print(json.dumps({"modes": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
