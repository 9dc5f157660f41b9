"""Where the port's semantic mapper spends a settled frame on the GPU.

    python -m visma_tpu_torch.profile_semantic [--frames 29] [--eager]

Builds the semantic bench scene (bench.py:170-207: 500x960, the procedural
chair and desk, 4 objects, `SemanticMapper(roi=(256, 384), cem 5x48,
settled 3x24, async_frames=16, roi_spawn=True)`), renders its ground-truth
edge frames with the port's own renderer, spawns from detections on frame
0, lets the tracks settle for 5 frames, then times the settled steps over
drained 8-frame windows with the host clock and traces one window with
torch.profiler. By default the mapper replays its executors' CUDA graphs
(captured by `warmup`; a replay runs no Python, so only the mapper's own
range `semantic.refine` shows host time); with `--eager` it runs them
eagerly (`graph=False`), with the CEM's ranges. Prints, per settled
frame: wall time, the host time of the mapper's and the CEM's ranges,
device busy time, the device's idle share, device operations, and the top
operators by device and by host time. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from visma_tpu_torch.image.edges import depth_edge
from visma_tpu_torch.io.procedural import bench_mesh_db
from visma_tpu_torch.io.synthetic_semantic import (BENCH_INTRINSICS,
                                                   bench_scene, gt_detections)
from visma_tpu_torch.render.camera import Intrinsics
from visma_tpu_torch.semantic import SemanticMapper

RANGES = ("semantic.refine", "semantic.edt", "semantic.occluders",
          "semantic.raster", "semantic.score")
WINDOW = 8
WARM = 5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=WARM + 3 * WINDOW)
    ap.add_argument("--eager", action="store_true",
                    help="profile the eager mapper (graph=False), with the "
                         "CEM's ranges")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_semantic: needs a CUDA device")
    if args.frames < WARM + 2 * WINDOW:
        raise SystemExit(f"profile_semantic: --frames >= {WARM + 2 * WINDOW}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())

    intr = Intrinsics(**BENCH_INTRINSICS)
    mapper = SemanticMapper(intr, bench_mesh_db(), cem_iters=5,
                            cem_samples=48, roi=(256, 384),
                            retrieval_yaws=24, settle_age=2, settled_iters=3,
                            settled_samples=24, settled_sigma=(0.05, 0.03),
                            async_frames=16, roi_spawn=True,
                            graph=False if args.eager else None)
    names, T_gt, yaw_gt, gwc_at, poses = bench_scene(args.frames)
    mi = np.array([mapper.mrenderer.index(n) for n in names])
    warm_s = mapper.warmup(len(names))
    print(f"{'eager mapper' if args.eager else 'graph'}: warmup "
          f"{warm_s:.2f} s, {mapper.captures} captures in "
          f"{[round(ms, 1) for ms in mapper.capture_ms]} ms (host)")
    d = mapper.mrenderer.render_depth(
        poses, np.broadcast_to(mi, poses.shape[:2]).copy())
    edges = depth_edge(d.amin(dim=1))
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    mapper.step(gwc_at(0), edges[0],
                bboxes=gt_detections(mapper._mesh_aabb, intr, names, yaw_gt,
                                     poses[0]))
    torch.cuda.synchronize()
    spawn_ms = (time.perf_counter() - t0) * 1e3
    for i in range(1, WARM):
        mapper.step(gwc_at(i), edges[i])
    mapper._sync_dev()

    def window(i0):
        for j in range(i0, i0 + WINDOW):
            mapper.step(gwc_at(j), edges[j])
        mapper._sync_dev()
        torch.cuda.synchronize()

    walls, i = [], WARM
    while i + 2 * WINDOW <= args.frames:     # the last window is traced
        t0 = time.perf_counter()
        window(i)
        walls.append((time.perf_counter() - t0) / WINDOW * 1e3)
        i += WINDOW
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        window(i)
    mapper.finalize()
    terr = [float(np.linalg.norm(mapper.tracks[o].pose_wm[:3, 3]
                                 - T_gt[k][:3, 3]))
            for k, o in enumerate(sorted(mapper.tracks))]

    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA
                 and e.key not in RANGES]         # kernels, memcpy, memset
    dev_ms = sum(e.self_device_time_total for e in on_device) / WINDOW / 1e3
    n_ops = sum(e.count for e in on_device) / WINDOW
    host = {e.key: e.cpu_time_total / WINDOW / 1e3 for e in events
            if e.device_type == DeviceType.CPU and e.key in RANGES}
    wall = min(walls)
    print(f"spawn frame {spawn_ms:.1f} ms; settled windows ms/frame "
          f"{[round(w, 3) for w in walls]} (host clock, drained and "
          f"synchronised, profiler off); translation errors "
          f"{[round(x, 4) for x in terr]} m")
    print("host time in ranges, ms/frame (profiler on): "
          + ", ".join(f"{k} {host.get(k, 0.0):.3f}" for k in RANGES))
    print(f"device busy {dev_ms:.3f} ms/frame ({n_ops:.0f} device "
          f"ops/frame); idle share {1 - dev_ms / wall:.3f} of the best "
          f"profiler-off frame time {wall:.3f} ms")
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    print(events.table(sort_by="self_cpu_time_total", row_limit=15))


if __name__ == "__main__":
    main()
