"""Where the port's semantic mapper spends a settled frame on the GPU.

    python -m visma_tpu_torch.profile_semantic [--frames 37] [--eager]

Builds the semantic bench scene (bench.py:170-207: 500x960, the procedural
chair and desk, 4 objects, `SemanticMapper(roi=(256, 384), cem 5x48,
settled 3x24, async_frames=16, roi_spawn=True)`), renders its ground-truth
edge frames with the port's own renderer, spawns from detections on frame
0, lets the tracks settle for 5 frames, then times the settled steps over
drained 8-frame windows with the host clock and traces one window with
torch.profiler, behind a window run untraced and a marker kernel
(`utils.trace.traced`: late in a process the profiler drops a trace's
first device records), its device ops held to the host's launches. By
default the mapper replays its executors' CUDA graphs (captured by
`warmup`); with `--eager` it runs them eagerly (`graph=False`). Prints,
per settled frame: wall time, device busy time, the device's idle share,
device operations beside the host's count, the device time of the CEM's
stages (`cem.edt`, `cem.occluders`, `cem.raster`, `cem.score`,
`cem.select`: their marks are replayed with the graph) and of the
replays' unstaged remainder, the program's spans (`utils.trace`), the
trace's idle time named by the innermost span open on the host
(`host.gc` included), the top device operators, and a window with
recording off against one with `utils.trace.enable()`, in alternating
pairs. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from visma_tpu_torch.image.edges import depth_edge
from visma_tpu_torch.io.procedural import bench_mesh_db
from visma_tpu_torch.io.synthetic_semantic import (BENCH_INTRINSICS,
                                                   bench_scene, gt_detections)
from visma_tpu_torch.render.camera import Intrinsics
from visma_tpu_torch.semantic import SemanticMapper
from visma_tpu_torch.profile_pipeline import (print_breakdown,
                                              print_untraced_spans)
from visma_tpu_torch.utils import trace as tr
from visma_tpu_torch.utils.trace import traced

WINDOW = 8
PAIRS = 4
WARM = 5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=WARM + 4 * WINDOW)
    ap.add_argument("--eager", action="store_true",
                    help="profile the eager mapper (graph=False)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_semantic: needs a CUDA device")
    if args.frames < WARM + 3 * WINDOW:
        raise SystemExit(f"profile_semantic: --frames >= {WARM + 3 * WINDOW}")
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
    while i + 3 * WINDOW <= args.frames:     # the last two go to the trace
        t0 = time.perf_counter()
        window(i)
        walls.append((time.perf_counter() - t0) / WINDOW * 1e3)
        i += WINDOW
    trace = traced(lambda: window(i + WINDOW), warm=lambda: window(i))
    counts = trace.check() + "".join(
        f"; a take before lost records: {x}" for x in trace.lost)
    # recording off against on, over the frames the trace ran again (the
    # first window with recording on captures the marked variants)
    tr.enable()
    window(i)
    tr.disable()
    since = time.perf_counter_ns()
    runs = tr.off_against_on(lambda: window(i + WINDOW), PAIRS)
    mapper.finalize()
    terr = [float(np.linalg.norm(mapper.tracks[o].pose_wm[:3, 3]
                                 - T_gt[k][:3, 3]))
            for k, o in enumerate(sorted(mapper.tracks))]

    busy, dev_total = trace.busy_ms()
    dev_ms, n_ops = busy / WINDOW, len(trace.ops) / WINDOW
    wall = min(walls)
    print(f"spawn frame {spawn_ms:.1f} ms; settled windows ms/frame "
          f"{[round(w, 3) for w in walls]} (host clock, drained and "
          f"synchronised, profiler off); translation errors "
          f"{[round(x, 4) for x in terr]} m")
    print(f"trace: {counts}")
    print(f"device busy {dev_ms:.3f} ms/frame ({dev_total / WINDOW:.3f} "
          f"summed over {n_ops:.0f} device ops/frame); idle share "
          f"{1 - dev_ms / wall:.3f} of the best profiler-off frame time "
          f"{wall:.3f} ms")
    print_breakdown(trace, WINDOW, dev_total * 1e3 if args.eager
                    else trace.replay_us)
    print("top device ops (us a frame, count a frame):")
    for name, us, c in trace.top():
        print(f"  {us / WINDOW:10.2f} {c / WINDOW:7.1f}  {name[:90]}")
    q = {k: np.percentile(v, [25, 50, 75]) / WINDOW * 1e3
         for k, v in runs.items()}
    print(f"a settled window over {PAIRS} pairs, ms/frame median "
          f"(quartiles): recording off {q[False][1]:.4f} ({q[False][0]:.4f}-"
          f"{q[False][2]:.4f}), on {q[True][1]:.4f} ({q[True][0]:.4f}-"
          f"{q[True][2]:.4f})")
    print_untraced_spans(since, WINDOW * PAIRS)


if __name__ == "__main__":
    main()
