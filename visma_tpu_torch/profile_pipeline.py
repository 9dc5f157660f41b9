"""Where the port's VIO pipeline spends its time on the GPU.

    python -m visma_tpu_torch.profile_pipeline [--frames 60] [--eager]

Synthesises the bench scene's imagery (500x960 adversarial frames + IMU,
bench.py:67-88, the first `--frames` frames) and runs `VioPipeline.run`
over it: by default the graphed run (the step captured once into a CUDA
graph and replayed a frame), with `--eager` the eager loop
(`graph=False`). One run warms up (and captures), one is timed with the
host clock (synchronised), one is traced with torch.profiler behind an
untraced run and a marker kernel (`utils.trace.traced`: late in a process
the profiler drops a trace's first device records), its device ops held
to the host's launches. Prints, per frame: wall time, device busy time,
device operations beside the host's count, the device's idle share of the
profiler-off run, and the top operators by device and by host time. A
replay runs no Python, so the graphed run has no `frontend` / `filter`
ranges: its numbers come from the device operations alone. With
`--eager` it also prints the host time of the step's two ranges and what
the ranges themselves cost with the profiler off: the eager run with its
`record_function` spans against the same run with `record_function` bound
to a null context, in alternating pairs, and a span entered and left
alone. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import time

import numpy as np
import torch

import visma_tpu_torch.pipeline as pipeline
from visma_tpu_torch.io.synthetic import SyntheticConfig, make_imu
from visma_tpu_torch.io.synthetic_images import render_adversarial_frames
from visma_tpu_torch.filter.config import FilterConfig
from visma_tpu_torch.pipeline import VioPipeline
from visma_tpu_torch.utils.trace import traced

RANGES = ("frontend", "filter")
SPAN_REPS = 100_000
SPAN_PAIRS = 8


def host_ms(fn, n):
    """Host ms a frame of fn() over n frames, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--eager", action="store_true",
                    help="profile the eager loop (graph=False) and time "
                         "its record_function spans")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_pipeline: needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())

    syn = SyntheticConfig(num_frames=args.frames, num_landmarks=240,
                          rows=500, cols=960, fx=486.405, fy=535.401,
                          cx=469.199, cy=257.916, seed=7)
    cfg = FilterConfig(window=8, max_tracks=96, max_updates=24, fx=syn.fx,
                       fy=syn.fy, cx=syn.cx, cy=syn.cy, pixel_noise=1.0)
    frames, gwc, _ = render_adversarial_frames(syn)
    imu = make_imu(syn)
    spf = imu["samples_per_frame"]
    N = args.frames - 1
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    images = t(frames[1:])
    gyro = t(imu["gyro"][: N * spf].reshape(N, spf, 3))
    accel = t(imu["accel"][: N * spf].reshape(N, spf, 3))
    dts = t(np.full((N, spf), float(np.diff(imu["ts_state"])[0])))
    pipe = VioPipeline(cfg, levels=4, cell=32, device=dev,
                       graph=False if args.eager else None)
    st0 = pipe.init(t(frames[0]), R0=gwc[0, :, :3], p0=gwc[0, :, 3],
                    v0=imu["v0"])

    def run():
        return pipe.run(st0, images, gyro, accel, dts)

    mode = "eager loop" if args.eager else "graph"
    t0 = time.perf_counter()
    run()                                       # warm-up (and capture)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    wall_ms = host_ms(run, N)
    if pipe.run_graph is not None:
        print(f"captured {pipe.run_graph.captures} graph(s) in "
              f"{pipe.run_graph.capture_ms[0]:.1f} ms (host); the first "
              f"run with its warm-up frames took {first_ms:.1f} ms")

    trace = traced(run, annotations=RANGES, cpu=args.eager)
    counts = trace.check() + "".join(
        f"; a take before lost records: {x}" for x in trace.lost)
    busy, dev_total = trace.busy_ms()
    dev_ms, n_ops = busy / N, len(trace.ops) / N
    print(f"frames {N}; wall {wall_ms:.3f} ms/frame through "
          f"VioPipeline.run, {mode} (host clock, synchronised, profiler off)")
    print(f"trace: {counts}")
    if args.eager:
        host = {k: ms / N for k, ms in trace.host_ms(RANGES).items()}
        print(f"host time in ranges (profiler on): frontend "
              f"{host.get('frontend', 0.0):.3f} ms/frame, filter "
              f"{host.get('filter', 0.0):.3f} ms/frame")
        # what a span costs the host with the profiler off: entered and
        # left SPAN_REPS times alone, then the eager run with its spans
        # against the same run with record_function bound to a null
        # context, SPAN_PAIRS pairs, the first of a pair alternating
        t0 = time.perf_counter()
        for _ in range(SPAN_REPS):
            with pipeline.record_function("frontend"):
                pass
        span_us = (time.perf_counter() - t0) / SPAN_REPS * 1e6
        spans = {True: [], False: []}
        for k in range(SPAN_PAIRS):
            for with_spans in ((True, False) if k % 2 == 0
                               else (False, True)):
                saved = pipeline.record_function
                if not with_spans:
                    pipeline.record_function = contextlib.nullcontext
                try:
                    spans[with_spans].append(host_ms(run, N))
                finally:
                    pipeline.record_function = saved
        q = {k: np.percentile(v, [25, 50, 75]) for k, v in spans.items()}
        print(f"record_function spans, profiler off: {span_us:.3f} us a span "
              f"alone, two a frame = {2 * span_us / 1e3:.4f} ms/frame; the "
              f"eager run over {SPAN_PAIRS} pairs, median (quartiles) with "
              f"spans {q[True][1]:.3f} ({q[True][0]:.3f}-{q[True][2]:.3f}), "
              f"without {q[False][1]:.3f} ({q[False][0]:.3f}-"
              f"{q[False][2]:.3f}) ms/frame")
    print(f"device busy {dev_ms:.3f} ms/frame ({dev_total / N:.3f} summed "
          f"over {n_ops:.1f} device ops/frame); idle share "
          f"{1 - dev_ms / wall_ms:.3f} of the profiler-off run")
    print("top device ops (us a frame, count a frame):")
    for name, us, c in trace.top():
        print(f"  {us / N:10.2f} {c / N:7.1f}  {name[:90]}")
    print("top host events by time, nested time included (us a frame, "
          "count a frame):")
    for name, us, c in trace.host_top():
        print(f"  {us / N:10.2f} {c / N:7.1f}  {name[:90]}")


if __name__ == "__main__":
    main()
