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
profiler-off run, the device time of the `frontend` and `filter` stages
(their marks are replayed with the graph) and of the replays' unstaged
remainder, the program's spans (`utils.trace`), the trace's idle time
named by the innermost span open on the host (`host.gc` included) and
the top device operators. Last, what recording costs: a span entered and
left alone, off and on, and the run with recording off against the run
with `utils.trace.enable()`, in alternating pairs. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from visma_tpu_torch.io.synthetic import SyntheticConfig, make_imu
from visma_tpu_torch.io.synthetic_images import render_adversarial_frames
from visma_tpu_torch.filter.config import FilterConfig
from visma_tpu_torch.pipeline import VioPipeline
from visma_tpu_torch.utils import trace as tr
from visma_tpu_torch.utils.trace import traced

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
                    help="profile the eager loop (graph=False)")
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

    trace = traced(run)
    counts = trace.check() + "".join(
        f"; a take before lost records: {x}" for x in trace.lost)
    busy, dev_total = trace.busy_ms()
    dev_ms, n_ops = busy / N, len(trace.ops) / N
    print(f"frames {N}; wall {wall_ms:.3f} ms/frame through "
          f"VioPipeline.run, {mode} (host clock, synchronised, profiler off)")
    print(f"trace: {counts}")
    print(f"device busy {dev_ms:.3f} ms/frame ({dev_total / N:.3f} summed "
          f"over {n_ops:.1f} device ops/frame); idle share "
          f"{1 - dev_ms / wall_ms:.3f} of the profiler-off run")
    print_breakdown(trace, N, dev_total * 1e3 if args.eager
                    else trace.replay_us)
    print("top device ops (us a frame, count a frame):")
    for name, us, c in trace.top():
        print(f"  {us / N:10.2f} {c / N:7.1f}  {name[:90]}")
    print_costs(run, N)


def print_breakdown(trace, n: int, work_us: float) -> None:
    """The stage split, the unstaged remainder of `work_us` (the device time
    of the replays, or of every operation when eager), the program's spans
    and the idle time by span, each a unit of n."""
    stages = trace.stages()
    staged = sum(ms for ms, _, _ in stages.values() if ms is not None)
    marks = trace.marks_us()
    print("stages (device ms a unit, segments, ops a segment): " + ", ".join(
        f"{k} {'varies' if ms is None else f'{ms / n:.4f}'} ({seg}, "
        f"{ops})" for k, (ms, seg, ops) in stages.items()))
    for k, top in trace.stage_top().items():
        print(f"  {k}'s top device ops (us a unit, count a unit): " + "; ".join(
            f"{name[:60]} {us / n:.2f} ({c / n:.1f})" for name, us, c in top))
    print(f"marks {marks / 1e3 / n:.4f} ms a unit; unstaged remainder "
          f"{(work_us / 1e3 - staged - marks / 1e3) / n:.4f} of "
          f"{work_us / 1e3 / n:.4f} ms a unit")
    print("program spans (host ms a unit, count a unit, nested time "
          "included): " + ", ".join(f"{k} {ms / n:.4f} ({c / n:.2f})"
                                    for k, ms, c in trace.span_ms()))
    idle = sorted(trace.idle_by_span().items(), key=lambda r: -r[1])
    print("device idle by the innermost span on the host (ms a unit): "
          + ", ".join(f"{k} {us / 1e3 / n:.4f}" for k, us in idle))


def print_costs(run, n: int) -> None:
    """What recording costs: a span alone, off and on, and run() off
    against on in alternating pairs (the first call with recording on
    captures the marked variants, so one goes before the pairs)."""
    cost = {}
    for on in (False, True):
        (tr.enable if on else tr.disable)()
        t0 = time.perf_counter()
        for _ in range(SPAN_REPS):
            with tr.span("vio.step"):
                pass
        cost[on] = (time.perf_counter() - t0) / SPAN_REPS * 1e6
        tr.disable()
    tr.enable()
    run()
    tr.disable()
    since = time.perf_counter_ns()
    runs = tr.off_against_on(run, SPAN_PAIRS)
    q = {k: np.percentile(v, [25, 50, 75]) / n * 1e3 for k, v in runs.items()}
    print(f"a span alone: {cost[False]:.3f} us off, {cost[True]:.3f} us "
          f"recording; the run over {SPAN_PAIRS} pairs, ms/frame median "
          f"(quartiles): off {q[False][1]:.4f} ({q[False][0]:.4f}-"
          f"{q[False][2]:.4f}), on {q[True][1]:.4f} ({q[True][0]:.4f}-"
          f"{q[True][2]:.4f})")
    print_untraced_spans(since, n * SPAN_PAIRS)


def print_untraced_spans(since_ns: int, units: int) -> None:
    """The host ms a unit of each span that recording left with no
    profiler running (no CUPTI cost in the runtime's calls)."""
    print("program spans with recording on and no profiler (host ms a unit, "
          "count a unit): " + ", ".join(
              f"{k} {ms / units:.4f} ({c / units:.2f})"
              for k, ms, c in tr.span_totals(since_ns)))


if __name__ == "__main__":
    main()
