"""Where the port's VIO pipeline spends its time on the GPU.

    python -m visma_tpu_torch.profile_pipeline [--frames 60]

Synthesises the bench scene's imagery (500x960 adversarial frames + IMU,
bench.py:67-88, the first `--frames` frames), runs VioPipeline once to warm
up, then times VioPipeline.step over the frames with the host clock
(synchronised) and traces the same frames with torch.profiler. Prints, per
frame: wall time, the host time of the step's `frontend` and `filter`
ranges, device busy time, the device's idle share, device operations, and
the top operators by device and by host time. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from visma_tpu_torch.io.synthetic import SyntheticConfig, make_imu
from visma_tpu_torch.io.synthetic_images import render_adversarial_frames
from visma_tpu_torch.filter.config import FilterConfig
from visma_tpu_torch.pipeline import VioPipeline


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=60)
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
    pipe = VioPipeline(cfg, levels=4, cell=32, device=dev)
    st0 = pipe.init(t(frames[0]), R0=gwc[0, :, :3], p0=gwc[0, :, 3],
                    v0=imu["v0"])

    def run():
        st = st0
        for i in range(N):
            st = pipe.step(st, images[i], gyro[i], accel[i], dts[i])
        return st

    run()                                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / N * 1e3
    t0 = time.perf_counter()
    pipe.run(st0, images, gyro, accel, dts)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) / N * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    ranges = ("frontend", "filter")
    on_device = [e for e in events if e.device_type == DeviceType.CUDA
                 and e.key not in ranges]         # kernels, memcpy, memset
    dev_ms = sum(e.self_device_time_total for e in on_device) / N / 1e3
    n_kernels = sum(e.count for e in on_device) / N
    host = {e.key: e.cpu_time_total / N / 1e3 for e in events
            if e.device_type == DeviceType.CPU and e.key in ranges}
    print(f"frames {N}; wall {wall_ms:.3f} ms/frame stepping, "
          f"{run_ms:.3f} ms/frame through VioPipeline.run (host clock, "
          f"synchronised, profiler off)")
    print(f"host time in ranges (profiler on): frontend "
          f"{host.get('frontend', 0.0):.3f} ms/frame, filter "
          f"{host.get('filter', 0.0):.3f} ms/frame")
    print(f"device busy {dev_ms:.3f} ms/frame ({n_kernels:.0f} device "
          f"ops/frame); idle share {1 - dev_ms / wall_ms:.3f} of the "
          f"profiler-off step time")
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    print(events.table(sort_by="self_cpu_time_total", row_limit=15))


if __name__ == "__main__":
    main()
