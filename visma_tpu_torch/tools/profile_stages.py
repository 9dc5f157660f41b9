"""Stage split of the 500x960 VIO pipeline (port of
tools/profile_stages.py).

    python -m visma_tpu_torch.tools.profile_stages [--frames 240]
        [--reps 4] [--device cpu]

Every stage runs over the whole device-staged chunk of frames as a
`StepGraph` (captured once into a CUDA graph on the card, a replay a
frame), timed by CUDA events around the chunk, best of `reps`; `full` is
`VioPipeline.run` itself. Prints one line a stage, so the frontend and
filter budgets are visible side by side:

  full            the pipeline (tracker step + filter step)
  pyr_only        the image pyramid
  pyr_detect      corner detection (K1, the cell pick in its epilogue)
  pyr_klt         pyramid + the windowed LK tracker (no detection)
  pyr_klt_fused   pyramid + the fused LK tracker (K2, one launch a frame)
  tracker_only    the tracker step: pyramid, K2, K1, replenishment
  filt_only       the filter step on synthetic observations
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from visma_tpu_torch.filter import FilterConfig
from visma_tpu_torch.filter.msckf import _frame_step
from visma_tpu_torch.frontend.detect import detect_features
from visma_tpu_torch.frontend.klt import track_features
from visma_tpu_torch.frontend.klt_fused import track_features_fused
from visma_tpu_torch.frontend.pyramid import build_pyramid
from visma_tpu_torch.io.synthetic import SyntheticConfig, make_imu
from visma_tpu_torch.io.synthetic_images import render_blob_frames
from visma_tpu_torch.pipeline import VioPipeline
from visma_tpu_torch.tools.common import best_ms, card_line
from visma_tpu_torch.utils.graphs import StepGraph
from visma_tpu_torch.utils.platform import configure_platform

LEVELS = 4
CELL = 32
STAGES = ("full", "pyr_only", "pyr_detect", "pyr_klt", "pyr_klt_fused",
          "tracker_only", "filt_only")


def scene(n_frames: int, device):
    """The bench camera's 500x960 blob scene, staged on the device: (cfg,
    pipe, start state, images, gyro, accel, dts)."""
    syn = SyntheticConfig(num_frames=n_frames, num_landmarks=240, rows=500,
                          cols=960, fx=486.405, fy=535.401, cx=469.199,
                          cy=257.916, seed=7)
    cfg = FilterConfig(window=8, max_tracks=96, max_updates=24, fx=syn.fx,
                       fy=syn.fy, cx=syn.cx, cy=syn.cy, pixel_noise=1.0)
    frames, gwc, _ = render_blob_frames(syn)
    imu = make_imu(syn)
    spf = imu["samples_per_frame"]
    N = n_frames - 1
    f32 = dict(dtype=torch.float32, device=device)
    images = torch.as_tensor(frames[1:], **f32)
    gyro = torch.as_tensor(imu["gyro"][: N * spf].reshape(N, spf, 3), **f32)
    accel = torch.as_tensor(imu["accel"][: N * spf].reshape(N, spf, 3),
                            **f32)
    dts = torch.full((N, spf), float(np.diff(imu["ts_state"])[0]), **f32)
    pipe = VioPipeline(cfg, levels=LEVELS, cell=CELL, device=device)
    st0 = pipe.init(torch.as_tensor(frames[0], **f32), R0=gwc[0, :, :3],
                    p0=gwc[0, :, 3], v0=imu["v0"])
    return cfg, pipe, st0, images, gyro, accel, dts


def stage_runs(cfg, pipe, st0, images, gyro, accel, dts, seed: int = 0):
    """{stage: fn() running the stage over the chunk}."""
    dev = images.device
    N = images.shape[0]
    tr = pipe.tracker
    zero = torch.zeros((), device=dev)

    def graphed(body, state, xs):
        g = StepGraph(body)
        return lambda: g.run(state, xs)

    def pyr_only(c, img):
        c = c + build_pyramid(img, LEVELS)[-1].sum()
        return c, c

    def pyr_detect(c, img):
        xy, score, valid = detect_features(img, cfg.max_tracks, CELL)
        c = c + xy.sum() + score.sum()
        return c, c

    def klt(track):
        def body(carry, img):
            prev_pyr, pos, valid = carry
            cur_pyr = tuple(build_pyramid(img, LEVELS))
            new_pos, ok = track(prev_pyr, cur_pyr, pos, valid,
                                radius=tr.radius, levels=LEVELS)
            return (cur_pyr, new_pos, ok), new_pos
        return body

    def tracker_only(s, img):
        s2, ids, xp, valid = tr._step_impl(s, img)
        return s2, xp

    def filt_only(s, fr):
        s2 = _frame_step(cfg, s, fr)
        return s2, s2.p

    rng = np.random.default_rng(seed)
    H, W = images.shape[1:]
    frames = {
        "ids": torch.arange(cfg.max_tracks, dtype=torch.int32,
                            device=dev).expand(N, -1),
        "xp": torch.as_tensor(rng.uniform(size=(N, cfg.max_tracks, 2))
                              * np.array([W, H]), dtype=torch.float32,
                              device=dev),
        "valid": torch.ones((N, cfg.max_tracks), dtype=torch.bool,
                            device=dev),
        "gyro": gyro, "accel": accel, "dts": dts}
    carry = (st0.tracker.pyr, st0.tracker.pos, st0.tracker.ids >= 0)
    return {
        "full": lambda: pipe.run(st0, images, gyro, accel, dts),
        "pyr_only": graphed(pyr_only, zero, images),
        "pyr_detect": graphed(pyr_detect, zero, images),
        "pyr_klt": graphed(klt(track_features), carry, images),
        "pyr_klt_fused": graphed(klt(track_features_fused), carry, images),
        "tracker_only": graphed(tracker_only, st0.tracker, images),
        "filt_only": graphed(filt_only, st0.filter, frames),
    }


def profile(device, n_frames: int = 240, reps: int = 4, stages=STAGES,
            log=print) -> dict:
    """ms a frame of every stage over the chunk."""
    inputs = scene(n_frames, device)
    runs = stage_runs(*inputs)
    N = n_frames - 1
    out = {}
    for name in stages:
        runs[name]()                    # warm-up frames and the capture
        out[name] = best_ms(runs[name], device, reps) / N
        log(f"{name:16s} {out[name]:8.4f} ms/frame")
    return {"frames": N, "reps": reps, "ms_per_frame": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--stages", nargs="+", default=list(STAGES),
                    choices=STAGES)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = configure_platform(args.device)
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    log(card_line(dev))
    print(json.dumps(profile(dev, args.frames, args.reps, args.stages,
                             log=log)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
