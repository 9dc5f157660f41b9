"""Sub-stage profile of the MSCKF frame step (port of
tools/profile_filter.py), bench config: window 8, 96 tracks, 24 updates,
IMU on.

    python -m visma_tpu_torch.tools.profile_filter [--n 512] [--reps 3]
        [--device cpu]

Each variant is a cumulative prefix of the frame step. It runs as a
`StepGraph` over `n` frames whose carry is the filter state itself (every
step's input depends on the previous output), captured into a CUDA graph
on the card and replayed a frame, and one run is timed with CUDA events
around the whole run: ms a step. A replayed graph's speed is partly its
capture's: on an H100 an occasional capture of a prefix replays up to a
tenth faster than the other captures of it, and keeps that speed. So each
of `reps` rounds captures every variant anew, the variants in turns, and
a variant's time is the median of its rounds. Successive differences are
the stages' costs. Where the reference folds a variant's unused
results into the carry so XLA cannot drop them, the same fold keeps the
variants comparable here. On the CPU the same buffers run without
capture, timed by the host clock.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from visma_tpu_torch.filter import FilterConfig, Msckf
from visma_tpu_torch.filter.imu import propagate
from visma_tpu_torch.filter.msckf import (_augment, _frame_step, _ingest,
                                          _select_for_update)
from visma_tpu_torch.filter.triangulate import triangulate
from visma_tpu_torch.filter.update import (chi2_gate, feature_jacobians,
                                           msckf_update, nullspace_project)
from visma_tpu_torch.tools.common import card_line, elapsed_ms
from visma_tpu_torch.utils.graphs import StepGraph
from visma_tpu_torch.utils.platform import configure_platform


def bench_config() -> FilterConfig:
    return FilterConfig(window=8, max_tracks=96, max_updates=24,
                        fx=486.405, fy=535.401, cx=469.199, cy=257.916,
                        pixel_noise=1.0)


def make_frame(cfg: FilterConfig, rng, device, ids_base: int = 0) -> dict:
    """One frame of IMU samples and track observations (the reference's
    draws, in its order)."""
    S, K = cfg.imu_per_frame, cfg.max_tracks
    f32 = dict(dtype=torch.float32, device=device)
    gyro = rng.standard_normal((S, 3)) * 0.02
    accel = np.array([0.0, 0.0, 9.81]) + rng.standard_normal((S, 3)) * 0.05
    return {
        "gyro": torch.as_tensor(gyro, **f32),
        "accel": torch.as_tensor(accel, **f32),
        "dts": torch.full((S,), 1.0 / 30.0 / S, **f32),
        "ids": torch.as_tensor(ids_base + np.arange(K), dtype=torch.int32,
                               device=device),
        "xp": torch.as_tensor(rng.uniform(50, 900, (K, 2)), **f32),
        "valid": torch.as_tensor(rng.random(K) < 0.9, device=device),
    }


def _leak(s, x):
    """Fold x into the carry without changing it: the stage cannot be
    dropped, the state stays the same bits."""
    return s.replace(p=s.p + 0.0 * x * 1e-20)


def variants(cfg: FilterConfig):
    """(name, fn(state, frame) -> state), each a prefix of the step."""
    def v_prop(s, f):
        return propagate(cfg, s, f["gyro"], f["accel"], f["dts"])

    def v_aug(s, f):
        s = v_prop(s, f)
        n = torch.sum(f["dts"] > 0, dtype=torch.int32)
        idx = torch.clamp(n - 1, 0, f["gyro"].shape[0] - 1)
        omega = (f["gyro"].index_select(0, idx.reshape(1)).squeeze(0)
                 - s.bg) * (n > 0)
        return _augment(cfg, s, omega)

    def ingested(s, f):
        s = v_aug(s, f)
        tracks, lost = _ingest(cfg, s.tracks, f["ids"], f["xp"], f["valid"])
        return s.replace(tracks=tracks), lost

    def v_ingest(s, f):
        return ingested(s, f)[0]

    def selected(s, f):
        s, lost = ingested(s, f)
        sel, sel_valid = _select_for_update(cfg, s.tracks, lost)
        obs = s.tracks.obs[sel]
        mask = s.tracks.mask[sel] & s.win_valid[None, :]
        return s, obs, mask

    def v_tri(s, f):
        s, obs, mask = selected(s, f)
        X, ok, _ = triangulate(cfg, obs, mask, s.win_R, s.win_p)
        return _leak(s, torch.sum(X))

    def v_jac(s, f):
        s, obs, mask = selected(s, f)
        X, ok, _ = triangulate(cfg, obs, mask, s.win_R, s.win_p)
        r, Hx, Hf = feature_jacobians(cfg, X, obs, mask, s.win_R, s.win_p)
        rp, Hp = nullspace_project(r, Hx, Hf)
        gate = chi2_gate(cfg, rp, Hp, s.P)
        return _leak(s, torch.sum(rp) + torch.sum(Hp) + torch.sum(gate))

    def v_update(s, f):
        s, lost = ingested(s, f)
        sel, sel_valid = _select_for_update(cfg, s.tracks, lost)
        s, used, rejected, X = msckf_update(
            cfg, s, s.tracks.obs[sel], s.tracks.mask[sel], sel_valid)
        return s

    def v_full(s, f):
        return _frame_step(cfg, s, f)

    return [("propagate", v_prop), ("+augment", v_aug),
            ("+ingest", v_ingest), ("+triangulate", v_tri),
            ("+jacobians/nullspace/gate", v_jac), ("+ekf update", v_update),
            ("full step (+bookkeeping)", v_full)]


def warm_state(cfg: FilterConfig, device, seed: int = 0):
    """The reference's start: a filter at the origin, three real steps so
    the track table is populated, and the frame every variant replays."""
    rng = np.random.default_rng(seed)
    kf = Msckf(cfg, device=device, graph=False)
    s0 = kf.init(R0=np.eye(3), p0=np.zeros(3), v0=np.zeros(3))
    frame = make_frame(cfg, rng, device)
    for _ in range(3):
        s0 = kf.step(s0, make_frame(cfg, rng, device))
    return s0, frame


def repeated(frame: dict, n: int) -> dict:
    """The frame as an n-frame sequence (the scan's per-step input)."""
    return {k: v.expand(n, *v.shape) for k, v in frame.items()}


def variant_run(fn, state, frame, n: int):
    """A `StepGraph` of the variant over n copies of the frame: the run
    function, the graph (for its record), and the final state of one run."""
    def body(s, f):
        s = fn(s, f)
        return s, s.P.sum()

    graph = StepGraph(body)
    xs = repeated(frame, n)
    return (lambda: graph.run(state, xs)), graph


def profile(cfg: FilterConfig, device, n: int = 512, reps: int = 3,
            log=print) -> dict:
    """ms a step of every variant (the median over `reps` rounds, each a
    capture of its own) and the stage deltas."""
    s0, frame = warm_state(cfg, device)
    named = variants(cfg)
    rounds = {name: [] for name, _ in named}
    captures = dict.fromkeys(rounds, 0)
    for _ in range(reps):
        for name, fn in named:
            run, graph = variant_run(fn, s0, frame, n)
            run()                  # warm-up frames and the capture
            rounds[name].append(elapsed_ms(run, device) / n)
            captures[name] += graph.captures
    rows = []
    for name, ts in rounds.items():
        ms = statistics.median(ts)
        rows.append({"variant": name, "ms_per_step": ms,
                     "rounds_ms": ts, "captures": captures[name]})
        log(f"{name:30s} {ms:8.4f} ms/step  (rounds "
            + " ".join(f"{t:.4f}" for t in ts) + ")")
    deltas, prev = [], 0.0
    for r in rows[:-1]:
        deltas.append({"stage": r["variant"],
                       "ms": r["ms_per_step"] - prev})
        prev = r["ms_per_step"]
    return {"n": n, "reps": reps, "variants": rows, "deltas": deltas,
            "stages_sum_ms": prev, "full_ms": rows[-1]["ms_per_step"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=512,
                    help="steps a variant's run replays")
    ap.add_argument("--reps", type=int, default=3,
                    help="rounds; each captures every variant anew")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = configure_platform(args.device)
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    log(card_line(dev))
    res = profile(bench_config(), dev, args.n, args.reps, log=log)
    log("\nper-stage deltas:")
    for d in res["deltas"]:
        log(f"  {d['stage']:30s} {d['ms']:+8.4f} ms")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
