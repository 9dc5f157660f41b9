"""Adversarial-imagery stress sweep of the VIO pipeline (port of
tools/noise_sweep.py): the full image pipeline over a grid of sensor-noise
sigmas, occluders on and off, and motion scales (the orbit's angular-rate
multiplier, which drives the per-frame feature displacement toward the
fused LK window's margin), reporting ATE, track churn and lifetime, and
the measured mean / p99 per-frame feature displacement.

    python -m visma_tpu_torch.tools.noise_sweep [--rows 240 --cols 320]
        [--frames 60] [--motions 1 2 3] [--noises 0 4 8]
        [--occluders 0 2] [--output PATH] [--device cpu]
    python -m visma_tpu_torch.tools.noise_sweep --headline  # 500x960

The reference's grid is the default. `--noises` and `--occluders` choose
points of it (or others: the VIO bench scene is `--headline --frames 240
--motions 1 --noises 2 --occluders 2`). Prints one line a point and the
rows as JSON ({"rows": [...]}); writes the markdown table to `--output` (default
build/tools/noise_sweep.md).
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time

import numpy as np

from visma_tpu_torch.tools.common import card_line, output_path
from visma_tpu_torch.utils.platform import configure_platform


def _displacement_stats(syn, gwc, X):
    """Mean / p99 per-frame px displacement of the visible landmarks."""
    ds = []
    prev_uv = prev_ok = None
    for i in range(syn.num_frames):
        uv = np.empty((len(X), 2))
        R, t = gwc[i, :, :3], gwc[i, :, 3]
        Xc = (X - t) @ R
        z = Xc[:, 2]
        ok = z > 0.1
        zs = np.where(ok, z, 1.0)
        uv[:, 0] = syn.fx * Xc[:, 0] / zs + syn.cx
        uv[:, 1] = syn.fy * Xc[:, 1] / zs + syn.cy
        ok &= ((uv[:, 0] >= 0) & (uv[:, 0] < syn.cols)
               & (uv[:, 1] >= 0) & (uv[:, 1] < syn.rows))
        if prev_uv is not None:
            both = ok & prev_ok
            if both.any():
                ds.append(np.linalg.norm(uv[both] - prev_uv[both], axis=1))
        prev_uv, prev_ok = uv, ok
    all_d = np.concatenate(ds) if ds else np.zeros(1)
    return float(all_d.mean()), float(np.percentile(all_d, 99))


def run_point(syn, cfg, noise_sigma, occluders, levels=4, cell=32,
              device=None):
    """One point of the grid through `VioPipeline.run` on `device`:
    (ATE m, churn %/frame, median track life in frames, healthy,
    displacement mean px, displacement p99 px)."""
    from visma_tpu_torch.filter.msckf import check_health
    from visma_tpu_torch.io.synthetic import make_imu
    from visma_tpu_torch.io.synthetic_images import render_adversarial_frames
    from visma_tpu_torch.pipeline import VioPipeline

    frames, gwc, X = render_adversarial_frames(
        syn, noise_sigma=noise_sigma, occluders=occluders)
    imu = make_imu(syn)
    spf = imu["samples_per_frame"]
    dt = float(np.diff(imu["ts_state"])[0])
    N = syn.num_frames - 1
    gyro = imu["gyro"][: N * spf].reshape(N, spf, 3)
    accel = imu["accel"][: N * spf].reshape(N, spf, 3)
    dts = np.full((N, spf), dt, np.float32)

    pipe = VioPipeline(cfg, levels=levels, cell=cell, device=device)
    st0 = pipe.init(frames[0], R0=gwc[0, :, :3], p0=gwc[0, :, 3],
                    v0=imu["v0"])
    _, outs = pipe.run(st0, frames[1:], gyro, accel, dts)
    ok = True
    try:
        check_health(outs)
    except Exception:
        ok = False
    p = outs["p"].cpu().numpy()
    ate = float(np.sqrt(np.mean(np.sum((p - gwc[1:, :, 3]) ** 2, axis=1))))
    # churn and lifetime, not the live count: replenishment holds the live
    # count at capacity, so it cannot tell tracking from thrash
    ids = outs["feat_ids"].cpu().numpy()
    valid = outs["obs_valid"].cpu().numpy() & (ids >= 0)
    churn = []
    cnt = collections.Counter()
    for i in range(len(ids)):
        cur = set(ids[i][valid[i]].tolist())
        for t in cur:
            cnt[t] += 1
        if i + 1 < len(ids) and cur:
            nxt = set(ids[i + 1][valid[i + 1]].tolist())
            churn.append(len(cur - nxt) / len(cur))
    churn_pct = 100.0 * float(np.mean(churn)) if churn else 0.0
    med_life = float(np.median(list(cnt.values()))) if cnt else 0.0
    d_mean, d_p99 = _displacement_stats(syn, gwc, X)
    return ate, churn_pct, med_life, ok, d_mean, d_p99


def sweep(args, device, log=print) -> list:
    from visma_tpu_torch.filter import FilterConfig
    from visma_tpu_torch.io.synthetic import SyntheticConfig

    if args.headline:
        args.rows, args.cols = 500, 960
        intr = dict(fx=486.405, fy=535.401, cx=469.199, cy=257.916)
    else:
        f = 240.0 * args.cols / 320.0
        intr = dict(fx=f, fy=f, cx=(args.cols - 1) / 2,
                    cy=(args.rows - 1) / 2)
    rows = []
    for motion in args.motions:
        syn = SyntheticConfig(num_frames=args.frames, num_landmarks=240,
                              rows=args.rows, cols=args.cols, seed=7,
                              angular_rate=0.35 * motion, **intr)
        cfg = FilterConfig(window=8, max_tracks=96, max_updates=24,
                           fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy,
                           pixel_noise=1.0)
        for occluders in args.occluders:
            for ns in args.noises:
                t0 = time.time()
                ate, churn, life, ok, dm, dp = run_point(
                    syn, cfg, ns, occluders, device=device)
                rows.append({"motion": motion, "noise_sigma": ns,
                             "occluders": occluders, "ate_m": ate,
                             "churn_pct": churn, "median_life": life,
                             "healthy": ok, "disp_mean_px": dm,
                             "disp_p99_px": dp})
                log(f"motion={motion:3.1f} noise={ns:4.1f} "
                    f"occluders={occluders} ATE={ate * 100:6.3f} cm "
                    f"churn={churn:4.1f}%/fr med_life={life:4.0f}fr "
                    f"healthy={ok} disp mean={dm:.1f} p99={dp:.1f} px "
                    f"({time.time() - t0:.1f}s)")
    return rows


def table(rows, args, device) -> str:
    lines = [
        "# Adversarial-imagery stress sweep",
        "",
        f"visma_tpu_torch.tools.noise_sweep on {card_line(device)} at "
        f"{args.rows}x{args.cols}, {args.frames} frames, 240 landmarks "
        "(seed 7).",
        "",
        "| motion | noise sigma | occluders | disp mean (px) | "
        "disp p99 (px) | ATE (cm) | churn %/frame | med track life (fr) "
        "| healthy |",
        "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['motion']:.1f} | {r['noise_sigma']:.1f} | "
            f"{r['occluders']} | {r['disp_mean_px']:.1f} | "
            f"{r['disp_p99_px']:.1f} | {r['ate_m'] * 100:.3f} | "
            f"{r['churn_pct']:.1f} | {r['median_life']:.0f} | "
            f"{'yes' if r['healthy'] else 'NO'} |")
    return "\n".join(lines) + "\n"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--headline", action="store_true",
                    help="500x960 VISMA geometry with the bench intrinsics")
    ap.add_argument("--rows", type=int, default=240)
    ap.add_argument("--cols", type=int, default=320)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--motions", type=float, nargs="*",
                    default=[1.0, 2.0, 3.0])
    ap.add_argument("--noises", type=float, nargs="*",
                    default=[0.0, 4.0, 8.0])
    ap.add_argument("--occluders", type=int, nargs="*", default=[0, 2])
    ap.add_argument("--output", default="",
                    help="markdown table (default build/tools/"
                         "noise_sweep.md)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = configure_platform(args.device)
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    log(card_line(dev))
    rows = sweep(args, dev, log=log)
    out = output_path(args.output, "noise_sweep.md")
    out.write_text(table(rows, args, dev))
    log(f"wrote {out}")
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
