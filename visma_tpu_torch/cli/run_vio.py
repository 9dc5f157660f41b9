"""Run the MSCKF VIO over a sequence and report ATE (port of
visma_tpu/cli/run_vio.py). Three modes:

  feature-feed: consume a vlslam `dataset` (feature tracks as the Corvis
    frontend produced them) + an IMU npz {ts, gyro, accel};
  image-frontend (--images): run the FULL pipeline on the sequence's PNG
    frames — pyramid, KLT, detection, filter — ignoring the dataset's
    packed feature tracks (they become the comparison, not the input);
  synthetic: generate a sequence on the fly (--synthetic N frames).

--no-imu runs the vision-only fallback (constant-velocity process model,
cfg.use_imu=False); scale is then a gauge freedom, so the report adds the
ATE after similarity alignment (align.umeyama).

Writes the estimated trajectory as a vlslam dataset (loadable by
example_load) and prints ATE vs the reference poses when available.

Not ported yet, and refused with an error instead of being replaced by
something else: `--ba dense|sharded` (needs ba/ and dist/).
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataroot", default=None, help="VISMA sequence dir")
    ap.add_argument("--imu", default=None, help="npz with ts/gyro/accel")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run on an N-frame synthetic sequence instead")
    ap.add_argument("--output", default=None,
                    help="write estimated trajectory dataset here")
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--max-tracks", type=int, default=96)
    ap.add_argument("--pixel-noise", type=float, default=0.5)
    ap.add_argument("--no-imu", action="store_true",
                    help="vision-only mode (constant-velocity prior)")
    ap.add_argument("--images", action="store_true",
                    help="image-frontend mode: run the full pipeline on "
                         "the sequence's PNG frames instead of its packed "
                         "feature tracks")
    ap.add_argument("--levels", type=int, default=3,
                    help="image pyramid levels (--images mode)")
    ap.add_argument("--cell", type=int, default=32,
                    help="detection grid cell in px (--images mode)")
    ap.add_argument("--fused-klt", choices=("auto", "on", "off"),
                    default="auto",
                    help="fused LK kernel (--images mode; auto and on = "
                         "fused, off = the windowed tracker)")
    ap.add_argument("--ba", choices=("off", "dense", "sharded"),
                    default="off",
                    help="batch BA trajectory refinement after the filter "
                         "pass; not ported yet")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="write a torch.profiler trace to LOGDIR/trace.json "
                         "plus a host-side Timer report")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.ba != "off":
        ap.error(f"--ba {args.ba} is not ported yet (needs ba/ and dist/)")

    from visma_tpu_torch.utils.platform import configure_platform

    device = configure_platform(args.device)

    import torch

    from visma_tpu_torch.filter import FilterConfig, Msckf
    from visma_tpu_torch.filter.feed import pack_frames

    if args.synthetic:
        from visma_tpu_torch.io.synthetic import (SyntheticConfig,
                                                  make_dataset, make_imu,
                                                  make_trajectory)

        syn = SyntheticConfig(num_frames=args.synthetic,
                              pixel_noise=args.pixel_noise)
        cfg = FilterConfig(window=args.window, max_tracks=args.max_tracks,
                           fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy,
                           pixel_noise=max(args.pixel_noise, 0.5),
                           use_imu=not args.no_imu)
        ds = make_dataset(syn)
        imu = None if args.no_imu else make_imu(syn)
        _, gwc = make_trajectory(syn)
        R0, p0 = gwc[0, :, :3], gwc[0, :, 3]
        ref_p = gwc[:, :, 3]
        v0 = (imu["v0"] if imu is not None
              else (gwc[1, :, 3] - gwc[0, :, 3]) * syn.fps)
        ts_norm = None
    else:
        if not args.dataroot or (args.imu is None and not args.no_imu):
            ap.error("--dataroot and --imu required "
                     "(or --no-imu, or --synthetic N)")
        from visma_tpu_torch.io import VlslamDatasetLoader

        loader = VlslamDatasetLoader(args.dataroot)
        ds = loader.dataset
        p = np.asarray(ds.camera.parameters)
        cfg = FilterConfig(window=args.window, max_tracks=args.max_tracks,
                           fx=float(p[0]), fy=float(p[1]), cx=float(p[2]),
                           cy=float(p[3]),
                           pixel_noise=max(args.pixel_noise, 0.5),
                           use_imu=not args.no_imu)
        if args.no_imu:
            imu = None
        else:
            imu_npz = np.load(args.imu)
            imu = {k: imu_npz[k] for k in ("ts", "gyro", "accel")}
            imu["v0"] = imu_npz.get("v0", np.zeros(3))
        g0 = loader.pose(0)
        R0, p0 = g0[:, :3], g0[:, 3]
        ref_p = np.stack([loader.pose(i)[:, 3] for i in range(len(loader))])
        # VISMA packets stamp microseconds (filenames like
        # 1520535134297896); IMU npz files stamp seconds. Normalize ONCE
        # here and use ts_norm for IMU windowing and export in BOTH modes
        # so stamp units always agree.
        ts_norm = np.asarray([pk.ts for pk in ds.packets], np.float64)
        if len(ts_norm) > 1 and np.median(np.diff(ts_norm)) > 1.0:
            ts_norm = ts_norm * 1e-6
        if imu is not None:
            v0 = imu["v0"]
        else:
            dt0 = max(float(ts_norm[1] - ts_norm[0]), 1e-6)
            v0 = (ref_p[1] - ref_p[0]) / dt0

    from visma_tpu_torch.filter.msckf import check_health
    from visma_tpu_torch.utils.timer import Timer, device_trace

    timer = Timer()
    packed = pack_frames(cfg, ds, imu, max_feats=args.max_tracks, ts=ts_norm)
    if args.images:
        # ---- image-frontend mode: images -> tracker -> filter ----------
        from visma_tpu_torch.pipeline import VioPipeline

        if args.synthetic:
            from visma_tpu_torch.io.synthetic_images import render_blob_frames

            images = render_blob_frames(syn)[0]
            ts = np.arange(syn.num_frames) / syn.fps
        else:
            import cv2

            imgs = []
            for i in range(len(loader)):
                img = loader.grab(i).image
                if img is None:
                    raise IOError(f"frame {i} of {args.dataroot} has no "
                                  "readable image")
                if img.ndim == 3:
                    img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
                imgs.append(img.astype(np.float32))
            images = np.stack(imgs)
            ts = ts_norm
        # the IMU windows come from the normalized stamps, so they match
        # the frame stamps in the same units
        gyro, accel, dts = (packed[k][1:] for k in ("gyro", "accel", "dts"))

        fused = {"auto": None, "on": True, "off": False}[args.fused_klt]
        pipe = VioPipeline(cfg, levels=args.levels, cell=args.cell,
                           fused_klt=fused, device=device)
        st0 = pipe.init(images[0], R0=R0, p0=p0, v0=v0)
        run_name = "pipeline_scan"

        def run():
            return pipe.run(st0, images[1:], gyro, accel, dts)

        # frame 0 initializes the pipeline; outputs cover frames 1..N-1
        ref_p = ref_p[1:]
        ts_out = ts[1:]
    else:
        frames = {k: torch.as_tensor(v, device=device)
                  for k, v in packed.items() if k != "ts"}
        kf = Msckf(cfg, device=device)
        s0 = kf.init(R0=R0, p0=p0, v0=v0)
        run_name = "vio_scan"

        def run():
            return kf.run(s0, frames)

        # export stamps in the SAME (normalized) units as --images mode
        ts_out = packed["ts"]

    if args.profile:
        timer.tick(run_name)
        with device_trace(args.profile):
            final, outs = run()
        timer.tock(run_name, block_on=outs["p"])
        print(f"profiler trace written to {args.profile}")
        print(timer)
    else:
        final, outs = run()
    # health gate: abort with a structured error on divergence instead of
    # exporting NaN poses
    check_health(outs)

    p_est = outs["p"].cpu().numpy()
    ate = float(np.sqrt(np.mean(np.sum((p_est - ref_p) ** 2, axis=1))))
    report = {"frames": len(p_est), "ate_rmse_m": round(ate, 5)}
    if args.no_imu:
        from visma_tpu_torch.align.umeyama import umeyama

        T = umeyama(torch.as_tensor(p_est, dtype=torch.float32, device=device),
                    torch.as_tensor(ref_p, dtype=torch.float32, device=device),
                    with_scaling=True).cpu().numpy()
        pa = p_est @ T[:3, :3].T + T[:3, 3]
        report["ate_sim_aligned_m"] = round(
            float(np.sqrt(np.mean(np.sum((pa - ref_p) ** 2, axis=1)))), 5)
    print(json.dumps(report))

    if args.output:
        import os

        from visma_tpu_torch.pipeline import export_packets
        from visma_tpu_torch.proto import Dataset

        packets = export_packets(cfg, outs, ts_out)
        est = Dataset(description="visma_tpu_torch VIO estimate",
                      camera=ds.camera, packets=packets)
        os.makedirs(args.output, exist_ok=True)
        with open(os.path.join(args.output, "dataset"), "wb") as fp:
            fp.write(est.encode())
        print(f"wrote {args.output}/dataset")
    return report


if __name__ == "__main__":
    main()
