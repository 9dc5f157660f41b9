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

--ba dense refines the trajectory after the filter pass by batch bundle
adjustment (BASELINE config 5): the problem is rebuilt from the run's own
observations and estimates (ba/from_vio.py, keyframes every --ba-stride
frames), solved by `ba.ba_solve` (--ba-iters GN steps) on the run's
device (on the card its steps replay a captured CUDA graph: two eager
warm-up steps and the capture come out of the first solve), and written
back over every frame. --ba sharded solves it with the
landmark-sharded `dist.sharded_ba_solve` over `dist.make_mesh()` instead
(one rank in a single process). The report then adds the BA trajectory's
ATE, over all frames and at the keyframes.

Writes the estimated trajectory as a vlslam dataset (loadable by
example_load), with --ba also the refined one as `dataset_ba`, and prints
ATE vs the reference poses when available.
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
                         "pass: rebuild the problem from the run's own "
                         "observations + estimates (ba/from_vio.py) and "
                         "solve on one device (dense) or landmark-sharded "
                         "over the process group's mesh (sharded)")
    ap.add_argument("--ba-stride", type=int, default=4,
                    help="keyframe stride for the BA problem")
    ap.add_argument("--ba-iters", type=int, default=10)
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="write a torch.profiler trace to LOGDIR/trace.json "
                         "plus a host-side Timer report")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

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
        obs_keys = ("obs_ids", "obs_xp", "obs_valid")
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
        obs_keys = None

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

    def rmse(pp, idx=slice(None)):
        return float(np.sqrt(np.mean(np.sum((pp[idx] - ref_p[idx]) ** 2,
                                            axis=1))))

    report = {"frames": len(p_est), "ate_rmse_m": round(rmse(p_est), 5)}

    outs_ba = None
    if args.ba != "off":
        from visma_tpu_torch.ba.from_vio import (ba_problem_from_vio,
                                                 refine_trajectory)

        if obs_keys is None:
            obs = (packed["ids"], packed["xp"], packed["valid"])
        else:
            obs = tuple(outs[k].cpu().numpy() for k in obs_keys)
        R_est = outs["R"].cpu().numpy()
        prob, info = ba_problem_from_vio(
            *obs, R_est, p_est, (cfg.fx, cfg.fy, cfg.cx, cfg.cy),
            R_bc=cfg.cam_R_bc, p_bc=cfg.cam_p_bc, stride=args.ba_stride,
            max_landmarks=2 * args.max_tracks * max(len(p_est)
                                                    // args.ba_stride, 1),
            device=device)
        if prob is None:
            report["ba"] = "skipped: too few landmarks"
        else:
            if args.ba == "sharded":
                from visma_tpu_torch.dist import make_mesh
                from visma_tpu_torch.dist.sharded_ba import sharded_ba_solve

                sol, _ = sharded_ba_solve(prob, make_mesh(device=device),
                                          iters=args.ba_iters)
            else:
                from visma_tpu_torch.ba.gauss_newton import ba_solve

                sol, _ = ba_solve(prob, iters=args.ba_iters)
            R_ba, p_ba = refine_trajectory(sol, info, R_est, p_est,
                                           cfg.cam_R_bc, cfg.cam_p_bc)
            kfi = info["kf"]
            report.update({
                "ba": args.ba, "ba_keyframes": len(kfi),
                "ba_landmarks": int(prob.num_landmarks),
                "ate_ba_m": round(rmse(p_ba), 5),
                "ate_kf_m": round(rmse(p_est, kfi), 5),
                "ate_kf_ba_m": round(rmse(p_ba, kfi), 5),
            })
            outs_ba = dict(outs)
            outs_ba["R"], outs_ba["p"] = R_ba, p_ba
    if args.no_imu:
        from visma_tpu_torch.align.umeyama import umeyama

        def aligned_ate(pp):
            T = umeyama(
                torch.as_tensor(pp, dtype=torch.float32, device=device),
                torch.as_tensor(ref_p, dtype=torch.float32, device=device),
                with_scaling=True).cpu().numpy()
            return rmse(pp @ T[:3, :3].T + T[:3, 3])

        report["ate_sim_aligned_m"] = round(aligned_ate(p_est), 5)
        if outs_ba is not None:
            # monocular BA inherits the initialization's gauge (pose 0 +
            # scale anchor pin the filter's drifted frame); alignment is
            # the meaningful metric for the vision-only configuration
            report["ate_ba_sim_aligned_m"] = round(aligned_ate(p_ba), 5)
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
        if outs_ba is not None:
            # both trajectories are written: the filter estimate above and
            # the BA-refined one here (same wire format)
            est_ba = Dataset(description="visma_tpu_torch VIO estimate (BA)",
                             camera=ds.camera,
                             packets=export_packets(cfg, outs_ba, ts_out))
            with open(os.path.join(args.output, "dataset_ba"), "wb") as fp:
                fp.write(est_ba.encode())
            print(f"wrote {args.output}/dataset_ba")
    return report


if __name__ == "__main__":
    main()
