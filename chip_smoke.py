#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (visma_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from visma_tpu_torch/csrc with nvcc,
synthesises the bench scene (240 frames of 500x960 adversarial imagery plus
IMU, bench.py:67-88), holds each kernel against its plain PyTorch version
on the card at the shapes the pipeline gives it, then runs
VioPipeline(levels=4, cell=32).run over the 239 tracked frames and checks
the trajectory (health, ATE < 0.10 m) and that every frame went through the
kernels (launch counts). Prints the card, the kernel table as one JSON line
and, last, {"ok": true, "device": {...}}. Exits non-zero on any failure,
and without a CUDA device.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 240
ATE_GATE_M = 0.10          # bench.py:108
REFERENCE_ATE_CM = 0.37    # BENCH_r05, the JAX reference on this scene
LK_TOL_PX = 1e-3           # kernel vs plain displacement, features ok in both
LK_MAX_OK_FLIPS = 1        # of 96: f32 sum order at the residual/FB gates


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Mean device time of fn() in ms over `reps` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def lk_level_args(prev_pyr, cur_pyr, pts, lv, win=24, r=5):
    """lk_level arguments at pyramid level lv for points tracked with a zero
    coarse-level guess, as track_features_fused builds them."""
    from visma_tpu_torch.frontend.klt_fused import _starts, window_origin

    Hl, Wl = prev_pyr[lv].shape
    wl = min(win, Hl - Hl % 8 or Hl, Wl - Wl % 8 or Wl)
    pts_l = pts / 2.0 ** lv
    org = window_origin(pts_l, wl, Hl, Wl)
    st = _starts(pts_l, r, org)
    return (prev_pyr[lv], cur_pyr[lv], org, org, st, st, wl, r, 8)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from visma_tpu.io.synthetic import SyntheticConfig, make_imu
    from visma_tpu.io.synthetic_images import render_adversarial_frames
    from visma_tpu_torch import _kernels
    from visma_tpu_torch.filter.config import FilterConfig
    from visma_tpu_torch.filter.msckf import check_health
    from visma_tpu_torch.frontend.detect import (corner_score,
                                                 corner_score_plain,
                                                 detect_features)
    from visma_tpu_torch.frontend.klt_fused import (lk_level, lk_level_plain,
                                                    track_features_fused)
    from visma_tpu_torch.frontend.pyramid import build_pyramid
    from visma_tpu_torch.pipeline import VioPipeline

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.time()
    _kernels.library()
    log(f"kernels built/loaded in {time.time() - t0:.2f} s "
        f"({_kernels.build_dir()})")
    build_log = _kernels.build_dir() / "build.log"
    if build_log.is_file():
        for line in build_log.read_text().splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line):
                log("  " + line.strip())

    # 2. the bench scene
    t0 = time.time()
    syn = SyntheticConfig(num_frames=N_FRAMES, num_landmarks=240,
                          rows=500, cols=960, fx=486.405, fy=535.401,
                          cx=469.199, cy=257.916, seed=7)
    cfg = FilterConfig(window=8, max_tracks=96, max_updates=24,
                       fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy,
                       pixel_noise=1.0)
    frames, gwc, _ = render_adversarial_frames(syn)
    imu = make_imu(syn)
    spf = imu["samples_per_frame"]
    dt = float(np.diff(imu["ts_state"])[0])
    N = N_FRAMES - 1
    gyro = imu["gyro"][: N * spf].reshape(N, spf, 3)
    accel = imu["accel"][: N * spf].reshape(N, spf, 3)
    dts = np.full((N, spf), dt, np.float32)
    log(f"synthesised {N_FRAMES} frames at 500x960 in "
        f"{time.time() - t0:.1f} s")

    kernels = []

    # 3. K1 against its plain version on a bench frame
    img = torch.as_tensor(frames[1], device=dev)
    got = corner_score(img)
    ref = corner_score_plain(img)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    tol = 1e-4 * max(1.0, float(ref.max()))
    log(f"K1 corner_score: max |kernel - plain| = {err:.3e} "
        f"(tol {tol:.3e}), {int((got > 0).sum())} corners")
    check(err <= tol, f"corner_score disagrees with its plain version: {err}")
    k1_ms = cuda_ms(lambda: corner_score(img))
    k1_plain_ms = cuda_ms(lambda: corner_score_plain(img))
    log(f"K1 time: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms")
    kernels.append({"name": "corner_score", "route": "cuda",
                    "source": "visma_tpu_torch/csrc/corner_score.cu",
                    "replaces": "visma_tpu/frontend/detect.py:30",
                    "max_abs_err": err, "ms": k1_ms,
                    "plain_ms": k1_plain_ms})

    # 4. K2 and track_features_fused against their plain versions on two
    #    bench frames (K = 96, 4 levels)
    prev_pyr = tuple(build_pyramid(torch.as_tensor(frames[0], device=dev), 4))
    cur_pyr = tuple(build_pyramid(img, 4))
    pts, _, valid = detect_features(prev_pyr[0], cfg.max_tracks, 32)
    check(int(valid.sum()) >= 48, "too few corners on the bench frame")
    k2_err, k2_flips = 0.0, 0
    for lv in range(4):
        args = lk_level_args(prev_pyr, cur_pyr, pts, lv)
        u_k, res_k, ok_k = lk_level(*args)
        u_p, res_p, ok_p = lk_level_plain(*args)
        both = ok_k & ok_p
        lv_err = float((u_k - u_p)[:, both].abs().max()) if both.any() else 0.0
        flips = int((ok_k != ok_p).sum())
        res_err = float((res_k - res_p)[both].abs().max()) if both.any() else 0.0
        log(f"K2 lk_level level {lv} ({tuple(prev_pyr[lv].shape)}, win "
            f"{args[6]}): max |du| = {lv_err:.3e} px, max |dres| = "
            f"{res_err:.3e}, ok flips {flips}, ok {int(ok_k.sum())}/96")
        k2_err, k2_flips = max(k2_err, lv_err), k2_flips + flips
    check(k2_err <= LK_TOL_PX, f"lk_level disagrees: {k2_err} px")
    check(k2_flips <= LK_MAX_OK_FLIPS, f"lk_level ok flips: {k2_flips}")
    args0 = lk_level_args(prev_pyr, cur_pyr, pts, 0)
    k2_ms = cuda_ms(lambda: lk_level(*args0))
    k2_plain_ms = cuda_ms(lambda: lk_level_plain(*args0))
    log(f"K2 time (level 0, K=96): kernel {k2_ms:.4f} ms, plain "
        f"{k2_plain_ms:.4f} ms")

    new_k, ok_k = track_features_fused(prev_pyr, cur_pyr, pts, valid,
                                       levels=4)
    cpu = torch.device("cpu")
    new_p, ok_p = track_features_fused(
        tuple(p.to(cpu) for p in prev_pyr), tuple(p.to(cpu) for p in cur_pyr),
        pts.to(cpu), valid.to(cpu), levels=4)
    both = (ok_k.cpu() & ok_p)
    tr_err = float((new_k.cpu() - new_p)[both].abs().max())
    tr_flips = int((ok_k.cpu() != ok_p).sum())
    log(f"track_features_fused (kernel on the card vs plain on the host): "
        f"max |dxy| = {tr_err:.3e} px, ok flips {tr_flips}, "
        f"tracked {int(ok_k.sum())}/{int(valid.sum())}")
    check(tr_err <= LK_TOL_PX, f"track_features_fused disagrees: {tr_err}")
    check(tr_flips <= LK_MAX_OK_FLIPS, f"tracker ok flips: {tr_flips}")
    kernels.append({"name": "lk_level", "route": "cuda",
                    "source": "visma_tpu_torch/csrc/lk_level.cu",
                    "replaces": "visma_tpu/frontend/klt_fused.py:118",
                    "max_abs_err": k2_err, "ms": k2_ms,
                    "plain_ms": k2_plain_ms})

    # 5. the main path: VioPipeline.run over the bench scene
    pipe = VioPipeline(cfg, levels=4, cell=32, device=dev)
    d_images = torch.as_tensor(frames[1:], device=dev)
    d_gyro = torch.as_tensor(gyro, device=dev)
    d_accel = torch.as_tensor(accel, device=dev)
    d_dts = torch.as_tensor(dts, device=dev)
    torch.cuda.synchronize()

    corner_score.launches = 0
    lk_level.launches = 0
    t0 = time.time()
    st0 = pipe.init(torch.as_tensor(frames[0], device=dev),
                    R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])
    final, outs = pipe.run(st0, d_images, d_gyro, d_accel, d_dts)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = {"corner_score": corner_score.launches,
                "lk_level": lk_level.launches}
    log(f"pipeline first run (init + {N} frames): {first_s:.2f} s; "
        f"launches {launches}")

    check_health(outs)
    p_est = outs["p"].cpu().numpy()
    check(p_est.shape == (N, 3) and np.isfinite(p_est).all(),
          f"bad trajectory shape {p_est.shape}")
    check(np.isfinite(final.filter.P.cpu().numpy()).all(), "P non-finite")
    ate = float(np.sqrt(np.mean(np.sum((p_est - gwc[1:, :, 3]) ** 2,
                                       axis=1))))
    log(f"pipeline ATE RMSE: {ate * 100:.3f} cm over {N} frames @ 500x960 "
        f"(JAX reference on this scene: {REFERENCE_ATE_CM} cm)")
    check(ate < ATE_GATE_M, f"accuracy gate failed: ATE {ate:.4f} m")
    check(launches["corner_score"] == N_FRAMES,
          f"corner_score launches {launches['corner_score']} != {N_FRAMES}")
    check(launches["lk_level"] == N * 5,
          f"lk_level launches {launches['lk_level']} != {N * 5}")
    n_tracked = int(outs["obs_valid"].sum())
    log(f"tracked observations over the run: {n_tracked}")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        _, o = pipe.run(st0, d_images, d_gyro, d_accel, d_dts)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        check(np.allclose(o["p"].cpu().numpy(), p_est, atol=1e-5),
              "repeat run differs")
    log(f"pipeline ms/frame per rep: "
        f"{[round(t / N * 1e3, 3) for t in times]}; best "
        f"{min(times) / N * 1e3:.3f} ms/frame "
        f"({N / min(times):.1f} frames/s)")

    check(sys.modules.get("jax") is None, "jax was imported")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
