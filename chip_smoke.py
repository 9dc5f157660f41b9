#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (visma_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from visma_tpu_torch/csrc with nvcc, then
drives the port's two paths at the full width of the configuration the
repo benches, holding each kernel against its plain PyTorch version on the
card at the shapes the path gives it:

  VIO       240 frames of 500x960 adversarial imagery plus IMU
            (bench.py:67-88) through VioPipeline(levels=4, cell=32).run;
            gates: health, ATE < 0.10 m; kernels corner_score, lk_level.
  semantic  the 4-object chair/desk scene of bench.py:170-207 through
            SemanticMapper.step (detection-driven spawn with retrieval,
            45 frames, finalize); gates of bench.py:318-327: retrieved
            models, 4 tracks, every translation error < 0.05 m, mean
            rotation error < 5 deg, worst < 10 deg; kernels
            chunk_raster_frame, chunk_raster_batched, depth_edge.

For each path the launch counts are set to 0 just before it runs and read
just after, and must equal what the schedule implies. Prints the card, the
kernel table as one JSON line and, last, {"ok": true, "device": {...}}.
Exits non-zero on any failure, and without a CUDA device.
"""
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 240
ATE_GATE_M = 0.10          # bench.py:108
REFERENCE_ATE_CM = 0.37    # BENCH_r05, the JAX reference on this scene
LK_TOL_PX = 1e-3           # kernel vs plain displacement, features ok in both
LK_MAX_OK_FLIPS = 1        # of 96: f32 sum order at the residual/FB gates

# the card's published peaks (H100 SXM data sheet) for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# semantic scene (bench.py:127-207)
SEM_FRAMES = 45
SEM_OBJECTS = 4
SEM_ROI = (256, 384)
SEM_WINDOW = 8             # frames per drained timing window
SEM_WARM = 5               # spawn + settle frames before the timed windows
RASTER_FLOP_PER_PAIR = 16  # 4 planes x (2 multiplies + 2 adds)
DEPTH_REL_TOL = 1e-6       # kernel vs plain depth, relative
EDGE_TOL = 1e-6            # kernel vs plain edge map, absolute


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


def bound(n_bytes, n_flop):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flop / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


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


def compare_depth(got, ref, what):
    """Kernel against plain depth: coverage flips and the largest relative
    difference where both cover. Expected: no flip (same planes, same
    order, no FMA contraction) and 1e-6 (the final reciprocal)."""
    import torch

    fg, fr = torch.isfinite(got), torch.isfinite(ref)
    flips = int((fg != fr).sum())
    both = fg & fr
    err = float((got - ref)[both].abs().max()) if both.any() else 0.0
    rel = float(((got - ref)[both] / ref[both]).abs().max()) \
        if both.any() else 0.0
    log(f"{what}: {int(fg.sum())} covered pixels, coverage flips {flips}, "
        f"max |kernel - plain| = {err:.3e} m (relative {rel:.3e}, tol "
        f"{DEPTH_REL_TOL:.0e})")
    check(flips == 0, f"{what}: {flips} coverage flips against plain")
    check(rel <= DEPTH_REL_TOL, f"{what}: relative depth error {rel}")
    check(int(fg.sum()) > 0, f"{what}: nothing rendered")
    return err


def compare_surface(got, ref, what):
    """Two roundings of one surface (plane raster against the barycentric
    oracle, a window against the crop of the full frame): coverage equal on
    >= 99.9 % of pixels and depth within 1e-3 m on >= 99.9 % of the pixels
    both cover (the bounds tests/test_render.py uses; at a silhouette a
    plane that rounds the other way hands the pixel to another triangle)."""
    import torch

    fg, fr = torch.isfinite(got), torch.isfinite(ref)
    same = float((fg == fr).float().mean())
    both = fg & fr
    far = float(((got - ref)[both].abs() > 1e-3).float().mean()) \
        if both.any() else 0.0
    log(f"{what}: coverage equal on {same:.5f} of pixels, "
        f"{int((fg != fr).sum())} flips; {far:.2e} of {int(both.sum())} "
        f"common pixels differ by > 1e-3 m")
    check(same >= 0.999, f"{what}: coverage differs on {1 - same}")
    check(far <= 1e-3, f"{what}: {far} of common pixels differ")


def vio_phase(dev, kernels):
    """Kernels K1, K2 against their plain versions and the VIO bench scene
    through VioPipeline.run."""
    import numpy as np
    import torch

    from visma_tpu_torch.filter.config import FilterConfig
    from visma_tpu_torch.filter.msckf import check_health
    from visma_tpu_torch.frontend.detect import (corner_score,
                                                 corner_score_plain,
                                                 detect_features)
    from visma_tpu_torch.frontend.klt_fused import (lk_level, lk_level_plain,
                                                    track_features_fused)
    from visma_tpu_torch.frontend.pyramid import build_pyramid
    from visma_tpu_torch.io.synthetic import SyntheticConfig, make_imu
    from visma_tpu_torch.io.synthetic_images import render_adversarial_frames
    from visma_tpu_torch.pipeline import VioPipeline

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

    # K1 against its plain version on a bench frame
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
    # bytes: the frame read once, the score map written once; ~60 flop/px
    k1_bound, k1_by = bound(2 * nbytes(img), 60 * img.numel())
    log(f"K1 time: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, "
        f"bound {k1_bound:.5f} ms ({k1_by})")
    kernels.append({"name": "corner_score", "route": "cuda",
                    "source": "visma_tpu_torch/csrc/corner_score.cu",
                    "replaces": "visma_tpu/frontend/detect.py:30",
                    "max_abs_err": err, "ms": k1_ms,
                    "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
                    "bound_by": k1_by, "library_ms": None})

    # K2 and track_features_fused against their plain versions on two
    # bench frames (K = 96, 4 levels)
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
    # bytes: K windows of win x win from each of the two images, read once
    # (what the function must move; the images are far larger), the starts
    # and origins in, u and the residual out. Operations: per feature and
    # Gauss-Newton step, ~30 flop on each of 11 x 11 template pixels.
    K, win = pts.shape[0], args0[6]
    k2_bytes = 2 * K * win * win * 4 + nbytes(*args0[2:6]) + K * 4 * 4
    k2_bound, k2_by = bound(k2_bytes, K * 8 * 121 * 30)
    log(f"K2 time (level 0, K={K}): kernel {k2_ms:.4f} ms, plain "
        f"{k2_plain_ms:.4f} ms, bound {k2_bound:.6f} ms ({k2_by})")

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
                    "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
                    "bound_by": k2_by, "library_ms": None})

    # the main path: VioPipeline.run over the bench scene
    pipe = VioPipeline(cfg, levels=4, cell=32)
    check(pipe.device.type == "cuda", "VioPipeline did not default to CUDA")
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
    log(f"tracked observations over the run: {int(outs['obs_valid'].sum())}")

    torch.cuda.synchronize()
    t0 = time.time()
    _, o = pipe.run(st0, d_images, d_gyro, d_accel, d_dts)
    torch.cuda.synchronize()
    rep_s = time.time() - t0
    check(np.allclose(o["p"].cpu().numpy(), p_est, atol=1e-5),
          "repeat run differs")
    log(f"pipeline repeat run: {rep_s / N * 1e3:.3f} ms/frame "
        f"({N / rep_s:.1f} frames/s)")
    return launches


def raster_work(planes, ids, counts, out, sub_px):
    """Bytes and operations of one chunk-raster call on these inputs: every
    input read once, the depth written once; each hitting (subtile, chunk)
    costs sub_px^2 x 128 pair evaluations."""
    pairs = int(counts.sum()) * sub_px * sub_px * 128
    return nbytes(planes, ids, counts, out), pairs * RASTER_FLOP_PER_PAIR


def semantic_kernel_checks(mapper, intr, roi, all_poses, mesh_idx, kernels,
                           n_hyp, plain_poses, reps=20):
    """K3, K4, K5 against their plain versions at the shapes of the path,
    the ROI property, and their times. n_hyp: hypothesis windows per
    object in the timed K4 launch; plain_poses: how many hypothesis
    windows go through the (slow) plain version beside the occluders."""
    import numpy as np
    import torch

    from visma_tpu_torch.geom.lie import SE3
    from visma_tpu_torch.image.edges import depth_edge, depth_edge_plain
    from visma_tpu_torch.render import raster as rs
    from visma_tpu_torch.semantic.cem import _others_index, _roi_origins

    dev = mapper.device
    Cs = mapper.mrenderer.Cs
    n = len(mesh_idx)
    mi = torch.as_tensor(mesh_idx, device=dev).long()
    roi_intr = rs._roi_intr(intr, roi)

    # the windows of one real CEM iteration on frame 0: n_hyp settled-sigma
    # perturbations of each object's pose, windows centred on the objects,
    # and the n (n-1) occluder windows
    mean = torch.as_tensor(all_poses[0], device=dev)
    sig = np.array([0.03] * 3 + [0.05] * 3, np.float32)
    xi = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (n, n_hyp, 6)).astype(np.float32) * sig, device=dev)
    hyp = (SE3(mean[:, None, :, :3], mean[:, None, :, 3])
           @ SE3.exp(xi)).matrix3x4().reshape(n * n_hyp, 3, 4)
    origins = _roi_origins(mean[:, :, 3], intr, roi)
    hyp_org = torch.repeat_interleave(origins, n_hyp, dim=0)
    hyp_mi = torch.repeat_interleave(mi, n_hyp)
    oi = _others_index(n, dev)
    occ_pose, occ_mi = mean[oi], mi[oi]
    occ_org = torch.repeat_interleave(origins, n - 1, dim=0)

    # K4 against plain: plain_poses hypothesis windows + all occluder windows
    pick = torch.arange(0, n * n_hyp, max(1, n * n_hyp // plain_poses),
                        device=dev)[:plain_poses]
    c_pose = torch.cat([hyp[pick], occ_pose])
    c_mi = torch.cat([hyp_mi[pick], occ_mi])
    c_org = torch.cat([hyp_org[pick], occ_org])
    got = rs.rasterize_depth_chunked_multi_roi(Cs, c_pose, c_mi, c_org, intr,
                                               roi)
    ref = rs.rasterize_depth_chunked_multi_roi_plain(Cs, c_pose, c_mi, c_org,
                                                     intr, roi)
    torch.cuda.synchronize()
    k4_err = compare_depth(
        got, ref, f"K4 chunk_raster_batched ({len(pick)} hypothesis + "
        f"{len(occ_pose)} occluder windows of {roi[0]}x{roi[1]})")

    # K4 times at one iteration's hypothesis batch
    planes, ids, counts = rs._prep_chunks_all(
        Cs[hyp_mi], hyp, roi_intr, origins=hyp_org, sub_px=rs.SUB_ROI)
    out = rs.chunk_raster_batched(planes, ids, counts, roi_intr)
    k4_ms = cuda_ms(lambda: rs.chunk_raster_batched(planes, ids, counts,
                                                    roi_intr), reps=reps)
    k4_plain_ms = cuda_ms(lambda: rs.chunk_raster_plain(planes, roi_intr),
                          reps=1, warmup=0)
    k4_bytes, k4_flop = raster_work(planes, ids, counts, out, rs.SUB_ROI)
    k4_bound, k4_by = bound(k4_bytes, k4_flop)
    hit = float(counts.float().mean())
    log(f"K4 time ({planes.shape[0]} windows, nc {planes.shape[1]}, mean "
        f"hitting chunks per 16-px subtile {hit:.2f}, "
        f"{float((counts > 0).float().mean()):.2f} of subtiles hit): kernel "
        f"{k4_ms:.4f} ms, plain {k4_plain_ms:.1f} ms, bound {k4_bound:.4f} "
        f"ms ({k4_by}; {k4_flop:.3e} flop, {k4_bytes:.3e} B)")
    kernels.append({"name": "chunk_raster_batched", "route": "cuda",
                    "source": "visma_tpu_torch/csrc/chunk_raster.cu",
                    "replaces": "visma_tpu/render/raster.py:289",
                    "max_abs_err": k4_err, "ms": k4_ms,
                    "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
                    "bound_by": k4_by, "library_ms": None})

    # K3: one full-frame pose per mesh against plain and the oracle
    f_pose = torch.as_tensor(all_poses[0, :2], device=dev)
    f_mi = mi[:2]
    full = rs.rasterize_depth_chunked_multi(Cs, f_pose, f_mi, intr)
    full_plain = rs.rasterize_depth_chunked_multi_plain(Cs, f_pose, f_mi,
                                                        intr)
    torch.cuda.synchronize()
    k3_err = compare_depth(full, full_plain,
                           f"K3 chunk_raster_frame (2 poses of "
                           f"{intr.rows}x{intr.cols})")
    for b in range(2):
        m = int(f_mi[b])
        brute = rs.rasterize_depth_brute(
            mapper.mrenderer.Vs[m], mapper.mrenderer.Fs[m], f_pose[b], intr,
            chunk=64)
        compare_surface(full[b], brute,
                        f"K3 against the barycentric oracle, mesh "
                        f"{mapper.mrenderer.names[m]}")
    fp, fi, fc = rs._prep_chunks_all(Cs[f_mi[:1]], f_pose[:1], intr,
                                     sub_px=rs.SUB_FRAME)
    f_out = rs.chunk_raster_frame(fp, fi, fc, intr)
    k3_ms = cuda_ms(lambda: rs.chunk_raster_frame(fp, fi, fc, intr),
                    reps=reps)
    k3_plain_ms = cuda_ms(lambda: rs.chunk_raster_plain(fp, intr), reps=1,
                          warmup=0)
    k3_bytes, k3_flop = raster_work(fp, fi, fc, f_out, rs.SUB_FRAME)
    k3_bound, k3_by = bound(k3_bytes, k3_flop)
    log(f"K3 time (one {intr.rows}x{intr.cols} pose, mean hitting chunks "
        f"per 32-px subtile {float(fc.float().mean()):.2f}): kernel "
        f"{k3_ms:.4f} ms, plain {k3_plain_ms:.1f} ms, bound {k3_bound:.4f} "
        f"ms ({k3_by}; {k3_flop:.3e} flop, {k3_bytes:.3e} B)")
    kernels.append({"name": "chunk_raster_frame", "route": "cuda",
                    "source": "visma_tpu_torch/csrc/chunk_raster.cu",
                    "replaces": "visma_tpu/render/raster.py:235",
                    "max_abs_err": k3_err, "ms": k3_ms,
                    "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
                    "bound_by": k3_by, "library_ms": None})

    # the ROI property: a K4 window equals the crop of K3's full frame
    win = rs.rasterize_depth_chunked_multi_roi(
        Cs, f_pose, f_mi, origins[:2], intr, roi)
    for b in range(2):
        x0, y0 = int(origins[b, 0]), int(origins[b, 1])
        compare_surface(win[b], full[b, y0:y0 + roi[0], x0:x0 + roi[1]],
                        f"ROI window {b} at ({x0}, {y0}) against the crop "
                        f"of the full frame")

    # K5 on the composited windows of the iteration, and on full frames
    occ_w = rs.rasterize_depth_chunked_multi_roi(
        Cs, occ_pose, occ_mi, occ_org, intr, roi
    ).reshape(n, n - 1, *roi).amin(dim=1)
    joint = torch.minimum(out.reshape(n, n_hyp, *roi), occ_w[:, None])
    joint = joint.reshape(n * n_hyp, *roi).contiguous()
    e_k, e_p = depth_edge(joint), depth_edge_plain(joint)
    f_k, f_p = depth_edge(full), depth_edge_plain(full)
    torch.cuda.synchronize()
    k5_err = max(float((e_k - e_p).abs().max()),
                 float((f_k - f_p).abs().max()))
    log(f"K5 depth_edge on {tuple(joint.shape)} windows and "
        f"{tuple(full.shape)} frames: max |kernel - plain| = {k5_err:.3e} "
        f"(tol {EDGE_TOL:.0e}), edge mass {float(e_k.sum()):.0f}")
    check(k5_err <= EDGE_TOL, f"depth_edge disagrees: {k5_err}")
    check(float(e_k.sum()) > 0, "depth_edge: no edges on real windows")
    k5_ms = cuda_ms(lambda: depth_edge(joint), reps=reps)
    k5_plain_ms = cuda_ms(lambda: depth_edge_plain(joint), reps=reps)
    # 4 bytes in and 4 out per pixel; ~15 operations per pixel
    k5_bound, k5_by = bound(2 * nbytes(joint), 15 * joint.numel())
    log(f"K5 time {tuple(joint.shape)}: kernel {k5_ms:.4f} ms, plain "
        f"{k5_plain_ms:.4f} ms, bound {k5_bound:.4f} ms ({k5_by})")
    kernels.append({"name": "depth_edge", "route": "cuda",
                    "source": "visma_tpu_torch/csrc/depth_edge.cu",
                    "replaces": "visma_tpu/image/edges.py:87",
                    "max_abs_err": k5_err, "ms": k5_ms,
                    "plain_ms": k5_plain_ms, "bound_ms": k5_bound,
                    "bound_by": k5_by, "library_ms": None})


def semantic_run(mapper, intr, names, n_frames, window, warm, sync_counter):
    """The scene through SemanticMapper.step: ground-truth edge frames from
    the port's own render_depth + depth_edge, spawn from detections on
    frame 0, `warm` spawn/settle frames, then drained windows of `window`
    frames, finalize. sync_counter(fn) runs fn and returns how many host
    synchronisations PyTorch reported in it. Returns a dict of results."""
    import numpy as np
    import torch
    from scipy.spatial.transform import Rotation

    from visma_tpu_torch.image.edges import depth_edge
    from visma_tpu_torch.io.synthetic_semantic import (bench_scene,
                                                       gt_detections)

    dev = mapper.device
    m = len(names)
    mesh_idx = np.array([mapper.mrenderer.index(nm) for nm in names])
    _, T_gt, yaw_gt, gwc_at, all_poses = bench_scene(n_frames, m)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.time()
    d = mapper.mrenderer.render_depth(
        all_poses, np.broadcast_to(mesh_idx, (n_frames, m)).copy())
    edge_frames = depth_edge(d.amin(dim=1))
    sync()
    log(f"semantic: rendered {n_frames} ground-truth edge frames "
        f"({n_frames * m} poses) in {time.time() - t0:.2f} s")
    check(tuple(edge_frames.shape) == (n_frames, intr.rows, intr.cols)
          and bool(torch.isfinite(edge_frames).all())
          and float(edge_frames.sum()) > 0, "bad ground-truth edge frames")

    t0 = time.time()
    mapper.step(gwc_at(0), edge_frames[0],
                bboxes=gt_detections(mapper._mesh_aabb, intr, names, yaw_gt,
                                     all_poses[0]))
    sync()
    spawn_ms = (time.time() - t0) * 1e3
    spawn_order = sorted(mapper.tracks)
    need_occ_spawn = mapper._footprints_may_overlap(
        all_poses[0], names, mapper.init_sigma)

    def trans_errs():
        return [float(np.linalg.norm(
            mapper.tracks[oid].pose_wm[:3, 3] - T_gt[k][:3, 3]))
            for k, oid in enumerate(spawn_order)]

    settle_frame = 0 if spawn_order and max(trans_errs()) < 0.075 else None
    for i in range(1, warm):
        mapper.step(gwc_at(i), edge_frames[i])
        mapper._sync_dev()
        if settle_frame is None and max(trans_errs()) < 0.075:
            settle_frame = i
    log(f"semantic: spawn frame {spawn_ms:.0f} ms (retrieval + windowed "
        f"spawn CEM, {len(mapper.tracks)} tracks), all within 0.075 m by "
        f"frame {settle_frame}")

    win_ms, syncs = [], 0
    i = warm
    while i + window <= n_frames:
        sync()
        t0 = time.time()
        for j in range(i, i + window):
            syncs += sync_counter(
                lambda: mapper.step(gwc_at(j), edge_frames[j]))
        mapper._sync_dev()      # drain the enqueued frames: honest timing
        sync()
        win_ms.append((time.time() - t0) / window * 1e3)
        i += window
    n_stepped = i
    mapper.finalize()

    terr, rerr, models = trans_errs(), [], []
    for k, oid in enumerate(spawn_order):
        tr = mapper.tracks[oid]
        rerr.append(float(np.degrees(Rotation.from_matrix(
            tr.pose_wm[:3, :3] @ T_gt[k][:3, :3].T).magnitude())))
        models.append(tr.model_name)
    log(f"semantic: window ms/frame {[round(x, 2) for x in win_ms]}")
    log(f"semantic: {m} objects, retrieved {models}, trans err "
        f"{[round(x, 4) for x in terr]} m, rot err "
        f"{[round(x, 2) for x in rerr]} deg; host synchronisations in "
        f"the {n_stepped - warm} windowed steps: {syncs}")
    poses = np.array([mapper.tracks[o].pose_wm for o in spawn_order])
    check(poses.shape == (m, 4, 4) and np.isfinite(poses).all(),
          "non-finite or missing track poses")
    check(len(mapper.history) == n_stepped
          and all(isinstance(p, list) and len(p) == m
                  for p in mapper.history), "history packets incomplete")
    return {"models": models, "terr": terr, "rerr": rerr,
            "n_tracks": len(mapper.tracks), "spawn_ms": spawn_ms,
            "settle_frame": settle_frame, "win_ms": win_ms, "syncs": syncs,
            "n_stepped": n_stepped, "need_occ_spawn": need_occ_spawn}


def check_semantic_gates(res, names):
    """bench.py:318-327."""
    import numpy as np

    check(res["models"] == names,
          f"shape retrieval failed: {res['models']} != {names}")
    check(res["n_tracks"] == len(names), "spawn/dedup failed")
    check(max(res["terr"]) < 0.05,
          f"per-object translation gate failed: {res['terr']} m")
    check(float(np.mean(res["rerr"])) < 5.0,
          f"mean rotation gate failed: {np.mean(res['rerr']):.2f} deg")
    check(max(res["rerr"]) < 10.0,
          f"worst-object rotation gate failed: {max(res['rerr']):.2f} deg")


def expected_semantic_launches(n_frames_rendered, n_objects, n_stepped,
                               mapper):
    """What the schedule implies, with occluders rendered in every
    iteration (the scene's footprints overlap): ground truth = one
    chunk_raster_frame a pose and one depth_edge for all frames; each
    retrieval = one batched raster + one depth_edge; each CEM iteration =
    one batched raster for the occluder windows and one for the hypothesis
    windows, one depth_edge for the composited windows and one for the
    occluders."""
    spawn_frames = min(mapper.settle_age, n_stepped)
    iters = (spawn_frames * mapper.cem_iters
             + (n_stepped - spawn_frames) * mapper.settled_iters)
    return {"chunk_raster_frame": n_frames_rendered * n_objects,
            "chunk_raster_batched": n_objects + 2 * iters,
            "depth_edge": 1 + n_objects + 2 * iters}


def semantic_phase(dev, kernels):
    import torch

    from visma_tpu_torch.image.edges import depth_edge
    from visma_tpu_torch.io.procedural import bench_mesh_db
    from visma_tpu_torch.io.synthetic_semantic import (BENCH_INTRINSICS,
                                                       bench_scene)
    from visma_tpu_torch.render import raster as rs
    from visma_tpu_torch.render.camera import Intrinsics
    from visma_tpu_torch.semantic import SemanticMapper

    intr = Intrinsics(**BENCH_INTRINSICS)
    db = bench_mesh_db()
    names, _, _, _, all_poses = bench_scene(SEM_FRAMES, SEM_OBJECTS)
    log(f"semantic: mesh database "
        f"{ {n: len(F) for n, (_, F) in db.items()} } faces")
    mapper = SemanticMapper(intr, db, cem_iters=5, cem_samples=48,
                            roi=SEM_ROI, retrieval_yaws=24, settle_age=2,
                            settled_iters=3, settled_samples=24,
                            settled_sigma=(0.05, 0.03), async_frames=16,
                            roi_spawn=True)
    check(mapper.device.type == "cuda"
          and mapper.mrenderer.Cs.device.type == "cuda",
          "SemanticMapper did not default to CUDA")
    warm_s = mapper.warmup(SEM_OBJECTS)
    log(f"semantic: warmup {warm_s:.2f} s")

    mesh_idx = [mapper.mrenderer.index(n) for n in names]
    semantic_kernel_checks(mapper, intr, SEM_ROI, all_poses, mesh_idx,
                           kernels, n_hyp=24, plain_poses=8)

    def sync_counter(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        hits = [w for w in caught
                if "called a synchronizing" in str(w.message)]
        for w in hits[:3]:
            log(f"  host synchronisation: {w.message} "
                f"({w.filename}:{w.lineno})")
        return len(hits)

    counted = (rs.chunk_raster_frame, rs.chunk_raster_batched, depth_edge)
    for fn in counted:
        fn.launches = 0
    res = semantic_run(mapper, intr, names, SEM_FRAMES, SEM_WINDOW, SEM_WARM,
                       sync_counter)
    launches = {fn.__name__: fn.launches for fn in counted}
    log(f"semantic: launches {launches}")
    check_semantic_gates(res, names)
    check(res["need_occ_spawn"], "the scene's footprints do not overlap")
    want = expected_semantic_launches(SEM_FRAMES, SEM_OBJECTS,
                                      res["n_stepped"], mapper)
    check(launches == want, f"semantic launches {launches} != {want}")
    # a settled step leaves the poses on the device and reads nothing back
    check(res["syncs"] == 0,
          f"{res['syncs']} host synchronisations in settled steps")
    log(f"semantic: settled best {min(res['win_ms']):.3f} ms/frame "
        f"({1e3 / min(res['win_ms']):.1f} frames/s) over drained "
        f"{SEM_WINDOW}-frame windows; spawn frame {res['spawn_ms']:.0f} ms; "
        f"all within 0.075 m by frame {res['settle_frame']}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from visma_tpu_torch import _kernels

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    _kernels.library()
    log(f"kernels built/loaded in {time.time() - t0:.2f} s "
        f"({_kernels.build_dir()})")
    build_log = _kernels.build_dir() / "build.log"
    if build_log.is_file():
        for line in build_log.read_text().splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line):
                log("  " + line.strip())

    kernels = []
    launches = vio_phase(dev, kernels)
    launches.update(semantic_phase(dev, kernels))

    check(sys.modules.get("jax") is None, "jax was imported")
    check(not any(k == "visma_tpu" or k.startswith("visma_tpu.")
                  for k in sys.modules), "the JAX package was imported")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        check(k["launches"] > 0, f"{k['name']} was never launched")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
