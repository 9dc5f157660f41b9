#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (visma_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from visma_tpu_torch/csrc with nvcc, then
drives the port's three paths at the full width of the configuration the
repo benches, holding each kernel against its plain PyTorch version on the
card at the shapes the path gives it:

  VIO       240 frames of 500x960 adversarial imagery plus IMU
            (bench.py:67-88) through VioPipeline(levels=4, cell=32).run;
            gates: health, ATE < 0.10 m; kernels corner_score, lk_track
            (one launch a tracked frame; its per-level entry lk_level is
            held against its plain version level by level as well).
  semantic  the 4-object chair/desk scene of bench.py:170-207 through
            SemanticMapper.step (detection-driven spawn with retrieval,
            45 frames, finalize); gates of bench.py:318-327: retrieved
            models, 4 tracks, every translation error < 0.05 m, mean
            rotation error < 5 deg, worst < 10 deg; kernels
            chunk_raster_frame, chunk_raster_batched (also on a set of
            windows made to hurt their coarse cull), depth_edge and
            edge_score (one call a CEM iteration and a retrieval).
  ingest    the VIO scene as the camera delivers it: 240 raw distorted
            600x960 uint8 frames (the scene rendered with the Corvis
            undistorter's output camera and warped by the inverse ATAN
            map) through Undistorter's table and bilinear_remap, cropped
            to the central 500 rows, then VioPipeline.run with the VIO
            phase's settings; then 40 such frames from disk through the
            undistort_images and run_vio command-line tools. Gates: blob
            centroids within 0.25 px of their projections after
            undistortion, health, ATE < 0.10 m; kernels bilinear_remap,
            corner_score, lk_track.

For each path the launch counts are set to 0 just before it runs and read
just after, and must equal what the schedule implies. No kernel may read
faster than its bound. Prints the card, the kernel table as one JSON line
and, last, {"ok": true, "device": {...}}.
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
EARLIER_ATE_CM = {"vio": 0.388, "ingest": 0.708}   # five launches a frame
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
SCORE_TOL = 1e-4           # edge_score vs plain: sums in another order

# ingest scene
REMAP_REL_TOL = 1e-5       # kernel vs plain remap, f32, of the value range
GEOMETRY_TOL_PX = 0.25     # blob centroid vs projection after undistortion
CLI_FRAMES = 40            # frames of the sequence written to disk
EPOCH_US = 1520535100000000  # VISMA frames are stamped in microseconds
REMAP_FLOP_PER_VALUE = 12  # 4 multiplies + 3 adds, the weights amortised


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


def graph_ms(fn, reps=20, replays=5):
    """Mean device time of fn() in ms with the host taken out: `reps` calls
    are captured into one CUDA graph and its replays are timed. Beside
    cuda_ms it shows how much of a short call's time is its Python
    wrapper."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=replays, warmup=1) / reps


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


def tie_frame():
    """A 200x300 frame of identical step corners, one in each of 160
    16-px cells (equal scores across cells), and two in one cell (equal
    scores inside it)."""
    import numpy as np

    img = np.zeros((200, 300), np.float32)
    for cy in range(1, 11):
        for cx in range(1, 17):
            img[cy * 16 + 6:cy * 16 + 11, cx * 16 + 6:cx * 16 + 11] = 100.0
    img[66:71, 100:105] = 100.0
    return img


def cell_pick_checks(img, corner_cells, corner_score_plain, cell_best_plain):
    """K1's per-cell pick equals cell_best_plain exactly, scores and
    indices, on the bench frame (cells 32, 16, 12) and on a frame built
    with ties (cells 16, 12); the map beside it equals plain within 1e-4
    of its largest score, as corner_score's does. Returns the number of
    cells checked."""
    import torch

    checked = 0
    frames = [(img, c) for c in (32, 16, 12)]
    ties = torch.as_tensor(tie_frame(), device=img.device)
    frames += [(ties, 16), (ties, 12)]
    for frame, cell in frames:
        score, best, idx, xy = corner_cells(frame, cell)
        ref = corner_score_plain(frame)
        pb, pi = cell_best_plain(ref, cell)
        torch.cuda.synchronize()
        e = float((score - ref).abs().max())
        tol = 1e-4 * max(1.0, float(ref.max()))
        same = bool(torch.equal(best, pb)) and bool(torch.equal(idx, pi))
        Wc = (frame.shape[1] // cell) * cell
        flat = torch.clamp(idx, min=0)
        xy_ok = bool(torch.equal(xy[..., 0], (flat % Wc).float())
                     and torch.equal(xy[..., 1], (flat // Wc).float()))
        log(f"K1 cell pick, {tuple(frame.shape)} cell {cell}: map max "
            f"|kernel - plain| = {e:.3e}; scores and indices of "
            f"{best.numel()} cells equal to cell_best_plain: {same}; "
            f"{int((idx >= 0).sum())} cells hold a corner")
        check(e <= tol, f"corner_cells map disagrees: {e}")
        check(same and xy_ok, f"K1 cell pick differs at cell {cell}")
        checked += best.numel()
    vals = corner_cells(ties, 16)[1]
    check(int((vals == vals.max()).sum()) > 1, "the tie frame has no ties")
    return checked


def old_cell_chain(img, cell, corner_score, cell_best_plain):
    """The detection's per-cell pick as the path ran it before the pick
    moved into K1: the map from the kernel, then PyTorch ops."""
    import torch

    best, idx = cell_best_plain(corner_score(img), cell)
    flat = torch.clamp(idx, min=0)
    Wc = (img.shape[1] // cell) * cell
    return best, idx, torch.stack([flat % Wc, flat // Wc], -1).float()


def old_score_chain(d, occ, dt, obs, mass):
    """The CEM's score as the path ran it before edge_score: depth_edge on
    the composited windows and on the occluders, then the max-pool,
    chamfer and coverage as PyTorch ops."""
    import torch

    from visma_tpu_torch.image.edges import depth_edge
    from visma_tpu_torch.render.likelihood import symmetric_edge_score

    o = occ.unsqueeze(-3)
    a = torch.clamp(depth_edge(torch.minimum(d, o)) - depth_edge(o), min=0.0)
    return symmetric_edge_score(a, dt.unsqueeze(-3), obs.unsqueeze(-3),
                                obs_mass=mass)


def vio_phase(dev, kernels):
    """Kernels K1, K2 against their plain versions and the VIO bench scene
    through VioPipeline.run."""
    import numpy as np
    import torch

    from visma_tpu_torch.filter.config import FilterConfig
    from visma_tpu_torch.filter.msckf import check_health
    from visma_tpu_torch.frontend.detect import (cell_best_plain,
                                                 corner_cells, corner_score,
                                                 corner_score_plain,
                                                 detect_features)
    from visma_tpu_torch.frontend.klt_fused import (lk_level, lk_level_plain,
                                                    lk_track, lk_track_plain,
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

    # K1 against its plain version on a bench frame: the map alone, and
    # the map with the per-cell pick of the path's detection (cell 32)
    img = torch.as_tensor(frames[1], device=dev)
    got = corner_score(img)
    ref = corner_score_plain(img)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    tol = 1e-4 * max(1.0, float(ref.max()))
    log(f"K1 corner_score: max |kernel - plain| = {err:.3e} "
        f"(tol {tol:.3e}), {int((got > 0).sum())} corners")
    check(err <= tol, f"corner_score disagrees with its plain version: {err}")
    k1_cells = cell_pick_checks(img, corner_cells, corner_score_plain,
                                cell_best_plain)
    k1_ms = cuda_ms(lambda: corner_cells(img, 32))
    k1_graph = graph_ms(lambda: corner_cells(img, 32))
    k1_plain_ms = cuda_ms(lambda: cell_best_plain(corner_score_plain(img), 32))
    chain_ms = cuda_ms(lambda: old_cell_chain(img, 32, corner_score,
                                              cell_best_plain))
    chain_graph = graph_ms(lambda: old_cell_chain(img, 32, corner_score,
                                                  cell_best_plain))
    map_ms = cuda_ms(lambda: corner_score(img))
    map_graph = graph_ms(lambda: corner_score(img))
    # bytes: the frame read once, the map and the cells' picks written
    # once; ~60 flop a pixel
    _, best, idx, xy = corner_cells(img, 32)
    k1_bound, k1_by = bound(2 * nbytes(img) + nbytes(best, idx, xy),
                            60 * img.numel())
    log(f"K1 time, one 500x960 frame with the pick of cell 32: kernel "
        f"{k1_ms:.4f} ms through the wrapper ({k1_graph:.4f} replayed from a "
        f"CUDA graph); the map alone {map_ms:.4f} ({map_graph:.4f}); the "
        f"chain it replaces (the map, then the cell pick in PyTorch ops) "
        f"{chain_ms:.4f} ({chain_graph:.4f} from a graph); plain "
        f"{k1_plain_ms:.4f} ms; bound {k1_bound:.5f} ms ({k1_by})")
    kernels.append({"name": "corner_score", "route": "cuda",
                    "source": "visma_tpu_torch/csrc/corner_score.cu",
                    "replaces": "visma_tpu/frontend/detect.py:30",
                    "max_abs_err": err, "ms": k1_ms,
                    "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
                    "bound_by": k1_by, "library_ms": None,
                    "shape": "one 500x960 frame, the map and the pick of "
                             "cell 32",
                    "graph_ms": k1_graph, "map_alone_ms": map_ms,
                    "map_alone_graph_ms": map_graph,
                    "replaced_chain_ms": chain_ms,
                    "replaced_chain_graph_ms": chain_graph,
                    "cells_checked": k1_cells})

    # K2 level by level, lk_track and track_features_fused against their
    # plain versions on two bench frames (K = 96, 4 levels)
    prev_pyr = tuple(build_pyramid(torch.as_tensor(frames[0], device=dev), 4))
    cur_pyr = tuple(build_pyramid(img, 4))
    pts, _, valid = detect_features(prev_pyr[0], cfg.max_tracks, 32)
    check(int(valid.sum()) >= 48, "too few corners on the bench frame")
    k2_err, k2_flips = 0.0, 0
    lk_level.launches = 0
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
    check(lk_level.launches == 4, "lk_level did not launch its kernel")
    args0 = lk_level_args(prev_pyr, cur_pyr, pts, 0)
    lv_ms = cuda_ms(lambda: lk_level(*args0))
    log(f"K2 lk_level alone (level 0, K={pts.shape[0]}): {lv_ms:.4f} ms")

    # lk_track against lk_track_plain on the card: every 7th feature
    # invalid, four moved to the frame's edge
    H, W = prev_pyr[0].shape
    t_pts = pts.clone()
    t_pts[:4] = torch.tensor([[2.0, 3.5], [W - 2.5, H - 3.0], [W / 2, 1.0],
                              [0.5, H / 2]], device=dev)
    t_valid = valid.clone()
    t_valid[::7] = False
    lk_track.launches = 0
    new_k, ok_k = lk_track(prev_pyr, cur_pyr, t_pts, t_valid, levels=4)
    torch.cuda.synchronize()
    check(lk_track.launches == 1, "lk_track did not launch once")
    new_p, ok_p = lk_track_plain(prev_pyr, cur_pyr, t_pts, t_valid, levels=4)
    both = ok_k & ok_p
    trk_err = float((new_k - new_p)[both].abs().max())
    trk_flips = int((ok_k != ok_p).sum())
    log(f"K2 lk_track (4 levels + forward-backward in one launch, "
        f"{int((~t_valid).sum())} features invalid, 4 at the frame's edge): "
        f"max |dxy| = {trk_err:.3e} px (tol {LK_TOL_PX}), ok flips "
        f"{trk_flips}, tracked {int(ok_k.sum())}/{int(t_valid.sum())}")
    check(trk_err <= LK_TOL_PX, f"lk_track disagrees: {trk_err} px")
    check(trk_flips <= LK_MAX_OK_FLIPS, f"lk_track ok flips: {trk_flips}")
    check(not bool(ok_k[~t_valid].any())
          and bool((new_k[~t_valid] == t_pts[~t_valid]).all()),
          "lk_track moved an invalid feature")
    check(int(ok_k.sum()) >= 40, "lk_track tracked too few features")

    k2_ms = cuda_ms(lambda: lk_track(prev_pyr, cur_pyr, pts, valid, levels=4))
    k2_graph_ms = graph_ms(lambda: lk_track(prev_pyr, cur_pyr, pts, valid,
                                            levels=4))
    k2_plain_ms = cuda_ms(lambda: lk_track_plain(prev_pyr, cur_pyr, pts,
                                                 valid, levels=4), reps=5)
    fused_ms = cuda_ms(lambda: track_features_fused(prev_pyr, cur_pyr, pts,
                                                    valid, levels=4))
    # bytes: per level and for the forward-backward pass, K windows of
    # wl x wl from each of the two images, read once (what the function
    # must move; the images are far larger); pts and valid in, new_pts and
    # ok out. Operations: per feature, solve and Gauss-Newton step, ~30
    # flop on each of 11 x 11 template pixels.
    K = pts.shape[0]
    wins = [lk_level_args(prev_pyr, cur_pyr, pts, lv)[6] for lv in range(4)]
    k2_bytes = sum(2 * K * w * w * 4 for w in wins + wins[:1]) \
        + 2 * nbytes(pts) + 2 * nbytes(valid)
    k2_bound, k2_by = bound(k2_bytes, K * 5 * 8 * 121 * 30)
    log(f"K2 time, one tracked frame (K={K}, windows {wins} + "
        f"forward-backward): lk_track {k2_ms:.4f} ms through the wrapper "
        f"({k2_graph_ms:.4f} replayed from a CUDA graph), "
        f"track_features_fused {fused_ms:.4f} ms, plain {k2_plain_ms:.3f} "
        f"ms, bound {k2_bound:.6f} ms ({k2_by})")

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
    kernels.append({"name": "lk_track", "route": "cuda",
                    "source": "visma_tpu_torch/csrc/lk_level.cu",
                    "replaces": "visma_tpu/frontend/klt_fused.py:118",
                    "max_abs_err": max(k2_err, trk_err), "ms": k2_ms,
                    "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
                    "bound_by": k2_by, "library_ms": None,
                    "shape": f"one tracked frame: K={K}, 4 levels and the "
                             "forward-backward pass",
                    "graph_ms": k2_graph_ms,
                    "lk_level_alone_ms": lv_ms})

    # the main path: VioPipeline.run over the bench scene
    pipe = VioPipeline(cfg, levels=4, cell=32)
    check(pipe.device.type == "cuda", "VioPipeline did not default to CUDA")
    d_images = torch.as_tensor(frames[1:], device=dev)
    d_gyro = torch.as_tensor(gyro, device=dev)
    d_accel = torch.as_tensor(accel, device=dev)
    d_dts = torch.as_tensor(dts, device=dev)
    torch.cuda.synchronize()

    corner_score.launches = 0
    lk_track.launches = 0
    t0 = time.time()
    st0 = pipe.init(torch.as_tensor(frames[0], device=dev),
                    R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])
    final, outs = pipe.run(st0, d_images, d_gyro, d_accel, d_dts)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = {"corner_score": corner_score.launches,
                "lk_track": lk_track.launches}
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
        f"(JAX reference on this scene: {REFERENCE_ATE_CM} cm; this path "
        f"with five launches a tracked frame: {EARLIER_ATE_CM['vio']} cm)")
    check(ate < ATE_GATE_M, f"accuracy gate failed: ATE {ate:.4f} m")
    check(launches["corner_score"] == N_FRAMES,
          f"corner_score launches {launches['corner_score']} != {N_FRAMES}")
    check(launches["lk_track"] == N,
          f"lk_track launches {launches['lk_track']} != {N}: not one launch "
          "a tracked frame")
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
    return launches, ate


def raster_work(C, poses, intr, origins, planes, ids, counts, out, sub_px):
    """Bytes and operations of one chunk-raster call on these inputs. Bytes:
    every input read once, the depth written once. Operations: the (pixel,
    triangle) pairs whose triangle's own screen bbox holds the pixel, 16
    flop each: a count that depends neither on the chunking nor on the
    kernel. Returns (bytes, flop, flop_chunks); flop_chunks is the earlier
    figure, every pixel of a subtile against all 128 triangles of each of
    its hitting chunks."""
    import torch

    from visma_tpu_torch.render import raster as rs

    _, _, x0, x1, y0, y1 = rs._planes_batched(C, poses, intr, origins=origins)
    nx = torch.clamp(torch.floor(x1), max=intr.cols - 1) \
        - torch.clamp(torch.ceil(x0), min=0) + 1
    ny = torch.clamp(torch.floor(y1), max=intr.rows - 1) \
        - torch.clamp(torch.ceil(y0), min=0) + 1
    pairs = int((torch.clamp(nx, min=0) * torch.clamp(ny, min=0))
                .to(torch.float64).sum())
    chunk_pairs = int(counts.sum()) * sub_px * sub_px * 128
    return (nbytes(planes, ids, counts, out), pairs * RASTER_FLOP_PER_PAIR,
            chunk_pairs * RASTER_FLOP_PER_PAIR)


def survivor_share(planes, ids, counts, intr, sub_px, step=8):
    """What the kernels' two culls leave, by the plain cull on the planes'
    device: (share of the (subtile, triangle) pairs of hitting chunks that
    survive the subtile's test, share of the (warp footprint, surviving
    triangle) pairs that survive the footprint's test too)."""
    import torch

    from visma_tpu_torch.render import raster as rs

    dev = planes.device
    nc = planes.shape[1]
    nsx = rs._subtile_grid(intr, sub_px)[1]
    fh, fw = rs.warp_footprint(sub_px)
    nfy, nfx = -(-intr.rows // fh), -(-intr.cols // fw)
    # the subtile each footprint of the (nfy, nfx) grid lies in
    st_of = ((torch.arange(nfy, device=dev) // (sub_px // fh))[:, None] * nsx
             + (torch.arange(nfx, device=dev) // (sub_px // fw))[None, :]
             ).reshape(-1)
    kept = total = fine_kept = 0
    for b in range(0, planes.shape[0], step):
        listed = torch.zeros(ids[b:b + step].shape, dtype=torch.bool,
                             device=dev)
        listed.scatter_(2, ids[b:b + step].long(),
                        torch.arange(nc, device=dev)[None, None]
                        < counts[b:b + step, :, None])
        surv = rs.subtile_cull_plain(planes[b:b + step], intr, sub_px) \
            & listed[..., None]
        fine = rs.subtile_cull_plain(planes[b:b + step], intr, (fh, fw))
        kept += int(surv.sum())
        total += int(listed.sum()) * planes.shape[2]
        fine_kept += int((fine & surv[:, st_of]).sum())
    per_subtile = (sub_px // fh) * (sub_px // fw)
    return kept / max(total, 1), fine_kept / max(kept * per_subtile, 1)


def adversarial_windows(mean, mesh_idx, origins, roi):
    """Windows made to hurt the coarse cull, from the objects' model->camera
    poses `mean` (n,3,4), their mesh indices and window origins (n,2):
      * object 0 at all 16 diagonal shifts of its window by one pixel, so
        that every silhouette runs along a 16-px subtile border in one of
        them;
      * objects 0 and 1 pulled to 0.9 m: they overflow the window, with
        triangles larger than a subtile;
      * objects 0 and 1 at 0.35 m, partly behind the near plane (dead
        triangles, huge coefficients), and pushed to 7.8 m, so that the
        far plane at 8 m clips inside the window;
      * object 0 seen through a window a frame away: nothing in it.
    Returns (poses (23,3,4), mesh index (23,), origins (23,2))."""
    import torch

    def at_depth(k, z):
        p = mean[k].clone()
        p[:, 3] = p[:, 3] * (z / p[2, 3])
        return p

    shifts = torch.arange(16, dtype=origins.dtype, device=origins.device)
    poses = [mean[0]] * 16
    orgs = [origins[0] + sh for sh in shifts]
    idx = [0] * 16
    for z in (0.9, 0.35, 7.8):
        for k in (0, 1):
            poses.append(at_depth(k, z))
            orgs.append(origins[k])
            idx.append(k)
    poses.append(mean[0])
    orgs.append(origins[0] + torch.tensor(
        [4.0 * roi[1], 4.0 * roi[0]], dtype=origins.dtype,
        device=origins.device))
    idx.append(0)
    return (torch.stack(poses), mesh_idx[torch.as_tensor(idx)],
            torch.stack(orgs))


def semantic_kernel_checks(mapper, intr, roi, all_poses, mesh_idx, kernels,
                           n_hyp, plain_poses, reps=20):
    """K3, K4, K5 against their plain versions at the shapes of the path,
    the ROI property, and their times. n_hyp: hypothesis windows per
    object in the timed K4 launch; plain_poses: how many hypothesis
    windows go through the (slow) plain version beside the occluders."""
    import torch

    from visma_tpu_torch.image.edges import depth_edge, depth_edge_plain
    from visma_tpu_torch.render import raster as rs
    from visma_tpu_torch.semantic.cem import _others_index, _roi_origins
    from visma_tpu_torch.time_kernels import hypothesis_windows

    dev = mapper.device
    Cs = mapper.mrenderer.Cs
    n = len(mesh_idx)
    mi = torch.as_tensor(mesh_idx, device=dev).long()
    roi_intr = rs._roi_intr(intr, roi)

    # the windows of one real CEM iteration on frame 0: n_hyp settled-sigma
    # perturbations of each object's pose, windows centred on the objects,
    # and the n (n-1) occluder windows
    mean = torch.as_tensor(all_poses[0], device=dev)
    hyp, hyp_mi, hyp_org = hypothesis_windows(mean, mi, intr, roi, n_hyp)
    origins = _roi_origins(mean[:, :, 3], intr, roi)
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

    # K4 on the windows made to hurt the cull
    a_pose, a_mi, a_org = adversarial_windows(mean, mi, origins, roi)
    got = rs.rasterize_depth_chunked_multi_roi(Cs, a_pose, a_mi, a_org, intr,
                                               roi)
    ref = rs.rasterize_depth_chunked_multi_roi_plain(Cs, a_pose, a_mi, a_org,
                                                     intr, roi)
    torch.cuda.synchronize()
    k4_err = max(k4_err, compare_depth(
        got, ref, f"K4 chunk_raster_batched on {len(a_pose)} adversarial "
        f"windows (subtile-border shifts, overflow, near and far clipping, "
        f"empty)"))
    check(bool(torch.isinf(got[-1]).all()), "the empty window is not empty")
    check(all(int(torch.isfinite(g).sum()) > 0 for g in got[:-1]),
          "an adversarial window rendered nothing")

    # K4 times at one iteration's hypothesis batch
    C = Cs[hyp_mi]

    def prep():
        return rs._prep_chunks_all(C, hyp, roi_intr, origins=hyp_org,
                                   sub_px=rs.SUB_ROI)

    planes, ids, counts = prep()
    prep_ms = cuda_ms(prep, reps=reps)
    out = rs.chunk_raster_batched(planes, ids, counts, roi_intr)
    k4_ms = cuda_ms(lambda: rs.chunk_raster_batched(planes, ids, counts,
                                                    roi_intr), reps=reps)
    none = torch.zeros_like(counts)
    k4_empty_ms = cuda_ms(lambda: rs.chunk_raster_batched(planes, ids, none,
                                                          roi_intr), reps=reps)
    k4_plain_ms = cuda_ms(lambda: rs.chunk_raster_plain(planes, roi_intr),
                          reps=1, warmup=0)
    k4_bytes, k4_flop, k4_flop_chunks = raster_work(
        C, hyp, roi_intr, hyp_org, planes, ids, counts, out, rs.SUB_ROI)
    k4_bound, k4_by = bound(k4_bytes, k4_flop)
    share, fine = survivor_share(planes, ids, counts, roi_intr, rs.SUB_ROI)
    hit = float(counts.float().mean())
    log(f"K4 time ({planes.shape[0]} windows, nc {planes.shape[1]}, mean "
        f"hitting chunks per 16-px subtile {hit:.2f}, "
        f"{float((counts > 0).float().mean()):.2f} of subtiles hit, "
        f"{share:.4f} of the (subtile, triangle) pairs of hitting chunks "
        f"survive the subtile's cull and {fine:.4f} of the (warp, surviving "
        f"triangle) pairs the warp footprint's): kernel {k4_ms:.4f} ms ({k4_empty_ms:.4f} with "
        f"every list empty), plain {k4_plain_ms:.1f} ms, bound "
        f"{k4_bound:.4f} ms ({k4_by}; {k4_flop:.3e} flop over the triangles' "
        f"own bboxes, {k4_bytes:.3e} B); every pair of every hitting chunk: "
        f"{k4_flop_chunks:.3e} flop, "
        f"{k4_flop_chunks / F32_FLOP_PER_S * 1e3:.4f} ms; _prep_chunks_all "
        f"for the batch {prep_ms:.4f} ms")
    kernels.append({"name": "chunk_raster_batched", "route": "cuda",
                    "source": "visma_tpu_torch/csrc/chunk_raster.cu",
                    "replaces": "visma_tpu/render/raster.py:289",
                    "max_abs_err": k4_err, "ms": k4_ms,
                    "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
                    "bound_by": k4_by, "library_ms": None,
                    "survivor_share": share, "footprint_share": fine,
                    "empty_lists_ms": k4_empty_ms,
                    "all_pairs_of_hitting_chunks_ms":
                        k4_flop_chunks / F32_FLOP_PER_S * 1e3,
                    "prep_chunks_all_ms": prep_ms})

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
    k3_bytes, k3_flop, k3_flop_chunks = raster_work(
        Cs[f_mi[:1]], f_pose[:1], intr, None, fp, fi, fc, f_out, rs.SUB_FRAME)
    k3_bound, k3_by = bound(k3_bytes, k3_flop)
    k3_share, k3_fine = survivor_share(fp, fi, fc, intr, rs.SUB_FRAME)
    log(f"K3 time (one {intr.rows}x{intr.cols} pose, mean hitting chunks "
        f"per 32-px subtile {float(fc.float().mean()):.2f}, {k3_share:.4f} "
        f"of their triangles survive the subtile's cull, {k3_fine:.4f} of "
        f"those a warp footprint's): kernel {k3_ms:.4f} ms, "
        f"plain {k3_plain_ms:.1f} ms, bound {k3_bound:.4f} ms ({k3_by}; "
        f"{k3_flop:.3e} flop over the triangles' own bboxes, "
        f"{k3_bytes:.3e} B); every pair of every hitting chunk: "
        f"{k3_flop_chunks:.3e} flop, "
        f"{k3_flop_chunks / F32_FLOP_PER_S * 1e3:.4f} ms")
    kernels.append({"name": "chunk_raster_frame", "route": "cuda",
                    "source": "visma_tpu_torch/csrc/chunk_raster.cu",
                    "replaces": "visma_tpu/render/raster.py:235",
                    "max_abs_err": k3_err, "ms": k3_ms,
                    "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
                    "bound_by": k3_by, "library_ms": None,
                    "survivor_share": k3_share, "footprint_share": k3_fine,
                    "all_pairs_of_hitting_chunks_ms":
                        k3_flop_chunks / F32_FLOP_PER_S * 1e3})

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
                    "bound_by": k5_by, "library_ms": None,
                    "shape": f"{tuple(joint.shape)}",
                    "graph_ms": graph_ms(lambda: depth_edge(joint),
                                         reps=reps)})

    edge_score_checks(mapper, intr, roi, mean, mi, origins,
                      out.reshape(n, n_hyp, *roi), occ_w, kernels, reps)


def edge_score_checks(mapper, intr, roi, mean, mi, origins, settled, occ_w,
                      kernels, reps):
    """The fused score against its plain version on the shapes of the path:
    the settled iteration's real windows (`settled` (n, S, *roi) hypothesis
    depths and their occluder windows occ_w), the spawn CEM's 48 windows an
    object, full frames with the evidence shared by all objects, and
    windows with no occluder (retrieval's form); every pair of launches
    bit-identical. Then its time at the settled shape beside the chain it
    replaced."""
    import torch

    from visma_tpu_torch.render import raster as rs
    from visma_tpu_torch.render.likelihood import (edge_distance_transform,
                                                   edge_score,
                                                   edge_score_plain)
    from visma_tpu_torch.image.edges import depth_edge
    from visma_tpu_torch.semantic.cem import CEM_TAU, _crop
    from visma_tpu_torch.time_kernels import hypothesis_windows

    Cs = mapper.mrenderer.Cs
    n = mean.shape[0]
    # the evidence: the scene's edges on frame 0, as the CEM sees it
    frames = rs.rasterize_depth_chunked_multi(Cs, mean, mi, intr)
    obs = depth_edge(frames.amin(dim=0))
    dt = edge_distance_transform(obs, iters=int(CEM_TAU) + 6)
    mass = torch.sum(obs)
    dt_w, obs_w = _crop(dt, origins, roi), _crop(obs, origins, roi)
    sp, sp_mi, sp_org = hypothesis_windows(mean, mi, intr, roi, 48, seed=1)
    spawn = rs.rasterize_depth_chunked_multi_roi(
        Cs, sp, sp_mi, sp_org, intr, roi).reshape(n, 48, *roi)
    others = torch.stack([frames[[j for j in range(n) if j != i]].amin(dim=0)
                          for i in range(n)])
    H, W = intr.rows, intr.cols
    cases = [("settled iteration", (settled, occ_w, dt_w, obs_w, mass)),
             ("spawn iteration", (spawn, occ_w, dt_w, obs_w, mass)),
             ("full frames", (frames[:, None], others, dt.expand(n, H, W),
                              obs.expand(n, H, W), mass)),
             ("no occluder", (settled[:1], None, dt_w[:1], obs_w[:1], None))]
    worst = 0.0
    for what, args in cases:
        got, again = edge_score(*args[:4], obs_mass=args[4]), \
            edge_score(*args[:4], obs_mass=args[4])
        ref = edge_score_plain(*args[:4], obs_mass=args[4])
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        same = bool(torch.equal(got, again))
        log(f"edge_score, {what} {tuple(args[0].shape)}: max |kernel - "
            f"plain| = {err:.3e} (tol {SCORE_TOL:.0e}), two launches "
            f"bit-identical: {same}, scores {float(ref.min()):.4f}.."
            f"{float(ref.max()):.4f}")
        check(err <= SCORE_TOL, f"edge_score disagrees on {what}: {err}")
        check(same, f"edge_score is not repeatable on {what}")
        check(bool(torch.isfinite(got).all()) and float(ref.std()) > 0,
              f"edge_score: degenerate scores on {what}")
        worst = max(worst, err)

    args = (settled, occ_w, dt_w, obs_w)
    chain = old_score_chain(*args, mass)
    torch.cuda.synchronize()
    chain_err = float((edge_score(*args, obs_mass=mass) - chain).abs().max())
    check(chain_err <= SCORE_TOL, f"the replaced chain disagrees: {chain_err}")
    ms = cuda_ms(lambda: edge_score(*args, obs_mass=mass), reps=reps)
    g_ms = graph_ms(lambda: edge_score(*args, obs_mass=mass), reps=reps)
    plain_ms = cuda_ms(lambda: edge_score_plain(*args, obs_mass=mass),
                       reps=reps)
    chain_ms = cuda_ms(lambda: old_score_chain(*args, mass), reps=reps)
    chain_g = graph_ms(lambda: old_score_chain(*args, mass), reps=reps)
    # bytes: every depth window read once, each object's occluder, dt and
    # evidence windows once, the scores written once; ~50 flop a pixel
    scores = edge_score(*args, obs_mass=mass)
    b_ms, b_by = bound(nbytes(*args, mass, scores), 50 * settled.numel())
    log(f"edge_score time {tuple(settled.shape)} with occluders: kernel "
        f"{ms:.4f} ms ({g_ms:.4f} replayed from a CUDA graph), plain "
        f"{plain_ms:.4f} ms, the chain it replaced (depth_edge x 2 + the "
        f"max-pool, chamfer and coverage ops) {chain_ms:.4f} ms ({chain_g:.4f}"
        f" from a graph), bound {b_ms:.4f} ms ({b_by}; "
        f"{nbytes(*args, mass, scores):.3e} B)")
    kernels.append({"name": "edge_score", "route": "cuda",
                    "source": "visma_tpu_torch/csrc/depth_edge.cu",
                    "replaces": "visma_tpu/image/edges.py:87",
                    "fuses": "visma_tpu/render/likelihood.py:120-155",
                    "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "shape": f"{tuple(settled.shape)} with occluders",
                    "graph_ms": g_ms, "replaced_chain_ms": chain_ms,
                    "replaced_chain_graph_ms": chain_g})


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
    retrieval = one batched raster + one edge_score; each CEM iteration =
    one batched raster for the occluder windows and one for the hypothesis
    windows, and one edge_score for all windows."""
    spawn_frames = min(mapper.settle_age, n_stepped)
    iters = (spawn_frames * mapper.cem_iters
             + (n_stepped - spawn_frames) * mapper.settled_iters)
    return {"chunk_raster_frame": n_frames_rendered * n_objects,
            "chunk_raster_batched": n_objects + 2 * iters,
            "depth_edge": 1, "edge_score": n_objects + iters}


def semantic_phase(dev, kernels):
    import torch

    from visma_tpu_torch.image.edges import depth_edge
    from visma_tpu_torch.io.procedural import bench_mesh_db
    from visma_tpu_torch.io.synthetic_semantic import (BENCH_INTRINSICS,
                                                       bench_scene)
    from visma_tpu_torch.render import raster as rs
    from visma_tpu_torch.render.camera import Intrinsics
    from visma_tpu_torch.render.likelihood import edge_score
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

    counted = (rs.chunk_raster_frame, rs.chunk_raster_batched, depth_edge,
               edge_score)
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


def inverse_atan_table(und):
    """Test data, not part of the port: for every pixel of the raw
    (distorted) frame, the (x, y) in the undistorter's output frame that it
    shows, as an (in_rows, in_cols, 2) float32 remap table. Per raw pixel:
    normalise with AtanModel.absolute(), r_u = tan(r_d s) / (2 tan(s/2)),
    project with the output K. Coordinates are clamped to the output frame
    (border replication), so every raw pixel has a value."""
    import numpy as np

    m = und.model
    fx, fy, cx, cy = m.absolute()
    ofx, ofy, ocx, ocy = und.K[0, 0], und.K[1, 1], und.K[0, 2], und.K[1, 2]
    yd, xd = np.mgrid[0:m.in_rows, 0:m.in_cols].astype(np.float64)
    mx, my = (xd - cx) / fx, (yd - cy) / fy
    rd = np.sqrt(mx * mx + my * my)
    safe = np.where(rd == 0, 1.0, rd)
    fac = np.where(rd == 0, 1.0,
                   np.tan(safe * m.s) / (2.0 * np.tan(m.s / 2.0)) / safe)
    u = np.clip(ofx * mx * fac + ocx, 0.0, und.out_cols - 1.0)
    v = np.clip(ofy * my * fac + ocy, 0.0, und.out_rows - 1.0)
    return np.stack([u, v], axis=-1).astype(np.float32)


def warp_to_raw(frames, inv_table, dev, chunk=40):
    """Ideal frames (N, out_rows, out_cols) f32 numpy -> raw distorted
    frames (N, in_rows, in_cols) uint8 on the device, as the camera's PNGs
    hold them: sampled with the plain remap, rounded, clipped to 0-255."""
    import torch

    from visma_tpu_torch.image.remap import bilinear_remap_plain

    inv = torch.as_tensor(inv_table, device=dev)
    out = []
    for i in range(0, len(frames), chunk):
        part = torch.as_tensor(frames[i:i + chunk], device=dev)
        raw = bilinear_remap_plain(part, inv)
        out.append(torch.clamp(torch.round(raw), 0, 255).to(torch.uint8))
    return torch.cat(out)


def grid_sample_remap(image, table):
    """The one PyTorch call that computes nearly this function, as a
    yardstick only: image (B, H, W) or (B, H, W, C) f32, table (oh, ow, 2).
    It differs from bilinear_remap at the frame border (zero padding
    instead of clamped taps), has no invalid mark and takes no uint8."""
    import torch
    import torch.nn.functional as F

    B, H, W = image.shape[:3]
    # channels first, made outside the timed call
    x = (image.permute(0, 3, 1, 2).contiguous() if image.dim() == 4
         else image[:, None])
    grid = torch.stack([2.0 * table[..., 0] / (W - 1) - 1.0,
                        2.0 * table[..., 1] / (H - 1) - 1.0], dim=-1)
    # the call wants one grid a frame: made once, outside the timed call
    grid = grid[None].expand(B, *grid.shape).contiguous()
    return lambda: F.grid_sample(x, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)


def remap_source_pixels(table, H, W):
    """How many pixels of an H x W frame the remap through `table` must
    read: the union of the four clamped taps of every valid entry."""
    import torch

    sx, sy = table[..., 0], table[..., 1]
    ok = sx >= 0
    x0 = torch.clamp(torch.floor(sx[ok]), 0, W - 2).long()
    y0 = torch.clamp(torch.nan_to_num(torch.floor(sy[ok]), nan=0.0), 0,
                     H - 2).long()
    hit = torch.zeros(H, W, dtype=torch.bool, device=table.device)
    for dy in (0, 1):
        for dx in (0, 1):
            hit[y0 + dy, x0 + dx] = True
    return int(hit.sum())


def remap_kernel_checks(dev, und, crop, raw_u8, kernels, reps=20):
    """K6 against its plain version on the card at the shapes of the path,
    and its times. raw_u8: the (N, in_rows, in_cols) uint8 frames of the
    scene; crop = (top, rows) of the table slice the path uses."""
    import numpy as np
    import torch

    from visma_tpu_torch.image.remap import (DIRECT, STAGED, bilinear_remap,
                                             bilinear_remap_plain,
                                             remap_footprint_plain,
                                             remap_tiling)

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def plain_branches(img, tab, C=1):
        tile, budget = remap_tiling(img.dtype, C)
        return remap_footprint_plain(
            tab.cpu(), H, W, tile, budget, C=C, itemsize=img.element_size(),
            aligned=img.data_ptr() % 16 == 0,
            frames=img.numel() // (H * W * C))[1]

    def remap_branches(img, tab, C=1):
        """(out, branches) of the kernel; on the CPU, where the wrapper is
        the plain version, the plain footprint's branches."""
        if dev.type == "cuda":
            return bilinear_remap(img, tab, return_branches=True)
        return bilinear_remap(img, tab), plain_branches(img, tab, C)

    rng = np.random.default_rng(3)
    H, W = und.in_rows, und.in_cols
    table = und.remap
    sliced = table[crop[0]:crop[0] + crop[1]]

    # f32: one raw frame through the whole table
    one = raw_u8[1].to(torch.float32)
    got, ref = bilinear_remap(one, table), bilinear_remap_plain(one, table)
    sync()
    span = float(ref.max() - ref.min())
    err_f32 = float((got - ref).abs().max())
    log(f"K6 bilinear_remap f32 {tuple(one.shape)} -> {tuple(got.shape)}: "
        f"max |kernel - plain| = {err_f32:.3e} (tol {REMAP_REL_TOL:.0e} of "
        f"the range {span:.1f}), {int((table[..., 0] < 0).sum())} invalid "
        f"table entries")
    check(span > 50.0, "remap check frame has no contrast")
    check(err_f32 <= REMAP_REL_TOL * span, f"bilinear_remap f32: {err_f32}")

    # u8: 8 colour frames, channels last
    col = torch.as_tensor(rng.integers(0, 256, (8, H, W, 3), dtype=np.uint8),
                          device=dev)
    got, ref = bilinear_remap(col, table), bilinear_remap_plain(col, table)
    sync()
    diff_u8 = int((got != ref).sum())
    log(f"K6 bilinear_remap u8 {tuple(col.shape)}: {diff_u8} differing "
        f"bytes of {got.numel()}")
    check(got.dtype == torch.uint8 and got.shape == ref.shape,
          "bilinear_remap u8: wrong type or shape")
    check(diff_u8 == 0, f"bilinear_remap u8: {diff_u8} differing bytes")

    # a random table with invalid rows and a NaN entry, f32 and u8, and the
    # row slice: remap through table[a:b] == remap(...)[a:b]
    oh, ow = 96, 128
    rnd = np.stack([rng.uniform(1, W - 2, (oh, ow)),
                    rng.uniform(1, H - 2, (oh, ow))], -1).astype(np.float32)
    rnd[10, :, 0] = -1.0
    rnd[20, 5] = np.nan
    rnd = torch.as_tensor(rnd, device=dev)
    err_rnd = 0.0
    for img in (one, raw_u8[:3]):
        (got, br), ref = (remap_branches(img, rnd),
                          bilinear_remap_plain(img, rnd))
        part = bilinear_remap(img, rnd[8:40])
        sync()
        check(torch.equal(br.cpu(), plain_branches(img, rnd))
              and bool((br == DIRECT).all()),
              f"random table: branches {br.tolist()} are not all direct")
        e = float((got.float() - ref.float()).abs().max())
        err_rnd = max(err_rnd, e)
        check(e <= REMAP_REL_TOL * 255.0 and bool((got[..., 10, :] == 0).all())
              and float(got[..., 20, 5].float().abs().max()) == 0.0,
              f"bilinear_remap on a random table: {e}")
        check(bool((part == got[..., 8:40, :]).all()),
              "remap of a table slice differs from the slice of the remap")
    log(f"K6 random table with invalid rows: max |kernel - plain| = "
        f"{err_rnd:.3e}; table slice == slice of the result; every tile "
        f"direct, as the plain footprint says")

    # the path's call: which tiles are staged, against the plain footprint
    outN, br = remap_branches(raw_u8, sliced)
    refN = bilinear_remap_plain(raw_u8, sliced)
    sync()
    want = plain_branches(raw_u8, sliced)
    n_staged = int((br == STAGED).sum())
    n_direct = int((br == DIRECT).sum())
    log(f"K6 the path's call: {n_staged} tiles staged, {n_direct} direct "
        f"(plain footprint: {int((want == STAGED).sum())} and "
        f"{int((want == DIRECT).sum())}); against plain: "
        f"{int((outN != refN).sum())} differing bytes")
    check(torch.equal(br.cpu(), want), "K6 branches differ from the plain "
          "footprint on the path's call")
    check(n_direct == 0, "a tile of the Corvis slice was not staged")
    check(torch.equal(outN, refN), "K6 path call differs from plain")
    del refN

    # times: one f32 frame, and the path's batch of u8 frames through the
    # row slice, each with plain, bound and grid_sample. The bound reads of
    # each frame only the pixels the table reaches.
    def read_bytes(img, tab):
        frames = img.numel() // (H * W)    # frames x channels
        return frames * remap_source_pixels(tab, H, W) * img.element_size()

    def work(img, tab, out):
        return bound(read_bytes(img, tab) + nbytes(tab, out),
                     REMAP_FLOP_PER_VALUE * out.numel())

    out1 = bilinear_remap(one, table)
    one_ms = cuda_ms(lambda: bilinear_remap(one, table), reps=reps)
    one_plain = cuda_ms(lambda: bilinear_remap_plain(one, table), reps=reps)
    one_lib = cuda_ms(grid_sample_remap(one[None], table), reps=reps)
    one_graph = graph_ms(lambda: bilinear_remap(one, table), reps=reps)
    one_lib_graph = graph_ms(grid_sample_remap(one[None], table), reps=reps)
    one_bound, one_by = work(one, table, out1)
    log(f"K6 time, one f32 {H}x{W} frame: kernel {one_ms:.4f} ms ("
        f"{one_graph:.4f} replayed from a CUDA graph, without the Python "
        f"wrapper), plain {one_plain:.4f} ms, grid_sample {one_lib:.4f} ms "
        f"({one_lib_graph:.4f} from a graph), bound {one_bound:.5f} ms "
        f"({one_by})")

    n_ms = cuda_ms(lambda: bilinear_remap(raw_u8, sliced), reps=reps)
    n_graph = graph_ms(lambda: bilinear_remap(raw_u8, sliced), reps=reps)
    n_plain = cuda_ms(lambda: bilinear_remap_plain(raw_u8, sliced), reps=3,
                      warmup=1)
    raw_f32 = raw_u8.to(torch.float32)
    n_lib = cuda_ms(grid_sample_remap(raw_f32, sliced), reps=reps)
    del raw_f32
    n_bound, n_by = work(raw_u8, sliced, outN)
    N = raw_u8.shape[0]
    log(f"K6 time, {N} u8 frames {H}x{W} -> {crop[1]}x{W}: kernel "
        f"{n_ms:.4f} ms ({n_ms / N:.5f} a frame; {n_graph:.4f} from a "
        f"graph), plain {n_plain:.3f} ms, grid_sample on the f32 batch "
        f"{n_lib:.4f} ms, bound {n_bound:.5f} ms ({n_by}; "
        f"{read_bytes(raw_u8, sliced) + nbytes(sliced, outN):.4e} B: "
        f"{remap_source_pixels(sliced, H, W)} source pixels a frame, of "
        f"{H * W})")

    # the per-file call of cli/undistort_images: one colour frame
    col1 = col[0].contiguous()
    out1c, br1c = remap_branches(col1, sliced, 3)
    sync()
    check(torch.equal(out1c, bilinear_remap_plain(col1, sliced))
          and torch.equal(br1c.cpu(), plain_branches(col1, sliced, 3)),
          "K6 colour frame differs from plain")
    cli = {"ms": cuda_ms(lambda: bilinear_remap(col1, sliced), reps=reps),
           "graph_ms": graph_ms(lambda: bilinear_remap(col1, sliced),
                                reps=reps),
           "plain_ms": cuda_ms(lambda: bilinear_remap_plain(col1, sliced),
                               reps=reps),
           "staged_tiles": int((br1c == STAGED).sum()),
           "direct_tiles": int((br1c == DIRECT).sum())}
    col_f32 = col1[None].to(torch.float32)
    cli["library_ms"] = cuda_ms(grid_sample_remap(col_f32, sliced),
                                reps=reps)
    cli["library_graph_ms"] = graph_ms(grid_sample_remap(col_f32, sliced),
                                       reps=reps)
    cli["bound_ms"], cli["bound_by"] = work(col1, sliced, out1c)
    log(f"K6 time, the CLI's per-file frame {tuple(col1.shape)} u8 -> "
        f"{tuple(out1c.shape)}: kernel {cli['ms']:.4f} ms through the "
        f"wrapper ({cli['graph_ms']:.4f} from a graph), plain "
        f"{cli['plain_ms']:.4f} ms, grid_sample on the f32 frame "
        f"{cli['library_ms']:.4f} ms ({cli['library_graph_ms']:.4f} from a "
        f"graph), bound {cli['bound_ms']:.5f} ms ({cli['bound_by']}); "
        f"{cli['staged_tiles']} tiles staged, {cli['direct_tiles']} direct")
    kernels.append({"name": "bilinear_remap", "route": "cuda",
                    "source": "visma_tpu_torch/csrc/bilinear_remap.cu",
                    "replaces": "visma_tpu/image/remap.py:81",
                    "max_abs_err": max(err_f32, err_rnd), "ms": n_ms,
                    "plain_ms": n_plain, "bound_ms": n_bound,
                    "bound_by": n_by, "library_ms": n_lib,
                    "shape": f"{N} u8 frames {H}x{W} -> {crop[1]}x{W}",
                    "graph_ms": n_graph,
                    "staged_tiles": n_staged, "direct_tiles": n_direct,
                    "u8_differing_bytes": diff_u8,
                    "cli_frame": cli,
                    "one_f32_frame": {"ms": one_ms, "graph_ms": one_graph,
                                      "plain_ms": one_plain,
                                      "bound_ms": one_bound,
                                      "bound_by": one_by,
                                      "library_ms": one_lib,
                                      "library_graph_ms": one_lib_graph}})


def ingest_camera(und, crop_top, rows, **kw):
    """SyntheticConfig pair for an undistorter: the camera of its whole
    output frame (what the scene is rendered with before it is warped to
    raw) and the camera after the crop to `rows` rows from `crop_top`
    (what the pipeline sees)."""
    from visma_tpu_torch.io.synthetic import SyntheticConfig

    K = und.K
    full = SyntheticConfig(rows=und.out_rows, cols=und.out_cols,
                           fx=float(K[0, 0]), fy=float(K[1, 1]),
                           cx=float(K[0, 2]), cy=float(K[1, 2]), **kw)
    cropped = SyntheticConfig(rows=rows, cols=und.out_cols, fx=full.fx,
                              fy=full.fy, cx=full.cx,
                              cy=full.cy - crop_top, **kw)
    return full, cropped


def ingest_geometry(dev, und, crop, inv_table, num_landmarks=240, seed=7):
    """One blob frame rendered with the output camera, warped to raw,
    undistorted by the kernel path and cropped: every isolated blob's
    centroid must sit within GEOMETRY_TOL_PX of project(gwc, X) under the
    cropped camera. A half-pixel or crop-offset mistake shows here."""
    import numpy as np

    from visma_tpu_torch.image.remap import bilinear_remap
    from visma_tpu_torch.io.synthetic import project
    from visma_tpu_torch.io.synthetic_images import render_blob_frames

    full, cropped = ingest_camera(und, crop[0], crop[1], num_frames=2,
                                  num_landmarks=num_landmarks, seed=seed)
    frames, gwc, X = render_blob_frames(full)
    raw = warp_to_raw(frames[:1], inv_table, dev)
    und_img = bilinear_remap(raw, und.remap[crop[0]:crop[0] + crop[1]])
    img = und_img[0].to("cpu").numpy().astype(np.float64)
    check(img.shape == (cropped.rows, cropped.cols), "bad undistorted shape")

    xp, _, valid = project(gwc[0], X, cropped)
    H, W = img.shape
    bg = float(np.median(img))
    seen = np.nonzero(valid)[0]
    errs = []
    for j in seen:
        u, v = xp[j]
        iu, iv = int(round(u)), int(round(v))
        apart = np.abs(xp[seen] - xp[j]).max(axis=1)
        apart[seen == j] = np.inf
        if not (12 <= iu < W - 12 and 12 <= iv < H - 12) or apart.min() < 14:
            continue        # near the border, or another blob overlaps
        w = np.clip(img[iv - 6:iv + 7, iu - 6:iu + 7] - bg, 0.0, None)
        if w.sum() < 100.0:
            continue
        yy, xx = np.mgrid[iv - 6:iv + 7, iu - 6:iu + 7]
        errs.append(np.hypot((w * xx).sum() / w.sum() - u,
                             (w * yy).sum() / w.sum() - v))
    check(len(errs) >= 5, f"only {len(errs)} isolated blobs in the frame")
    log(f"ingest geometry: {len(errs)} isolated blobs, centroid vs "
        f"projection under the cropped K: max {max(errs):.4f} px, mean "
        f"{float(np.mean(errs)):.4f} px (tol {GEOMETRY_TOL_PX})")
    check(max(errs) <= GEOMETRY_TOL_PX,
          f"undistorted blobs are off their projections: {max(errs)} px")
    return max(errs)


def ingest_run(dev, und, crop, raw_u8, gwc, imu, cfg, levels, cell):
    """The path: staged raw uint8 frames -> bilinear_remap through the row
    slice of the table (one launch for the sequence) -> f32 ->
    VioPipeline.run -> check_health -> ATE. Returns a dict of results."""
    import numpy as np
    import torch

    from visma_tpu_torch.filter.msckf import check_health
    from visma_tpu_torch.image.remap import bilinear_remap
    from visma_tpu_torch.pipeline import VioPipeline

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    n_frames = raw_u8.shape[0]
    N = n_frames - 1
    spf = imu["samples_per_frame"]
    dt = float(np.diff(imu["ts_state"])[0])
    d_gyro = torch.as_tensor(
        imu["gyro"][: N * spf].reshape(N, spf, 3).astype(np.float32),
        device=dev)
    d_accel = torch.as_tensor(
        imu["accel"][: N * spf].reshape(N, spf, 3).astype(np.float32),
        device=dev)
    d_dts = torch.full((N, spf), dt, dtype=torch.float32, device=dev)
    sliced = und.remap[crop[0]:crop[0] + crop[1]]
    pipe = VioPipeline(cfg, levels=levels, cell=cell, device=dev)
    sync()

    t0 = time.time()
    if dev.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
    images = bilinear_remap(raw_u8, sliced)
    if dev.type == "cuda":
        ev[1].record()
    images = images.to(torch.float32)
    if dev.type == "cuda":
        ev[2].record()
    sync()
    und_host_ms = (time.time() - t0) * 1e3
    und_dev_ms = k6_ms = cast_ms = None
    if dev.type == "cuda":
        und_dev_ms = ev[0].elapsed_time(ev[2])
        k6_ms, cast_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    st0 = pipe.init(images[0], R0=gwc[0, :, :3], p0=gwc[0, :, 3],
                    v0=imu["v0"])
    final, outs = pipe.run(st0, images[1:], d_gyro, d_accel, d_dts)
    sync()
    total_s = time.time() - t0

    check_health(outs)
    p_est = outs["p"].cpu().numpy()
    check(p_est.shape == (N, 3) and np.isfinite(p_est).all(),
          f"bad ingest trajectory shape {p_est.shape}")
    check(tuple(images.shape) == (n_frames, crop[1], und.out_cols),
          f"bad undistorted batch {tuple(images.shape)}")
    ate = float(np.sqrt(np.mean(np.sum((p_est - gwc[1:, :, 3]) ** 2,
                                       axis=1))))
    return {"ate": ate, "und_host_ms": und_host_ms, "und_dev_ms": und_dev_ms,
            "und_k6_ms": k6_ms, "und_cast_ms": cast_ms,
            "total_s": total_s, "n_frames": n_frames,
            "tracked": int(outs["obs_valid"].sum())}


def frame_stamp_us(i, fps):
    """Microsecond stamp of frame i: 1 us after the IMU sample of its
    instant, so the sample falls into the frame's own window whatever the
    rounding of the two clocks."""
    import numpy as np

    return EPOCH_US + int(np.ceil(i * 1e6 / fps)) + 1


def raw_sequence_dataset(gwc, camera, fps):
    """The `dataset` of a raw sequence: one packet a pose with its
    microsecond stamp and no features, and the camera the undistorted
    frames have (a SyntheticConfig)."""
    import numpy as np

    from visma_tpu_torch.proto import CameraInfo, Dataset, Packet

    packets = [Packet(ts=float(frame_stamp_us(i, fps)), gwc=g.reshape(-1),
                      features=[], wg=np.zeros(2))
               for i, g in enumerate(gwc)]
    cam = CameraInfo(rows=camera.rows, cols=camera.cols,
                     parameters=np.array([camera.fx, camera.fy, camera.cx,
                                          camera.cy]))
    return Dataset(description="raw ingest sequence", camera=cam,
                   packets=packets)


def write_raw_sequence(root, raw_u8, gwc, camera, imu, fps):
    """A VISMA directory of raw frames under `root`: PNGs named by
    microsecond stamp, the `dataset` of raw_sequence_dataset, and beside
    the directory an IMU npz stamped in seconds on the same clock. Returns
    (sequence dir, npz path)."""
    import cv2
    import numpy as np

    seq = os.path.join(root, "raw")
    os.makedirs(seq)
    for i in range(len(raw_u8)):
        check(cv2.imwrite(os.path.join(
            seq, f"{frame_stamp_us(i, fps):d}.png"), raw_u8[i]),
            "cv2.imwrite failed")
    with open(os.path.join(seq, "dataset"), "wb") as fp:
        fp.write(raw_sequence_dataset(gwc[:len(raw_u8)], camera,
                                      fps).encode())
    npz = os.path.join(root, "imu.npz")
    np.savez(npz, ts=imu["ts"] + EPOCH_US * 1e-6, gyro=imu["gyro"],
             accel=imu["accel"], v0=imu["v0"])
    return seq, npz


def ingest_cli(root, raw_u8, gwc, camera, imu, fps, levels, device_args,
               und_args=()):
    """The entry points from disk, in-process: undistort_images on the raw
    directory, then run_vio --images on its output. camera: what the
    undistorted frames have (a SyntheticConfig); und_args: more arguments
    for undistort_images (a --calib file in a rehearsal at another size).
    Returns the report."""
    import shutil

    import numpy as np

    from visma_tpu_torch.cli import run_vio, undistort_images
    from visma_tpu_torch.io import glob_by_timestamp
    from visma_tpu_torch.proto import Dataset

    n = len(raw_u8)
    seq, npz = write_raw_sequence(root, raw_u8, gwc, camera, imu, fps)
    und_dir, est_dir = os.path.join(root, "und"), os.path.join(root, "est")
    undistort_images.main([seq, "--output", und_dir, *und_args,
                           *device_args])
    check(len(glob_by_timestamp(und_dir, ".png")) == n,
          "undistort_images wrote the wrong number of frames")
    shutil.copy(os.path.join(seq, "dataset"), os.path.join(und_dir, "dataset"))
    report = run_vio.main(["--dataroot", und_dir, "--imu", npz, "--images",
                           "--levels", str(levels), "--cell", "32",
                           "--pixel-noise", "1.0", "--output", est_dir,
                           *device_args])
    check(report["frames"] == n - 1, f"run_vio report: {report}")
    check(np.isfinite(report["ate_rmse_m"])
          and report["ate_rmse_m"] < ATE_GATE_M, f"run_vio report: {report}")
    with open(os.path.join(est_dir, "dataset"), "rb") as fp:
        est = Dataset.decode(fp.read())
    check(len(est.packets) == n - 1,
          f"exported dataset has {len(est.packets)} packets")
    stamps = np.array([p.ts for p in est.packets])
    check(np.all(np.diff(stamps) > 0) and abs(
        stamps[0] - (EPOCH_US * 1e-6 + 1.0 / fps)) < 1e-3,
        "exported stamps are not the normalised frame stamps")
    return report


def ingest_phase(dev, kernels, direct_ate):
    """K6 against its plain version, the undistortion geometry, the VIO
    scene through the whole ingest path, and the two CLIs from disk.
    direct_ate: the VIO phase's ATE in metres, printed beside this one."""
    import tempfile

    import numpy as np
    import torch

    from visma_tpu_torch.filter.config import FilterConfig
    from visma_tpu_torch.frontend.detect import corner_score
    from visma_tpu_torch.frontend.klt_fused import lk_track
    from visma_tpu_torch.image.remap import bilinear_remap
    from visma_tpu_torch.image.undistort import (CORVIS_ATAN_CALIB,
                                                 corvis_undistorter)
    from visma_tpu_torch.io.synthetic import make_imu
    from visma_tpu_torch.io.synthetic_images import render_adversarial_frames

    t0 = time.time()
    und = corvis_undistorter()
    torch.cuda.synchronize()
    table_ms = (time.time() - t0) * 1e3
    check(und.remap.device.type == "cuda",
          "corvis_undistorter did not default to CUDA")
    crop = (CORVIS_ATAN_CALIB["crop_top"], CORVIS_ATAN_CALIB["final_rows"])
    full, cropped = ingest_camera(und, *crop, num_frames=N_FRAMES,
                                  num_landmarks=240, seed=7)
    log(f"ingest: Corvis table {tuple(und.remap.shape)} built and staged in "
        f"{table_ms:.1f} ms; camera after the crop fx={cropped.fx:.3f} "
        f"fy={cropped.fy:.3f} cx={cropped.cx:.3f} cy={cropped.cy:.3f} "
        f"(the VIO scene's: 486.405 535.401 469.199 257.916)")
    check(max(abs(cropped.fx - 486.405), abs(cropped.fy - 535.401),
              abs(cropped.cx - 469.199), abs(cropped.cy - 257.916)) < 0.5,
          "the cropped camera is not the VIO scene's")

    inv = inverse_atan_table(und)
    ingest_geometry(dev, und, crop, inv)

    t0 = time.time()
    frames, gwc, _ = render_adversarial_frames(full)
    imu = make_imu(full)
    raw_u8 = warp_to_raw(frames, inv, dev)
    del frames
    torch.cuda.synchronize()
    log(f"ingest: synthesised {N_FRAMES} raw u8 frames at "
        f"{und.in_rows}x{und.in_cols} in {time.time() - t0:.1f} s")

    remap_kernel_checks(dev, und, crop, raw_u8, kernels)

    cfg = FilterConfig(window=8, max_tracks=96, max_updates=24,
                       fx=cropped.fx, fy=cropped.fy, cx=cropped.cx,
                       cy=cropped.cy, pixel_noise=1.0)
    counted = (bilinear_remap, corner_score, lk_track)
    for fn in counted:
        fn.launches = 0
    res = ingest_run(dev, und, crop, raw_u8, gwc, imu, cfg, levels=4, cell=32)
    n = res["n_frames"]
    log(f"ingest: ATE RMSE {res['ate'] * 100:.3f} cm over {n - 1} frames "
        f"undistorted from raw u8 (the VIO phase's direct run on ideal "
        f"500-row frames: {direct_ate * 100:.3f} cm; this path with five "
        f"launches a tracked frame: {EARLIER_ATE_CM['ingest']} cm); tracked "
        f"observations "
        f"{res['tracked']}")
    log(f"ingest: undistort {n} frames in one launch: "
        f"{res['und_dev_ms']:.3f} ms by CUDA events ("
        f"{res['und_dev_ms'] / n:.5f} ms/frame) = K6 "
        f"{res['und_k6_ms']:.3f} ms + the f32 conversion "
        f"{res['und_cast_ms']:.3f} ms, {res['und_host_ms']:.3f} ms on the "
        f"host clock; whole "
        f"path (undistort + init + {n - 1} frames) "
        f"{res['total_s'] / n * 1e3:.3f} ms/frame on the host clock")
    check(res["ate"] < ATE_GATE_M,
          f"ingest accuracy gate failed: ATE {res['ate']:.4f} m")

    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        report = ingest_cli(root, raw_u8[:CLI_FRAMES].cpu().numpy(), gwc,
                            cropped, imu, full.fps, levels=4, device_args=[])
        log(f"ingest: undistort_images + run_vio --images on {CLI_FRAMES} "
            f"frames from disk in {time.time() - t0:.1f} s: {report}")

    launches = {fn.__name__: fn.launches for fn in counted}
    # one remap launch for the staged sequence and one a file in
    # undistort_images; one detection a frame; one LK launch a tracked
    # frame (four levels and the forward-backward pass inside it)
    want = {"bilinear_remap": 1 + CLI_FRAMES,
            "corner_score": n + CLI_FRAMES,
            "lk_track": (n - 1) + (CLI_FRAMES - 1)}
    log(f"ingest: launches {launches}")
    check(launches == want, f"ingest launches {launches} != {want}")
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
    vio_launches, vio_ate = vio_phase(dev, kernels)
    by_path = {"vio": vio_launches,
               "semantic": semantic_phase(dev, kernels),
               "ingest": ingest_phase(dev, kernels, vio_ate)}

    check(sys.modules.get("jax") is None, "jax was imported")
    check(not any(k == "visma_tpu" or k.startswith("visma_tpu.")
                  for k in sys.modules), "the JAX package was imported")
    for k in kernels:
        # each path's count was set to 0 before it ran and read after it
        k["launches_by_path"] = {path: counts[k["name"]]
                                 for path, counts in by_path.items()
                                 if k["name"] in counts}
        k["launches"] = sum(k["launches_by_path"].values())
        check(min(k["launches_by_path"].values()) > 0,
              f"{k['name']} was never launched on one of its paths")
        # a reading below the bound means the count of work is wrong
        check(k["ms"] >= k["bound_ms"],
              f"{k['name']}: {k['ms']} ms is below its bound "
              f"{k['bound_ms']} ms")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
