"""Times of the tracker's and the rasterizer's entry points on the card.

    python -m visma_tpu_torch.time_kernels

Prints the card's name and power limit and one JSON line with, in ms by
CUDA events over 20 back-to-back calls after 3 warm-ups:

  track_features_fused  one tracked frame: K = 96 features, 4 levels and
                        the forward-backward pass, two 500x960 frames of
                        the VIO bench scene's imagery
  prep_chunks_all       the triangle setup and binning of one CEM
                        iteration's hypothesis batch: 96 ROI windows of
                        256x384, 16-px subtiles (`_prep_chunks_all`)
  chunk_raster_batched  K4 on that batch
  chunk_raster_frame    K3 on one 500x960 pose

It goes through names that do not depend on the layout of the plane table
or on how many launches a tracked frame is, so the same file times an
older checkout of the package beside this one: to compare two trees, run
it from each in turns, one after the other on one card.
"""
from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from visma_tpu_torch.frontend.detect import detect_features
from visma_tpu_torch.frontend.klt_fused import track_features_fused
from visma_tpu_torch.frontend.pyramid import build_pyramid
from visma_tpu_torch.geom.lie import SE3
from visma_tpu_torch.io.procedural import bench_mesh_db
from visma_tpu_torch.io.synthetic import SyntheticConfig
from visma_tpu_torch.io.synthetic_images import render_adversarial_frames
from visma_tpu_torch.io.synthetic_semantic import (BENCH_INTRINSICS,
                                                   bench_scene)
from visma_tpu_torch.render import raster as rs
from visma_tpu_torch.render.camera import Intrinsics
from visma_tpu_torch.semantic.cem import _roi_origins

ROI = (256, 384)
N_HYP = 24          # hypothesis windows per object in a settled iteration
SETTLED_SIGMA = np.array([0.03] * 3 + [0.05] * 3, np.float32)


def cuda_ms(fn, reps=20, warmup=3):
    """Mean device time of fn() in ms over `reps` back-to-back calls."""
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


def hypothesis_windows(mean, mesh_idx, intr, roi, n_hyp, seed=0):
    """The hypothesis windows of one settled CEM iteration: n_hyp
    settled-sigma perturbations of each object's model->camera pose `mean`
    (n,3,4), every window centred on its object. Returns (poses
    (n*n_hyp,3,4), mesh index (n*n_hyp,), window origins (n*n_hyp,2))."""
    n, dev = mean.shape[0], mean.device
    xi = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (n, n_hyp, 6)).astype(np.float32) * SETTLED_SIGMA, device=dev)
    hyp = (SE3(mean[:, None, :, :3], mean[:, None, :, 3])
           @ SE3.exp(xi)).matrix3x4().reshape(n * n_hyp, 3, 4)
    origins = _roi_origins(mean[:, :, 3], intr, roi)
    return (hyp, torch.repeat_interleave(mesh_idx, n_hyp),
            torch.repeat_interleave(origins, n_hyp, dim=0))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)

    # 30 frames: the scene's photometric drift is spread over its length,
    # and a 2-frame scene would put all of it between the two frames
    syn = SyntheticConfig(num_frames=30, num_landmarks=240, rows=500,
                          cols=960, fx=486.405, fy=535.401, cx=469.199,
                          cy=257.916, seed=7)
    frames, _, _ = render_adversarial_frames(syn)
    prev = tuple(build_pyramid(torch.as_tensor(frames[0], device=dev), 4))
    cur = tuple(build_pyramid(torch.as_tensor(frames[1], device=dev), 4))
    pts, _, valid = detect_features(prev[0], 96, 32)
    _, ok = track_features_fused(prev, cur, pts, valid, levels=4)
    out = {"card": card, "tracked": int(ok.sum()), "features": int(valid.sum())}
    out["track_features_fused_ms"] = cuda_ms(
        lambda: track_features_fused(prev, cur, pts, valid, levels=4))

    intr = Intrinsics(**BENCH_INTRINSICS)
    renderer = rs.MultiMeshRenderer(intr)
    renderer.set_meshes(bench_mesh_db())
    names, _, _, _, all_poses = bench_scene(1, 4)
    mi = torch.as_tensor([renderer.index(n) for n in names], device=dev)
    mean = torch.as_tensor(all_poses[0], device=dev)
    hyp, hyp_mi, hyp_org = hypothesis_windows(mean, mi, intr, ROI, N_HYP)
    roi_intr = rs._roi_intr(intr, ROI)
    C = renderer.Cs[hyp_mi]

    def prep():
        return rs._prep_chunks_all(C, hyp, roi_intr, origins=hyp_org,
                                   sub_px=rs.SUB_ROI)

    planes, ids, counts = prep()
    out["prep_chunks_all_ms"] = cuda_ms(prep)
    depth = rs.chunk_raster_batched(planes, ids, counts, roi_intr)
    out["covered_pixels"] = int(torch.isfinite(depth).sum())
    out["chunk_raster_batched_ms"] = cuda_ms(
        lambda: rs.chunk_raster_batched(planes, ids, counts, roi_intr))

    fp, fi, fc = rs._prep_chunks_all(renderer.Cs[mi[:1]], mean[:1], intr,
                                     sub_px=rs.SUB_FRAME)
    full = rs.chunk_raster_frame(fp, fi, fc, intr)
    out["covered_pixels_frame"] = int(torch.isfinite(full).sum())
    out["chunk_raster_frame_ms"] = cuda_ms(
        lambda: rs.chunk_raster_frame(fp, fi, fc, intr))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
