"""Times of the frontend's, the rasterizer's and the score's entry points
on the card.

    python -m visma_tpu_torch.time_kernels

Prints the card's name and power limit and one JSON line with, in ms by
CUDA events over 20 back-to-back calls after 3 warm-ups (`_graph_ms`: the
same 20 calls captured in a CUDA graph and replayed, without the host):

  track_features_fused  one tracked frame: K = 96 features, 4 levels and
                        the forward-backward pass, two 500x960 frames of
                        the VIO bench scene's imagery
  detect_features       one detection on such a frame: 96 features, cell
                        32 (the corner map, the per-cell pick, the sort)
  corner_score_graph    K1's map of such a frame
  occlusion_aware_edge_score (and _graph)
                        the score of one settled CEM iteration: 96
                        hypothesis windows of 256x384 against their
                        objects' occluder, distance and evidence windows
  prep_chunks_all       the triangle setup and binning of one CEM
                        iteration's hypothesis batch: 96 ROI windows of
                        256x384, 16-px subtiles, by the PyTorch chain
                        (`_prep_chunks_all` on the gathered corners);
                        _graph: with the corner gather, replayed;
                        _occluders / _frame (and _graph): the same at the
                        iteration's 12 occluder windows and at one 500x960
                        pose, 32-px subtiles
  triangle_setup        the same three setups through `triangle_setup`
                        (on the card csrc/tri_setup.cu; _occluders,
                        _frame, and each _graph); left out where the
                        checkout has no such function
  chunk_raster_batched  K4 on that batch
  chunk_raster_frame    K3 on one 500x960 pose
  bilinear_remap        K6 on the ingest path's call: 240 uint8 600x960
                        frames through rows 50-549 of the Corvis table
                        (and _graph); _f32_frame: one float32 frame through
                        the whole table; _cli_frame: one (600, 960, 3) uint8
                        frame through rows 50-549, the per-file call of
                        cli/undistort_images

    python -m visma_tpu_torch.time_kernels --only bilinear_remap

times K6 alone (the frames are random uint8 from a seed: K6's work does
not depend on them).

It goes through names that do not depend on the layout of the plane table,
on how many launches a tracked frame, a detection or a score makes, so the
same file times an older checkout of the package beside this one: to
compare two trees, run it from each in turns, one after the other on one
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from visma_tpu_torch.frontend.detect import corner_score, detect_features
from visma_tpu_torch.frontend.klt_fused import track_features_fused
from visma_tpu_torch.frontend.pyramid import build_pyramid
from visma_tpu_torch.geom.lie import SE3
from visma_tpu_torch.image.edges import depth_edge
from visma_tpu_torch.image.remap import bilinear_remap
from visma_tpu_torch.image.undistort import corvis_undistorter
from visma_tpu_torch.io.procedural import bench_mesh_db
from visma_tpu_torch.io.synthetic import SyntheticConfig
from visma_tpu_torch.io.synthetic_images import render_adversarial_frames
from visma_tpu_torch.io.synthetic_semantic import (BENCH_INTRINSICS,
                                                   bench_scene)
from visma_tpu_torch.render import raster as rs
from visma_tpu_torch.render.camera import Intrinsics
from visma_tpu_torch.render.likelihood import (edge_distance_transform,
                                               occlusion_aware_edge_score)
from visma_tpu_torch.semantic.cem import _crop, _others_index, _roi_origins

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


def graph_ms(fn, reps=20, replays=5):
    """Mean device time of fn() in ms with the host taken out: `reps` calls
    captured into one CUDA graph, its replays timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=replays, warmup=1) / reps


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


def remap_times(dev):
    """K6 at the ingest path's call, one float32 frame and the CLI's
    per-file colour frame, in ms."""
    table = corvis_undistorter(device=dev).remap
    sliced = table[50:550]
    rng = np.random.default_rng(11)
    raw = torch.as_tensor(rng.integers(0, 256, (240, 600, 960),
                                       dtype=np.uint8), device=dev)
    one = raw[1].to(torch.float32)
    col = torch.as_tensor(rng.integers(0, 256, (600, 960, 3),
                                       dtype=np.uint8), device=dev)
    return {
        "bilinear_remap_ms": cuda_ms(lambda: bilinear_remap(raw, sliced)),
        "bilinear_remap_graph_ms": graph_ms(
            lambda: bilinear_remap(raw, sliced)),
        "bilinear_remap_f32_frame_ms": cuda_ms(
            lambda: bilinear_remap(one, table)),
        "bilinear_remap_f32_frame_graph_ms": graph_ms(
            lambda: bilinear_remap(one, table)),
        "bilinear_remap_cli_frame_ms": cuda_ms(
            lambda: bilinear_remap(col, sliced)),
        "bilinear_remap_cli_frame_graph_ms": graph_ms(
            lambda: bilinear_remap(col, sliced)),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["bilinear_remap"],
                    help="time this kernel alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    if args.only == "bilinear_remap":
        print(json.dumps({"card": card, **remap_times(dev)}), flush=True)
        return

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
    out["detect_features_ms"] = cuda_ms(lambda: detect_features(prev[0], 96,
                                                                32))
    out["corner_score_graph_ms"] = graph_ms(lambda: corner_score(prev[0]))

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
    n = mean.shape[0]
    oi = _others_index(n, dev)
    occ_org = torch.repeat_interleave(_roi_origins(mean[:, :, 3], intr, ROI),
                                      n - 1, dim=0)
    setups = {"": (hyp, hyp_mi, hyp_org, roi_intr, rs.SUB_ROI),
              "_occluders": (mean[oi], mi[oi], occ_org, roi_intr, rs.SUB_ROI),
              "_frame": (mean[:1], mi[:1], None, intr, rs.SUB_FRAME)}
    for key, (p, m, o, it, sub) in setups.items():
        def chain(p=p, m=m, o=o, it=it, sub=sub):
            return rs._prep_chunks_all(renderer.Cs[m], p, it, origins=o,
                                       sub_px=sub)

        if key:
            out[f"prep_chunks_all{key}_ms"] = cuda_ms(chain)
        out[f"prep_chunks_all{key}_graph_ms"] = graph_ms(chain)
        setup = getattr(rs, "triangle_setup", None)
        if setup is not None:
            def kernel(p=p, m=m, o=o, it=it, sub=sub):
                return setup(renderer.Cs, m, p, it, origins=o, sub_px=sub)

            out[f"triangle_setup{key}_ms"] = cuda_ms(kernel)
            out[f"triangle_setup{key}_graph_ms"] = graph_ms(kernel)
    depth = rs.chunk_raster_batched(planes, ids, counts, roi_intr)
    out["covered_pixels"] = int(torch.isfinite(depth).sum())
    out["chunk_raster_batched_ms"] = cuda_ms(
        lambda: rs.chunk_raster_batched(planes, ids, counts, roi_intr))

    # the score of the iteration: occluder windows of the other objects,
    # the scene's edges on this frame as the evidence
    occ = rs.rasterize_depth_chunked_multi_roi(
        renderer.Cs, mean[oi], mi[oi],
        torch.repeat_interleave(_roi_origins(mean[:, :, 3], intr, ROI),
                                n - 1, dim=0), intr, ROI
    ).reshape(n, n - 1, *ROI).amin(dim=1)
    obs = depth_edge(rs.rasterize_depth_chunked_multi(renderer.Cs, mean, mi,
                                                      intr).amin(dim=0))
    dt = edge_distance_transform(obs, iters=16)
    org = _roi_origins(mean[:, :, 3], intr, ROI)
    dt_w, obs_w, mass = _crop(dt, org, ROI), _crop(obs, org, ROI), obs.sum()
    windows = depth.reshape(n, N_HYP, *ROI)
    def score():
        return occlusion_aware_edge_score(windows, occ, dt_w, obs_w,
                                          obs_mass=mass)

    out["occlusion_aware_edge_score_ms"] = cuda_ms(score)
    out["occlusion_aware_edge_score_graph_ms"] = graph_ms(score)

    fp, fi, fc = rs._prep_chunks_all(renderer.Cs[mi[:1]], mean[:1], intr,
                                     sub_px=rs.SUB_FRAME)
    full = rs.chunk_raster_frame(fp, fi, fc, intr)
    out["covered_pixels_frame"] = int(torch.isfinite(full).sum())
    out["chunk_raster_frame_ms"] = cuda_ms(
        lambda: rs.chunk_raster_frame(fp, fi, fc, intr))
    out.update(remap_times(dev))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
