#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (visma_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from visma_tpu_torch/csrc with nvcc, then
drives the port's paths at the full width of the configuration the repo
benches, holding each kernel against its plain PyTorch version on the
card at the shapes the path gives it:

  VIO       240 frames of 500x960 adversarial imagery plus IMU
            (bench.py:67-88) through VioPipeline(levels=4, cell=32).run,
            which captures its step once into a CUDA graph and replays it
            a frame; gates: health, ATE < 0.10 m, one capture, none on the
            repeat run (K1 and K2 counted through replays alone), every
            output equal to the eager loop's (graph=False; host ms/frame
            in turns, device busy, ops a frame and idle share of both);
            then online: the 239 tracked frames stepped one at a time
            through VioPipeline.step (one CallGraph over the frame) and
            its eager twin (graph=False) in turns, the pose read back
            every frame and not: poses bit-equal to the graphed run's,
            ATE 0.388 cm, one capture, K1 240 / K2 239 through replays,
            0 host synchronisations without the readback, within 33 ms a
            frame with it; FeatureTracker.step and Msckf.step graphed
            against their eager twins, every output equal; kernels
            corner_score, lk_track (one launch a tracked frame; its
            per-level entry lk_level is held against its plain version
            level by level as well).
  semantic  the 4-object chair/desk scene of bench.py:170-207 through
            SemanticMapper.step (detection-driven spawn with retrieval,
            45 frames, finalize), whose CEM and retrieval replay the
            CUDA graphs that warmup captured; gates of bench.py:318-327:
            retrieved models, 4 tracks, every translation error < 0.05 m,
            mean rotation error < 5 deg, worst < 10 deg; one capture an
            executor key, none on a repeat run (launches counted through
            replays alone), 0 host synchronisations in settled steps and
            in a capture; poses and scores of every frame equal to the
            eager mapper's (graph=False; run in turns graph / eager /
            graph / eager, settled ms/frame of each); kernels
            chunk_raster_frame, chunk_raster_batched (also on a set of
            windows made to hurt their coarse cull), triangle_setup (its
            tables bit for bit the PyTorch chain's at the settled
            iteration's 96 and 12 windows and at full frames; one call
            before each K4 launch and one for the ground-truth render),
            depth_edge and edge_score (one call a CEM iteration and a
            retrieval).
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
  slam      the VIO scene again with 16 in-state SLAM landmark slots
            (filter/slam.py); gates: health, ATE < 0.10 m, a live landmark
            with a finite position at the end, INSTATE exported, the VIO
            phase's launch counts; the online step as in the VIO phase,
            its poses bit-equal to this run's; then 60 frames in Schmidt
            mode (each
            landmark keeps its estimate from its promotion on) and
            `run_vio --synthetic 60 --no-imu` (similarity-aligned ATE
            < 0.1 m, tests/test_cli.py:120).
  eval      bench.py:341-478's evaluation operating points, built with the
            port's own copies: surface error of 500k samples against the
            10,164-face chair + desk scene (graphed, a StepGraph over
            6,144-row chunks, and eager in turns by CUDA events, the same
            bytes, one capture with its pool; mean held to the JAX
            package's on the same samples; the SoA path against the
            pairwise oracle on 20k of them), ICP at voxel 0.05 / 0.075 m /
            30 iterations, point-to-point and point-to-plane, graphed (one
            captured iteration replayed) and eager in turns: the same
            bytes, one capture a loop and none later, 0 host
            synchronisations in the graphed loops (fitness >= 0.99, 728
            correspondences and rmse within 1e-5 of the JAX package's),
            RegisterScenes 5/5; then the evaluate tool on a written
            tool.json scene (2 chairs + 2 desks, a ~500k-point cloud; gates
            of tests/test_eval.py:165) and the annotate tool on each
            object's part of that cloud, each 24-yaw sweep one ICP capture.
            The loops' graphs are dropped at the phase's end. No hand
            kernel: the reference computes this path in XLA.
  ba        trajectory refinement (ba/, Msckf.run_batched; no hand kernel,
            the reference computes it in XLA): one GN step and a 10-step
            ba_solve at the multichip dryrun's size (32 poses x 2048
            landmarks) held to the port's CPU step (2e-4 m) and to the JAX
            package's solved cost (1e-3 relative) and poses (2e-2 m); the
            128 x 8192 instance (cost 1e-3, ms a GN step, peak memory); the
            VIO scene again through VioPipeline.run (K1, K2), then
            ba_problem_from_vio + ba_solve + refine_trajectory (ATE <
            2.5 x the filter's + 5 mm, tests/test_ba_from_vio.py:150);
            `run_vio --synthetic 48 --no-imu --ba dense` (similarity-aligned
            ATE below the filter's, both datasets loadable); the
            pose-graph loop closure of tests/test_ba.py (< 2 cm, < a
            quarter of the drift); Msckf.run_batched over 64 feature feeds
            of 240 frames: rows 0 and 63 equal to Msckf.run to 1e-5 over
            the first 30 frames, every row's ATE < 1 cm, one capture each
            for run_batched and run; ms a 64-stream frame of the graph
            against the eager loop.
  dist      the distributed layer (dist/, no hand kernel of its own, the
            reference computes it in XLA): (c) the VIO scene through
            TwoStagePipeline with both stages on the card (two CUDA
            streams, chunk 32, each stage a replayed StepGraph) and its
            eager twin in turns: poses equal to VioPipeline.run's bit for
            bit, ATE 0.388 cm, K1 240 / K2 239 on the "pp" path, one
            capture a stage, no more host synchronisations than one
            stream, graphed ms a frame below the eager twin's, device
            busy (the union) and device time from traces begun behind a
            marker kernel; (a) an in-process nccl
            group of one rank runs the multichip dryrun's twin
            (visma_tpu_torch/dryrun.py, the reference's gates: the step
            within 2e-4 m of ba_step, dense / pcg / submap within 2e-2 /
            2e-2 / 1.5e-2 m and 1e-3 of ba_solve at 32 x 2048, the filter-
            made problem, the two-stage pipeline, 128 x 8192 auto -> pcg
            within 3e-2 m / 2e-3) and the VIO scene's own BA problem; (b)
            the dryrun's solvers on eight gloo ranks of the one card (NCCL
            refuses two ranks on one card), replicated outputs the same
            bytes on every rank; (d) beside (b), the kill-and-recover drill
            of tests/test_multihost.py at 8 x 64 on the card (recovered to
            1e-6); (e) `run_vio --synthetic 48 --no-imu --ba sharded` within
            2e-2 m of `--ba dense`. ms a GN step and all_reduces a GN step
            of each solver; peak device memory. The VIO step makes no host
            synchronisation in (c), one stream or two.
  tools     the command-line tools that compute on the card, at the bench
            camera (500x960): (a) render_depth of the procedural chair
            against the plain render (depthmap.bin: no coverage flip,
            1e-6 relative; mask.bin the same bytes); (b) run_semantic
            --synthetic 4 with tests/test_cli.py's flags and gates, its
            result equal to an eager in-process twin's (graph=False), and
            at its 120x160 full-frame shapes K3, depth_edge and edge_score
            (no occluder) against their plain versions; (c) the
            semantic scene written to disk (gwc, the card's ground-truth
            .edge renders, frame 0's detections, OBJ meshes) through
            run_semantic --dataroot --models with the semantic phase's
            settings: 4 tracks, one packet a frame, every translation error
            < 0.15 m, every packet equal to the same run in-process,
            eagerly (graph=False);
            (d) visualize --animate on it (45 overlay PNGs; frames 0,
            22, 44 agree with an overlay of the plain render and plain
            depth_edge on 99.9% of the pixels; the static figure too where
            matplotlib is installed, else reported as not met; every
            overlay the same bytes as an eager in-process twin's); (e) the
            native decoder builds and decodes the sequence as the Python
            codec does; (f) render_depth graphed against eager: the 180
            ground-truth poses through MultiMeshRenderer and 45 through
            Renderer in turns, the same bytes, one capture, K3 one a pose
            through the replays, and after set_stack / set_mesh the new
            meshes' renders, not the old ones'.
            Kernels chunk_raster_frame, chunk_raster_batched, depth_edge,
            edge_score, each part's launches held to its schedule.

  scripts   the twins of the repo's scripts through their entry points
            (`main`), each at a reduced grid: (a) noise_sweep --headline
            at the VIO scene's settings, its ATE bit for bit the VIO
            phase's; (b) spawn_sweep over 2 scenes, each with the right
            meshes retrieved and 4 tracks (bench.py:318-327's retrieval
            part), every object's error within the worst of the JAX
            package's own 8-scene sweep (0.239 m, 21.8 deg;
            docs/SPAWN_SWEEP.md), bench.py's pose part reported, met or
            not; (c) profile_filter at n = 64, 5 rounds (each variant
            captured anew a round, its median round kept), its
            stages summing to the full step within 10%; (d) profile_cem
            --trace, each triangle setup as long as the launches the
            host queues before K4 and one before each K4 of the trace,
            K4 two launches and edge_score one a CEM iteration; (e)
            profile_stages over 39 frames; (f) diag_semantic, graphed and
            eager windows; (g) bench_scaling over 1 (group-less, one nccl
            rank), 2, 4 and 8 gloo ranks of the card, a GN step's measured
            all-reduce payload equal to the analytic count (dense; PCG
            plus its block preconditioner's 30 K floats), less the step's
            cost scalar; (h) scaling_model to its JSON. Kernels
            corner_score, lk_track, chunk_raster_frame,
            chunk_raster_batched, depth_edge, edge_score, each launched.

    python3 chip_smoke.py --eager-vs-tree OTHER

holds the eager `VioPipeline.run` of this checkout against that of the
port in the checkout OTHER (an earlier commit, unpacked), on the VIO scene
without and with 16 SLAM landmark slots, each tree in its own process:
every output's largest difference and the frames where it differs, and
both ATEs, printed as one JSON line. A comparison, no gate.

For each path that runs kernels the launch counts are set to 0 just before
it runs and read just after, and must equal what the schedule implies. No
kernel may read faster than its bound. Prints the card, the kernel table as
one JSON line and, last, {"ok": true, "device": {...}}.
Exits non-zero on any failure, and without a CUDA device.
"""
import contextlib
import json
import os
import subprocess
import sys
import threading
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

# SLAM landmarks on the VIO scene (tests/test_slam.py's slot count)
SLAM_SLOTS = 16
SCHMIDT_FRAMES = 60
NO_IMU_ATE_GATE_M = 0.1    # tests/test_cli.py:120

# evaluation scene (bench.py:341-478) and the evaluate tool's scene
EVAL_SURFACE_SAMPLES = 500_000
EVAL_AOS_SAMPLES = 20_000
EVAL_ICP_SAMPLES = 50_000  # cfg/tool.json's samples_per_model
EVAL_VOXEL_CAP = 8192
EVAL_CLOUD_POINTS = 500_000
# BENCH_r05's parity targets, measured with a 4,999-face chair; the
# procedural chair has 5,016 faces now, so the surface mean is held to the
# JAX package on this scene instead: its mean over the 20,000 samples of
# seed 0 (tests/test_torch_eval.py pins it), within 1e-6 m, and the 500k
# mean within 4 standard errors (4 x 9.2e-5 m) of it
BENCH_SURFACE_MEAN_M = 0.0125
SURFACE_REF_MEAN_20K_M = 0.013020372158137195
SURFACE_SAMPLE_TOL_M = 4e-4
# ... and ICP (BENCH_r05: fitness 0.993, rmse 0.71 cm) to the JAX package's
# result on this scene (tests/test_torch_align.py pins it): the same
# correspondences, rmse within 1e-5 m
BENCH_ICP_FITNESS = 0.993
ICP_REF_CORRESPONDENCES = 728
ICP_REF_RMSE_M = 0.018558146432042122

# bundle adjustment: the multichip dryrun's problem and the large instance
# (__graft_entry__.py:58, :213), with the reference's cross-implementation
# tolerances (one GN step :70-71, a solve :113-118) and the VIO -> BA gate
# of tests/test_ba_from_vio.py:150
BA_DRYRUN = (32, 2048, 10)        # poses, landmarks, GN iterations
BA_LARGE = (128, 8192, 8)
BA_STEP_TOL_M = 2e-4
BA_COST_REL = 1e-3
BA_POSE_TOL_M = 2e-2
BA_STRIDE = 4
BA_ITERS = 10
BA_CLI_FRAMES = 48
POSE_GRAPH_NODES = 12
POSE_GRAPH_ITERS = 15
BATCH_STREAMS = 64                # visma_tpu/filter/msckf.py:280-285
BATCH_TOL_M = 1e-5                # tests/test_filter.py:211-213
BATCH_HORIZON = 30                # the frames of that test
BATCH_SEGMENT = 24                # frames a run_batched call
# gloo ranks on the one card: the mesh size of the reference's dryrun
# (__graft_entry__.py:257, MULTICHIP_r05), whose gates are set for it; on
# 4 devices the submap's chunking lands 4.7e-2 m from the oracle in the
# JAX package itself, past its own 1.5e-2 m gate
DIST_RANKS = 8
DIST_TIMEOUT_S = 300
# the fault drill (tests/workers/fault_worker.py): poses, landmarks, GN
# steps; recovered to 1e-6 (tests/test_multihost.py:157)
DRILL = (8, 64, 6)
DRILL_TOL = 1e-6
PP_CHUNK = 32
PP_PROFILE_FRAMES = 64            # two chunks
TRACE_WARM_FRAMES = 4             # a trace's untraced warm run
TRACE_TAKES = 5                   # takes of a trace that loses records
# host synchronisations a tracked frame of the VIO step may make (the dist
# phase's (c) counts them over the whole scene, one stream and two)
VIO_SYNCS_PER_FRAME = 0
ONLINE_BUDGET_MS = 33.0           # PERF.md section 1: a frame online

# the tools phase: the command-line tools on the card
RENDER_DEPTH_T = (0.1, 0.0, 2.4)     # the chair 2.4 m ahead, in view
SYN_FRAMES = 4                       # tests/test_cli.py:72-90's flags
SYN_ITERS, SYN_SAMPLES = 3, 32
TOOL_POS_GATE_M = 0.15               # tests/test_cli.py:87
# the scripts phase: the twins of the repo's scripts at reduced grids
SCRIPT_FILTER_STEPS = 64           # profile_filter --n
SCRIPT_FILTER_REPS = 5             # profile_filter --reps: captures a variant
SCRIPT_STAGE_FRAMES = 40           # profile_stages --frames
SCRIPT_SPAWN_SCENES = 2            # spawn_sweep --scenes (seeds 100-101)
# the JAX package's own sweep of 8 such scenes (docs/SPAWN_SWEEP.md): its
# pooled worst translation (m) and rotation (deg) error of any object
SPAWN_SWEEP_MAX = (0.239, 21.80)
SCRIPT_CEM = (3, 24)               # profile_cem --iters --samples
SCRIPT_DIAG = ["--frames", "11", "--warmup", "3", "--window", "8"]
SCRIPT_SWEEP = ["1", "2", "4", "8"]  # bench_scaling --devices
SCRIPT_POSES = 16                  # bench_scaling's keyframes a mesh
SCRIPT_FILTER_TOL = 0.10           # stages' sum against the full step
# the link scaling_model's run assumes (latency s, bandwidth bytes/s): a
# stated assumption, not a measurement (PERF.md)
SCRIPT_LINK = ("1e-6", "4.5e10")
OVERLAY_AGREE = 0.999                # of the pixels, tests/test_cli.py:203
OVERLAY_FRAMES = (0, 22, 44)
# renders of the tools phase's (f): MultiMeshRenderer's 180 poses five
# times in turns and three times after set_stack, Renderer's 45 four times
# and three times after set_mesh
RENDER_TURNS = {"multi": 5 + 3, "single": 4 + 3}
# the JAX package's ba_solve on these problems (synthetic_ba_problem with
# noise_px 0.5, pose_noise 0.02, seed 0), run on the CPU at commit 18fd3f8:
# final total_cost, and for the dryrun's problem the solved positions.
# tests/test_torch_ba.py pins the dryrun's; to reproduce either:
#   JAX_PLATFORMS=cpu python -c "from visma_tpu.ba.gauss_newton import *;
#   from visma_tpu.ba.problem import synthetic_ba_problem as s;
#   p, _ = s(128, 8192, 0.5, 0.02); q, _ = ba_solve(p, iters=8);
#   print(repr(float(total_cost(q))))"
BA_REF_COST = {(32, 2048): 11277.4638671875, (128, 8192): 187307.796875}
BA_REF_P_32 = [
    [2.5, 0.0, 1.2000000476837158],
    [2.4997165203094482, 0.03089355304837227, 1.2029550075531006],
    [2.499526262283325, 0.06010865047574043, 1.2055652141571045],
    [2.4979758262634277, 0.09185191988945007, 1.2083872556686401],
    [2.497105836868286, 0.12182259559631348, 1.2111848592758179],
    [2.49556303024292, 0.1520807147026062, 1.2136443853378296],
    [2.493445873260498, 0.18251937627792358, 1.2166454792022705],
    [2.4913830757141113, 0.2131311595439911, 1.2195093631744385],
    [2.488645553588867, 0.24369050562381744, 1.2221672534942627],
    [2.485138416290283, 0.27327558398246765, 1.2255361080169678],
    [2.481792449951172, 0.30446770787239075, 1.227683186531067],
    [2.4778387546539307, 0.3345594108104706, 1.2300548553466797],
    [2.4740679264068604, 0.36471816897392273, 1.2328182458877563],
    [2.4700663089752197, 0.3946147859096527, 1.2353731393814087],
    [2.465104341506958, 0.4246549904346466, 1.2384098768234253],
    [2.460130453109741, 0.454720675945282, 1.2412196397781372],
    [2.4545388221740723, 0.48389023542404175, 1.2437115907669067],
    [2.4485135078430176, 0.5143647193908691, 1.2464655637741089],
    [2.442854404449463, 0.5440285205841064, 1.2489837408065796],
    [2.4361090660095215, 0.5749799609184265, 1.2509863376617432],
    [2.4292099475860596, 0.6038573384284973, 1.2536016702651978],
    [2.421459913253784, 0.6340291500091553, 1.2558828592300415],
    [2.414555549621582, 0.663364052772522, 1.2580463886260986],
    [2.406233787536621, 0.6934967041015625, 1.2605633735656738],
    [2.3983724117279053, 0.7214130759239197, 1.2625318765640259],
    [2.389657497406006, 0.7507282495498657, 1.265001654624939],
    [2.3809595108032227, 0.7801379561424255, 1.2665170431137085],
    [2.3711376190185547, 0.8102691173553467, 1.269141674041748],
    [2.3612895011901855, 0.8387373089790344, 1.2708990573883057],
    [2.351461887359619, 0.8671496510505676, 1.2724632024765015],
    [2.3412656784057617, 0.8959563374519348, 1.2751638889312744],
    [2.3298215866088867, 0.9244268536567688, 1.277034044265747]]


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg):
    print(msg, flush=True)


def unequal_leaves(a, b):
    """The indices of the tensor leaves of two pytrees (the port's states
    are pytree nodes) that are not equal bit for bit, NaN equal to NaN,
    in flattening order; [] when every leaf is."""
    import torch
    from torch.utils._pytree import tree_flatten

    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    if str(sa) != str(sb):
        return ["the trees' structures"]
    bad = []
    for i, (x, y) in enumerate(zip(la, lb)):
        same = x.shape == y.shape and x.dtype == y.dtype and bool(
            ((x == y) | (torch.isnan(x) & torch.isnan(y))).all()
            if x.is_floating_point() else (x == y).all())
        if not same:
            bad.append(f"leaf {i} {tuple(x.shape)}")
    return bad


def sync_counter(fn):
    """Run fn() and return how many times it made the host wait for the
    device (torch.cuda.set_sync_debug_mode), logging the first three."""
    import torch

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


def timed_ms(fn):
    """(fn(), its device time in ms between two CUDA events): one call,
    for work that is long or that cannot be repeated cheaply."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def solver_graphs():
    """Every graph runner the refinement solvers and the evaluation loops
    (ICP, its normals, the surface distance) have cached so far:
    [(label, runner)] (the mesh solvers' keyed by their mesh, the loops'
    by their form and shapes)."""
    import importlib

    from visma_tpu_torch.ba import gauss_newton, pose_graph
    from visma_tpu_torch.dist import sharded_ba
    from visma_tpu_torch.eval import metrics

    # the module: the package attribute `align.icp` is the function
    icp = importlib.import_module("visma_tpu_torch.align.icp")

    out = [("ba_step", gauss_newton._STEP), ("ba_solve", gauss_newton._RUN)]
    out += [(f"pose_graph damping {k}", r)
            for k, r in pose_graph._RUNS.items()]
    out += [(" ".join(map(str, key[1:])), r)
            for key, r in sharded_ba._RUNS.items()]
    out += [("sharded_ba_step", r) for r in sharded_ba._STEPS.values()]
    out += [(" ".join(map(str, key)), r)
            for cache in (icp._RUNS, metrics._RUNS)
            for key, r in cache.items()]
    return out


def captures_since(before):
    """The captures the solvers' runners made since `before` (a
    `solver_graphs()` snapshot of (runner, captures)): [(label, capture
    ms, pool MB)]."""
    seen = {id(r): n for r, n in before}
    return [(label, ms, mb / 2 ** 20)
            for label, r in solver_graphs()
            for ms, mb in list(zip(r.capture_ms, r.pool_bytes))[
                seen.get(id(r), 0):]]


def graph_turns(call, steps, spread=False, sync_call=None):
    """`call(graph)` in turns graph / eager / graph / eager in one
    process, each on the host clock around synchronised calls; then one
    more graphed call (`sync_call()` instead, where given) with its host
    synchronisations counted. Returns ms a GN step of each turn, the
    first graphed call's captures (label, capture ms, pool MB), the
    captures of the later calls (none), the synchronisations, and the
    outputs; checks graph against eager bit for bit, or, with `spread`,
    within the two eager runs' own spread."""
    import torch

    res = {"ms_per_step": {"graph": [], "eager": []}, "later_captures": []}
    outs = {"graph": [], "eager": []}
    for i, mode in enumerate(("graph", "eager", "graph", "eager")):
        before = [(r, r.captures) for _, r in solver_graphs()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[mode].append(call(mode == "graph"))
        torch.cuda.synchronize()
        res["ms_per_step"][mode].append((time.perf_counter() - t0) * 1e3
                                        / steps)
        new = captures_since(before)
        if i == 0:
            res["captures"] = new
        else:
            res["later_captures"] += new
    before = [(r, r.captures) for _, r in solver_graphs()]
    res["syncs"] = sync_counter(sync_call or (lambda: call(True)))
    res["later_captures"] += captures_since(before)
    check(not res["later_captures"],
          f"captures after the first graphed call: {res['later_captures']}")
    check(res["syncs"] == 0, f"{res['syncs']} host synchronisations in a "
          "graphed solve after its capture")
    g, e = outs["graph"], outs["eager"]
    from torch.utils._pytree import tree_flatten

    if tree_flatten(g[0])[0][0].is_cuda:
        check(res["captures"], "the first graphed call captured nothing")
    check(not unequal_leaves(g[0], g[1]) or spread,
          f"two graphed calls differ: {unequal_leaves(g[0], g[1])}")
    if spread:
        def dist(a, b):
            return max(float((x.float() - y.float()).abs().max())
                       for x, y in zip(tree_flatten(a)[0],
                                       tree_flatten(b)[0]))

        res["eager_spread"] = dist(e[0], e[1])
        res["graph_vs_eager"] = max(dist(a, b) for a in g for b in e)
        check(res["graph_vs_eager"] <= res["eager_spread"],
              f"graph against eager {res['graph_vs_eager']} past the eager "
              f"runs' own spread {res['eager_spread']}")
    else:
        for a in g:
            for b in e:
                bad = unequal_leaves(a, b)
                check(not bad, f"graph != eager: {bad} differ")
    res["outputs"] = g[0]
    return res


def turns_line(t):
    """One line of a `graph_turns` result: ms a GN step in turns, the
    first graphed call's captures, the synchronisations."""
    ms = t["ms_per_step"]
    caps = ", ".join(f"{label} {c_ms:.1f} ms / {mb:.0f} MB"
                     for label, c_ms, mb in t["captures"]) or "none"
    return (f"ms a GN step graph / eager / graph / eager {ms['graph'][0]:.3f}"
            f" / {ms['eager'][0]:.3f} / {ms['graph'][1]:.3f} / "
            f"{ms['eager'][1]:.3f}; first graphed call's captures: {caps}; "
            f"none later; {t['syncs']} host synchronisations in a graphed "
            "solve after its capture")


def turns_record(t):
    """A `graph_turns` result without its outputs, for the JSON line."""
    return {k: v for k, v in t.items() if k != "outputs"}


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


def vio_scene_inputs():
    """The VIO bench scene: (cfg, frames (N_FRAMES, 500, 960), gwc, imu,
    gyro, accel, dts), the last three over the N_FRAMES - 1 tracked
    frames."""
    import numpy as np

    from visma_tpu_torch.filter.config import FilterConfig
    from visma_tpu_torch.io.synthetic import SyntheticConfig, make_imu
    from visma_tpu_torch.io.synthetic_images import render_adversarial_frames

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
    return cfg, frames, gwc, imu, gyro, accel, dts


def vio_phase(dev, kernels, card):
    """Kernels K1, K2 against their plain versions, the VIO bench scene
    through VioPipeline.run, then stepped frame by frame (`vio_online`,
    `step_twins`). Returns ({path: launches}, ATE in m, the scene)."""
    import numpy as np
    import torch

    from visma_tpu_torch.filter.msckf import check_health
    from visma_tpu_torch.frontend.detect import (cell_best_plain,
                                                 corner_cells, corner_score,
                                                 corner_score_plain,
                                                 detect_features)
    from visma_tpu_torch.frontend.klt_fused import (lk_level, lk_level_plain,
                                                    lk_track, lk_track_plain,
                                                    track_features_fused)
    from visma_tpu_torch.frontend.pyramid import build_pyramid
    from visma_tpu_torch.pipeline import VioPipeline

    t0 = time.time()
    cfg, frames, gwc, imu, gyro, accel, dts = vio_scene_inputs()
    N = N_FRAMES - 1
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
    graph = pipe.run_graph
    check(graph is not None and graph.captures == 1,
          "VioPipeline.run did not capture its step once on the card")
    log(f"pipeline: the step captured once into a CUDA graph in "
        f"{graph.capture_ms[0]:.1f} ms (host), after {graph.warmup} eager "
        f"warm-up frames; the other {N - graph.warmup} frames replayed it")

    # the repeat run replays every frame: K1 and K2 counted through replays
    corner_score.launches = 0
    lk_track.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    _, o = pipe.run(st0, d_images, d_gyro, d_accel, d_dts)
    torch.cuda.synchronize()
    rep_s = time.time() - t0
    rep_launches = {"corner_score": corner_score.launches,
                    "lk_track": lk_track.launches}
    check(graph.captures == 1, f"the repeat run captured again "
          f"({graph.captures} captures)")
    check(rep_launches == {"corner_score": N, "lk_track": N},
          f"repeat run launches {rep_launches}: not one K1 and one K2 a "
          "replayed frame")
    check(np.allclose(o["p"].cpu().numpy(), p_est, atol=1e-5),
          "repeat run differs")
    log(f"pipeline repeat run: {rep_s / N * 1e3:.3f} ms/frame "
        f"({N / rep_s:.1f} frames/s), {N} replays, no capture, launches "
        f"{rep_launches}")
    scene = {"cfg": cfg, "frames": frames, "gwc": gwc, "imu": imu,
             "images": d_images, "gyro": d_gyro, "accel": d_accel,
             "dts": d_dts}
    vio_graph_vs_eager(dev, scene, pipe, st0, outs)
    online_launches, online = vio_online(dev, scene, cfg, p_est, card)
    check(f"{online['ate_cm']:.3f}" == f"{EARLIER_ATE_CM['vio']:.3f}",
          f"online ATE {online['ate_cm']:.4f} cm != {EARLIER_ATE_CM['vio']}")
    log("vio online: " + json.dumps(online))
    return {"vio": launches, "online": online_launches,
            "step_twins": step_twins(dev, scene, card)}, ate, scene


def vio_graph_vs_eager(dev, scene, pipe, st0, outs):
    """The graphed `VioPipeline.run` (pipe, captured and replayed) against
    the eager loop (`graph=False`) on the VIO scene from the same start in
    one process. Gate: every output of every frame equal (max |dp| 0.0;
    else the first frame and the outputs that differ are reported). Host
    ms/frame in turns, eager / graph / graph / eager (the host clock moves
    2x between calls); over the first PP_PROFILE_FRAMES frames of each,
    device busy ms/frame and device ops a frame under torch.profiler, and
    the idle share 1 - busy / the host ms/frame of a profiler-off run of
    the same frames just before."""
    import numpy as np
    import torch

    from visma_tpu_torch.pipeline import VioPipeline

    seq = (scene["images"], scene["gyro"], scene["accel"], scene["dts"])
    N = seq[0].shape[0]
    eager = VioPipeline(scene["cfg"], levels=4, cell=32, device=dev,
                        graph=False)
    check(eager.run_graph is None, "graph=False did not ask for the loop")
    runs = {"eager": eager, "graph": pipe}
    ms = {"eager": [], "graph": []}
    res = {}
    for name in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, o = runs[name].run(st0, *seq)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) / N * 1e3)
        res.setdefault(name, o)
    differ = {}
    for k, a in res["eager"].items():
        b = res["graph"][k]
        same = (a == b) | (torch.isnan(a) & torch.isnan(b)) \
            if a.is_floating_point() else a == b
        rows = ~same.reshape(N, -1).all(dim=1)
        if bool(rows.any()):
            differ[k] = int(torch.nonzero(rows)[0])
    max_dp = float((res["eager"]["p"] - res["graph"]["p"]).abs().max())
    check(not differ and max_dp == 0.0,
          f"graph and eager VioPipeline.run differ: max |dp| {max_dp} m; "
          f"first frame that differs, by output: {differ}")
    check(bool((res["graph"]["p"] == outs["p"]).all()),
          "the graphed run differs from its first run")

    head = tuple(x[:PP_PROFILE_FRAMES] for x in seq)
    warm = tuple(x[:TRACE_WARM_FRAMES] for x in seq)
    n = head[0].shape[0]
    prof_res = {}
    for name in ("eager", "graph"):
        # the host clock over the same frames as the trace, profiler off
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name].run(st0, *head)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / n * 1e3
        trace = device_trace(lambda: runs[name].run(st0, *head),
                             lambda: runs[name].run(st0, *warm),
                             f"the VIO run, {name}")
        busy, _ = trace.busy_ms()
        prof_res[name] = {"busy_ms_per_frame": busy / n,
                          "ops_per_frame": len(trace.ops) / n,
                          "host_launches_per_frame": trace.host_launches / n,
                          "graph_launches": trace.graph_launches,
                          "host_ms_per_frame": host,
                          "idle_share": 1 - busy / n / host}
    log(f"vio graph against eager, one process, in turns eager / graph / "
        f"graph / eager: {ms['eager'][0]:.3f} / {ms['graph'][0]:.3f} / "
        f"{ms['graph'][1]:.3f} / {ms['eager'][1]:.3f} ms/frame (host clock, "
        f"{N} frames); outputs equal, max |dp| {max_dp} m; over the first "
        f"{n} frames: device busy {prof_res['graph']['busy_ms_per_frame']:.3f}"
        f" / {prof_res['eager']['busy_ms_per_frame']:.3f} ms/frame (graph / "
        f"eager), device ops {prof_res['graph']['ops_per_frame']:.1f} / "
        f"{prof_res['eager']['ops_per_frame']:.1f} a frame, host "
        f"{prof_res['graph']['host_ms_per_frame']:.3f} / "
        f"{prof_res['eager']['host_ms_per_frame']:.3f} ms/frame, idle share "
        f"{prof_res['graph']['idle_share']:.3f} / "
        f"{prof_res['eager']['idle_share']:.3f}; capture "
        f"{pipe.run_graph.capture_ms[0]:.1f} ms once")
    log("vio graph: " + json.dumps({"ms_per_frame": ms, "max_dp_m": max_dp,
                                    "profile": prof_res,
                                    "capture_ms": pipe.run_graph.capture_ms}))


def vio_online(dev, scene, cfg, ref, card, label="vio"):
    """The online caller's frame: the scene's tracked frames stepped one at
    a time through `VioPipeline.step`, graphed (the default: one
    CallGraph over the whole frame) and eager (`graph=False`), with the
    inputs staged on the device, in one process. The first graphed pass
    (a fresh pipeline, launch counts set to 0 before its `init`) reads the
    pose back every frame, as an online caller does; then in turns eager /
    graph / graph / eager with the readback, graph without it, and one
    more graphed pass without it under `sync_counter`. `ref`: the
    graphed `VioPipeline.run`'s poses (N, 3) on the host. Gates: every
    pass's poses bit-equal to `ref` and the final states graph = eager,
    one capture, none later, K1 N + 1 / K2 N through the replays, 0 host
    synchronisations without the readback, the graphed frame with the
    readback within ONLINE_BUDGET_MS. Returns (launches, numbers)."""
    import numpy as np
    import torch

    from visma_tpu_torch.frontend.detect import corner_score
    from visma_tpu_torch.frontend.klt_fused import lk_track
    from visma_tpu_torch.pipeline import VioPipeline

    gwc, imu = scene["gwc"], scene["imu"]
    seq = (scene["images"], scene["gyro"], scene["accel"], scene["dts"])
    N = seq[0].shape[0]
    frame0 = torch.as_tensor(scene["frames"][0], device=dev)
    init = dict(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])
    pipes = {"graph": VioPipeline(cfg, levels=4, cell=32),
             "eager": VioPipeline(cfg, levels=4, cell=32, graph=False)}
    check(pipes["graph"].step_graph is not None
          and pipes["eager"].step_graph is None,
          f"{label} online: graph=None / False did not pick the step")
    res = {"first_calls_ms": [], "ms_per_frame": {}}

    def online(mode, readback, first=None, count_syncs=False):
        """One pass over the scene; returns (ms a frame, the poses, the
        final state). `first`: a list to get the first two calls' ms,
        each between synchronisations; `count_syncs`: the steps' host
        synchronisations into res["syncs"] (`init` and the readback of
        the poses after the last step are outside)."""
        pipe = pipes[mode]
        st = pipe.init(frame0, **init)
        ps = []

        def steps():
            nonlocal st
            for i in range(N):
                t = time.perf_counter()
                st = pipe.step(st, *(x[i] for x in seq))
                ps.append(pipe.pose(st)[1] if readback else st.filter.p)
                if first is not None and i < 2:
                    torch.cuda.synchronize()
                    first.append((time.perf_counter() - t) * 1e3)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if count_syncs:
            res["syncs"] = sync_counter(steps)
        else:
            steps()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / N * 1e3
        p = np.stack(ps) if readback else torch.stack(ps).cpu().numpy()
        return ms, p, st

    def record(key, mode, readback):
        ms, p, st = online(mode, readback)
        res["ms_per_frame"].setdefault(key, []).append(ms)
        check(np.array_equal(p, ref), f"{label} online: {key} poses differ "
              f"from the graphed run's, max |dp| {np.abs(p - ref).max()}")
        return st

    torch.cuda.synchronize()
    corner_score.launches = 0
    lk_track.launches = 0
    res["first_pass_ms_per_frame"], p, _ = online("graph", True,
                                                  res["first_calls_ms"])
    launches = {"corner_score": corner_score.launches,
                "lk_track": lk_track.launches}
    check(np.array_equal(p, ref), f"{label} online: the first graphed pass "
          f"differs from the graphed run, max |dp| {np.abs(p - ref).max()}")
    cg = pipes["graph"].step_graph
    res["captures"] = cg.captures
    res["capture_ms"] = cg.capture_ms
    res["pool_mb"] = [b / 2 ** 20 for b in cg.pool_bytes]
    finals = {}
    for key, mode, rb in (("eager_readback", "eager", True),
                          ("graph_readback", "graph", True),
                          ("graph_readback", "graph", True),
                          ("eager_readback", "eager", True),
                          ("graph", "graph", False)):
        finals[mode] = record(key, mode, rb)
    bad = unequal_leaves(finals["graph"], finals["eager"])
    check(not bad, f"{label} online: graph and eager final states differ: "
          f"{bad}")
    online("graph", False, count_syncs=True)
    check(res["syncs"] == 0, f"{label} online: {res['syncs']} host "
          "synchronisations in graphed steps after the capture")
    check(cg.captures == 1, f"{label} online: {cg.captures} captures: not "
          "one, none after it")
    check(launches == {"corner_score": N + 1, "lk_track": N},
          f"{label} online: launches {launches}: not init + one K1 a "
          "step and one K2 a step")
    worst = max(res["ms_per_frame"]["graph_readback"])
    check(worst < ONLINE_BUDGET_MS, f"{label} online: graphed step with the "
          f"readback {worst:.3f} ms a frame, past {ONLINE_BUDGET_MS}")
    res["ate_cm"] = float(np.sqrt(np.mean(np.sum(
        (p - gwc[1:, :, 3]) ** 2, axis=1)))) * 100
    m = res["ms_per_frame"]
    log(f"{label} online: VioPipeline.step over {N} frames, one at a time, "
        f"inputs on the device; ms a frame with the pose read back every "
        f"frame, in turns eager / graph / graph / eager: "
        f"{m['eager_readback'][0]:.3f} / {m['graph_readback'][0]:.3f} / "
        f"{m['graph_readback'][1]:.3f} / {m['eager_readback'][1]:.3f}; "
        f"graphed without it {m['graph'][0]:.3f}; the first graphed pass "
        f"{res['first_pass_ms_per_frame']:.3f} "
        f"(its first two calls {res['first_calls_ms'][0]:.1f} ms eager and "
        f"{res['first_calls_ms'][1]:.1f} ms with the capture of "
        f"{res['capture_ms'][0]:.1f} ms, pool {res['pool_mb'][0]:.1f} MB); "
        f"{res['captures']} capture, none later; launches {launches}; "
        f"{res['syncs']} host synchronisations without the readback; poses "
        f"equal to the graphed run's every frame, ATE {res['ate_cm']:.3f} cm "
        f"[{card}]")
    return launches, res


def step_twins(dev, scene, card):
    """`FeatureTracker.step` and `Msckf.step` graphed (the default: a
    CallGraph each) against their eager twins (`graph=False`) over the
    scene's first PP_PROFILE_FRAMES tracked frames, the filter on the
    tracker's observations: every output of every frame equal, one
    capture each. Returns the graphed tracker's launches (init + its
    steps)."""
    import torch

    from visma_tpu_torch.filter.msckf import Msckf
    from visma_tpu_torch.frontend.detect import corner_score
    from visma_tpu_torch.frontend.klt_fused import lk_track
    from visma_tpu_torch.frontend.tracker import FeatureTracker

    cfg, gwc, imu = scene["cfg"], scene["gwc"], scene["imu"]
    images = scene["images"][:PP_PROFILE_FRAMES]
    N = images.shape[0]
    frame0 = torch.as_tensor(scene["frames"][0], device=dev)
    res = {}
    trackers = {g: FeatureTracker(max_features=cfg.max_tracks, levels=4,
                                  cell=32, graph=None if g else False)
                for g in (True, False)}
    obs = {}
    torch.cuda.synchronize()
    corner_score.launches = 0
    lk_track.launches = 0
    for g in (True, False):
        tr = trackers[g]
        st = tr.init(frame0)
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(N):
            out = tr.step(st, images[i])
            st = out[0]
            outs.append(out)
        torch.cuda.synchronize()
        res[f"tracker_{'graph' if g else 'eager'}_ms_per_frame"] = (
            time.perf_counter() - t0) / N * 1e3
        obs[g] = outs
        if g:
            launches = {"corner_score": corner_score.launches,
                        "lk_track": lk_track.launches}
    bad = [i for i in range(N) if unequal_leaves(obs[True][i], obs[False][i])]
    check(not bad, f"FeatureTracker.step graph != eager in frames {bad[:5]}")
    check(trackers[True].step_graph.captures == 1,
          "FeatureTracker.step did not capture once")
    check(launches == {"corner_score": N + 1, "lk_track": N},
          f"FeatureTracker.step launches {launches}")
    kfs = {g: Msckf(cfg, graph=None if g else False) for g in (True, False)}
    # the filter takes float32 (VioPipeline.step converts what it is given)
    imu_f32 = {k: scene[k].float() for k in ("gyro", "accel", "dts")}
    states = {}
    for g, kf in kfs.items():
        st = kf.init(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])
        seen = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, (_, ids, xp, valid) in enumerate(obs[True]):
            st = kf.step(st, {"gyro": imu_f32["gyro"][i],
                              "accel": imu_f32["accel"][i],
                              "dts": imu_f32["dts"][i], "ids": ids,
                              "xp": xp, "valid": valid})
            seen.append(st)
        torch.cuda.synchronize()
        res[f"msckf_{'graph' if g else 'eager'}_ms_per_frame"] = (
            time.perf_counter() - t0) / N * 1e3
        states[g] = seen
    bad = [i for i in range(N) if unequal_leaves(states[True][i],
                                                 states[False][i])]
    check(not bad, f"Msckf.step graph != eager in frames {bad[:5]}")
    check(kfs[True].step_graph.captures == 1, "Msckf.step did not capture "
          "once")
    log(f"step twins over {N} frames, graph / eager ms a frame (host clock, "
        f"no readback): FeatureTracker.step "
        f"{res['tracker_graph_ms_per_frame']:.3f} / "
        f"{res['tracker_eager_ms_per_frame']:.3f}, Msckf.step "
        f"{res['msckf_graph_ms_per_frame']:.3f} / "
        f"{res['msckf_eager_ms_per_frame']:.3f}; every output equal, one "
        f"capture each (tracker {trackers[True].step_graph.capture_ms[0]:.1f}"
        f" ms, filter {kfs[True].step_graph.capture_ms[0]:.1f} ms); the "
        f"graphed tracker's launches {launches} [{card}]")
    return launches


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


def setup_checks(Cs, batches, kernels, reps):
    """The triangle setup's kernel (csrc/tri_setup.cu) against its plain
    twin, the PyTorch chain `_prep_chunks_all` on the gathered corners, on
    the card: the plane table, the chunk lists and the counts bit for bit
    at each batch {name: (poses, mesh index, origins or None, intr)} (the
    16-px windows where origins are given, the 32-px frame elsewhere); both
    timed, the kernel beside its bound at the first batch."""
    import torch

    from visma_tpu_torch.render import raster as rs

    times = {}
    for name, (poses, mi, org, it) in batches.items():
        sub = rs.SUB_FRAME if org is None else rs.SUB_ROI

        def kernel(poses=poses, mi=mi, org=org, it=it, sub=sub):
            return rs.triangle_setup(Cs, mi, poses, it, origins=org,
                                     sub_px=sub)

        def chain(poses=poses, mi=mi, org=org, it=it, sub=sub):
            return rs._prep_chunks_all(Cs[mi], poses, it, origins=org,
                                       sub_px=sub)

        n0 = rs.triangle_setup.launches
        got, ref = kernel(), chain()
        torch.cuda.synchronize()
        check(rs.triangle_setup.launches == n0 + 1,
              "triangle_setup did not launch once")
        diff = [int((g.view(torch.int32) != r.view(torch.int32)).sum())
                for g, r in zip(got, ref)]
        check(diff == [0, 0, 0], f"triangle_setup ({name}): planes, ids and "
                                 f"counts differ from the chain in {diff}")
        times[name] = (cuda_ms(kernel, reps=reps), cuda_ms(chain, reps=reps))
        if not kernels or kernels[-1]["name"] != "triangle_setup":
            planes, ids, counts = got
            B, nc = planes.shape[:2]
            # inputs read once (the stack, poses, origins, indices), the
            # outputs written once, the chunk bboxes written and read back
            n_bytes = (nbytes(Cs, poses, planes, ids, counts, mi)
                       + (0 if org is None else nbytes(org)) + 2 * B * nc * 16)
            st_bound, st_by = bound(n_bytes, 0)
            kernels.append({
                "name": "triangle_setup", "route": "cuda",
                "source": "visma_tpu_torch/csrc/tri_setup.cu",
                "replaces": "none: XLA ops at visma_tpu/render/raster.py "
                            "(_prep_chunks_all)",
                "max_abs_err": 0.0, "ms": times[name][0],
                "plain_ms": times[name][1], "bound_ms": st_bound,
                "bound_by": st_by, "library_ms": None, "shape": name,
                "bytes": n_bytes})
        log(f"triangle_setup ({name}: {tuple(got[0].shape)} planes, "
            f"{int(got[2].sum())} listed hits): bit for bit the chain's; "
            f"kernel {times[name][0]:.4f} ms, the chain "
            f"{times[name][1]:.4f} ms")
    kernels[-1]["ms_by_shape"] = times
    log(f"triangle_setup bound at {kernels[-1]['shape']}: "
        f"{kernels[-1]['bound_ms']:.4f} ms ({kernels[-1]['bytes']:.3e} B)")


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

    setup_checks(Cs, {"hypotheses": (hyp, hyp_mi, hyp_org, roi_intr),
                      "occluders": (occ_pose, occ_mi, occ_org, roi_intr),
                      "frame": (mean[:2], mi[:2], None, intr)},
                 kernels, reps)

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
    synchronisations PyTorch reported in it. Returns a dict of results,
    with each frame's refined poses (N, n, 3, 4) and scores (N, n) as the
    mapper left them on the device."""
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

    trail = []      # each frame's refined poses and scores, on the device

    def step(i, **kw):
        mapper.step(gwc_at(i), edge_frames[i], **kw)
        trail.append((mapper._dev["poses"], mapper._dev["scores"]))

    t0 = time.time()
    step(0, bboxes=gt_detections(mapper._mesh_aabb, intr, names, yaw_gt,
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
        step(i)
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
            syncs += sync_counter(lambda: step(j))
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
            "n_stepped": n_stepped, "need_occ_spawn": need_occ_spawn,
            "poses": torch.stack([p for p, _ in trail]),
            "scores": torch.stack([sc for _, sc in trail])}


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


def warmup_launches(mapper, n_objects):
    """The launches `SemanticMapper.warmup(n_objects)` makes, occluders
    rendered from poses in the window: per schedule and call, two batched
    rasters and one edge_score a CEM iteration, and one batched raster and
    one edge_score a call of the retrieval; each executor called once
    eagerly, or graphed CallGraph.warmup times eagerly and then captured
    (0) and replayed."""
    from visma_tpu_torch.utils.graphs import CallGraph

    calls = CallGraph.warmup + 1 if mapper.graphed else 1
    iters = mapper.cem_iters + (mapper.settled_iters or 0)
    occ = 2 if n_objects > 1 and mapper.roi is not None else 1
    retr = 1 if mapper.roi is not None else 0
    return {"chunk_raster_batched": calls * (occ * iters + retr),
            "edge_score": calls * (iters + retr)}


def setup_launches():
    """A reading of the triangle setup's launch counter, started now:
    called with the run's launches of the other kernels, it checks that
    the run went through the setup's kernel once before each K4 launch
    and once for the renderer's one ground-truth render (K3), and returns
    its count."""
    from visma_tpu_torch.render import raster as rs

    start = rs.triangle_setup.launches

    def read(launches):
        n = rs.triangle_setup.launches - start
        check(n == launches["chunk_raster_batched"] + 1,
              f"semantic: {n} triangle setups, not one a K4 launch "
              f"({launches['chunk_raster_batched']}) and one for the "
              f"ground-truth render")
        return n

    return read


def executor_log(mapper):
    """{executor key: (captures, capture ms, pool MB)} of a mapper's
    executors, for the log."""
    return {f"{c.strip('_').split('_')[0]} {k}": (
        g.captures, [round(ms, 1) for ms in g.capture_ms],
        [round(b / 2**20, 1) for b in g.pool_bytes])
        for (c, k), g in mapper.graphs().items()}


def semantic_phase(dev, kernels):
    """The semantic scene through the graphed mapper (its executors
    captured by warmup, replayed by the frames), then in turns through an
    eager mapper (graph=False), the graphed one again (a fresh mapper on
    the first one's renderer, whose executors are cached there: a repeat
    run, no capture) and eager again. Gates: the semantic gates and the
    launch schedule (first graphed run and the repeat run), poses and
    scores of every frame equal graph against eager, one capture an
    executor key, 0 host synchronisations in settled steps and in a
    capture of its own (the settled schedule without occluders)."""
    import torch

    from visma_tpu_torch.io.procedural import bench_mesh_db
    from visma_tpu_torch.io.synthetic_semantic import (BENCH_INTRINSICS,
                                                       bench_scene)
    from visma_tpu_torch.render.camera import Intrinsics
    from visma_tpu_torch.semantic import SemanticMapper
    from visma_tpu_torch.semantic.cem import (CEM_TAU, cem_n_elite,
                                              fused_cem_executor)
    from visma_tpu_torch.utils.graphs import CallGraph

    intr = Intrinsics(**BENCH_INTRINSICS)
    db = bench_mesh_db()
    names, _, _, _, all_poses = bench_scene(SEM_FRAMES, SEM_OBJECTS)
    log(f"semantic: mesh database "
        f"{ {n: len(F) for n, (_, F) in db.items()} } faces")

    def make(graph=None, renderer=None):
        m = SemanticMapper(intr, db, cem_iters=5, cem_samples=48,
                           roi=SEM_ROI, retrieval_yaws=24, settle_age=2,
                           settled_iters=3, settled_samples=24,
                           settled_sigma=(0.05, 0.03), async_frames=16,
                           roi_spawn=True, graph=graph)
        if renderer is not None:
            m.mrenderer = renderer
        return m

    mapper = make()
    check(mapper.device.type == "cuda" and mapper.graphed
          and mapper.mrenderer.Cs.device.type == "cuda",
          "SemanticMapper did not default to CUDA and its graphs")
    warm_s = {"graph": [mapper.warmup(SEM_OBJECTS)], "eager": []}
    warm_caps = mapper.captures
    check(warm_caps == 3 and all(g.captures == len(g._entries) == 1
                                 for g in mapper.graphs().values()),
          f"warmup captured {executor_log(mapper)}: not the two schedules' "
          f"CEM and the retrieval, once each")
    log(f"semantic: warmup {warm_s['graph'][0]:.2f} s, {warm_caps} captures "
        f"(executor: captures, capture ms, pool MB): {executor_log(mapper)}")

    mesh_idx = [mapper.mrenderer.index(n) for n in names]
    semantic_kernel_checks(mapper, intr, SEM_ROI, all_poses, mesh_idx,
                           kernels, n_hyp=24, plain_poses=8)

    setups = setup_launches()
    res, launches = launches_of(semantic_run, mapper, intr, names,
                                SEM_FRAMES, SEM_WINDOW, SEM_WARM,
                                sync_counter)
    log(f"semantic: launches {launches}")
    check_semantic_gates(res, names)
    check(res["need_occ_spawn"], "the scene's footprints do not overlap")
    want = expected_semantic_launches(SEM_FRAMES, SEM_OBJECTS,
                                      res["n_stepped"], mapper)
    check(launches == want, f"semantic launches {launches} != {want}")
    launches["triangle_setup"] = setups(launches)
    check(mapper.captures == warm_caps,
          f"the frames captured anew: {executor_log(mapper)}")

    runs = {"graph": [res], "eager": []}
    for name in ("eager", "graph", "eager"):
        m = make(False) if name == "eager" else make(None, mapper.mrenderer)
        warm_s[name].append(m.warmup(SEM_OBJECTS))
        setups = setup_launches()
        r, got = launches_of(semantic_run, m, intr, names, SEM_FRAMES,
                             SEM_WINDOW, SEM_WARM, sync_counter)
        check_semantic_gates(r, names)
        check(got == want, f"semantic launches ({name} run) {got} != {want}")
        setups(got)
        runs[name].append(r)
    check(mapper.captures == warm_caps,
          f"the repeat run captured: {executor_log(mapper)}")
    for name, rs in runs.items():
        for r in rs:
            # a settled step leaves the poses on the device and reads
            # nothing back
            check(r["syncs"] == 0, f"{r['syncs']} host synchronisations "
                                   f"in settled steps ({name})")
            for key in ("poses", "scores"):
                same = r[key] == res[key]
                if not bool(same.all()):
                    frame = int(torch.nonzero(
                        ~same.reshape(len(same), -1).all(dim=1))[0])
                    check(False, f"semantic {key} differ ({name} run) from "
                                 f"frame {frame}")

    # a capture of its own makes no host synchronisation either: the
    # settled schedule without occluders, from tensors on the device
    r0 = res["poses"][-1]
    run = fused_cem_executor(mapper.mrenderer, CEM_TAU, mapper.settled_iters,
                             mapper.settled_samples,
                             cem_n_elite(mapper.settled_samples), SEM_ROI,
                             "none", mapper.coverage_radius)
    gen = torch.Generator(device=dev)
    args = (torch.as_tensor(mesh_idx, device=dev), r0[:, :, :3].contiguous(),
            r0[:, :, 3].contiguous(),
            torch.full((SEM_OBJECTS, 6), 0.03, device=dev),
            torch.zeros((intr.rows, intr.cols), device=dev))
    torch.cuda.synchronize()
    cap_syncs = sync_counter(lambda: [
        run(*args, generator=gen.manual_seed(0))
        for _ in range(CallGraph.warmup + 1)])
    check(run.graph.captures == 1 and cap_syncs == 0,
          f"a capture made {cap_syncs} host synchronisations")

    settled = {k: [min(r["win_ms"]) for r in rs] for k, rs in runs.items()}
    spawn = {k: [r["spawn_ms"] for r in rs] for k, rs in runs.items()}
    log(f"semantic: graph against eager, in turns graph / eager / graph / "
        f"eager: settled {settled['graph'][0]:.3f} / "
        f"{settled['eager'][0]:.3f} / {settled['graph'][1]:.3f} / "
        f"{settled['eager'][1]:.3f} ms/frame (best drained {SEM_WINDOW}-"
        f"frame window); spawn frame {spawn['graph'][0]:.1f} / "
        f"{spawn['eager'][0]:.1f} / {spawn['graph'][1]:.1f} / "
        f"{spawn['eager'][1]:.1f} ms; warmup {warm_s['graph'][0]:.2f} / "
        f"{warm_s['eager'][0]:.2f} / {warm_s['graph'][1]:.2f} / "
        f"{warm_s['eager'][1]:.2f} s; poses and scores of all "
        f"{SEM_FRAMES} frames equal; {warm_caps} captures, none in the "
        f"frames or the repeat run; 0 host synchronisations, a capture "
        f"included; all within 0.075 m by frame {res['settle_frame']}")
    log("semantic graph: " + json.dumps({
        "settled_ms_per_frame": settled, "spawn_ms": spawn,
        "warmup_s": warm_s, "executors": executor_log(mapper),
        "win_ms": {k: [r["win_ms"] for r in rs] for k, rs in runs.items()},
        "capture_syncs": cap_syncs}))
    res["retrieval_yaws"] = mapper.retrieval_yaws
    return launches, res


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


def slam_phase(dev, scene, direct_ate, card):
    """The VIO bench scene with 16 in-state SLAM landmark slots through
    VioPipeline.run (the VIO phase's settings otherwise), 60 frames of it
    in Schmidt mode, and `run_vio --synthetic 60 --no-imu` on the card.
    direct_ate: the VIO phase's ATE in metres (num_slam = 0), printed
    beside this one."""
    from dataclasses import replace

    import numpy as np
    import torch

    from visma_tpu_torch.cli import run_vio
    from visma_tpu_torch.filter.msckf import check_health
    from visma_tpu_torch.frontend.detect import corner_score
    from visma_tpu_torch.frontend.klt_fused import lk_track
    from visma_tpu_torch.pipeline import VioPipeline
    from visma_tpu_torch.proto import FeatureStatus

    cfg = replace(scene["cfg"], num_slam=SLAM_SLOTS)
    frames, gwc, imu = scene["frames"], scene["gwc"], scene["imu"]
    seq = (scene["images"], scene["gyro"], scene["accel"], scene["dts"])
    N = seq[0].shape[0]
    init = dict(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])
    pipe = VioPipeline(cfg, levels=4, cell=32)
    check(pipe.device.type == "cuda", "VioPipeline did not default to CUDA")
    frame0 = torch.as_tensor(frames[0], device=dev)
    torch.cuda.synchronize()

    corner_score.launches = 0
    lk_track.launches = 0
    t0 = time.time()
    final, outs = pipe.run(pipe.init(frame0, **init), *seq)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = {"corner_score": corner_score.launches,
                "lk_track": lk_track.launches}

    check_health(outs)
    p_est = outs["p"].cpu().numpy()
    check(p_est.shape == (N, 3) and np.isfinite(p_est).all(),
          f"slam: bad trajectory shape {p_est.shape}")
    ate = float(np.sqrt(np.mean(np.sum((p_est - gwc[1:, :, 3]) ** 2,
                                       axis=1))))
    lm_ids = final.filter.lm_ids.cpu().numpy()
    lm_xw = final.filter.lm_xw.cpu().numpy()
    live = lm_ids >= 0
    instate = int((outs["feat_status"] == int(FeatureStatus.INSTATE)).sum())
    ids_run = outs["lm_ids"].cpu().numpy()
    promoted = len(np.unique(ids_run[ids_run >= 0]))
    log(f"slam: ATE RMSE {ate * 100:.3f} cm over {N} frames with "
        f"num_slam={SLAM_SLOTS} (num_slam=0 in this run: "
        f"{direct_ate * 100:.3f} cm, in earlier runs "
        f"{EARLIER_ATE_CM['vio']} cm); {int(live.sum())} live landmarks at "
        f"the end, {promoted} promoted over the run, {instate} INSTATE "
        f"exports; first run (init + {N} frames) {first_s:.2f} s; launches "
        f"{launches} [{card}]")
    check(ate < ATE_GATE_M, f"slam accuracy gate failed: ATE {ate:.4f} m")
    check(live.any(), "slam: no live landmark at the end")
    check(np.isfinite(lm_xw[live]).all(), "slam: non-finite landmark")
    check(instate > 0, "slam: INSTATE never exported")
    want = {"corner_score": N + 1, "lk_track": N}
    check(launches == want, f"slam launches {launches} != {want}")
    online_launches, online = vio_online(dev, scene, cfg, p_est, card,
                                         label="slam")
    check(online["ate_cm"] == ate * 100, f"slam online: ATE "
          f"{online['ate_cm']} cm != the run's {ate * 100}")
    log("slam online: " + json.dumps(online))

    torch.cuda.synchronize()
    t0 = time.time()
    _, o = pipe.run(pipe.init(frame0, **init), *seq)
    torch.cuda.synchronize()
    rep_s = time.time() - t0
    check(np.allclose(o["p"].cpu().numpy(), p_est, atol=1e-5),
          "slam: repeat run differs")
    log(f"slam: repeat run {rep_s / N * 1e3:.3f} ms/frame "
        f"({N / rep_s:.1f} frames/s) on the host clock [{card}]")

    # Schmidt mode: a landmark keeps its estimate from its promotion on
    # (tests/test_slam.py:85)
    pipe_s = VioPipeline(replace(cfg, schmidt=True), levels=4, cell=32)
    n_s = SCHMIDT_FRAMES - 1
    _, o_s = pipe_s.run(pipe_s.init(frame0, **init),
                        *(x[:n_s] for x in seq))
    check_health(o_s)
    ids = o_s["lm_ids"].cpu().numpy()
    xw = o_s["lm_xw"].cpu().numpy()
    checked = 0
    for j in range(ids.shape[1]):
        live_j = np.flatnonzero(ids[:, j] >= 0)
        if live_j.size < 2:
            continue
        seg = [live_j[0]]
        for t in live_j[1:]:
            if t != seg[-1] + 1 or ids[t, j] != ids[live_j[0], j]:
                break
            seg.append(t)
        check((xw[seg, j] == xw[seg[0], j]).all(),
              f"slam: Schmidt landmark {ids[seg[0], j]} moved")
        checked += len(seg) > 1
    check(checked > 0, "slam: no Schmidt landmark lived two frames")
    ate_s = float(np.sqrt(np.mean(np.sum(
        (o_s["p"].cpu().numpy() - gwc[1:SCHMIDT_FRAMES, :, 3]) ** 2, 1))))
    log(f"slam: Schmidt mode, {n_s} frames: {checked} landmarks held their "
        f"estimate from promotion on; ATE {ate_s * 100:.3f} cm")

    t0 = time.time()
    report = run_vio.main(["--synthetic", str(SCHMIDT_FRAMES), "--no-imu"])
    log(f"slam: run_vio --synthetic {SCHMIDT_FRAMES} --no-imu on the card in "
        f"{time.time() - t0:.1f} s: {report}")
    check(report["ate_sim_aligned_m"] < NO_IMU_ATE_GATE_M,
          f"run_vio --no-imu: sim-aligned ATE {report['ate_sim_aligned_m']}")
    return {"slam": launches, "online_slam": online_launches}


def ba_synthetic(dev, num_poses, num_landmarks, iters, ref_cost, ref_p=None,
                 step=True, profile=False):
    """`synthetic_ba_problem(num_poses, num_landmarks, 0.5, 0.02)` on `dev`:
    with `step`, one GN step at damping 1e-3 with the scale anchor held to
    the port's CPU step on the same problem (max |dp| < 2e-4), and the step
    through its CallGraph in turns with the eager step (`graph_turns`);
    then `ba_solve(iters)` in turns graphed / eager, its final cost within
    1e-3 relative of `ref_cost` (the JAX package's) and, given `ref_p`, its
    positions within 2e-2 m of the JAX package's. Times by CUDA events
    (the graphed step and solve) and the turns' host clock; with
    `profile`, the device busy ms and idle share of one graphed and one
    eager solve. Returns the numbers."""
    import numpy as np
    import torch

    from visma_tpu_torch.ba.gauss_newton import ba_solve, ba_step, total_cost
    from visma_tpu_torch.ba.problem import synthetic_ba_problem

    prob, _ = synthetic_ba_problem(num_poses, num_landmarks, 0.5, 0.02,
                                   device=dev)
    out = {"poses": num_poses, "landmarks": num_landmarks, "iters": iters}
    if step:
        cpu = torch.device("cpu")
        prob_cpu, _ = synthetic_ba_problem(num_poses, num_landmarks, 0.5,
                                           0.02, device=cpu)
        p0 = prob_cpu.p.numpy()
        anchor = float(np.linalg.norm(p0[-1] - p0[0]))
        a_dev = torch.tensor(anchor, device=dev)
        got, _ = ba_step(prob, 1e-3, a_dev)
        ref, _ = ba_step(prob_cpu, 1e-3, torch.tensor(anchor))
        out["step_max_dp_m"] = float((got.p.cpu() - ref.p).abs().max())
        check(out["step_max_dp_m"] < BA_STEP_TOL_M,
              f"ba_step on {dev} != the CPU step: max |dp| "
              f"{out['step_max_dp_m']}")
        # the gate's call was the CallGraph's eager warm-up: the turns'
        # first graphed call captures
        out["step_turns"] = turns_record(graph_turns(
            lambda g: ba_step(prob, 1e-3, a_dev, graph=g), 1))
        out["step_ms"] = cuda_ms(lambda: ba_step(prob, 1e-3, a_dev), reps=5,
                                 warmup=1)
    turns = graph_turns(lambda g: ba_solve(prob, iters=iters, graph=g),
                        iters)
    sol, hist = turns["outputs"]
    out["solve_turns"] = turns_record(turns)
    cost = float(total_cost(sol))
    out["cost"], out["cost_ref"] = cost, ref_cost
    out["cost_rel"] = (cost - ref_cost) / ref_cost
    check(np.isfinite(hist.cpu().numpy()).all(), "ba_solve: non-finite cost")
    check(abs(out["cost_rel"]) < BA_COST_REL,
          f"ba_solve cost {cost} vs the JAX package's {ref_cost}")
    if ref_p is not None:
        out["max_dp_ref_m"] = float(np.abs(sol.p.cpu().numpy()
                                           - np.asarray(ref_p)).max())
        check(out["max_dp_ref_m"] < BA_POSE_TOL_M,
              f"ba_solve poses {out['max_dp_ref_m']} m from the JAX "
              "package's")
    out["solve_ms"] = cuda_ms(lambda: ba_solve(prob, iters=iters), reps=3,
                              warmup=1)
    out["ms_per_gn_step"] = out["solve_ms"] / iters
    if profile:
        for mode in ("graph", "eager"):
            trace = device_trace(
                lambda: ba_solve(prob, iters=iters, graph=mode == "graph"),
                what=f"ba_solve, {mode}")
            busy, _ = trace.busy_ms()
            host = min(turns["ms_per_step"][mode]) * iters
            out[f"{mode}_device_busy_ms"] = busy
            out[f"{mode}_idle_share"] = 1.0 - busy / host
            out[f"{mode}_device_ops"] = len(trace.ops)
            out[f"{mode}_host_launches"] = trace.host_launches
            # where a GN step's device time goes: the largest ops
            out[f"{mode}_top_ms_per_step"] = [
                (name[:60], us / 1e3 / iters)
                for name, us, _ in trace.top(6)]
    return out


def vio_to_ba(dev, scene, levels=4, cell=32, stride=BA_STRIDE,
              iters=BA_ITERS, ate_limit=None):
    """The VIO scene through `VioPipeline.run` on `dev` (launch counts set to
    0 just before, read just after), then the trajectory refinement of
    `run_vio --ba dense`: `ba_problem_from_vio` from the tracker's own
    observations and the filter's poses, `ba_solve`, `refine_trajectory`.
    The solve runs in turns graphed / eager (`graph_turns`). Gates: ATE of
    the refined trajectory < 2.5 x the filter's + 5 mm
    (tests/test_ba_from_vio.py:150), rotations orthonormal to 1e-4.
    `ate_limit(observations, truth)` replaces the ATE gate by the limit it
    returns: `observations` is (args, kwargs) of `ba_problem_from_vio`
    without the device, `truth` the ground-truth positions (a CPU test
    gives the reference's own refined ATE on a scene too small for the
    gate). Returns (launches, numbers)."""
    import numpy as np
    import torch

    from visma_tpu_torch.ba.from_vio import (ba_problem_from_vio,
                                             refine_trajectory)
    from visma_tpu_torch.ba.gauss_newton import ba_solve, total_cost
    from visma_tpu_torch.filter.msckf import check_health
    from visma_tpu_torch.frontend.detect import corner_score
    from visma_tpu_torch.frontend.klt_fused import lk_track
    from visma_tpu_torch.pipeline import VioPipeline

    cfg, gwc, imu = scene["cfg"], scene["gwc"], scene["imu"]
    seq = (scene["images"], scene["gyro"], scene["accel"], scene["dts"])
    N = seq[0].shape[0]
    pipe = VioPipeline(cfg, levels=levels, cell=cell, device=dev)
    frame0 = torch.as_tensor(scene["frames"][0], device=dev)
    corner_score.launches = 0
    lk_track.launches = 0
    final, outs = pipe.run(pipe.init(frame0, R0=gwc[0, :, :3],
                                     p0=gwc[0, :, 3], v0=imu["v0"]), *seq)
    launches = {"corner_score": corner_score.launches,
                "lk_track": lk_track.launches}
    check_health(outs)
    R_est, p_est = outs["R"].cpu().numpy(), outs["p"].cpu().numpy()
    ref = gwc[1:, :, 3]

    t0 = time.time()
    obs_args = (outs["obs_ids"].cpu().numpy(), outs["obs_xp"].cpu().numpy(),
                outs["obs_valid"].cpu().numpy(), R_est, p_est,
                (cfg.fx, cfg.fy, cfg.cx, cfg.cy))
    obs_kw = dict(R_bc=cfg.cam_R_bc, p_bc=cfg.cam_p_bc, stride=stride,
                  max_landmarks=2 * cfg.max_tracks * max(N // stride, 1))
    prob, info = ba_problem_from_vio(*obs_args, **obs_kw, device=dev)
    assembly_ms = (time.time() - t0) * 1e3
    check(prob is not None, "VIO -> BA: too few landmarks")
    cost0 = float(total_cost(prob))
    turns = graph_turns(lambda g: ba_solve(prob, iters=iters, graph=g),
                        iters)
    sol, hist = turns["outputs"]
    solve_ms = cuda_ms(lambda: ba_solve(prob, iters=iters), reps=3, warmup=1)
    R_ba, p_ba = refine_trajectory(sol, info, R_est, p_est, cfg.cam_R_bc,
                                   cfg.cam_p_bc)

    def ate(pp):
        return float(np.sqrt(np.mean(np.sum((pp - ref) ** 2, axis=1))))

    res = {"frames": N, "keyframes": len(info["kf"]),
           "landmarks": int(prob.num_landmarks), "assembly_host_ms":
           assembly_ms, "solve_ms": solve_ms, "cost0": cost0,
           "cost": float(hist[-1]), "ate_filter_m": ate(p_est),
           "ate_ba_m": ate(p_ba),
           "orthonormal_err": float(np.abs(
               np.einsum("nij,nkj->nik", R_ba, R_ba) - np.eye(3)).max()),
           "solve_turns": turns_record(turns)}
    check(np.isfinite(p_ba).all(), "VIO -> BA: non-finite trajectory")
    check(res["cost"] < cost0, "VIO -> BA: the cost did not go down")
    limit = (2.5 * res["ate_filter_m"] + 0.005 if ate_limit is None
             else ate_limit((obs_args, obs_kw), ref))
    check(res["ate_ba_m"] < limit,
          f"VIO -> BA damaged the trajectory: {res['ate_filter_m']} -> "
          f"{res['ate_ba_m']} m (limit {limit} m)")
    check(res["orthonormal_err"] < 1e-4,
          f"VIO -> BA rotations off SO(3) by {res['orthonormal_err']}")
    return launches, res


def ba_cli(root, device_args=()):
    """`run_vio --synthetic 48 --pixel-noise 1.0 --no-imu --ba dense
    --ba-stride 2`: the similarity-aligned ATE of the refined trajectory
    below the filter's (tests/test_ba_from_vio.py:234), both datasets
    loadable through the port's loader with 48 packets. Returns the
    report."""
    import shutil

    from visma_tpu_torch.cli import run_vio
    from visma_tpu_torch.io import VlslamDatasetLoader

    out = os.path.join(root, "est")
    report = run_vio.main(["--synthetic", str(BA_CLI_FRAMES),
                           "--pixel-noise", "1.0", "--no-imu", "--ba",
                           "dense", "--ba-stride", "2", "--output", out,
                           *device_args])
    check(report.get("ba") == "dense", f"run_vio --ba dense: {report}")
    check(report["ate_ba_sim_aligned_m"] < report["ate_sim_aligned_m"],
          f"run_vio --ba dense did not improve: {report}")
    os.makedirs(os.path.join(root, "ba"))
    shutil.copy(os.path.join(out, "dataset_ba"),
                os.path.join(root, "ba", "dataset"))
    for d in (out, os.path.join(root, "ba")):
        n = len(VlslamDatasetLoader(d))
        check(n == BA_CLI_FRAMES, f"{d}: {n} packets")
    return report


@contextlib.contextmanager
def solves_timed(graph, record):
    """`ba.gauss_newton.ba_solve` with `graph` fixed inside the block (the
    CLI takes the default and has no flag for it), the host ms of each
    call around synchronised calls appended to `record`."""
    import torch

    from visma_tpu_torch.ba import gauss_newton

    solve = gauss_newton.ba_solve

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solve(*args, graph=graph, **kw)
        torch.cuda.synchronize()
        record.append((time.perf_counter() - t0) * 1e3)
        return out

    gauss_newton.ba_solve = timed
    try:
        yield
    finally:
        gauss_newton.ba_solve = solve


def ba_cli_turns(dev, device_args=()):
    """`ba_cli` in turns graph / eager / graph / eager: the reports equal,
    the solve's host ms in each (the first graphed one pays its warm-up
    steps and its capture: the CLI solves once) and the captures of the
    first graphed call. Returns (the first report, the numbers)."""
    import tempfile

    reports, ms = [], {"graph": [], "eager": []}
    caps = []
    for mode in ("graph", "eager", "graph", "eager"):
        before = [(r, r.captures) for _, r in solver_graphs()]
        with tempfile.TemporaryDirectory() as root, \
                solves_timed(mode == "graph", ms[mode]):
            reports.append(ba_cli(root, device_args))
        caps.append(captures_since(before))
    for r in reports[1:]:
        check(r == reports[0], f"run_vio --ba dense graph / eager reports "
              f"differ: {r} / {reports[0]}")
    check(len(caps[0]) == int(dev.type == "cuda") and not any(caps[1:]),
          f"run_vio --ba dense captures {caps}")
    return reports[0], {"solve_ms": ms, "captures": caps[0]}


def pose_graph_circle(dev, K=POSE_GRAPH_NODES, iters=POSE_GRAPH_ITERS):
    """tests/test_ba.py:70-115 on `dev`: K poses on a circle, a drifting
    odometry chain as the estimate, exact odometry edges and one loop
    closure. Gates: max position error < 0.02 m and < a quarter of the
    drift. The solve runs in turns graphed / eager (`graph_turns`), held to
    the two eager runs' own spread (its sums accumulate by index). Returns
    the numbers."""
    import numpy as np
    import torch
    from scipy.spatial.transform import Rotation

    from visma_tpu_torch.ba.pose_graph import pose_graph_solve

    rng = np.random.default_rng(1)
    th = 2 * np.pi * np.arange(K) / K
    R_gt = Rotation.from_euler("z", th[:, None]).as_matrix()
    p_gt = np.stack([np.cos(th), np.sin(th), np.zeros(K)], axis=1)
    R_est, p_est = [R_gt[0]], [p_gt[0]]
    for k in range(1, K):
        dR = R_gt[k - 1].T @ R_gt[k]
        dp = R_gt[k - 1].T @ (p_gt[k] - p_gt[k - 1])
        nR = Rotation.from_rotvec(rng.normal(scale=0.03, size=3)).as_matrix()
        R_est.append(R_est[-1] @ dR @ nR)
        p_est.append(p_est[-1] + R_est[-2] @ dp
                     + rng.normal(scale=0.02, size=3))
    drift = float(np.linalg.norm(np.asarray(p_est) - p_gt, axis=1).max())
    ei = list(range(K - 1)) + [K - 1]
    ej = list(range(1, K)) + [0]

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    args = (f32(R_est), f32(p_est),
            torch.as_tensor(ei, dtype=torch.int32, device=dev),
            torch.as_tensor(ej, dtype=torch.int32, device=dev),
            f32([R_gt[i].T @ R_gt[j] for i, j in zip(ei, ej)]),
            f32([R_gt[i].T @ (p_gt[j] - p_gt[i]) for i, j in zip(ei, ej)]))
    turns = graph_turns(lambda g: pose_graph_solve(*args, iters=iters,
                                                   graph=g), iters,
                        spread=True)
    _, p_opt = turns["outputs"]
    err = float(np.linalg.norm(p_opt.cpu().numpy() - p_gt, axis=1).max())
    check(err < 0.02 and err < 0.25 * drift,
          f"pose graph: error {err} m against drift {drift} m")
    ms = cuda_ms(lambda: pose_graph_solve(*args, iters=iters), reps=3,
                 warmup=1)
    return {"nodes": K, "edges": len(ei), "iters": iters, "err_m": err,
            "drift_m": drift, "ms": ms, "turns": turns_record(turns)}


def batched_streams(dev, B=BATCH_STREAMS, n_frames=N_FRAMES, max_tracks=96,
                    max_updates=24, window=8, horizon=BATCH_HORIZON,
                    segment=BATCH_SEGMENT):
    """`Msckf.run_batched` over B synthetic feature feeds of `n_frames`
    frames with IMU, one seed each (the landmarks differ, the trajectory is
    shared; the feed's default noise-free pixels, the filter's 0.5 px
    noise), at the VIO settings, in calls of `segment` frames (the state
    carries over; the times of the calls are summed). Streams 0 and B-1
    also go through `Msckf.run`.

    Gates: the rows of both streams equal to `run` to 1e-5 m over the first
    `horizon` frames (tests/test_filter.py:189-213); every row finite with
    an ATE < 1 cm (tests/test_filter.py:182, a noise-free feed); the
    graphed `run` and `run_batched` equal to their eager loops
    (`graph=False`) in every output and final state, one capture each, and
    a replay after nine other configurations equal to the first run.
    Reported, not gated: the
    rows against `run` over all frames, and at each segment's first frame
    one batched step against `Msckf.step` on row 0 of the same state. A
    batched matrix product or factorisation rounds apart from a single one,
    and the filter amplifies that over a run. Returns the numbers, with
    aggregate frames/s of the batch against one stream's (host clock)."""
    from dataclasses import replace

    import numpy as np
    import torch
    from torch.utils._pytree import tree_map

    from visma_tpu_torch.filter import FilterConfig, Msckf, stack_states
    from visma_tpu_torch.filter.feed import pack_frames
    from visma_tpu_torch.filter.msckf import check_health
    from visma_tpu_torch.io.synthetic import (SyntheticConfig, make_dataset,
                                              make_imu, make_trajectory)

    t0 = time.time()
    syn = SyntheticConfig(num_frames=n_frames)
    cfg = FilterConfig(window=window, max_tracks=max_tracks,
                       max_updates=max_updates, fx=syn.fx, fy=syn.fy,
                       cx=syn.cx, cy=syn.cy, pixel_noise=0.5)
    # no IMU noise: the samples follow the trajectory alone, one for all
    imu = make_imu(syn)
    _, gwc = make_trajectory(syn)
    packs = [pack_frames(cfg, make_dataset(replace(syn, seed=s)), imu,
                         max_feats=max_tracks) for s in range(B)]
    frames = {k: torch.as_tensor(np.stack([pk[k] for pk in packs]),
                                 device=dev)
              for k in packs[0] if k != "ts"}
    make_s = time.time() - t0
    # graph=True: the default on the card; on the CPU (the rehearsal) the
    # graph's static buffers without capture
    kf = Msckf(cfg, device=dev, graph=True)
    s0 = kf.init(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])
    cur = stack_states([s0] * B)
    kf.run_batched(cur, {k: v[:, :2] for k, v in frames.items()})

    batched_s, step_dp, ps = 0.0, [], []
    for j in range(0, n_frames, segment):
        one = kf.step(tree_map(lambda t: t[0], cur),
                      {k: v[0, j] for k, v in frames.items()})
        nxt, _ = kf.run_batched(cur, {k: v[:, j:j + 1]
                                      for k, v in frames.items()})
        step_dp.append(float((one.p - nxt.p[0]).abs().max()))
        torch.cuda.synchronize()
        t0 = time.time()
        cur, out = kf.run_batched(cur, {k: v[:, j:j + segment]
                                        for k, v in frames.items()})
        torch.cuda.synchronize()
        batched_s += time.time() - t0
        ps.append(out["p"])
    p_b = torch.cat(ps, dim=1).cpu().numpy()
    check(np.isfinite(p_b).all(), "run_batched: non-finite positions")
    ate = np.sqrt(np.mean(np.sum((p_b - gwc[None, :, :, 3]) ** 2, axis=2),
                          axis=1))
    check(ate.max() < 0.01, f"run_batched: a row's ATE {ate.max()} m")
    res = {"streams": B, "frames": n_frames, "make_host_s": make_s,
           "batched_s": batched_s, "horizon": horizon, "segment": segment,
           "step_dp_m": step_dp, "ate_min_m": float(ate.min()),
           "ate_max_m": float(ate.max())}
    single = {}
    for b in (0, B - 1):
        torch.cuda.synchronize()
        t0 = time.time()
        single[b] = kf.run(s0, {k: v[b] for k, v in frames.items()})
        torch.cuda.synchronize()
        res["single_s"] = time.time() - t0
        o = single[b][1]
        check_health(o)
        d = np.abs(o["p"].cpu().numpy() - p_b[b]).max(axis=1)
        res[f"run_dp_{horizon}_stream_{b}_m"] = float(d[:horizon].max())
        res[f"run_dp_all_stream_{b}_m"] = float(d.max())
        check(d[:horizon].max() <= BATCH_TOL_M,
              f"run_batched row {b} != run on stream {b} over the first "
              f"{horizon} frames: {d[:horizon].max()} m")
    res["batched_frames_per_s"] = B * n_frames / batched_s
    res["single_frames_per_s"] = n_frames / res["single_s"]

    # the captured Msckf.run against its eager loop (graph=False) on
    # streams 0 and B-1: every output of every frame and the final state
    eager = Msckf(cfg, device=dev, graph=False)
    for b in (0, B - 1):
        bad = unequal_leaves(single[b], eager.run(
            s0, {k: v[b] for k, v in frames.items()}))
        check(not bad, f"Msckf.run graph != graph=False on stream {b}: "
              f"{bad} differ")
    # a replay reads the step's cached constants by address: nine other
    # filter configurations between two runs of one graph change nothing
    for w in (3, 4, 5, 6, 7, 9, 10, 11, 12):
        other = Msckf(replace(cfg, window=w), device=dev, graph=False)
        other.run(other.init(R0=gwc[0, :, :3], p0=gwc[0, :, 3],
                             v0=imu["v0"]),
                  {k: v[0, :3] for k, v in frames.items()})
    bad = unequal_leaves(single[0], kf.run(
        s0, {k: v[0] for k, v in frames.items()}))
    check(not bad, f"Msckf.run replayed after nine other configurations "
          f"differs from its first run: {bad} differ")
    # one capture a run shape on the card: the 2-, 1- and 24-frame calls
    # share one, and so do the two streams through run and the run after
    # the nine other configurations
    want = int(dev.type == "cuda")
    check(kf.batched_graph.captures == want and kf.run_graph.captures == want,
          f"captures: run_batched {kf.batched_graph.captures}, run "
          f"{kf.run_graph.captures}, not {want} each")

    # the graph against the eager loop (graph=False) on one call of
    # `segment` frames from the start, in turns eager / graph / graph /
    # eager; every output (R, p) of every frame and the final states equal
    start = stack_states([s0] * B)
    seg = {k: v[:, :segment] for k, v in frames.items()}
    eager.run_batched(start, {k: v[:, :2] for k, v in frames.items()})
    ms, got = {"eager": [], "graph": []}, {}
    for name in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = (eager if name == "eager" else kf).run_batched(start, seg)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) / segment * 1e3)
        got.setdefault(name, o)
    res["ms_per_batched_frame"] = ms
    res["graph_vs_eager_dp_m"] = float(
        (got["graph"][1]["p"] - got["eager"][1]["p"]).abs().max())
    bad = unequal_leaves(got["graph"], got["eager"])
    check(not bad, f"run_batched graph != graph=False: {bad} differ, max "
          f"|dp| {res['graph_vs_eager_dp_m']} m")
    res["capture_ms"] = kf.batched_graph.capture_ms
    # the graph's device time a frame (on the card)
    if dev.type == "cuda":
        trace = device_trace(lambda: kf.run_batched(start, seg),
                             what="run_batched")
        res["graph_device_busy_ms_per_frame"] = trace.busy_ms()[0] / segment
    return res


def ba_phase(dev, vio_scene, card):
    """The trajectory-refinement path on the card: (a) BA at the multichip
    dryrun's size against the JAX package, (b) the large instance, (c) VIO
    -> BA on the VIO bench scene (K1, K2 on the card), (d) `run_vio --ba
    dense`, (e) the pose-graph loop closure, (f) `Msckf.run_batched` at 64
    streams. Returns the launches of (c)."""
    import tempfile

    import torch

    K, L, it = BA_DRYRUN
    a = ba_synthetic(dev, K, L, it, BA_REF_COST[(K, L)], BA_REF_P_32)
    log(f"ba: (a) {K} poses x {L} landmarks: one GN step {a['step_ms']:.3f}"
        f" ms, max |dp| {a['step_max_dp_m']:.3e} m against the CPU step "
        f"(tol {BA_STEP_TOL_M}); ba_solve({it}) {a['solve_ms']:.3f} ms "
        f"({a['ms_per_gn_step']:.3f} ms a GN step), cost {a['cost']:.4f} "
        f"(JAX package {a['cost_ref']}, rel {a['cost_rel']:+.2e}), poses "
        f"{a['max_dp_ref_m']:.3e} m from the JAX package's [{card}]")
    log(f"ba: (a) ba_step {turns_line(a['step_turns'])} [{card}]")
    log(f"ba: (a) ba_solve({it}) {turns_line(a['solve_turns'])} [{card}]")

    K, L, it = BA_LARGE
    torch.cuda.reset_peak_memory_stats()
    b = ba_synthetic(dev, K, L, it, BA_REF_COST[(K, L)], step=False,
                     profile=True)
    b["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"ba: (b) {K} poses x {L} landmarks: ba_solve({it}) "
        f"{b['solve_ms']:.3f} ms ({b['ms_per_gn_step']:.3f} ms a GN step), "
        f"cost {b['cost']:.4f} (JAX package {b['cost_ref']}, rel "
        f"{b['cost_rel']:+.2e}), peak device memory {b['peak_mib']:.1f} MiB "
        f"[{card}]")
    log(f"ba: (b) ba_solve({it}) {turns_line(b['solve_turns'])}; device "
        f"busy {b['graph_device_busy_ms']:.3f} ms graphed, idle share "
        f"{b['graph_idle_share']:.3f}, against {b['eager_device_busy_ms']:.3f}"
        f" ms eager, idle share {b['eager_idle_share']:.3f}, over "
        f"{b['graph_device_ops']} / {b['eager_device_ops']} device ops; a "
        "GN step's largest, graphed: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in b["graph_top_ms_per_step"])
        + f" [{card}]")

    launches, c = vio_to_ba(dev, vio_scene)
    log(f"ba: (c) VIO -> BA on the VIO scene ({c['frames']} frames): "
        f"{c['keyframes']} keyframes, {c['landmarks']} landmarks, assembly "
        f"{c['assembly_host_ms']:.1f} ms on the host, ba_solve({BA_ITERS}) "
        f"{c['solve_ms']:.3f} ms, cost {c['cost0']:.1f} -> {c['cost']:.1f}; "
        f"ATE filter {c['ate_filter_m'] * 100:.3f} cm -> BA "
        f"{c['ate_ba_m'] * 100:.3f} cm (gate < 2.5x + 0.5 cm), rotations "
        f"orthonormal to {c['orthonormal_err']:.1e}; launches {launches} "
        f"[{card}]")
    log(f"ba: (c) ba_solve({BA_ITERS}) {turns_line(c['solve_turns'])} "
        f"[{card}]")
    want = {"corner_score": c["frames"] + 1, "lk_track": c["frames"]}
    check(launches == want, f"ba launches {launches} != {want}")

    t0 = time.time()
    report, d = ba_cli_turns(dev)
    ms = d["solve_ms"]
    log(f"ba: (d) run_vio --synthetic {BA_CLI_FRAMES} --no-imu --ba dense "
        f"--ba-stride 2, four runs in {time.time() - t0:.1f} s: {report}; "
        f"reports equal graph / eager; its one ba_solve({BA_ITERS}) in turns "
        f"graph / eager / graph / eager {ms['graph'][0]:.3f} / "
        f"{ms['eager'][0]:.3f} / {ms['graph'][1]:.3f} / {ms['eager'][1]:.3f}"
        f" ms (the first graphed one with its warm-up steps and capture: "
        f"{d['captures']}) [{card}]")

    e = pose_graph_circle(dev)
    log(f"ba: (e) pose graph, {e['nodes']} nodes / {e['edges']} edges, "
        f"{e['iters']} iterations: {e['ms']:.3f} ms, error "
        f"{e['err_m']:.3e} m (drift {e['drift_m']:.4f} m) [{card}]")
    log(f"ba: (e) pose graph {turns_line(e['turns'])}; graph against eager "
        f"{e['turns']['graph_vs_eager']} m, two eager runs' spread "
        f"{e['turns']['eager_spread']} m [{card}]")

    f = batched_streams(dev)
    last, h = f["streams"] - 1, f["horizon"]
    log(f"ba: (f) run_batched, {f['streams']} streams x {f['frames']} "
        f"frames in calls of {f['segment']}: {f['batched_s']:.2f} s = "
        f"{f['batched_frames_per_s']:.1f} frames/s aggregate; one stream "
        f"through run {f['single_s']:.2f} s = "
        f"{f['single_frames_per_s']:.1f} frames/s; rows 0 / {last} against "
        f"run over the first {h} frames {f[f'run_dp_{h}_stream_0_m']:.2e} / "
        f"{f[f'run_dp_{h}_stream_{last}_m']:.2e} m (tol {BATCH_TOL_M}), "
        f"over all frames {f['run_dp_all_stream_0_m']:.2e} / "
        f"{f[f'run_dp_all_stream_{last}_m']:.2e} m; one batched step "
        f"against Msckf.step on row 0 at each call's first frame: max "
        f"{max(f['step_dp_m']):.2e} m; ATE of the {f['streams']} rows "
        f"{f['ate_min_m']:.3e}-{f['ate_max_m']:.3e} m; feeds "
        f"made in {f['make_host_s']:.1f} s on the host; ms a {f['streams']}"
        f"-stream frame, a call of {f['segment']} frames in turns eager / "
        f"graph / graph / eager: {f['ms_per_batched_frame']['eager'][0]:.3f}"
        f" / {f['ms_per_batched_frame']['graph'][0]:.3f} / "
        f"{f['ms_per_batched_frame']['graph'][1]:.3f} / "
        f"{f['ms_per_batched_frame']['eager'][1]:.3f}, graph against eager "
        f"max |dp| {f['graph_vs_eager_dp_m']} m, the graph's device busy "
        f"{f['graph_device_busy_ms_per_frame']:.3f} ms a frame, capture "
        f"{f['capture_ms'][0]:.1f} ms once [{card}]")
    log("ba: " + json.dumps({"dryrun": a, "large": b, "vio_to_ba": c,
                             "cli": report, "cli_turns": d,
                             "pose_graph": e, "batched": f}))
    return launches


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def device_trace(fn, warm=None, what=""):
    """fn() traced on the card by `utils.trace.traced`: behind an untraced
    warm call (`warm`, else fn itself) and a marker kernel, since late in
    a process torch.profiler drops a trace's first device records; the
    traced device ops held to the host's launches (`Trace.check`) and
    both logged. A trace that lost device records is taken again, up to
    TRACE_TAKES takes, each loss logged; TRACE_TAKES losses raise.
    `Trace.busy_ms()` gives (the union of the device intervals, their
    sum) in ms: the union counts time two streams overlap once."""
    from visma_tpu_torch.utils.trace import traced

    trace = traced(fn, warm, takes=TRACE_TAKES)
    for line in trace.lost:
        log(f"  trace of {what}, a take that lost records: {line}")
    log(f"  trace of {what}: {trace.check()}")
    check(trace.ops, f"the profiler saw no device work ({what})")
    return trace


def pp_two_streams(dev, scene, chunk=PP_CHUNK):
    """(c) The VIO scene through `TwoStagePipeline` with both stages on
    `dev` (two CUDA streams of the card), each stage a `StepGraph`
    replayed a frame (the default), launch counts set to 0 just before its
    first run and read just after, against `VioPipeline.run` and against
    its eager twin (`graph=False`) in the same process: max |dp| = 0.0 for
    both, no more host synchronisations than one stream, one capture a
    stage, and the graphed run's host ms a frame below the eager twin's
    (in turns eager / graph / eager / graph after the first run; the VIO
    phase warmed the path up). Device busy (the union of the device
    intervals) and device time a frame of each over a traced run of the
    first PP_PROFILE_FRAMES frames (`device_trace`). Returns (launches,
    numbers, the single-stream outputs)."""
    import numpy as np
    import torch

    from visma_tpu_torch.dist.pipeline_pp import TwoStagePipeline
    from visma_tpu_torch.frontend.detect import corner_score
    from visma_tpu_torch.frontend.klt_fused import lk_track
    from visma_tpu_torch.pipeline import VioPipeline

    cfg, gwc, imu = scene["cfg"], scene["gwc"], scene["imu"]
    seq = (scene["images"], scene["gyro"], scene["accel"], scene["dts"])
    N = seq[0].shape[0]
    frame0 = torch.as_tensor(scene["frames"][0], device=dev)
    init = dict(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])
    pps = {"graph": TwoStagePipeline(cfg, dev, dev, levels=4, cell=32,
                                     chunk=chunk),
           "eager": TwoStagePipeline(cfg, dev, dev, levels=4, cell=32,
                                     chunk=chunk, graph=False)}
    check(pps["graph"].frontend_graph is not None
          and pps["graph"].filter_graph is not None
          and pps["eager"].frontend_graph is None,
          "TwoStagePipeline's graph argument did not pick the runners")
    pipe = VioPipeline(cfg, levels=4, cell=32, device=dev)
    st0 = pipe.init(frame0, **init)
    starts = {k: pp.init(frame0, **init) for k, pp in pps.items()}
    torch.cuda.synchronize()
    corner_score.launches = 0
    lk_track.launches = 0
    pp0 = pps["graph"].init(frame0, **init)

    res = {}

    def timed(name, fn):
        """fn() on the host clock between synchronisations, its host
        synchronisations counted."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[f"{name}_syncs"] = sync_counter(lambda: res.update(out=fn()))
        torch.cuda.synchronize()
        res[f"{name}_host_ms_per_frame"] = (time.perf_counter() - t0) / N * 1e3
        return res.pop("out")

    _, fs, out = timed("pp", lambda: pps["graph"].run(*pp0, *seq))
    launches = {"corner_score": corner_score.launches,
                "lk_track": lk_track.launches}
    _, single = timed("single", lambda: pipe.run(st0, *seq))
    # the single-stream run is a fresh VioPipeline's: its capture is inside
    # the synchronisations counted
    res["single_captures"] = pipe.run_graph.captures if pipe.run_graph else 0
    turns = {"graph": [], "eager": []}
    got = {"graph": [out], "eager": []}
    for name in ("eager", "graph", "eager", "graph"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[name].append(pps[name].run(*starts[name], *seq)[2])
        torch.cuda.synchronize()
        turns[name].append((time.perf_counter() - t0) / N * 1e3)
    res["turns_ms_per_frame"] = turns
    g = pps["graph"]
    res["captures"] = [g.frontend_graph.captures, g.filter_graph.captures]
    res["capture_ms"] = g.frontend_graph.capture_ms + g.filter_graph.capture_ms
    res["pool_mb"] = [b / 2 ** 20 for b in g.frontend_graph.pool_bytes
                      + g.filter_graph.pool_bytes]
    p_1 = single["p"].cpu().numpy()
    res["max_dp_m"] = max(float(np.abs(o["p"].cpu().numpy() - p_1).max())
                          for o in got["graph"])
    res["eager_max_dp_m"] = max(float(np.abs(o["p"].cpu().numpy()
                                              - p_1).max())
                                for o in got["eager"])
    res["ate_cm"] = float(np.sqrt(np.mean(np.sum(
        (out["p"].cpu().numpy() - gwc[1:, :, 3]) ** 2, axis=1)))) * 100
    check(bool(out["healthy"].all()), "two-stage run unhealthy")
    check(fs.p.device.type == dev.type, f"filter stage on {fs.p.device}")
    check(res["max_dp_m"] == 0.0,
          f"two streams != one stream: max |dp| {res['max_dp_m']}")
    check(res["eager_max_dp_m"] == 0.0, "the eager two-stage run != one "
          f"stream: max |dp| {res['eager_max_dp_m']}")
    check(res["captures"] == [1, 1], f"the stages captured "
          f"{res['captures']} graphs over {1 + len(turns['graph'])} runs: "
          "not one a stage")
    check(res["pp_syncs"] <= res["single_syncs"],
          f"two-stage run synchronises the host {res['pp_syncs']} times, "
          f"the single-stream run {res['single_syncs']}")
    check(max(turns["graph"]) < min(turns["eager"]),
          f"graphed two-stage ms a frame {turns['graph']} not below the "
          f"eager twin's {turns['eager']}")

    # the profiler's bookkeeping of a whole run takes minutes on the host:
    # trace the first PP_PROFILE_FRAMES frames
    head = tuple(x[:PP_PROFILE_FRAMES] for x in seq)
    warm = tuple(x[:TRACE_WARM_FRAMES] for x in seq)
    n = head[0].shape[0]
    for name, fn in (("single", lambda x: pipe.run(st0, *x)),
                     ("pp", lambda x: pps["graph"].run(*pp0, *x)),
                     ("pp_eager", lambda x: pps["eager"].run(
                         *starts["eager"], *x))):
        trace = device_trace(lambda: fn(head), lambda: fn(warm),
                             f"{name} over {n} frames")
        busy, total = trace.busy_ms()
        res[f"{name}_device_busy_ms_per_frame"] = busy / n
        res[f"{name}_device_time_ms_per_frame"] = total / n
        res[f"{name}_device_ops_per_frame"] = len(trace.ops) / n
        res[f"{name}_host_launches_per_frame"] = trace.host_launches / n
        res[f"{name}_graph_launches"] = trace.graph_launches
    return launches, res, single


def dist_one_rank(dev, ba_prob, card):
    """(a) An in-process group of one rank (nccl on the card) runs the
    dryrun twin at full size: the step, dense / pcg / submap against
    `ba_solve`, the dryrun's own filter-made problem, the two-stage pipeline
    on its 13-frame scene, 128 x 8192 auto -> pcg; then the VIO bench
    scene's own BA problem (the BA phase's feed). ms a GN step of each
    solver by CUDA events, all_reduces a GN step, peak device memory."""
    import torch
    import torch.distributed as tdist

    from visma_tpu_torch import dryrun
    from visma_tpu_torch.ba.problem import synthetic_ba_problem
    from visma_tpu_torch.dist import make_mesh
    from visma_tpu_torch.dist.sharded_ba import sharded_ba_solve

    backend = "nccl" if dev.type == "cuda" else "gloo"
    tdist.init_process_group(backend, init_method="tcp://127.0.0.1:"
                             f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(device=dev)
        check(mesh.group is not None and mesh.size == 1, "no one-rank group")
        torch.cuda.reset_peak_memory_stats()
        turns = dist_graph_turns(mesh)
        out = dryrun.dryrun_multichip(mesh, *BA_DRYRUN[:2],
                                      large=BA_LARGE[:2],
                                      log=lambda m: log(f"dist: (a) {m}"),
                                      timer=timed_ms)
        out["vio_bench"] = dryrun.vio_parity(
            mesh, ba_prob, iters=BA_ITERS, what="VIO bench scene",
            log=lambda m: log(f"dist: (a) {m}"))
        big, _ = synthetic_ba_problem(*BA_LARGE[:2], 0.5, 0.02, device=dev)
        timing = solver_timing(out)
        mesh.reset_counts()
        ms = cuda_ms(lambda: sharded_ba_solve(big, mesh, iters=BA_LARGE[2],
                                              solver="auto", cg_iters=40),
                     reps=1, warmup=0)
        calls = dict(mesh.counts)
        timing["large_auto_pcg"] = {
            "ms_per_call": ms, "ms_per_gn_step": ms / BA_LARGE[2],
            "all_reduce_per_gn_step": calls["all_reduce"] / BA_LARGE[2],
            "all_gather_per_call": calls["all_gather"]}
        out["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
        out["backend"] = tdist.get_backend()
    finally:
        tdist.destroy_process_group()
    for k in ("solutions", "ms", "counts"):
        out.pop(k)
    out["timing"] = timing
    out["turns"] = turns
    for name, t in turns.items():
        log(f"dist: (a) {name}: {turns_line(t)}; all_reduces a GN step "
            f"{t['all_reduce_per_gn_step']:.1f} graphed, "
            f"{t['eager_all_reduce_per_gn_step']:.1f} eager [{card}]")
    log(f"dist: (a) one rank, {out['backend']}: " + "; ".join(
        f"{k} {v['ms_per_gn_step']:.3f} ms a GN step, "
        f"{v['all_reduce_per_gn_step']:.1f} all_reduces a GN step"
        for k, v in timing.items())
        + f"; peak device memory {out['peak_mib']:.1f} MiB [{card}]")
    return out


def dist_graph_turns(mesh):
    """The distributed solvers on `mesh` in turns graph / eager / graph /
    eager (`graph_turns`), each on a fresh key, before the dryrun runs
    them: dense, PCG (40 CG iterations) and submap at the dryrun's 32 x
    2048, and 128 x 8192 auto -> PCG. Graph equal to eager bit for bit;
    the all_reduces a GN step counted through replays equal the eager
    loop's (dense 3, PCG cg_iters + 3); 0 host synchronisations in a
    graphed solve after its capture (for the submap: its local solve,
    the submap's bookkeeping being host numpy). Returns the numbers."""
    from visma_tpu_torch.ba.problem import BaProblem, synthetic_ba_problem
    from visma_tpu_torch.dist import submap_ba
    from visma_tpu_torch.dist.pcg_ba import pcg_ba_solve
    from visma_tpu_torch.dist.sharded_ba import sharded_ba_solve

    prob, _ = synthetic_ba_problem(*BA_DRYRUN[:2], 0.5, 0.02,
                                   device=mesh.device)
    big, _ = synthetic_ba_problem(*BA_LARGE[:2], 0.5, 0.02,
                                  device=mesh.device)
    chunks, _ = submap_ba.split_into_chunks(prob, mesh.size, halo=2)
    chunk = BaProblem(*(getattr(chunks, f)[mesh.shard_rank()] for f in
                        ("R", "p", "X", "obs", "mask", "intr")))
    cases = {
        "dense": (lambda g: sharded_ba_solve(prob, mesh, iters=10,
                                             solver="dense", graph=g), 10,
                  3, None),
        "pcg": (lambda g: pcg_ba_solve(prob, mesh, iters=10, cg_iters=40,
                                       graph=g), 10, 43, None),
        "submap": (lambda g: submap_ba.submap_ba_solve(
            prob, mesh, iters=8, polish_iters=6, halo=2,
            polish_solver="pcg", graph=g)[0], 8 + 6, None,
            lambda: submap_ba._local_solve(chunk, 8)),
        "large_auto_pcg": (lambda g: sharded_ba_solve(
            big, mesh, iters=BA_LARGE[2], solver="auto", cg_iters=40,
            graph=g), BA_LARGE[2], 43, None)}
    out = {}
    for name, (call, steps, per_step, sync_call) in cases.items():
        counted = {}

        def counting(g, call=call, counted=counted):
            mesh.reset_counts()
            res = call(g)
            counted.setdefault(g, dict(mesh.counts))
            return res

        t = graph_turns(counting, steps, sync_call=sync_call)
        t = turns_record(t)
        t["all_reduce_per_gn_step"] = counted[True]["all_reduce"] / steps
        t["eager_all_reduce_per_gn_step"] = (counted[False]["all_reduce"]
                                             / steps)
        check(counted[True] == counted[False],
              f"{name}: collectives graphed {counted[True]} != eager "
              f"{counted[False]}")
        if per_step is not None:
            check(t["all_reduce_per_gn_step"] == per_step,
                  f"{name}: {t['all_reduce_per_gn_step']} all_reduces a GN "
                  f"step, not {per_step}")
        out[name] = t
    return out


def solver_timing(parity):
    """ms and collectives a GN step of each solver from
    `dryrun.solver_parity`'s readings of its one call (the submap: 8 local
    steps and 6 of the polish)."""
    steps = {"dense": 10, "pcg": 10, "submap": 8 + 6}
    return {name: {"ms_per_call": parity["ms"][name],
                   "ms_per_gn_step": parity["ms"][name] / n,
                   "all_reduce_per_gn_step":
                       parity["counts"][name]["all_reduce"] / n,
                   "all_gather_per_call":
                       parity["counts"][name]["all_gather"]}
            for name, n in steps.items()}


def dist_rank_main(rank, world, addr, out_dir, device):
    """(b) One of the gloo ranks on the card: the dryrun's solvers at 32 x
    2048 (gated in `dryrun.solver_parity`), each call timed by CUDA events
    and its reductions counted; writes rank{r}.npz (the replicated
    outputs) and rank{r}.json (the numbers)."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    sys.path.insert(0, ROOT)
    from visma_tpu_torch import dryrun
    from visma_tpu_torch.dist import make_mesh

    torch.set_num_threads(1)
    dev = torch.device(device)
    tdist.init_process_group("gloo", init_method=f"tcp://{addr}",
                             world_size=world, rank=rank)
    mesh = make_mesh(device=dev)
    # a CPU rehearsal of the phase times nothing
    out = dryrun.solver_parity(
        mesh, *BA_DRYRUN[:2],
        log=(lambda m: log(f"dist: (b) {m}")) if rank == 0 else
        (lambda m: None),
        timer=timed_ms if dev.type == "cuda" else
        (lambda fn: (fn(), float("nan"))))
    arrays = {}
    for name, (sol, hist) in out.pop("solutions").items():
        arrays.update({f"{name}_p": sol.p.cpu().numpy(),
                       f"{name}_R": sol.R.cpu().numpy(),
                       f"{name}_X": sol.X.cpu().numpy()})
        if name != "submap":
            arrays[f"{name}_hist"] = hist.cpu().numpy()
    out["timing"] = solver_timing(out)
    for k in ("ms", "counts"):
        out.pop(k)
    # a gloo group loops its mesh solvers eagerly; the local solve and the
    # stitch make no collective and capture on the card
    from visma_tpu_torch.dist import sharded_ba

    mine = sharded_ba.mesh_key(mesh)
    out["mesh_solver_graphs"] = sum(
        key[0] == mine for key in sharded_ba._RUNS) + sum(
        key == mine for key in sharded_ba._STEPS)
    out["captures"] = {label: r.captures for label, r in solver_graphs()
                       if r.captures}
    tdist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fp:
        json.dump(out, fp)


def dist_gloo_ranks(card, device="cuda:0", world=DIST_RANKS):
    """(b) `world` gloo ranks, all on one card: the dryrun's gates on every
    rank and the replicated outputs the same bytes on every rank. Ranks
    that share one card measure the host round trip of each reduction (gloo
    stages CUDA tensors through host memory) and the card's time slicing
    between their processes, not scaling."""
    import tempfile

    import numpy as np

    with tempfile.TemporaryDirectory() as out_dir:
        addr = f"127.0.0.1:{free_port()}"
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-rank",
             str(r), str(world), addr, out_dir, device],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        deadline = time.time() + DIST_TIMEOUT_S
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(1.0, deadline - time.time()))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()  # the exact pids this phase started
                    p.wait()
        for line in logs[0].splitlines():
            log(line)
        for r, p in enumerate(procs):
            check(p.returncode == 0, f"gloo rank {r} failed:\n{logs[r]}")
        arrays = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
                  for r in range(world)]
        nums = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as fp:
                nums.append(json.load(fp))
    for r in range(1, world):
        for k, v in arrays[0].items():
            check(np.array_equal(arrays[r][k], v),
                  f"rank {r}'s {k} differs from rank 0's")
    res = nums[0]
    for r, n in enumerate(nums):
        check(n["mesh_solver_graphs"] == 0,
              f"gloo rank {r} made {n['mesh_solver_graphs']} mesh solver "
              "graphs")
    log(f"dist: (b) captures on each of the {world} gloo ranks: "
        f"{[n['captures'] for n in nums]}; mesh solvers (eager on gloo): "
        f"{[n['mesh_solver_graphs'] for n in nums]} graphs")
    log(f"dist: (b) {world} gloo ranks on one card: replicated outputs the "
        f"same bytes on every rank ({len(arrays[0])} arrays); " + "; ".join(
            f"{k} {v['ms_per_gn_step']:.3f} ms a GN step, "
            f"{v['all_reduce_per_gn_step']:.1f} all_reduces a GN step"
            for k, v in res["timing"].items())
        + " (each reduction a round trip through host memory: not "
        f"scaling) [{card}]")
    return res


def drill_worker(workdir, total_steps, step_sleep, device):
    """(d) The checkpointing worker (tests/workers/fault_worker.py on the
    port): `total_steps` sharded GN steps on a one-rank mesh, the whole
    BaProblem saved after each and a heartbeat touched; resumes from the
    latest snapshot."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from visma_tpu_torch.ba.problem import synthetic_ba_problem
    from visma_tpu_torch.dist import make_mesh, sharded_ba_step
    from visma_tpu_torch.dist.multihost import Heartbeat
    from visma_tpu_torch.utils.checkpoint import (latest_step, load_state,
                                                  save_state)

    dev = torch.device(device)
    ckpt = os.path.join(workdir, "ckpt")
    hb = Heartbeat(os.path.join(workdir, "heartbeat"), interval_s=0.0)
    prob, _ = synthetic_ba_problem(*DRILL[:2], 0.5, 0.02, device=dev)
    start = 0
    if os.path.exists(os.path.join(ckpt, "latest.json")):
        start = latest_step(ckpt)
        prob = load_state(ckpt, prob, step=start)
        log(f"drill worker: resumed from step {start}")
    mesh = make_mesh(device=dev)
    for step in range(start, total_steps):
        prob, _ = sharded_ba_step(prob, mesh, damping=1e-3)
        save_state(ckpt, prob, step=step + 1)
        hb.touch(step + 1)
        time.sleep(step_sleep)
    np.savez(os.path.join(workdir, "final.npz"), p=prob.p.cpu().numpy(),
             X=prob.X.cpu().numpy())


def fault_drill(device="cuda:0"):
    """(d) tests/test_multihost.py:111-158 with the port on `device`: an
    uninterrupted run and a victim run side by side; the victim is
    SIGKILLed by its exact pid once it has checkpointed step 2, the
    Watchdog respawns it, it resumes from the npz, and its final p and X
    equal the uninterrupted run's to 1e-6. Returns the numbers."""
    import signal
    import tempfile

    import numpy as np

    from visma_tpu_torch.dist.multihost import Watchdog

    def spawn(workdir, sleep_s):
        logf = open(os.path.join(workdir, "log.txt"), "a")
        try:
            return subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--drill-worker",
                 workdir, str(DRILL[2]), str(sleep_s), device],
                cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT)
        finally:
            logf.close()

    t0 = time.time()
    with tempfile.TemporaryDirectory() as root:
        clean, drill = os.path.join(root, "clean"), os.path.join(root, "drill")
        os.makedirs(clean)
        os.makedirs(drill)
        latest = os.path.join(drill, "ckpt", "latest.json")
        ref_proc = spawn(clean, 0.0)
        victim = spawn(drill, 0.5)
        try:
            deadline = time.time() + 120
            while time.time() < deadline and victim.poll() is None:
                if os.path.exists(latest):
                    with open(latest) as fp:
                        if json.load(fp)["step"] >= 2:
                            break
                time.sleep(0.05)
            check(victim.poll() is None, "the drill's victim ended early")
            os.kill(victim.pid, signal.SIGKILL)
            victim.wait()
            with open(latest) as fp:
                killed_at = json.load(fp)["step"]
            check(not os.path.exists(os.path.join(drill, "final.npz")),
                  "the victim finished before the kill")
            wd = Watchdog(lambda: spawn(drill, 0.0),
                          heartbeat_path=os.path.join(drill, "heartbeat"),
                          stale_timeout_s=60.0, poll_s=0.2, max_restarts=2)
            restarts = wd.run()
            check(ref_proc.wait(timeout=120) == 0, "the clean run failed")
        finally:
            for p in (ref_proc, victim):
                if p.poll() is None:
                    p.kill()  # the exact pids this phase started
                    p.wait()
        with open(os.path.join(drill, "log.txt")) as fp:
            resumed = "resumed from step" in fp.read()
        ref = np.load(os.path.join(clean, "final.npz"))
        got = np.load(os.path.join(drill, "final.npz"))
        res = {"killed_after_step": killed_at, "restarts": restarts,
               "resumed": resumed,
               "max_dp_m": float(np.abs(got["p"] - ref["p"]).max()),
               "max_dX_m": float(np.abs(got["X"] - ref["X"]).max()),
               "seconds": time.time() - t0}
    check(resumed and restarts == 0, f"the drill did not resume: {res}")
    check(res["max_dp_m"] <= DRILL_TOL and res["max_dX_m"] <= DRILL_TOL,
          f"the recovered run differs from the uninterrupted one: {res}")
    return res


def dist_cli(device_args=()):
    """(e) `run_vio --synthetic 48 --pixel-noise 1.0 --no-imu --ba sharded
    --ba-stride 2` (one process: the one-rank mesh) against `--ba dense`:
    the same report keys, the similarity-aligned refined ATE within
    BA_POSE_TOL_M. Returns both reports."""
    from visma_tpu_torch.cli import run_vio

    args = ["--synthetic", str(BA_CLI_FRAMES), "--pixel-noise", "1.0",
            "--no-imu", "--ba-stride", "2", *device_args]
    sharded = run_vio.main(args + ["--ba", "sharded"])
    dense = run_vio.main(args + ["--ba", "dense"])
    check(sharded.get("ba") == "sharded" and sharded.keys() == dense.keys(),
          f"run_vio --ba sharded: {sharded}")
    d = abs(sharded["ate_ba_sim_aligned_m"] - dense["ate_ba_sim_aligned_m"])
    check(d < BA_POSE_TOL_M, f"--ba sharded vs dense: {sharded} / {dense}")
    return sharded, dense


def dist_phase(dev, vio_scene, card):
    """The distributed layer on the card (no hand kernel of its own; the
    two-stage pipeline runs K1 and K2): (c) the two-stream pipeline, then
    (a) one nccl rank, (b) eight gloo ranks with (d) the fault drill beside
    them, (e) `run_vio --ba sharded`. Returns the launches of (c)."""
    from visma_tpu_torch.ba.from_vio import ba_problem_from_vio

    t_phase = time.time()
    launches, c, single = pp_two_streams(dev, vio_scene)
    t = c["turns_ms_per_frame"]
    log(f"dist: (c) two-stage pipeline, both stages on {dev} (two streams, "
        f"chunk {PP_CHUNK}, each stage a replayed StepGraph), "
        f"{vio_scene['images'].shape[0]} frames: max |p - VioPipeline.run's "
        f"p| = {c['max_dp_m']} (the eager twin's {c['eager_max_dp_m']}), ATE "
        f"{c['ate_cm']:.3f} cm, launches {launches}; host ms/frame: the "
        f"first graphed run {c['pp_host_ms_per_frame']:.3f} (captures "
        f"{c['captures']} in {[round(x, 1) for x in c['capture_ms']]} ms, "
        f"pools {[round(x, 1) for x in c['pool_mb']]} MB), one stream "
        f"{c['single_host_ms_per_frame']:.3f}, in turns eager / graph / "
        f"eager / graph {t['eager'][0]:.3f} / {t['graph'][0]:.3f} / "
        f"{t['eager'][1]:.3f} / {t['graph'][1]:.3f}; over the first "
        f"{PP_PROFILE_FRAMES} frames, graphed / eager / one stream: device "
        f"busy {c['pp_device_busy_ms_per_frame']:.3f} / "
        f"{c['pp_eager_device_busy_ms_per_frame']:.3f} / "
        f"{c['single_device_busy_ms_per_frame']:.3f} ms a frame (device time "
        f"{c['pp_device_time_ms_per_frame']:.3f} / "
        f"{c['pp_eager_device_time_ms_per_frame']:.3f} / "
        f"{c['single_device_time_ms_per_frame']:.3f}; device ops "
        f"{c['pp_device_ops_per_frame']:.1f} / "
        f"{c['pp_eager_device_ops_per_frame']:.1f} / "
        f"{c['single_device_ops_per_frame']:.1f} a frame, host launches "
        f"{c['pp_host_launches_per_frame']:.1f} / "
        f"{c['pp_eager_host_launches_per_frame']:.1f} / "
        f"{c['single_host_launches_per_frame']:.1f} a frame); host "
        f"synchronisations {c['pp_syncs']} / {c['single_syncs']} (the one "
        f"stream's run captured {c['single_captures']} CUDA graph) [{card}]")

    check(f"{c['ate_cm']:.3f}" == f"{EARLIER_ATE_CM['vio']:.3f}",
          f"two-stage ATE {c['ate_cm']:.4f} cm != {EARLIER_ATE_CM['vio']} cm")
    n = vio_scene["images"].shape[0]
    check(launches == {"corner_score": n + 1, "lk_track": n},
          f"pp launches {launches}: not one K1 a frame and one K2 a "
          "tracked frame")
    # the frame step reads nothing back (filter/msckf.py's body-rate
    # gather stays on the device)
    check(max(c["pp_syncs"], c["single_syncs"]) <= VIO_SYNCS_PER_FRAME * n,
          f"host synchronisations {c['pp_syncs']} / {c['single_syncs']} "
          f"over {n} tracked frames: more than {VIO_SYNCS_PER_FRAME} a "
          "frame")

    cfg = vio_scene["cfg"]
    N = vio_scene["images"].shape[0]
    ba_prob, _ = ba_problem_from_vio(
        single["obs_ids"].cpu().numpy(), single["obs_xp"].cpu().numpy(),
        single["obs_valid"].cpu().numpy(), single["R"].cpu().numpy(),
        single["p"].cpu().numpy(), (cfg.fx, cfg.fy, cfg.cx, cfg.cy),
        R_bc=cfg.cam_R_bc, p_bc=cfg.cam_p_bc, stride=BA_STRIDE,
        max_landmarks=2 * cfg.max_tracks * max(N // BA_STRIDE, 1),
        device=dev)
    check(ba_prob is not None, "dist: the VIO scene gave BA no problem")
    secs = {"c": time.time() - t_phase}
    t0 = time.time()
    a = dist_one_rank(dev, ba_prob, card)
    secs["a"] = time.time() - t0
    # the drill waits on process starts and files, not on the card: it runs
    # beside (b) in a thread of its own
    drill = {}

    def run_drill():
        try:
            drill["res"] = fault_drill()
        except Exception as e:  # re-raised below, in the phase's thread
            drill["err"] = e

    t0 = time.time()
    worker = threading.Thread(target=run_drill)
    worker.start()
    try:
        b = dist_gloo_ranks(card)
    finally:
        worker.join()
    secs["b+d"] = time.time() - t0
    if "err" in drill:
        raise drill["err"]
    d = drill["res"]
    log(f"dist: (d) fault drill at {DRILL[0]} x {DRILL[1]}, {DRILL[2]} "
        f"steps on {dev}: killed after step {d['killed_after_step']}, "
        f"resumed, final p / X {d['max_dp_m']:.1e} / {d['max_dX_m']:.1e} "
        f"from the uninterrupted run's (tol {DRILL_TOL}), "
        f"{d['seconds']:.1f} s beside (b) [{card}]")
    t0 = time.time()
    sharded, dense = dist_cli()
    secs["e"] = time.time() - t0
    log(f"dist: (e) run_vio --ba sharded: similarity-aligned ATE "
        f"{sharded['ate_sim_aligned_m']} -> {sharded['ate_ba_sim_aligned_m']}"
        f" m (--ba dense {dense['ate_ba_sim_aligned_m']} m) [{card}]")
    log("dist: " + json.dumps({
        "pp": c, "one_rank": a, "gloo_ranks": b, "drill": d,
        "cli": {"sharded": sharded, "dense": dense},
        "seconds": time.time() - t_phase, "seconds_by_part": secs},
        default=float))
    log(f"dist: phase {time.time() - t_phase:.1f} s ("
        + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items())
        + f") [{card}]")
    return launches


def place(V, T):
    import numpy as np

    return np.asarray(V) @ T[:3, :3].T + T[:3, 3]


def bench_eval_scene():
    """bench.py:341-478's scene, built with the port's copies: the chair +
    desk ground truth, the perturbed estimate, the ICP pair and the five
    RegisterScenes objects, from the bench's seeds."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    from visma_tpu_torch.eval.sampling import sample_mesh
    from visma_tpu_torch.io.procedural import bench_mesh_db

    rng = np.random.default_rng(11)
    db = bench_mesh_db()
    Vc, Fc = db["chair"]
    Vd, Fd = db["desk"]
    T1 = np.eye(4)
    T1[:3, :3] = Rotation.from_euler("y", 0.4).as_matrix()
    T1[:3, 3] = [-0.8, 0.0, 2.5]
    T2 = np.eye(4)
    T2[:3, 3] = [0.8, 0.0, 3.0]
    Vt = np.concatenate([place(Vc, T1), place(Vd, T2)])
    Ft = np.concatenate([np.asarray(Fc), np.asarray(Fd) + len(Vc)])
    dT = np.eye(4)
    dT[:3, :3] = Rotation.from_euler("y", 0.01).as_matrix()
    dT[:3, 3] = [0.01, -0.005, 0.008]
    Vs = place(Vt, dT)

    model_pts = sample_mesh(Vc, Fc, EVAL_ICP_SAMPLES, seed=1)
    scan = place(model_pts, T1) + rng.normal(0, 0.004, model_pts.shape)
    dTi = np.eye(4)
    dTi[:3, :3] = Rotation.from_euler("y", 0.03).as_matrix()
    dTi[:3, 3] = [0.02, -0.01, 0.015]
    src = place(model_pts, dTi @ T1)

    objs_t, objs_s = {}, {}
    T_off = np.eye(4)
    T_off[:3, :3] = Rotation.from_euler("z", 0.3).as_matrix()
    T_off[:3, 3] = [0.5, -0.2, 0.1]
    for i in range(5):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("y", rng.uniform(0, 6)).as_matrix()
        T[:3, 3] = rng.uniform(-2, 2, 3)
        objs_t[i] = {"name": "chair" if i % 2 else "desk", "pose": T}
        objs_s[i] = {"name": objs_t[i]["name"], "pose": T_off @ T}
    return dict(Vt=Vt, Ft=Ft, Vs=Vs, src=src, scan=scan, objs_t=objs_t,
                objs_s=objs_s)


def z_up_mesh_db():
    """The bench chair and desk turned z-up (the annotation tool's yaw
    sweep turns about z), standing on z = 0."""
    import numpy as np

    from visma_tpu_torch.io.procedural import bench_mesh_db

    Rx = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
    out = {}
    for name, (V, F) in bench_mesh_db().items():
        Vz = np.asarray(V, np.float64) @ Rx.T
        Vz[:, 2] -= Vz[:, 2].min()
        out[name] = (Vz, np.asarray(F))
    return out


def write_tool_scene(root, cloud_points):
    """A VISMA evaluation directory (eval/evaluate.py's layout): 2 chairs +
    2 desks of the z-up bench meshes at ground-truth poses, alignment.json,
    result.json in a frame offset by a known T_ef_corvis, and test.klg.ply,
    a pseudo-ground-truth cloud of about `cloud_points` points (the objects
    sampled by area and a floor, 2 mm noise). Returns (config path,
    T_ef_corvis, {key: (name, pose)}, the cloud)."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    from visma_tpu_torch.eval.sampling import sample_mesh
    from visma_tpu_torch.io import save_obj, save_ply
    from visma_tpu_torch.io.json_io import matrix_to_json

    rng = np.random.default_rng(5)
    db = z_up_mesh_db()
    cad = os.path.join(root, "cad")
    scene_dir = os.path.join(root, "data", "scene")
    os.makedirs(cad)
    os.makedirs(os.path.join(scene_dir, "fragments"))
    for name, (V, F) in db.items():
        save_obj(os.path.join(cad, name + ".obj"), V, F)

    objects, gt_json, pts = {}, {}, []
    slots = [(-1.25, -1.25), (1.25, -1.25), (-1.25, 1.25), (1.25, 1.25)]
    area = {n: 0.5 * np.linalg.norm(np.cross(V[F[:, 1]] - V[F[:, 0]],
                                             V[F[:, 2]] - V[F[:, 0]]),
                                    axis=1).sum() for n, (V, F) in db.items()}
    n_obj = int(cloud_points * 0.8)
    total = 2 * (area["chair"] + area["desk"])
    for i, (name, xy) in enumerate(zip(["chair", "desk", "chair", "desk"],
                                       slots)):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("z", rng.uniform(0, 2 * np.pi)
                                        ).as_matrix()
        T[:3, 3] = [xy[0] + rng.uniform(-0.2, 0.2),
                    xy[1] + rng.uniform(-0.2, 0.2), 0.0]
        key = f"{name}_{i}"
        objects[key] = (name, T)
        matrix_to_json(gt_json, key, T[:3, :4])
        V, F = db[name]
        pts.append(place(sample_mesh(V, F, int(n_obj * area[name] / total),
                                     seed=10 + i), T))
    n_floor = cloud_points - sum(len(p) for p in pts)
    pts.append(np.column_stack([rng.uniform(-2.5, 2.5, (n_floor, 2)),
                                np.zeros(n_floor)]))
    cloud = (np.concatenate(pts) + rng.normal(0, 0.002, (cloud_points, 3))
             ).astype(np.float32)
    with open(os.path.join(scene_dir, "fragments", "alignment.json"),
              "w") as fp:
        json.dump(gt_json, fp)

    T_ef_corvis = np.eye(4)
    T_ef_corvis[:3, :3] = Rotation.from_rotvec([0.1, -0.2, 0.3]).as_matrix()
    T_ef_corvis[:3, 3] = [0.4, -0.3, 0.2]
    result = []
    for i, (key, (name, T)) in enumerate(objects.items()):
        obj = {"id": i, "model_name": name, "status": 2}
        matrix_to_json(obj, "model_pose",
                       (np.linalg.inv(T_ef_corvis) @ T)[:3, :4])
        result.append(obj)
    with open(os.path.join(scene_dir, "result.json"), "w") as fp:
        json.dump([result], fp)
    save_ply(os.path.join(scene_dir, "test.klg.ply"), cloud)

    config = {"dataroot": os.path.join(root, "data"), "dataset": "scene",
              "CAD_database_root": cad,
              "evaluation": {"ICP_refinement": True, "voxel_size": 0.05,
                             "max_distance": 0.075,
                             "samples_per_model": EVAL_ICP_SAMPLES},
              "visualization": {"model_samples": 5000}}
    cfg_path = os.path.join(root, "tool.json")
    with open(cfg_path, "w") as fp:
        json.dump(config, fp)
    return cfg_path, T_ef_corvis, objects, cloud


def eval_cli(root, card):
    """cli.evaluate on a tool.json scene, then cli.annotate on each
    object's part of the same cloud, both on the card by default. Returns
    the evaluate tool's seconds and metrics."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    from visma_tpu_torch.cli import annotate, evaluate
    from visma_tpu_torch.io import save_ply

    cfg_path, T_true, objects, cloud = write_tool_scene(root,
                                                        EVAL_CLOUD_POINTS)
    scene_dir = os.path.join(root, "data", "scene")
    t0 = time.time()
    metrics = evaluate.main([cfg_path])
    eval_s = time.time() - t0
    with open(os.path.join(scene_dir, "result_alignment.json")) as fp:
        T = np.asarray(json.load(fp)["T_ef_corvis"]).reshape(3, 4)
    t_err = float(np.abs(T - T_true[:3]).max())
    log(f"eval: cli.evaluate on {len(cloud)} cloud points, "
        f"{len(objects)} objects: {eval_s:.2f} s; T_ef_corvis recovered to "
        f"{t_err:.2e} (gate 0.02); surface mean "
        f"{metrics['surface']['mean']:.5f} m, translation max "
        f"{metrics['translation']['max']:.5f} m, rotation max "
        f"{metrics['rotation']['max']:.4f} deg [{card}]")
    check(t_err < 0.02, f"evaluate: T_ef_corvis off by {t_err}")
    check(metrics["surface"]["mean"] < 0.02, "evaluate: surface mean")
    check(metrics["translation"]["max"] < 0.05, "evaluate: translation max")
    check(metrics["rotation"]["max"] < 3.0, "evaluate: rotation max")
    for name in ("result_alignment.json", "augmented_view.ply",
                 "surface_error.json", "translation_error.json",
                 "rotation_error.json"):
        check(os.path.isfile(os.path.join(scene_dir, name)),
              f"evaluate did not write {name}")

    # the annotation tool, one object's part of the cloud at a time (its
    # yaw sweep starts from the part's centroid)
    t0 = time.time()
    cad = os.path.join(root, "cad")
    for key, (name, T) in objects.items():
        near = (np.linalg.norm(cloud[:, :2] - T[:2, 3], axis=1) < 0.9) \
            & (cloud[:, 2] > 0.01)
        scan = os.path.join(root, f"{key}.ply")
        save_ply(scan, cloud[near])
        out = os.path.join(root, f"{key}.json")
        before = [(r, r.captures) for _, r in solver_graphs()]
        fits = annotate.main([scan, cad, name, "--output", out])
        caps = captures_since(before)
        res = fits[f"{name}_0"]
        with open(out) as fp:
            Ta = np.asarray(json.load(fp)[f"{name}_0"]).reshape(3, 4)
        dR = Ta[:, :3].T @ T[:3, :3]
        rot = Rotation.from_matrix(dR).magnitude()
        if name == "desk":       # symmetric under a half turn about z
            rot = min(rot, Rotation.from_matrix(
                dR @ np.diag([-1.0, -1.0, 1.0])).magnitude())
        trans = float(np.linalg.norm(Ta[:, 3] - T[:3, 3]))
        log(f"eval: cli.annotate {key} on {int(near.sum())} points: fitness "
            f"{res.fitness:.3f}, translation {trans:.4f} m, rotation "
            f"{rot:.4f} rad; the 24-yaw sweep's ICP captures "
            f"{[(lb, round(c, 1), round(mb)) for lb, c, mb in caps]}")
        # one capture a sweep: its 24 ICPs have one shape (none where an
        # earlier object's sweep had the same shapes)
        check(len(caps) <= 1 and all(
            r.captures == 1 for lb, r in solver_graphs()
            if lb.startswith("icp ")),
              f"annotate {key}: the yaw sweep captured {caps}")
        check(res.fitness > 0.6, f"annotate {key}: fitness {res.fitness}")
        check(trans < 0.05, f"annotate {key}: translation {trans}")
        check(rot < 0.1, f"annotate {key}: rotation {rot}")
    log(f"eval: cli.annotate, {len(objects)} objects: "
        f"{time.time() - t0:.2f} s [{card}]")
    return eval_s, metrics


def surface_graph_turns(P, A, B, C, card):
    """`_pm_dist` of P against the triangles (A, B, C) graphed (a StepGraph
    over the chunks: the default on the card) and eager in turns graph /
    eager / graph / eager by CUDA events: one capture, in the first
    graphed call, none later; graph and eager the same bytes. Returns the
    ms of each turn."""
    import torch

    from visma_tpu_torch.eval.metrics import _pm_dist

    before = [(r, r.captures) for _, r in solver_graphs()]
    ms = {"graph": [], "eager": []}
    for i, mode in enumerate(("graph", "eager", "graph", "eager")):
        ms[mode].append(cuda_ms(
            lambda g=mode == "graph": _pm_dist(P, A, B, C, graph=g),
            reps=2, warmup=1))
        if i == 0:
            caps = captures_since(before)
            before = [(r, r.captures) for _, r in solver_graphs()]
    same = torch.equal(_pm_dist(P, A, B, C), _pm_dist(P, A, B, C,
                                                      graph=False))
    later = captures_since(before)
    log(f"eval: surface distance, {P.shape[0]} points x {A.shape[0]} "
        f"faces, graphed / eager / graphed / eager: "
        + " / ".join(f"{ms[m][i]:.3f}" for i in (0, 1) for m in ms)
        + f" ms by CUDA events (graphed: the first call's capture "
        f"{', '.join(f'{lb} {c:.1f} ms / {mb:.0f} MB' for lb, c, mb in caps)}"
        f", none later); the same bytes: {same} [{card}]")
    check(len(caps) == 1 and not later,
          f"surface distance captures {caps}, later {later}: not one")
    check(same, "surface distance: graphed and eager differ")
    return ms


def icp_tensors(res, dev):
    """An IcpResult as tensors on `dev`, for `graph_turns`."""
    import torch

    return (torch.as_tensor(res.transformation, device=dev),
            torch.tensor([res.fitness, res.inlier_rmse], dtype=torch.float64,
                         device=dev),
            torch.tensor(res.correspondences, device=dev))


def icp_graph_turns(s_dn, s_ok, t_dn, t_ok, kw, card):
    """`icp` at the bench's operating point, point-to-point and
    point-to-plane, graphed and eager in turns (`graph_turns`): the same
    bytes (transformation, fitness, rmse, correspondences), one capture of
    each loop in the first graphed call (point-to-plane: its normals' too,
    their one chunk warmed up by two calls before the turns) and none
    later, no host synchronisation in the graphed loops after
    their capture (their replays and the final pass alone; `icp` itself
    reads the target's mask and the result back)."""
    import importlib

    import torch

    from visma_tpu_torch.utils import graphs

    icp_mod = importlib.import_module("visma_tpu_torch.align.icp")
    dev = s_dn.device
    dst = t_dn[t_ok]
    dv = torch.ones(dst.shape[0], dtype=torch.bool, device=dev)
    T0 = torch.eye(4, device=dev)
    for p2p in (False, True):
        if p2p:
            # the normals' loop is one chunk on the card (`nn.map_rows`):
            # its two warm-up chunks are two calls, made before the turns
            for _ in range(graphs.StepGraph.warmup):
                icp_mod._estimate_normals(dst, dv, graph=True)

        def loops(p2p=p2p):
            n = (icp_mod._estimate_normals(dst, dv, graph=True) if p2p
                 else torch.zeros_like(dst))
            return icp_mod._icp_core(s_dn, s_ok, dst, dv, n, T0,
                                     kw["max_distance"], kw["max_iters"],
                                     p2p, graph=True)

        t = graph_turns(lambda g, p2p=p2p: icp_tensors(icp_mod.icp(
            s_dn, t_dn, point_to_plane=p2p, graph=g, **kw), dev),
            kw["max_iters"], sync_call=loops)
        check(len(t["captures"]) == 1 + p2p,
              f"ICP (point_to_plane={p2p}) captured {t['captures']}")
        ms = t["ms_per_step"]
        name = "point-to-plane" if p2p else "point-to-point"
        caps = ", ".join(f"{lb} {c:.1f} ms / {mb:.0f} MB"
                         for lb, c, mb in t["captures"])
        log(f"eval: ICP {name}, {kw['max_iters']} iterations, ms a call "
            f"graph / eager / graph / eager "
            + " / ".join(f"{ms[m][i] * kw['max_iters']:.3f}"
                         for i in (0, 1) for m in ms)
            + f" on the host clock (a call's set-up and read-back "
            f"included); graph and eager the same bytes; first graphed "
            f"call's captures: {caps}; none later; {t['syncs']} host "
            f"synchronisations in the graphed loops [{card}]")


def icp_cpu_times(s_dn, s_ok, t_dn, t_ok, kw):
    """The same ICP on the host's CPU, eager, in turns with LAPACK's
    `svd` (the CPU's form) and with the card's `eig3.kabsch_rotation`:
    ms a call on the host clock, 3 turns each; both at the JAX package's
    correspondences and rmse."""
    import importlib

    import torch

    eig3 = importlib.import_module("visma_tpu_torch.align.eig3")
    icp_mod = importlib.import_module("visma_tpu_torch.align.icp")
    cpu = [x.cpu() for x in (s_dn, s_ok, t_dn, t_ok)]
    args = dict(kw, source_valid=cpu[1], target_valid=cpu[3])
    capturable = eig3.capturable
    times = {"lapack": [], "jacobi": []}
    try:
        for _ in range(3):
            for form in times:
                eig3.capturable = ((lambda t: True) if form == "jacobi"
                                   else capturable)
                t0 = time.perf_counter()
                r = icp_mod.icp(cpu[0], cpu[2], device="cpu", **args)
                times[form].append((time.perf_counter() - t0) * 1e3)
                check(r.correspondences == ICP_REF_CORRESPONDENCES
                      and abs(r.inlier_rmse - ICP_REF_RMSE_M) < 1e-5,
                      f"ICP on the CPU ({form}) is not the JAX package's")
    finally:
        eig3.capturable = capturable
    log(f"eval: ICP on the host CPU ({torch.get_num_threads()} threads), "
        f"eager, ms a call with LAPACK's svd / the card's Jacobi rotation "
        f"in turns: "
        + ", ".join(f"{a:.1f} / {b:.1f}" for a, b in zip(times["lapack"],
                                                         times["jacobi"]))
        + "; both at the JAX package's correspondences and rmse")


def eval_phase(dev, card):
    """bench.py:341-478's operating points with the port's copies (surface
    error, ICP, RegisterScenes), then the evaluate and annotate tools."""
    import importlib
    import tempfile

    import numpy as np
    import torch

    from visma_tpu_torch.align import (icp, nearest_neighbors,
                                       register_scenes, voxel_downsample)
    from visma_tpu_torch.eval.metrics import (_pm_dist, _pm_dist_aos,
                                              compute_error_metric,
                                              point_mesh_distances)
    from visma_tpu_torch.eval.sampling import sample_mesh
    from visma_tpu_torch.eval import metrics

    icp_mod = importlib.import_module("visma_tpu_torch.align.icp")

    sc = bench_eval_scene()
    # surface error: EVAL_SURFACE_SAMPLES samples against the scene mesh
    pts = sample_mesh(sc["Vs"], sc["Ft"], EVAL_SURFACE_SAMPLES, seed=0)
    V = torch.as_tensor(sc["Vt"], dtype=torch.float32, device=dev)
    F = torch.as_tensor(sc["Ft"], dtype=torch.int64, device=dev)
    A, B, C = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    P = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    surf = surface_graph_turns(P, A, B, C, card)
    surf_ms = surf["graph"][1]
    m = compute_error_metric(point_mesh_distances(pts, sc["Vt"], sc["Ft"]))
    sub_pts = sample_mesh(sc["Vs"], sc["Ft"], EVAL_AOS_SAMPLES, seed=0)
    sub = torch.as_tensor(sub_pts, dtype=torch.float32, device=dev)
    d2_sub = _pm_dist(sub, A, B, C)
    sub_mean = float(torch.sqrt(d2_sub.double()).mean())
    log(f"eval: surface error, {len(pts)} samples x {len(sc['Ft'])} faces: "
        f"{surf_ms:.3f} ms by CUDA events; mean {m.mean:.6f} m (BENCH_r05: "
        f"{BENCH_SURFACE_MEAN_M} with a 4,999-face chair); over the "
        f"{len(sub)} samples of seed 0 {sub_mean:.9f} m, the JAX package "
        f"{SURFACE_REF_MEAN_20K_M:.9f} [{card}]")
    check(abs(sub_mean - SURFACE_REF_MEAN_20K_M) < 1e-6,
          f"surface mean {sub_mean} is not the JAX package's")
    check(abs(m.mean - SURFACE_REF_MEAN_20K_M) < SURFACE_SAMPLE_TOL_M,
          f"surface mean {m.mean} over {len(pts)} samples")
    err = (torch.sqrt(d2_sub) - torch.sqrt(_pm_dist_aos(sub, A, B, C))).abs()
    log(f"eval: SoA against the pairwise oracle on {len(sub)} samples: max "
        f"{float(err.max()):.3e} m, mean {float(err.mean()):.3e} m")
    check(float(err.max()) < 1.5e-3 and float(err.mean()) < 1e-5,
          "surface error: SoA path outside its documented bound")
    # a row's answer does not depend on the chunk the card takes
    pieces = torch.cat([_pm_dist(c, A, B, C) for c in torch.split(sub, 1024)])
    check(torch.equal(pieces, d2_sub), "surface error depends on the chunk")

    # ICP at the reference operating point
    s_dn, s_ok = voxel_downsample(torch.as_tensor(sc["src"], dtype=torch
                                                  .float32, device=dev),
                                  0.05, max_out=EVAL_VOXEL_CAP)
    t_dn, t_ok = voxel_downsample(torch.as_tensor(sc["scan"], dtype=torch
                                                  .float32, device=dev),
                                  0.05, max_out=EVAL_VOXEL_CAP)
    again = voxel_downsample(torch.as_tensor(sc["scan"], dtype=torch.float32,
                                             device=dev), 0.05,
                             max_out=EVAL_VOXEL_CAP)
    check(torch.equal(again[0], t_dn) and torch.equal(again[1], t_ok),
          "voxel_downsample: two runs differ")
    kw = dict(max_distance=0.075, max_iters=30, source_valid=s_ok,
              target_valid=t_ok)
    icp_graph_turns(s_dn, s_ok, t_dn, t_ok, kw, card)
    res = icp(s_dn, t_dn, **kw)
    times = {"graph": [], "eager": []}
    for _ in range(5):
        for mode in times:
            torch.cuda.synchronize()
            t0 = time.time()
            again = icp(s_dn, t_dn, graph=mode == "graph", **kw)
            times[mode].append((time.time() - t0) * 1e3)
    log(f"eval: ICP, {len(sc['src'])} samples at voxel 0.05 (cap "
        f"{EVAL_VOXEL_CAP}: {int(s_ok.sum())} / {int(t_ok.sum())} voxels), "
        f"30 iterations, graphed (the default) / eager in turns: "
        f"{np.mean(times['graph']):.3f} / {np.mean(times['eager']):.3f} ms "
        f"mean, {min(times['graph']):.3f} / {min(times['eager']):.3f} min "
        f"of 5 on the host clock; fitness {res.fitness:.4f}, rmse "
        f"{res.inlier_rmse * 100:.4f} cm, {res.correspondences} "
        f"correspondences (the JAX package: {ICP_REF_CORRESPONDENCES}, "
        f"{ICP_REF_RMSE_M * 100:.4f} cm; BENCH_r05 with a 4,999-face chair: "
        f"fitness {BENCH_ICP_FITNESS}) [{card}]")
    check(res.fitness >= 0.99, f"ICP fitness {res.fitness}")
    check(res.correspondences == ICP_REF_CORRESPONDENCES
          and abs(res.inlier_rmse - ICP_REF_RMSE_M) < 1e-5,
          "ICP is not the JAX package's")
    check(np.array_equal(res.transformation, again.transformation)
          and res.fitness == again.fitness
          and res.inlier_rmse == again.inlier_rmse,
          "ICP: two runs (graphed, eager) differ")
    icp_cpu_times(s_dn, s_ok, t_dn, t_ok, kw)
    q = torch.as_tensor(place(sc["src"], res.transformation),
                        dtype=torch.float32, device=dev)
    ref = t_dn[t_ok]
    i_all, d_all = nearest_neighbors(q, ref)
    i_pc, d_pc = zip(*(nearest_neighbors(c, ref) for c in torch.split(q,
                                                                      2048)))
    check(torch.equal(i_all, torch.cat(i_pc))
          and torch.equal(d_all, torch.cat(d_pc)),
          "nearest neighbours depend on the chunk")

    t0 = time.time()
    _, matches = register_scenes(sc["objs_t"], sc["objs_s"], threshold=0.5)
    reg_ms = (time.time() - t0) * 1e3
    log(f"eval: RegisterScenes, 5 objects: {reg_ms:.3f} ms on the host, "
        f"{len(matches)}/5 matched")
    check(len(matches) == 5, f"register_scenes found {len(matches)}/5")

    with tempfile.TemporaryDirectory() as root:
        eval_cli(root, card)
    # the loops' graphs keep their pools (the surface distance's about
    # 7 GB): the phases after this one get that memory back
    icp_mod.release_graphs()
    metrics.release_graphs()
    torch.cuda.empty_cache()


def counted_kernels():
    """The wrappers of the kernels the tools reach: K3, K4, K5's
    depth_edge and the fused edge_score."""
    from visma_tpu_torch.image.edges import depth_edge
    from visma_tpu_torch.render import raster as rs
    from visma_tpu_torch.render.likelihood import edge_score

    return (rs.chunk_raster_frame, rs.chunk_raster_batched, depth_edge,
            edge_score)


def launches_of(fn, *args):
    """(fn(*args), {kernel: launches}): the counts of the tools' kernels
    set to 0 just before the call and read just after."""
    counted = counted_kernels()
    for k in counted:
        k.launches = 0
    out = fn(*args)
    return out, {k.__name__: k.launches for k in counted}


def quiet_main(main_fn, argv):
    """(main_fn(argv), the JSON record it printed last, seconds): a tool's
    entry point in-process, its standard output kept for the record."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        out = main_fn(argv)
    secs = time.time() - t0
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return out, json.loads(lines[-1]) if lines else None, secs


def tool_render_depth(root, dev, intr, device_args=()):
    """(a) render_depth of the procedural chair from a written config:
    depthmap.bin against the plain render of the same mesh and pose (no
    coverage flip, DEPTH_REL_TOL; the background z_far), and mask.bin the
    same bytes as the plain coverage written the same way. Returns the
    tool's seconds."""
    import numpy as np
    import torch

    from visma_tpu_torch.cli import render_depth
    from visma_tpu_torch.io import load_mat, load_mesh, save_mat, save_obj
    from visma_tpu_torch.io.procedural import bench_mesh_db
    from visma_tpu_torch.render.raster import rasterize_depth_chunked_plain

    mesh = os.path.join(root, "chair.obj")
    save_obj(mesh, *bench_mesh_db()["chair"])
    out = os.path.join(root, "render")
    cfg = {"image_height": intr.rows, "image_width": intr.cols,
           "fx": intr.fx, "fy": intr.fy, "cx": intr.cx, "cy": intr.cy,
           "z_near": intr.z_near, "z_far": intr.z_far, "mesh": mesh,
           "translation": list(RENDER_DEPTH_T), "save": True,
           "output_path": out, "mask": True}
    cfg_path = os.path.join(root, "render_depth.json")
    with open(cfg_path, "w") as fp:
        json.dump(cfg, fp)
    _, _, secs = quiet_main(render_depth.main, [cfg_path, *device_args])

    V, F = load_mesh(mesh)
    pose = torch.eye(3, 4, dtype=torch.float32, device=dev)
    pose[:, 3] = torch.tensor(RENDER_DEPTH_T, dtype=torch.float32)
    ref = rasterize_depth_chunked_plain(
        torch.as_tensor(V, device=dev), torch.as_tensor(F, device=dev),
        pose[None], intr)[0]
    got = torch.as_tensor(load_mat(os.path.join(out, "depthmap.bin")),
                          device=dev)
    check(bool((got[~torch.isfinite(ref)] == intr.z_far).all()),
          "render_depth: background is not z_far")
    compare_depth(torch.where(got == intr.z_far,
                              torch.full_like(got, float("inf")), got), ref,
                  f"tools: (a) render_depth, {len(F)} faces at "
                  f"{intr.rows}x{intr.cols}")
    plain_mask = os.path.join(root, "plain_mask.bin")
    save_mat(plain_mask, (np.isfinite(ref.cpu().numpy()) * 255)
             .astype(np.float32))
    with open(os.path.join(out, "mask.bin"), "rb") as a, \
            open(plain_mask, "rb") as b:
        check(a.read() == b.read(), "render_depth: mask.bin is not the "
              "plain render's coverage")
    return secs


def tool_run_semantic_synthetic(root, device_args=(), graph=None):
    """(b) run_semantic --synthetic with tests/test_cli.py:72-90's flags
    and gates: one track, the retrieved model `lchair`, position error
    under 0.15 m, one packet a frame. graph: the mapper's (False: the
    eager in-process twin). Returns (the tool's mapper, its record,
    seconds)."""
    from visma_tpu_torch.cli import run_semantic

    out = os.path.join(root, f"synthetic_result_{graph}.json")
    mapper, rec, secs = quiet_main(
        lambda argv: run_semantic.main(argv, graph=graph), [
        "--synthetic", str(SYN_FRAMES), "--output", out,
        "--cem-iters", str(SYN_ITERS), "--cem-samples", str(SYN_SAMPLES),
        *device_args])
    check(rec["tracks"] == 1 and rec["model"] == "lchair"
          and rec["pos_err_m"] < TOOL_POS_GATE_M,
          f"run_semantic --synthetic: {rec}")
    with open(out) as fp:
        packets = json.load(fp)
    check(len(packets) == SYN_FRAMES
          and all(len(p) == 1 for p in packets),
          "run_semantic --synthetic: not one packet a frame")
    return mapper, rec, secs


def synthetic_kernel_checks(mapper):
    """(b)'s kernels against their plain versions at the shapes the tool
    gives them: its camera, full frames, no occluder. The evidence is the
    retrieved mesh's edge render at the track's final pose from frame 0's
    camera (the identity), made as the tool makes its ground truth (K3,
    then depth_edge); the hypotheses are one CEM iteration's, the tool's
    cem_samples draws of its first sigma about that pose, the mean first;
    the score takes them as the CEM does (tau, the coverage radius, the
    evidence's mass). Tolerances those of the semantic phase."""
    import torch

    from visma_tpu_torch.geom.lie import SE3
    from visma_tpu_torch.image.edges import depth_edge, depth_edge_plain
    from visma_tpu_torch.render import raster as rs
    from visma_tpu_torch.render.likelihood import (edge_distance_transform,
                                                   edge_score,
                                                   edge_score_plain)
    from visma_tpu_torch.semantic.cem import CEM_TAU, _sigma6

    mr, intr, dev = mapper.mrenderer, mapper.intr, mapper.device
    tr = next(iter(mapper.tracks.values()))
    pose = torch.as_tensor(tr.pose_wm[:3, :4], dtype=torch.float32,
                           device=dev)
    mi = torch.tensor([mr.index(tr.model_name)], device=dev)
    shape = f"{intr.rows}x{intr.cols}"
    d = rs.rasterize_depth_chunked_multi(mr.Cs, pose[None], mi, intr)
    compare_depth(d, rs.rasterize_depth_chunked_multi_plain(
        mr.Cs, pose[None], mi, intr), f"tools: (b) K3, the evidence {shape}")
    obs = depth_edge(d)[0]
    e_err = float((obs - depth_edge_plain(d)[0]).abs().max())
    log(f"tools: (b) depth_edge {shape}: max |kernel - plain| = "
        f"{e_err:.3e} (tol {EDGE_TOL:.0e})")
    check(e_err <= EDGE_TOL, f"(b) depth_edge disagrees: {e_err}")

    S = mapper.cem_samples
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    xi = torch.randn((1, S, 6), generator=gen, device=dev) \
        * torch.as_tensor(_sigma6(mapper.init_sigma, 1), dtype=torch.float32,
                          device=dev)[:, None]
    xi[:, 0] = 0.0
    hyp = (SE3(pose[None, None, :, :3], pose[None, None, :, 3])
           @ SE3.exp(xi)).matrix3x4().reshape(S, 3, 4)
    h = rs.rasterize_depth_chunked_multi(mr.Cs, hyp, mi.repeat(S), intr)
    compare_depth(h, rs.rasterize_depth_chunked_multi_plain(
        mr.Cs, hyp, mi.repeat(S), intr),
        f"tools: (b) K3, one CEM iteration's {S} hypotheses {shape}")
    dt = edge_distance_transform(obs, iters=int(CEM_TAU) + 6)
    args = (h.reshape(1, S, intr.rows, intr.cols), None, dt, obs)
    kw = dict(tau=CEM_TAU, radius=mapper.coverage_radius,
              obs_mass=torch.sum(obs))
    got, ref = edge_score(*args, **kw), edge_score_plain(*args, **kw)
    err = float((got - ref).abs().max())
    log(f"tools: (b) edge_score (1, {S}, {shape}), full frames, no "
        f"occluder: max |kernel - plain| = {err:.3e} (tol {SCORE_TOL:.0e}), "
        f"scores {float(ref.min()):.4f}..{float(ref.max()):.4f}")
    check(err <= SCORE_TOL, f"(b) edge_score disagrees: {err}")
    check(bool(torch.isfinite(got).all()) and float(ref.std()) > 0,
          "(b) edge_score: degenerate scores")


def write_semantic_sequence(root, dev, intr, n_frames, m, fps=30.0):
    """The semantic phase's scene as a VISMA directory: `dataset` (the
    camera, each frame's gwc, and the INSTATE observations of 40 seeded
    landmarks), one .edge file a frame holding the card's ground-truth edge
    render (K3 a pose, one depth_edge), frame 0's detections as its .bbox
    (the mapper spawns from them, as in the semantic phase), and the chair
    and desk as OBJ under models/. Returns (dataroot, models dir, names,
    T_gt, the edge frames on the card)."""
    import numpy as np

    from visma_tpu_torch.image.edges import depth_edge
    from visma_tpu_torch.io import save_obj
    from visma_tpu_torch.io.procedural import bench_mesh_db
    from visma_tpu_torch.io.synthetic_semantic import (bench_scene,
                                                       gt_detections)
    from visma_tpu_torch.proto import (CameraInfo, Dataset, EdgeMap, Feature,
                                       FeatureStatus, Packet)
    from visma_tpu_torch.render.raster import MultiMeshRenderer

    db = bench_mesh_db()
    names, T_gt, yaw_gt, gwc_at, all_poses = bench_scene(n_frames, m)
    mr = MultiMeshRenderer(intr, device=dev)
    mr.set_meshes(db)
    mesh_idx = np.array([mr.index(nm) for nm in names])
    d = mr.render_depth(all_poses,
                        np.broadcast_to(mesh_idx, (n_frames, m)).copy())
    edges = depth_edge(d.amin(dim=1))
    edges_np = edges.cpu().numpy()

    seq, models = os.path.join(root, "semantic"), os.path.join(root, "models")
    os.makedirs(seq)
    os.makedirs(models)
    for name, (V, F) in db.items():
        save_obj(os.path.join(models, name + ".obj"), V, F)
    rng = np.random.default_rng(8)
    Xw = np.column_stack([rng.uniform(-2.5, 2.5, 40), rng.uniform(-1, 1, 40),
                          rng.uniform(2.0, 4.0, 40)])
    packets = []
    for i in range(n_frames):
        stamp = frame_stamp_us(i, fps)
        with open(os.path.join(seq, f"{stamp:d}.edge"), "wb") as fp:
            fp.write(EdgeMap(rows=intr.rows, cols=intr.cols,
                             data=edges_np[i].ravel()).encode())
        g = gwc_at(i)
        Xc = (Xw - g[:, 3]) @ g[:, :3]
        uv = np.column_stack([intr.fx * Xc[:, 0] / Xc[:, 2] + intr.cx,
                              intr.fy * Xc[:, 1] / Xc[:, 2] + intr.cy])
        feats = [Feature(id=k, status=FeatureStatus.INSTATE, xp=uv[k],
                         xw=Xw[k]) for k in range(len(Xw))
                 if 0 <= uv[k, 0] < intr.cols and 0 <= uv[k, 1] < intr.rows]
        packets.append(Packet(ts=float(stamp), gwc=g.reshape(-1),
                              features=feats, wg=np.zeros(2)))
    aabbs = {n: (np.asarray(V, np.float64).min(0),
                 np.asarray(V, np.float64).max(0)) for n, (V, _) in db.items()}
    with open(os.path.join(seq, f"{frame_stamp_us(0, fps):d}.bbox"),
              "wb") as fp:
        fp.write(gt_detections(aabbs, intr, names, yaw_gt,
                               all_poses[0]).encode())
    cam = CameraInfo(rows=intr.rows, cols=intr.cols,
                     parameters=np.array([intr.fx, intr.fy, intr.cx,
                                          intr.cy]))
    with open(os.path.join(seq, "dataset"), "wb") as fp:
        fp.write(Dataset(description="semantic tools sequence", camera=cam,
                         packets=packets).encode())
    return seq, models, names, T_gt, edges


def semantic_cli_args(seq, models, out, device_args=()):
    """run_semantic on the written sequence with the semantic phase's
    settings (its retrieval_yaws has no flag: the tool keeps the mapper's
    default)."""
    return ["--dataroot", seq, "--models", models, "--output", out,
            "--roi", *map(str, SEM_ROI), "--roi-spawn", "--settled", "3",
            "24", "--async-frames", "16", "--warmup-objects",
            str(SEM_OBJECTS), *device_args]


def tool_run_semantic_dataroot(seq, models, m, device_args=()):
    """(c) run_semantic --dataroot --models on the written sequence: one
    packet a frame, m tracks. Returns (the tool's mapper, seconds)."""
    from visma_tpu_torch.cli import run_semantic
    from visma_tpu_torch.io import VlslamDatasetLoader

    n = len(VlslamDatasetLoader(seq))
    out = os.path.join(seq, "result.json")
    mapper, rec, secs = quiet_main(
        run_semantic.main, semantic_cli_args(seq, models, out, device_args))
    check(rec["frames"] == n and rec["tracks"] == m,
          f"run_semantic --dataroot: {rec}")
    with open(out) as fp:
        packets = json.load(fp)
    check(len(packets) == n and all(len(p) == m for p in packets),
          "run_semantic --dataroot: not one packet of every track a frame")
    return mapper, secs


def semantic_in_process(seq, models, tool, edges, dev):
    """The tool's run again in-process and eagerly (graph=False): a
    SemanticMapper built as the tool builds it from the same command line
    (its parser, its camera and mesh database), warmed up as it is,
    stepped on the loader's poses and
    detections but on the edge frames as the card rendered them (which
    checks that the .edge files round-trip them exactly). Returns (the
    mapper, ms a frame of the steps on the host clock)."""
    import numpy as np
    import torch

    from visma_tpu_torch.cli import run_semantic
    from visma_tpu_torch.io import VlslamDatasetLoader

    loader = VlslamDatasetLoader(seq)
    args = run_semantic.build_parser().parse_args(
        semantic_cli_args(seq, models, os.devnull))
    mapper = run_semantic.mapper_from_args(args, tool.intr, tool.mesh_db,
                                           dev, graph=False)
    mapper.warmup(args.warmup_objects)
    frames = [loader.grab(i, load_image=False) for i in range(len(loader))]
    for i, fr in enumerate(frames):
        check(np.array_equal(fr.edgemap, edges[i].cpu().numpy()),
              f"frame {i}: the .edge file does not hold the render")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    for i, fr in enumerate(frames):
        mapper.step(fr.gwc, edges[i], fr.bboxlist)
    mapper.finalize()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return mapper, (time.time() - t0) / len(frames) * 1e3


def semantic_errors(mapper, T_gt):
    """Translation (m) and rotation (deg) errors of the tracks in spawn
    order against the ground-truth poses."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    order = sorted(mapper.tracks)
    terr = [float(np.linalg.norm(mapper.tracks[o].pose_wm[:3, 3]
                                 - T_gt[k][:3, 3]))
            for k, o in enumerate(order)]
    rerr = [float(np.degrees(Rotation.from_matrix(
        mapper.tracks[o].pose_wm[:3, :3] @ T_gt[k][:3, :3].T).magnitude()))
        for k, o in enumerate(order)]
    return terr, rerr


def tool_visualize(seq, models, root, dev, device_args=()):
    """(d) visualize on the sequence and its result.json: the static figure,
    and --animate's overlay PNG a frame with coloured object pixels; on
    OVERLAY_FRAMES the overlay agrees with one made in-process from the
    plain render and the plain depth_edge on OVERLAY_AGREE of the pixels.
    Where matplotlib is not installed the static figure cannot be drawn:
    the tool then runs with `--output ''`, --animate alone, and the figure
    is reported as not drawn. --animate's overlays equal those of an
    in-process eager twin (`visualize.main(graph=False)`) byte for byte.
    Returns ((the tool's seconds, its eager twin's), the agreements,
    whether the figure was drawn)."""
    import importlib.util

    import cv2
    import numpy as np
    import torch

    from visma_tpu_torch.cli import visualize
    from visma_tpu_torch.image.edges import depth_edge_plain
    from visma_tpu_torch.io import VlslamDatasetLoader, load_json, load_mesh
    from visma_tpu_torch.render import Intrinsics
    from visma_tpu_torch.render.raster import (
        MultiMeshRenderer, rasterize_depth_chunked_multi_plain)

    fig, anim = os.path.join(root, "scene.png"), os.path.join(root, "anim")
    loader = VlslamDatasetLoader(seq)
    n = len(loader)
    figure = importlib.util.find_spec("matplotlib") is not None
    _, _, secs = quiet_main(visualize.main, [
        seq, "--cad-root", models, "--output", fig if figure else "",
        "--animate", anim, *device_args])
    check(not figure or cv2.imread(fig) is not None,
          "visualize: no static figure")
    pngs = sorted(f for f in os.listdir(anim) if f.startswith("overlay_")
                  and f.endswith(".png"))
    check(len(pngs) == n, f"visualize --animate wrote {len(pngs)} of {n}")
    # its eager twin in-process: the renderer's graph=False, every overlay
    # the same bytes
    twin = os.path.join(root, "anim_eager")
    _, _, twin_secs = quiet_main(lambda argv: visualize.main(argv,
                                                             graph=False), [
        seq, "--cad-root", models, "--output", "", "--animate", twin,
        *device_args])
    for f in pngs:
        with open(os.path.join(anim, f), "rb") as a, \
                open(os.path.join(twin, f), "rb") as b:
            check(a.read() == b.read(), f"visualize --animate: {f} differs "
                  "from the eager twin's")

    result = load_json(os.path.join(seq, "result.json"))
    names = sorted({o["model_name"] for pk in result for o in pk})
    mesh_db = {nm: load_mesh(os.path.join(models, nm + ".obj"))
               for nm in names}
    cam = loader.grab_camera_info()
    p = np.asarray(cam.parameters)
    intr = Intrinsics(fx=float(p[0]), fy=float(p[1]), cx=float(p[2]),
                      cy=float(p[3]), rows=cam.rows, cols=cam.cols,
                      z_near=0.05, z_far=10.0)
    mr = MultiMeshRenderer(intr, device=dev)
    mr.set_meshes(mesh_db)
    agree = {}
    for i in OVERLAY_FRAMES:
        poses, midx, colors = visualize.packet_poses(
            result[min(i, len(result) - 1)], loader.pose(i), mr, mesh_db)
        d = rasterize_depth_chunked_multi_plain(
            mr.Cs, torch.as_tensor(np.stack(poses), dtype=torch.float32,
                                   device=dev),
            torch.as_tensor(midx, device=dev), intr)
        want = visualize.overlay_frame(
            np.full((cam.rows, cam.cols, 3), 32, np.uint8),
            depth_edge_plain(d).cpu().numpy(), colors)
        visualize.draw_features(want, loader.dataset.packets[i])
        got = cv2.imread(os.path.join(anim, pngs[i])).astype(int)
        agree[i] = float((got == want).all(axis=2).mean())
        colored = int((np.abs(got[:, :, 2] - got[:, :, 0]) > 40).sum())
        check(agree[i] >= OVERLAY_AGREE,
              f"visualize: frame {i} overlay agrees on {agree[i]:.5f}")
        check(colored > 50, f"visualize: frame {i} has {colored} coloured "
              "object pixels")
    return (secs, twin_secs), agree, figure


def tool_render_graphs(dev, intr, card):
    """(f) render_depth graphed (one CallGraph over the whole render, the
    default on the card) against eager: the semantic scene's 180
    ground-truth poses (45 frames x 4 objects) through MultiMeshRenderer
    in turns graph / eager / graph / eager / graph (the first graphed call
    warms up, the second captures, the third replays), every depth the
    same bytes, K3 180 a call, counted through the replays, one capture;
    then `set_stack` with the meshes scaled by 1.3 drops the graph, and
    the next graphed renders (a warm-up, a capture) are the new stack's
    eager render, not the old one's; the same for Renderer over the first
    object's mesh at its 45 poses (graph / eager / graph / graph, then
    `set_mesh`). Returns the host ms of each call by what it ran:
    eager, a graph's warm-up, its capture (with a replay) or a replay."""
    import numpy as np
    import torch

    from visma_tpu_torch.io.procedural import bench_mesh_db
    from visma_tpu_torch.io.synthetic_semantic import bench_scene
    from visma_tpu_torch.render import raster as rs

    k3 = rs.chunk_raster_frame
    db = bench_mesh_db()
    names, _, _, _, all_poses = bench_scene(SEM_FRAMES, SEM_OBJECTS)
    mr = rs.MultiMeshRenderer(intr, device=dev)
    mr.set_meshes(db)
    mi = np.broadcast_to([mr.index(nm) for nm in names],
                         all_poses.shape[:2]).copy()
    single = rs.Renderer(intr, device=dev)
    single.set_mesh(*db[names[0]])
    ms = {"multi": [], "single": []}

    def render(kind, graph, renderer):
        args = ((all_poses, mi) if kind == "multi"
                else (all_poses[:, 0],))
        n = all_poses.shape[0] * (SEM_OBJECTS if kind == "multi" else 1)
        before = k3.launches
        g = renderer.__dict__.get("_depth_graph")
        replay = g is not None and any(False in e.variants
                                       for e in g._entries.values())
        caps = g.captures if g is not None else 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = renderer.render_depth(*args, graph=graph)
        torch.cuda.synchronize()
        label = ("eager" if not graph else "replay" if replay
                 else "capture" if renderer._depth_graph.captures > caps
                 else "warm-up")
        ms[kind].append((label, round((time.perf_counter() - t0) * 1e3, 3)))
        check(k3.launches - before == n, f"render_depth ({kind}, graph="
              f"{graph}) launched K3 {k3.launches - before} times, not {n}")
        return out

    def turns(kind, renderer, modes):
        outs = [render(kind, g, renderer) for g in modes]
        check(all(torch.equal(o, outs[0]) for o in outs),
              f"render_depth ({kind}): graphed and eager renders differ")
        return outs[0]

    def swapped(V):
        return np.asarray(V, np.float32) * 1.3

    old = turns("multi", mr, (True, False, True, False, True))
    check(mr._depth_graph.captures == 1, "MultiMeshRenderer: "
          f"{mr._depth_graph.captures} captures over five renders")
    Vs, Fs = rs.pad_mesh_stack([(swapped(db[n][0]), db[n][1])
                                for n in mr.names])
    mr.set_stack(Vs, Fs)
    new = turns("multi", mr, (True, True, False))
    check(not torch.equal(new, old) and mr._depth_graph.captures == 1,
          "MultiMeshRenderer: set_stack did not drop the old graph")
    old = turns("single", single, (True, False, True, True))
    check(single._depth_graph.captures == 1,
          f"Renderer: {single._depth_graph.captures} captures")
    single.set_mesh(swapped(db[names[0]][0]), db[names[0]][1])
    new = turns("single", single, (True, True, False))
    check(not torch.equal(new, old) and single._depth_graph.captures == 1,
          "Renderer: set_mesh did not drop the old graph")
    log(f"tools: (f) render_depth of {all_poses.shape[0] * SEM_OBJECTS} "
        f"poses (MultiMeshRenderer) and {all_poses.shape[0]} (Renderer), "
        f"graphed against eager, host ms {ms}; the same bytes, one capture "
        f"each, K3 one a pose through the replays; after set_stack / "
        f"set_mesh the new meshes' renders [{card}]")
    return ms


def tool_native(seq):
    """(e) The native decoder builds here, and on the sequence
    packed_packets through it equals the Python codec's bit for bit.
    Returns the two decodes' seconds."""
    import numpy as np

    from visma_tpu_torch.io import VlslamDatasetLoader, native_loader

    check(native_loader.available(), "the native decoder did not build")
    loader = VlslamDatasetLoader(seq)
    t0 = time.time()
    a = loader.packed_packets()
    t1 = time.time()
    b = loader.packed_packets(native=False)
    t2 = time.time()
    check(a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a),
        "native packed_packets differs from the Python codec's")
    check(int((a["feat_status"] > 0).sum()) > 0, "no features decoded")
    return t1 - t0, t2 - t1


def tools_expected(syn, tool, twin, n_frames, m):
    """Launches each tool part's schedule implies. (a) one K3; (b) and its
    eager twin each: per frame one K3 + one depth_edge of the ground
    truth, one K3 a yaw of the full-frame retrieval (syn.retrieval_yaws:
    one "chair" candidate) and its edge_score, and per frame and CEM
    iteration SYN_SAMPLES K3 (full frame: pose by pose) and one edge_score;
    (c) writing the sequence: one K3 a pose and one depth_edge; the tool
    (graphed) and its in-process twin (eager): warmup's (`warmup_launches`)
    and one batched raster + one edge_score a retrieval, and per CEM
    iteration two batched rasters (occluders, hypotheses) and one
    edge_score; (d) per frame one K3 an object and one depth_edge, for the
    tool and its eager twin; (f) one K3 a pose of each render
    (`RENDER_TURNS`)."""
    def k(frame=0, batched=0, edge=0, score=0):
        return {"chunk_raster_frame": frame, "chunk_raster_batched": batched,
                "depth_edge": edge, "edge_score": score}

    syn_iters = SYN_FRAMES * SYN_ITERS
    sem = expected_semantic_launches(0, m, n_frames, tool)

    def run(mapper):
        warm = warmup_launches(mapper, m)
        return k(batched=sem["chunk_raster_batched"]
                 + warm["chunk_raster_batched"],
                 score=sem["edge_score"] + warm["edge_score"])

    b = k(frame=SYN_FRAMES + syn.retrieval_yaws + syn_iters * SYN_SAMPLES,
          edge=SYN_FRAMES, score=1 + syn_iters)
    return {"a": k(frame=1), "b": b, "b_twin": b,
            "c_write": k(frame=n_frames * m, edge=1),
            "c_tool": run(tool), "c_twin": run(twin),
            "d": k(frame=2 * n_frames * m, edge=2 * n_frames),
            "f": k(frame=RENDER_TURNS["multi"] * n_frames * m
                   + RENDER_TURNS["single"] * n_frames)}


def tools_phase(dev, card, semantic_res):
    """The command-line tools that compute on the card, at the bench
    camera: (a) render_depth, (b) run_semantic --synthetic, (c)
    run_semantic --dataroot --models on the semantic scene written to disk
    (against the same run in-process), (d) visualize with --animate, (e)
    the native decoder. Each part's launches are counted on their own and
    held to its schedule. Returns the phase's launches."""
    import tempfile

    import numpy as np

    from visma_tpu_torch.io.synthetic_semantic import BENCH_INTRINSICS
    from visma_tpu_torch.render.camera import Intrinsics

    intr = Intrinsics(**BENCH_INTRINSICS)
    t_phase = time.time()
    got = {}

    def part(name, fn, *args):
        out, got[name] = launches_of(fn, *args)
        return out

    with tempfile.TemporaryDirectory() as root:
        secs_a = part("a", tool_render_depth, root, dev, intr)
        syn, rec_b, secs_b = part("b", tool_run_semantic_synthetic, root)
        syn_twin, _, secs_b_twin = part("b_twin",
                                        tool_run_semantic_synthetic, root,
                                        (), False)
        check(syn.graphed and not syn_twin.graphed
              and syn.history == syn_twin.history,
              "run_semantic --synthetic differs from its eager twin")
        synthetic_kernel_checks(syn)
        seq, models, names, T_gt, edges = part(
            "c_write", write_semantic_sequence, root, dev, intr, SEM_FRAMES,
            SEM_OBJECTS)
        tool, secs_c = part("c_tool", tool_run_semantic_dataroot, seq,
                            models, SEM_OBJECTS)
        twin, step_ms = part("c_twin", semantic_in_process, seq, models,
                             tool, edges, dev)
        secs_d, agree, figure = part("d", tool_visualize, seq, models,
                                     root, dev)
        render_ms = part("f", tool_render_graphs, dev, intr, card)
        native_s, python_s = tool_native(seq)

    want = tools_expected(syn, tool, twin, SEM_FRAMES, SEM_OBJECTS)
    for name in want:
        check(got[name] == want[name],
              f"tools: ({name}) launches {got[name]} != {want[name]}")
    launches = {k: sum(g[k] for g in got.values()) for k in got["a"]}

    terr, rerr = semantic_errors(tool, T_gt)
    dp = max(float(np.abs(tool.tracks[o].pose_wm[:3, 3]
                          - twin.tracks[o].pose_wm[:3, 3]).max())
             for o in tool.tracks)
    check(tool.graphed and not twin.graphed
          and sorted(tool.tracks) == sorted(twin.tracks)
          and tool.history == twin.history,
          f"run_semantic's packets differ from the eager in-process "
          f"mapper's (poses up to {dp} m)")
    check(max(terr) < TOOL_POS_GATE_M,
          f"run_semantic --dataroot translation errors {terr} m")
    models_got = [tool.tracks[o].model_name for o in sorted(tool.tracks)]
    check(models_got == names,
          f"run_semantic --dataroot retrieved {models_got} != {names}")
    log(f"tools: (a) render_depth {secs_a:.2f} s; (b) run_semantic "
        f"--synthetic {SYN_FRAMES}: {rec_b}, {secs_b:.2f} s (its eager "
        f"twin {secs_b_twin:.2f} s, every packet equal) [{card}]")
    log(f"tools: (c) run_semantic --dataroot, {SEM_FRAMES} frames of the "
        f"{SEM_OBJECTS}-object scene: {secs_c:.2f} s, "
        f"{secs_c / SEM_FRAMES * 1e3:.1f} ms a frame with set-up (load, "
        f"warmup, finalize); the same steps in-process {step_ms:.1f} ms a "
        f"frame; retrieval_yaws {tool.retrieval_yaws} (the semantic phase: "
        f"{semantic_res['retrieval_yaws']}); trans err "
        f"{[round(x, 4) for x in terr]} m, rot err "
        f"{[round(x, 2) for x in rerr]} deg (the semantic phase: "
        f"{[round(x, 4) for x in semantic_res['terr']]} m, "
        f"{[round(x, 2) for x in semantic_res['rerr']]} deg); the tool "
        f"(graphed, {tool.captures} captures) against in-process (eager): "
        f"every packet equal, max |dp| {dp:.2e} m [{card}]")
    log(f"tools: (d) visualize --animate, {SEM_FRAMES} frames: "
        f"{secs_d[0]:.2f} s (its eager twin {secs_d[1]:.2f} s, every overlay "
        f"the same bytes); the static figure "
        + ("drawn" if figure else "NOT MET, not drawn: no matplotlib on "
           "this machine (the CPU tests hold it to the JAX package's)")
        + "; overlay agreement with the plain render "
        f"{agree}; (e) packed_packets native {native_s * 1e3:.1f} ms, "
        f"Python codec {python_s * 1e3:.1f} ms, equal; (f) render_depth "
        f"graphed / eager in turns {render_ms}; launches {launches}; "
        f"phase {time.time() - t_phase:.1f} s [{card}]")
    return launches


def script_counters():
    """The wrappers of every kernel the script twins reach: K1, K2, K3,
    K4, depth_edge and edge_score."""
    from visma_tpu_torch.frontend.detect import corner_score
    from visma_tpu_torch.frontend.klt_fused import lk_track

    return (corner_score, lk_track) + counted_kernels()


def script_noise_sweep(main, out_dir, vio_ate):
    """(a) noise_sweep --headline at the VIO phase's settings (240 frames,
    motion 1, noise 2, two occluders: render_adversarial_frames' defaults,
    levels 4, cell 32): its one point's ATE bit for bit the VIO phase's."""
    _, rec, secs = quiet_main(main, [
        "--headline", "--frames", str(N_FRAMES), "--motions", "1",
        "--noises", "2", "--occluders", "2",
        "--output", os.path.join(out_dir, "noise_sweep.md")])
    (row,) = rec["rows"]
    check(row["healthy"], "noise_sweep: the bench point is not healthy")
    check(row["ate_m"] == vio_ate,
          f"noise_sweep --headline at the bench settings: ATE "
          f"{row['ate_m']!r} m, the VIO phase's {vio_ate!r} m")
    return {"row": row, "seconds": secs}


def script_spawn_sweep(main, out_dir):
    """(b) spawn_sweep over SCRIPT_SPAWN_SCENES scenes (seeds 100+). Gated
    per scene by the retrieval part of bench.py:318-327's envelope (the
    right mesh retrieved for every object, 4 tracks, each on its own
    object) and by the JAX package's own sweep of such scenes: every
    object's errors within SPAWN_SWEEP_MAX, its pooled worst. The pose part
    of bench.py's envelope (every translation error < 0.05 m, mean
    rotation error < 5 deg, worst < 10 deg) is the bench scene's, which
    the semantic phase gates; on random scenes the JAX package's sweep
    misses it too (seeds 103, 104 and 107), so here each scene's errors
    are reported against it, met or not."""
    import numpy as np

    _, rec, secs = quiet_main(main, [
        "--scenes", str(SCRIPT_SPAWN_SCENES),
        "--output", os.path.join(out_dir, "spawn_sweep.md")])
    rows = rec["rows"]
    for r in rows:
        check(r["retrieval_ok"] and r["n_tracks"] == 4
              and r["gt_covered"] == 4,
              f"spawn_sweep seed {r['seed']}: retrieved {r['retrieved']} "
              f"for {r['names']}, {r['n_tracks']} tracks covering "
              f"{r['gt_covered']}")
        check(max(r["trans"]) <= SPAWN_SWEEP_MAX[0]
              and max(r["rot"]) <= SPAWN_SWEEP_MAX[1],
              f"spawn_sweep seed {r['seed']}: trans {r['trans']} m, rot "
              f"{r['rot']} deg, beyond the JAX package's sweep's worst "
              f"{SPAWN_SWEEP_MAX}")
        r["bench_envelope_met"] = bool(
            max(r["trans"]) < 0.05 and np.mean(r["rot"]) < 5.0
            and max(r["rot"]) < 10.0)
    return {"rows": rows, "seconds": secs}


def script_profiles(pf, pc, ps):
    """(c) profile_filter at n = SCRIPT_FILTER_STEPS over
    SCRIPT_FILTER_REPS rounds, a capture of each variant a round: its
    stages' sum within SCRIPT_FILTER_TOL of the full step; (d)
    profile_cem --trace: each setup as long as the host's launches before
    K4 and one before each K4 of the trace, K4 two launches and
    edge_score one a CEM iteration; (e) profile_stages over SCRIPT_STAGE_FRAMES
    frames: every stage timed."""
    out = {}
    _, f, out["filter_s"] = quiet_main(pf.main, [
        "--n", str(SCRIPT_FILTER_STEPS),
        "--reps", str(SCRIPT_FILTER_REPS)])
    gap = abs(f["stages_sum_ms"] - f["full_ms"]) / f["full_ms"]
    check(gap <= SCRIPT_FILTER_TOL,
          f"profile_filter: the stages sum to {f['stages_sum_ms']} ms, the "
          f"full step {f['full_ms']} ms")
    check(all(v["captures"] == SCRIPT_FILTER_REPS for v in f["variants"]),
          "profile_filter: a variant did not capture once a round")
    out["filter"] = f
    iters, samples = SCRIPT_CEM
    _, c, out["cem_s"] = quiet_main(pc.main, [
        "--iters", str(iters), "--samples", str(samples), "--reps", "5",
        "--trace"])
    # profile_cem raises unless each setup is as long as the launches the
    # host queues before K4, every K4 follows a whole setup and the traced
    # dispatches are alike; here: a setup of each shape before each CEM
    # iteration's two K4 launches, no event left out or counted twice
    t = c["trace"]
    ev, n = t["categories_events"], t["dispatches"]
    check(ev["raster"] == 2 * iters * n
          and ev["prep"] == iters * n * sum(t["setup_launches"])
          and sum(ev.values()) == t["events_per_dispatch"] * n,
          f"profile_cem: events by category {ev} over {n} dispatches of "
          f"{t['events_per_dispatch']}, setups {t['setup_launches']}")
    per = c["launches_per_dispatch"]
    check(per["chunk_raster_batched"] == 2 * iters
          and per["edge_score"] == iters,
          f"profile_cem: launches a dispatch {per}, the schedule's K4 "
          f"{2 * iters} and edge_score {iters}")
    out["cem"] = c
    _, st, out["stages_s"] = quiet_main(ps.main, [
        "--frames", str(SCRIPT_STAGE_FRAMES), "--reps", "2"])
    check(all(0 < v < float("inf") for v in st["ms_per_frame"].values()),
          f"profile_stages: {st['ms_per_frame']}")
    out["stages"] = st
    return out


def script_scaling(bs, sm):
    """(g) bench_scaling over SCRIPT_SWEEP ranks (the group-less mesh and
    one nccl rank, then gloo ranks on the card): a GN step's measured
    all-reduce payload, less its cost scalar, equal to
    `comm_floats_per_step` for dense, and for PCG to it plus 30 K floats
    (the (K, 6, 6) block preconditioner the reference's count takes for a
    6K diagonal); (h) scaling_model to its JSON."""
    out = {}
    _, sweep, out["sweep_s"] = quiet_main(bs.main, [
        "--devices", *SCRIPT_SWEEP, "--reps", "2", "--poses",
        str(SCRIPT_POSES)])
    for solver in ("dense", "pcg"):
        extra = 0 if solver == "dense" else 30 * SCRIPT_POSES
        for pt in sweep["solvers"][solver]["points"]:
            m = pt["measured_floats"]
            check(m["all_reduce"] == pt["comm_floats_per_step"] + extra
                  and m["all_gather"] == 0,
                  f"bench_scaling {solver} at {pt['devices']} "
                  f"({pt['mesh']}): measured {m}, analytic "
                  f"{pt['comm_floats_per_step']} + {extra}")
    meshes = {(p["devices"], p["mesh"])
              for p in sweep["solvers"]["dense"]["points"]}
    check(meshes == {(1, "group-less"), (1, "nccl")}
          | {(int(n), "gloo") for n in SCRIPT_SWEEP if n != "1"},
          f"bench_scaling ran on {sorted(meshes)}")
    out["sweep"] = sweep
    _, model, out["model_s"] = quiet_main(sm.main, [
        "--link-latency-s", SCRIPT_LINK[0], "--link-bandwidth-bytes",
        SCRIPT_LINK[1], "--hosts", "2", "4", "8", "--reps", "5"])
    check(set(model["curves"]) == {"dense", "pcg", "submap"},
          f"scaling_model: {sorted(model['curves'])}")
    out["model"] = model
    return out


def scripts_phase(dev, card, vio_ate):
    """The twins of the repo's scripts on the card through their entry
    points (`main`), each at a reduced grid with its gate (see the
    parts); diag_semantic's graphed and eager windows run too. Returns
    the launches of every kernel the phase reached, the counts set to 0
    just before it and read just after."""
    import tempfile

    from visma_tpu_torch import bench_scaling
    from visma_tpu_torch.tools import (diag_semantic, noise_sweep,
                                       profile_cem, profile_filter,
                                       profile_stages, scaling_model,
                                       spawn_sweep)

    t_phase = time.time()
    counters = script_counters()
    for k in counters:
        k.launches = 0
    with tempfile.TemporaryDirectory() as d:
        a = script_noise_sweep(noise_sweep.main, d, vio_ate)
        b = script_spawn_sweep(spawn_sweep.main, d)
    p = script_profiles(profile_filter, profile_cem, profile_stages)
    _, rec, diag_s = quiet_main(diag_semantic.main, SCRIPT_DIAG)
    diag = rec["modes"]
    check([m["mode"] for m in diag] == ["graph", "eager"]
          and all(e["t_m"] < 1.0 for m in diag for e in m["errors"]),
          f"diag_semantic: {diag}")
    g = script_scaling(bench_scaling, scaling_model)
    launches = {k.__name__: k.launches for k in counters}
    for name in ("corner_score", "lk_track", "chunk_raster_frame",
                 "chunk_raster_batched", "depth_edge", "edge_score"):
        check(launches[name] > 0, f"scripts: {name} was never launched")
    f, c = p["filter"], p["cem"]
    log(f"scripts: (a) noise_sweep --headline at the bench settings: ATE "
        f"{a['row']['ate_m'] * 100:.3f} cm (the VIO phase's "
        f"{vio_ate * 100:.3f} cm, bit for bit), churn "
        f"{a['row']['churn_pct']:.1f}%/frame, displacement mean "
        f"{a['row']['disp_mean_px']:.1f} / p99 "
        f"{a['row']['disp_p99_px']:.1f} px, {a['seconds']:.1f} s [{card}]")
    for r in b["rows"]:
        log(f"scripts: (b) spawn_sweep seed {r['seed']}: {r['retrieved']} "
            f"(right), trans {[round(x, 4) for x in r['trans']]} m, rot "
            f"{[round(x, 2) for x in r['rot']]} deg (the JAX package's "
            f"sweep's worst {SPAWN_SWEEP_MAX}); bench.py's pose envelope "
            f"{'met' if r['bench_envelope_met'] else 'NOT MET'}")
    log(f"scripts: (c) profile_filter n={SCRIPT_FILTER_STEPS}, ms a step "
        f"(the median of {SCRIPT_FILTER_REPS} captures; their range) "
        + ", ".join(f"{v['variant']} {v['ms_per_step']:.4f} "
                    f"({min(v['rounds_ms']):.4f}-{max(v['rounds_ms']):.4f})"
                    for v in f["variants"])
        + f"; stages sum {f['stages_sum_ms']:.4f} against the full step "
        f"{f['full_ms']:.4f} [{card}]")
    t = c["trace"]
    log(f"scripts: (d) profile_cem {SCRIPT_CEM[0]}x{SCRIPT_CEM[1]}: best "
        f"{c['dispatch_ms_best']} ms a dispatch; traced "
        f"{t['total_us'] / t['dispatches'] / 1e3:.4f} ms a dispatch: "
        + ", ".join(f"{k} {v / t['dispatches'] / 1e3:.4f}"
                    for k, v in t["categories_us"].items())
        + f"; launches a dispatch {c['launches_per_dispatch']} [{card}]")
    log(f"scripts: (e) profile_stages, ms a frame over "
        f"{SCRIPT_STAGE_FRAMES - 1} frames: "
        + ", ".join(f"{k} {v:.4f}" for k, v in
                    p["stages"]["ms_per_frame"].items()) + f" [{card}]")
    log(f"scripts: (f) diag_semantic: "
        + "; ".join(f"{m['mode']} windows {[round(x, 2) for x in m['window_ms_per_frame']]} ms/frame, "
                    f"|t| {[round(e['t_m'], 4) for e in m['errors']]} m, "
                    f"along-ray {[round(e['along_ray_m'], 4) for e in m['errors']]}"
                    for m in diag) + f", {diag_s:.1f} s [{card}]")
    for solver, entry in g["sweep"]["solvers"].items():
        log(f"scripts: (g) bench_scaling {solver}: "
            + ", ".join(f"{pt['devices']} {pt['mesh']} "
                        f"{pt['step_ms']:.3f} ms (floats reduced "
                        f"{pt['measured_floats']['all_reduce']}, gathered "
                        f"{pt['measured_floats']['all_gather']}; analytic "
                        f"{pt['comm_floats_per_step']})"
                        for pt in entry["points"]) + f" [{card}]")
    log("scripts: (h) scaling_model, assumed link latency "
        f"{SCRIPT_LINK[0]} s, bandwidth {SCRIPT_LINK[1]} B/s: "
        + ", ".join(f"{k} t_compute {v['t_compute_ms']:.4f} ms eff "
                    f"{[round(q['efficiency'], 4) for q in v['points']]}"
                    for k, v in g["model"]["curves"].items()))
    log("scripts: launches " + json.dumps(launches) + f"; phase "
        f"{time.time() - t_phase:.1f} s")
    log("scripts: record " + json.dumps(
        {"noise": a, "spawn": b, "filter": f, "cem": c,
         "stages": p["stages"], "diag": diag, "sweep": g["sweep"],
         "model": g["model"]}, default=str))
    return launches


def eager_dump(tree, out):
    """`--eager-dump TREE OUT`, the worker of `--eager-vs-tree`: the VIO
    scene through the eager `VioPipeline.run` of the port in TREE, with 0
    and SLAM_SLOTS landmark slots; every output saved to OUT (npz) as
    "<slots>/<key>", the ground truth as "gwc"."""
    import inspect
    from dataclasses import replace
    from pathlib import Path

    import numpy as np
    import torch

    sys.path.insert(0, tree)
    import visma_tpu_torch
    from visma_tpu_torch.pipeline import VioPipeline

    check(Path(tree).resolve() in Path(visma_tpu_torch.__file__).resolve()
          .parents, f"imported {visma_tpu_torch.__file__}, not {tree}'s")
    dev = torch.device("cuda", 0)
    cfg, frames, gwc, imu, gyro, accel, dts = vio_scene_inputs()
    # an earlier port's VioPipeline has no `graph` and loops eagerly
    kw = ({"graph": False}
          if "graph" in inspect.signature(VioPipeline).parameters else {})
    seq = [torch.as_tensor(x, device=dev)
           for x in (frames[1:], gyro, accel, dts)]
    arrays = {"gwc": gwc}
    for slots in (0, SLAM_SLOTS):
        pipe = VioPipeline(replace(cfg, num_slam=slots), levels=4, cell=32,
                           device=dev, **kw)
        st0 = pipe.init(torch.as_tensor(frames[0], device=dev),
                        R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])
        _, outs = pipe.run(st0, *seq)
        for k, v in outs.items():
            arrays[f"{slots}/{k}"] = v.cpu().numpy()
    np.savez(out, **arrays)


def eager_vs_tree(other):
    """`--eager-vs-tree OTHER` (see the module)."""
    import tempfile

    import numpy as np

    res = {"this": ROOT, "other": os.path.abspath(other)}
    with tempfile.TemporaryDirectory() as d:
        got = {}
        for name in ("this", "other"):
            path = os.path.join(d, f"{name}.npz")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--eager-dump", res[name], path], check=True,
                           timeout=900)
            with np.load(path) as z:
                got[name] = dict(z)
    a, b = got["this"], got["other"]
    check(a.keys() == b.keys(), f"the trees' outputs differ in keys: "
          f"{sorted(a.keys() ^ b.keys())}")
    gt = a.pop("gwc")[1:, :, 3]
    b.pop("gwc")
    for k in sorted(a):
        x, y = a[k], b[k]
        diff = x != y
        if x.dtype.kind == "f":
            diff &= ~(np.isnan(x) & np.isnan(y))
        rows = np.nonzero(diff.reshape(len(x), -1).any(axis=1))[0]
        res[k] = {"frames_differ": int(len(rows)),
                  "first_frame": int(rows[0]) if len(rows) else None,
                  "max_abs": float(np.abs(x.astype(np.float64)
                                          - y.astype(np.float64)).max())}
        if k.endswith("/p"):
            for name, p in (("this", x), ("other", y)):
                res[k][f"ate_cm_{name}"] = 100 * float(
                    np.sqrt(np.mean(np.sum((p - gt) ** 2, axis=1))))
    log("eager vs tree: " + json.dumps(res))


def main(argv=None):
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--dist-rank"]:
        r, world, addr, out_dir, device = argv[1:]
        dist_rank_main(int(r), int(world), addr, out_dir, device)
        return 0
    if argv[:1] == ["--drill-worker"]:
        workdir, steps, sleep_s, device = argv[1:]
        drill_worker(workdir, int(steps), float(sleep_s), device)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if argv[:1] == ["--eager-dump"]:
        eager_dump(*argv[1:])
        return 0
    if argv[:1] == ["--eager-vs-tree"]:
        log(f"card: {card_line()}")
        eager_vs_tree(argv[1])
        return 0
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
    by_path, vio_ate, vio_scene = vio_phase(dev, kernels, card)
    sem_launches, sem_res = semantic_phase(dev, kernels)
    by_path.update({"semantic": sem_launches,
                    "ingest": ingest_phase(dev, kernels, vio_ate),
                    **slam_phase(dev, vio_scene, vio_ate, card),
                    "ba": ba_phase(dev, vio_scene, card),
                    "pp": dist_phase(dev, vio_scene, card)})
    del vio_scene
    eval_phase(dev, card)
    by_path["tools"] = tools_phase(dev, card, sem_res)
    by_path["scripts"] = scripts_phase(dev, card, vio_ate)

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
