"""The semantic mapper's settled steady state, closed loop, one caller: the
objects are detected and spawned in set-up (shape retrieval, the spawn
CEM) and settle; the camera then strafes back and forth over a bounded
path, every object stays in view, and each frame's edge evidence goes
through `SemanticMapper.step` with no new detection. The evidence of the
path's distinct poses is made once in set-up. The window ends by reading
the last frame's object poses back to the host, which waits for every
enqueued step.

The check, once the window has closed: frames drawn from the seed
replayed by the plain reference (`portbench.reference.semantic.cem`) from
the poses the program handed back for the frame before, with the same
random draws: the object poses against the program's; the retrieved
models against the scene's. The poses after the last frame against the
ground truth are reported beside it."""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.reference.semantic import cem as ref_cem
from portbench.reference.semantic import raster as ref_raster
from portbench.scenes import semantic as scenes
from portbench.scenes.vio import sub_seed


def _intr(cam: dict, cls):
    return cls(cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["rows"],
               cam["cols"], cam["z_near"], cam["z_far"])


def setup(run):
    from visma_tpu_torch.proto import BoundingBox, BoundingBoxList

    cfg, sc = run.config, run.config["scene"]
    dev = run.device
    db = scenes.mesh_db()
    run.names, run.T_wm, yaws = scenes.objects(sc["objects"],
                                               sub_seed(run.seed, 0))
    run.gwcs = scenes.strafe(sc["distinct_poses"], sc["strafe_step_m"])
    run.ref_intr = _intr(cfg["camera"], ref_raster.Intrinsics)
    Vs, Fs = ref_raster.pad_mesh_stack([db[n] for n in db])
    run.ref_Cs = torch.as_tensor(ref_raster.face_corner_stack(Vs, Fs),
                                 device=dev)
    run.db_names = list(db)
    run.mesh_idx = [run.db_names.index(n) for n in run.names]
    run.edges = scenes.evidence(run.ref_Cs, run.mesh_idx, run.T_wm,
                                run.gwcs, run.ref_intr)
    run.aabbs = {n: (V.astype(np.float64).min(0), V.astype(np.float64).max(0))
                 for n, (V, _) in db.items()}
    run.shapes = _shapes(run)
    run.note("inputs_s")
    poses0 = scenes.model_to_camera(run.T_wm, run.gwcs[0])
    boxes = [BoundingBox(top_left_x=x0, top_left_y=y0, bottom_right_x=x1,
                         bottom_right_y=y1, scores=np.array([0.9], np.float32),
                         class_name="furniture", azimuth_prob=ap)
             for x0, y0, x1, y1, ap in scenes.detections(
                 run.aabbs, run.ref_intr, run.names, yaws, poses0)]
    run.mapper = _mapper(run, db)
    run.note("captures_s")
    run.frame = 0
    _step(run, BoundingBoxList(bounding_boxes=boxes))      # spawn
    for _ in range(sc["warmup_frames"] - 1):
        _step(run)
    _drain(run)
    run.first = run.frame
    run.note("spawn_settle_s")


def _mapper(run, db):
    """The program's mapper at the configuration's settings, its executors
    captured (`warmup`)."""
    from visma_tpu_torch.render.camera import Intrinsics
    from visma_tpu_torch.semantic import SemanticMapper

    mp = run.config["mapper"]
    mapper = SemanticMapper(
        _intr(run.config["camera"], Intrinsics), db,
        cem_iters=mp["cem_iters"], cem_samples=mp["cem_samples"],
        init_sigma=tuple(mp["cem_sigma"]),
        retrieval_yaws=mp["retrieval_yaws"], roi=tuple(mp["roi"]),
        settle_age=mp["settle_age"], settled_iters=mp["settled_iters"],
        settled_samples=mp["settled_samples"],
        settled_sigma=tuple(mp["settled_sigma"]),
        async_frames=mp["async_frames"], roi_spawn=mp["roi_spawn"],
        coverage_radius=mp["coverage_radius"], device=run.device,
        graph=run.traffic.get("graph"))
    mapper.warmup(run.config["scene"]["objects"])
    return mapper


def _shapes(run) -> dict:
    """The sizes the roofline counts read, and the (pixel, triangle) pairs
    a settled window needs: those of each object's triangles' own screen
    bboxes at its ground-truth pose, in its window."""
    mp = run.config["mapper"]
    roi = tuple(mp["roi"])
    n = len(run.names)
    poses = torch.as_tensor(scenes.model_to_camera(run.T_wm, run.gwcs[0]),
                            device=run.device)
    origins = ref_cem._roi_origins(poses[:, :, 3], run.ref_intr, roi)
    ri = ref_raster.roi_intr(run.ref_intr, roi)
    mi = torch.as_tensor(run.mesh_idx, device=run.device)
    _, _, x0, x1, y0, y1 = ref_raster._planes_batched(
        run.ref_Cs[mi], poses, ri, origins=origins)
    nx = torch.clamp(torch.floor(x1), max=roi[1] - 1) \
        - torch.clamp(torch.ceil(x0), min=0) + 1
    ny = torch.clamp(torch.floor(y1), max=roi[0] - 1) \
        - torch.clamp(torch.ceil(y0), min=0) + 1
    pairs = float((torch.clamp(nx, min=0) * torch.clamp(ny, min=0))
                  .to(torch.float64).sum()) / n
    return {"roi": roi, "sub_px": ref_raster.SUB_ROI,
            "chunk": ref_raster.CHUNK,
            "chunks": math.ceil(run.ref_Cs.shape[1] / ref_raster.CHUNK),
            "objects": n, "samples": mp["settled_samples"],
            "k4_pairs_per_window": pairs}


def _step(run, boxes=None):
    k = scenes.path_index(run.frame, len(run.gwcs))
    with run.span("step"):
        run.mapper.step(run.gwcs[k], run.edges[k], boxes)
    run.frame += 1


def _drain(run):
    """The last frame's object poses on the host: waits for every step."""
    with run.span("drain"):
        last = run.mapper.history[-1]
        run.last = last[2].cpu() if isinstance(last, tuple) else None


def window(run, seconds: float):
    t0 = time.perf_counter()
    end = t0 + seconds
    while time.perf_counter() < end:
        _step(run)
    _drain(run)
    run.window_s = time.perf_counter() - t0
    run.frames = run.frame - run.first
    run.attempted = run.frames


def trace_unit(run):
    frames = run.config["mapper"]["async_frames"]
    run.trace_frames = frames

    def unit():
        for _ in range(frames):
            _step(run)
        _drain(run)
        run.attempted += frames
    return unit


def release(run):
    run.history = run.mapper.history
    run.models = [tr.model_name for tr in run.mapper.tracks.values()]
    del run.mapper
    run.failed = sum(1 for h in run.history[run.first:]
                     if not (isinstance(h, tuple)
                             and bool(torch.isfinite(h[2]).all())))


def _G(gwc) -> np.ndarray:
    G = np.eye(4)
    G[:3, :4] = gwc
    return G


def check(run):
    """[(name, value, limit)]: the retrieved models against the scene's,
    and the replayed frames' object poses against the program's. The
    poses after the last frame against the ground truth go to the result's
    notes: the mapper misses those gates at spawn on some scenes, which
    this cell runs in set-up (PERF.md section 7)."""
    lim = run.traffic["limits"]
    truth = run.notes["against_truth"] = _against_truth(run)
    out = [("models_wrong", float(truth["models_wrong"][0]), 0.0)]
    gaps = {"pos_gap_m": 0.0, "rot_gap_rad": 0.0}
    for t in _frames_checked(run):
        p, R = replay(run, t)
        g = _pose_gaps(run.history[t][2], p, R)
        gaps = {k: max(gaps[k], g[k]) for k in gaps}
    return out + [(k, gaps[k], lim[k]) for k in gaps]


def _against_truth(run) -> dict:
    """The objects' errors after the last frame against the ground truth,
    each beside the configuration's gate, and the models retrieved wrong."""
    acc = run.config["accuracy"]
    G = _G(run.gwcs[scenes.path_index(run.frame - 1, len(run.gwcs))])
    trans, rot = [], []
    for pose, T in zip(run.last.numpy().astype(np.float64), run.T_wm):
        T_est = G @ np.vstack([pose, [0.0, 0.0, 0.0, 1.0]])
        trans.append(float(np.linalg.norm(T_est[:3, 3] - T[:3, 3])))
        c = (np.trace(T_est[:3, :3].T @ T[:3, :3]) - 1.0) / 2.0
        rot.append(math.degrees(math.acos(min(1.0, max(-1.0, c)))))
    wrong = sum(a != b for a, b in zip(run.models, run.names)) \
        + abs(len(run.models) - len(run.names))
    return {"models_wrong": [wrong, 0],
            "trans_err_worst_m": [max(trans), acc["trans_err_m"]],
            "rot_err_mean_deg": [float(np.mean(rot)),
                                 acc["rot_err_mean_deg"]],
            "rot_err_worst_deg": [max(rot), acc["rot_err_worst_deg"]]}


def _frames_checked(run) -> list:
    """Frames of the window drawn from the seed (each after another
    settled frame, so that its start is a state the program handed back)."""
    first = max(run.first, 1)
    cand = [t for t in range(first, len(run.history))
            if isinstance(run.history[t], tuple)
            and isinstance(run.history[t - 1], tuple)]
    rng = np.random.default_rng(sub_seed(run.seed, 20_000))
    k = min(run.traffic["frames_checked"], len(cand))
    return sorted(rng.choice(cand, size=k, replace=False).tolist())


def replay(run, t: int, precision: str = "float32"):
    """The plain reference's frame t: the CEM of every object from the
    poses the program handed back for frame t - 1, moved by the
    camera's motion, with the draws of the mapper's generator for frame t
    (seeded with the frame's number). Returns the best poses as (t (n, 3),
    R (n, 3, 3))."""
    mp = run.config["mapper"]
    best = cem_frame(run, run.history[t - 1][2], t, mp["settled_iters"],
                     mp["settled_samples"], mp["settled_sigma"], t,
                     precision)
    return best[:, :, 3], best[:, :, :3]


def cem_frame(run, start, t: int, iters: int, samples: int, sigma,
              seed: int, precision: str = "float32"):
    """The plain reference's CEM of frame t from `start`, the (n, 3, 4)
    object poses in the camera of frame t - 1, moved by the camera's
    motion, with the draws of a generator seeded with `seed`, as the
    mapper's. Returns the best (n, 3, 4) poses in the camera of frame t."""
    from portbench.reference.vio.check import matmul_precision

    mp = run.config["mapper"]
    dev = run.device
    n = len(run.names)
    sigma = tuple(sigma)
    k_prev = scenes.path_index(t - 1, len(run.gwcs))
    k = scenes.path_index(t, len(run.gwcs))
    G_cw = np.linalg.inv(_G(run.gwcs[k]))
    dG = (G_cw @ _G(run.gwcs[k_prev]))[:3, :4].astype(np.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    noise = [torch.randn((n, samples, 6), dtype=torch.float32, device=dev,
                         generator=gen) for _ in range(iters)]
    with matmul_precision(precision):
        poses = ref_cem._compose_dg(torch.as_tensor(dG, device=dev), start)
        occ = ref_cem.footprints_may_overlap(
            run.ref_intr, run.aabbs, poses.cpu().numpy(), run.names, sigma)
        best, _ = ref_cem._cem_fused_body(
            run.ref_Cs, torch.as_tensor(run.mesh_idx, device=dev),
            poses[:, :, :3].contiguous(), poses[:, :, 3].contiguous(),
            torch.as_tensor(ref_cem._sigma6(sigma, n), device=dev), None,
            run.edges[k], None, run.ref_intr, ref_cem.CEM_TAU, iters,
            samples, ref_cem.cem_n_elite(samples), roi=tuple(mp["roi"]),
            occ_poses=poses if occ else None, radius=mp["coverage_radius"],
            noise=noise)
    return best


def _pose_gaps(prog, p, R) -> dict:
    from portbench.reference.vio.check import pose_gaps
    return pose_gaps(prog[:, :, 3], prog[:, :, :3], p, R)


def control(run):
    """The control's readings: the replay with TF32 products, in the
    program's place, judged against the float32 replay."""
    gaps = {"pos_gap_m": 0.0, "rot_gap_rad": 0.0}
    for t in _frames_checked(run):
        pc, Rc = replay(run, t, precision="control")
        p, R = replay(run, t)
        prog = torch.cat([Rc, pc[:, :, None]], dim=2)
        g = _pose_gaps(prog, p, R)
        gaps = {k: max(gaps[k], g[k]) for k in gaps}
    return gaps
