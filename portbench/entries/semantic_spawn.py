"""The semantic mapper over a cluttered room, from an empty map, with the
detector's boxes on every frame, closed loop, one caller: the offline
reprocessing of recorded sequences that `run_semantic --dataroot` does.

Set-up makes the mapper's executors for every object count up to the
configuration's (`SemanticMapper.warmup` over counts), makes the
traffic's sequences from the seed (each its own objects, detection order
and edge evidence), and maps each of them whole once: a spawn miss can
duplicate a track (the dedup no longer sees the object under it), and a
sequence then reaches a track count past the scene's objects, whose
executors are made there and not in the window. The window then maps
the sequences in turn, each from an empty map (`SemanticMapper.reset`):
every frame goes through `SemanticMapper.step` with its box list, so
every frame takes the sync path (the dedup, a retrieval and the spawn
CEM where an object is new, the poses read back).

The check, once the window has closed: frames drawn from the seed, at
least `spawn_frames_checked` of them with a new object, each replayed by
the plain reference from the state the program handed back for the frame
before (its history packet): the dedup, the retrieval of each new
detection (`portbench.reference.semantic.retrieve`) and the CEM of every
track with the draws of the mapper's generator (seeded with the frame's
least track age). Errors against the ground truth, and the mapper's CEM
windows a frame over the window, go to the result's notes."""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.entries.semantic_settled import _G, _intr
from portbench.reference.semantic import cem as ref_cem
from portbench.reference.semantic import raster as ref_raster
from portbench.reference.semantic import retrieve as ref_retrieve
from portbench.reference.semantic import score as ref_score
from portbench.reference.vio.check import matmul_precision, pose_gaps
from portbench.scenes import clutter, semantic as scenes
from portbench.scenes.vio import sub_seed

CLASS = "furniture"                 # a class name that no model has


def setup(run):
    cfg, sc, tf = run.config, run.config["scene"], run.traffic
    if not cfg["mapper"]["roi_spawn"]:
        raise ValueError("sem.spawn's reference renders windows only: "
                         "roi_spawn must be true")
    db = scenes.mesh_db()
    run.mapper = _mapper(run, db)
    run.note("captures_s")
    graphs = getattr(run.mapper, "graphs", dict)().values()
    run.notes["warmup"] = {
        "captures": sum(len(g.capture_ms) for g in graphs),
        "capture_s": sum(sum(g.capture_ms) for g in graphs) / 1e3,
        "pool_bytes": sum(sum(getattr(g, "pool_bytes", ())) for g in graphs)}
    run.db_names = list(db)
    run.aabbs = {n: (V.astype(np.float64).min(0), V.astype(np.float64).max(0))
                 for n, (V, _) in db.items()}
    run.ref_intr = _intr(cfg["camera"], ref_raster.Intrinsics)
    Vs, Fs = ref_raster.pad_mesh_stack([db[n] for n in db])
    run.ref_Cs = torch.as_tensor(ref_raster.face_corner_stack(Vs, Fs),
                                 device=run.device)
    run.gwcs = scenes.strafe(sc["distinct_poses"], sc["strafe_step_m"])
    run.seqs = [_sequence(run, k) for k in range(tf["sequences"])]
    run.note("inputs_s")
    run.mapped = []              # (sequence, its history list), in turn
    run.k, run.t, run.frame = 0, 0, 0
    for k in range(len(run.seqs)):
        _start(run, k)
        while run.t < tf["frames"]:
            _step(run)
    run.first_mapped = len(run.mapped)
    run.frame = 0
    run.note("sequences_s")


def _mapper(run, db):
    """The program's mapper at the configuration's settings, its executors
    made for every count a map of up to the scene's objects reaches."""
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
    mapper.warmup(range(1, len(run.config["scene"]["slots"]) + 1))
    return mapper


def _sequence(run, k: int) -> dict:
    """Sequence k of the run: its objects, the frame of each object's
    first detection, the box list of every frame and the edge evidence of
    every distinct camera pose."""
    from visma_tpu_torch.proto import BoundingBox, BoundingBoxList

    sc, tf = run.config["scene"], run.traffic
    names, T_wm, yaws = clutter.objects(sc["slots"], sub_seed(run.seed, k))
    first = clutter.first_detections(
        len(names), tf["first_detections"], tf["detect_every"],
        sub_seed(run.seed, 100 + k))
    mesh_idx = [run.db_names.index(n) for n in names]

    def box(x0, y0, x1, y1, ap):
        return BoundingBox(top_left_x=x0, top_left_y=y0, bottom_right_x=x1,
                           bottom_right_y=y1,
                           scores=np.array([0.9], np.float32),
                           class_name=CLASS, azimuth_prob=ap)

    lists = clutter.detection_lists(run.aabbs, run.ref_intr, names, yaws,
                                    T_wm, run.gwcs, first, tf["frames"], box)
    return {"names": names, "T_wm": T_wm, "first": first,
            "boxes": [BoundingBoxList(bounding_boxes=b) for b in lists],
            "spawn_frames": sorted(set(first)),
            "edges": scenes.evidence(run.ref_Cs, mesh_idx, T_wm, run.gwcs,
                                     run.ref_intr)}


def _start(run, k: int) -> None:
    """Sequence k from an empty map."""
    with run.span("reset"):
        run.mapper.reset()
    run.k, run.t = k, 0
    run.mapped.append((k, run.mapper.history))


def _step(run) -> None:
    """The next frame of the current sequence, or the next sequence."""
    if run.t == run.traffic["frames"]:
        _start(run, (run.k + 1) % len(run.seqs))
    seq = run.seqs[run.k]
    kp = scenes.path_index(run.t, len(run.gwcs))
    with run.span("step"):
        run.mapper.step(run.gwcs[kp], seq["edges"][kp], seq["boxes"][run.t])
    run.t += 1
    run.frame += 1


def window(run, seconds: float):
    before = _cem_windows(run)
    t0 = time.perf_counter()
    end = t0 + seconds
    while time.perf_counter() < end:
        _step(run)
    run.window_s = time.perf_counter() - t0
    run.frames = run.frame
    run.attempted = run.frames
    run.notes["cem_windows_per_frame"] = \
        (_cem_windows(run) - before) / max(run.frames, 1)


def _cem_windows(run) -> int:
    """The mapper's count of CEM hypothesis windows so far (tracks x
    samples x iterations of every CEM, plus each retrieval's hypotheses):
    640 a frame of a sequence whose every object is spawned once."""
    return run.mapper.counts["cem_windows"]


def trace_unit(run):
    """The first sequence, whole, from an empty map: the same frames on
    every call, so that the traced call replays what the calls before it
    made."""
    frames = run.traffic["frames"]
    run.trace_frames = frames

    def unit():
        _start(run, 0)
        for _ in range(frames):
            _step(run)
        run.attempted += frames
    return unit


def release(run):
    run.tracks_max = max((len(h[-1]) for _, h in run.mapped if h),
                         default=0)
    del run.mapper
    hists = [h for _, h in run.mapped[run.first_mapped:]]
    run.failed = sum(1 for h in hists for packet in h
                     if not all(np.isfinite(o["model_pose"]).all()
                                for o in packet))


# ----------------------------------------------------------------- check

def check(run):
    """[(name, value, limit)]: each drawn frame replayed by the reference
    (see the module), the largest reading over the frames."""
    lim = run.traffic["limits"]
    run.notes["against_truth"] = _against_truth(run)
    run.notes["tracks_max"] = run.tracks_max
    worst = dict.fromkeys(lim, 0.0)
    t0 = time.time()
    for i, t in _frames_checked(run):
        got = replay(run, i, t)
        worst = {k: max(worst[k], got[k]) for k in worst}
    run.notes["check_s"] = time.time() - t0
    return [(k, worst[k], lim[k]) for k in lim]


def _frames_checked(run) -> list:
    """(index into run.mapped, frame) pairs drawn from the seed among the
    window's whole frames, `spawn_frames_checked` of them frames with a
    new object."""
    tf = run.traffic
    spawn, other = [], []
    for i in range(run.first_mapped, len(run.mapped)):
        k, hist = run.mapped[i]
        for t in range(len(hist)):
            (spawn if t in run.seqs[k]["spawn_frames"] else other).append(
                (i, t))
    rng = np.random.default_rng(sub_seed(run.seed, 20_000))
    ns = min(tf["spawn_frames_checked"], len(spawn))
    no = min(tf["frames_checked"] - ns, len(other))
    pick = [spawn[j] for j in rng.choice(len(spawn), ns, replace=False)] \
        + [other[j] for j in rng.choice(len(other), no, replace=False)]
    return sorted(pick)


def _packet_tracks(packet) -> list:
    """[(id, model name, (4, 4) model->world pose)] of a history packet."""
    out = []
    for o in packet:
        T = np.eye(4)
        T[:3, :4] = np.asarray(o["model_pose"], np.float64).reshape(3, 4)
        out.append((o["id"], o["model_name"], T))
    return out


def replay(run, i: int, t: int, precision: str = "float32"):
    """The reference's frame t of run.mapped[i] from the program's packet
    of frame t - 1 (the empty map at frame 0). Returns the compared
    numbers, and under "spawned" and "best" the frame's reference
    retrievals and poses."""
    with matmul_precision(precision):
        return _replay(run, i, t, precision)


def _replay(run, i, t, precision):
    mp = run.config["mapper"]
    k, hist = run.mapped[i]
    seq = run.seqs[k]
    kp = scenes.path_index(t, len(run.gwcs))
    gwc = np.asarray(run.gwcs[kp], np.float64)
    G = _G(gwc)
    G_cw = np.linalg.inv(G)
    edge = seq["edges"][kp]
    born = {}
    for f in range(t + 1):
        for o in hist[f]:
            born.setdefault(o["id"], f)
    prev = _packet_tracks(hist[t - 1]) if t > 0 else []
    tracks = [(name, T, t - born[oid]) for oid, name, T in prev]
    boxes = seq["boxes"][t].bounding_boxes
    dt, spawned = None, []
    for j, bb in enumerate(boxes):
        if ref_retrieve.covered(bb, gwc, [(n, T) for n, T, _ in tracks],
                                run.aabbs, run.ref_intr):
            continue
        if dt is None:
            dt = ref_score.edge_distance_transform(edge)
        r = ref_retrieve.retrieve(bb, edge, dt, run.ref_Cs, run.db_names,
                                  run.aabbs, run.ref_intr, tuple(mp["roi"]),
                                  mp["retrieval_yaws"])
        T_wm = np.eye(4)
        T_wm[:3, :4] = gwc @ r.pose_cm
        tracks.append((r.name, T_wm, 0))
        spawned.append((j, r))
    best = _cem(run, tracks, G_cw, edge, precision)

    now = _packet_tracks(hist[t])
    old = {oid for oid, _, _ in prev}
    new = [(name, T) for oid, name, T in now if oid not in old]
    out = {"spawn_mismatch": float(_spawn_mismatch(run, boxes, new, gwc,
                                                   spawned)),
           "models_wrong": float(sum(a[0] != b[1].name
                                     for a, b in zip(new, spawned))
                                 + abs(len(new) - len(spawned)))}
    m = min(len(now), best.shape[0])
    T_cm = np.stack([G_cw @ T for _, _, T in now[:m]]).reshape(m, 4, 4)
    out.update(pose_gaps(torch.as_tensor(T_cm[:, :3, 3]),
                         torch.as_tensor(T_cm[:, :3, :3]),
                         best[:m, :, 3], best[:m, :, :3]))
    if len(now) != best.shape[0]:
        out["pos_gap_m"] = out["rot_gap_rad"] = float("inf")
    out["spawned"], out["best"] = spawned, best
    return out


def _cem(run, tracks, G_cw, edge, precision="float32"):
    """The reference's CEM of every track (name, model->world, age) as the
    mapper's sync step runs it. Returns the best (n, 3, 4) poses. The
    start poses in the frame's camera are composed on the host in float64,
    as the mapper's; the control composes them on the device, with TF32
    products."""
    mp = run.config["mapper"]
    dev = run.device
    n = len(tracks)
    if n == 0:
        return torch.zeros((0, 3, 4), device=dev)
    ages = [a for _, _, a in tracks]
    settled = mp["settle_age"] >= 0 and min(ages) >= mp["settle_age"]
    iters, samples, sigma = (
        (mp["settled_iters"], mp["settled_samples"], mp["settled_sigma"])
        if settled else (mp["cem_iters"], mp["cem_samples"],
                         mp["cem_sigma"]))
    sigma = tuple(sigma)
    names = [name for name, _, _ in tracks]
    if precision == "control":
        poses_cm = torch.einsum(
            "ij,njk->nik",
            torch.as_tensor(G_cw[:3], dtype=torch.float32, device=dev),
            torch.as_tensor(np.stack([T for _, T, _ in tracks]),
                            dtype=torch.float32, device=dev)
        ).cpu().numpy()
    else:
        poses_cm = np.stack([(G_cw @ T)[:3, :4] for _, T, _ in tracks]
                            ).astype(np.float32)
    occ = n > 1 and ref_cem.footprints_may_overlap(
        run.ref_intr, run.aabbs, poses_cm, names, sigma)
    poses = torch.as_tensor(poses_cm, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(min(ages))
    noise = [torch.randn((n, samples, 6), dtype=torch.float32, device=dev,
                         generator=gen) for _ in range(iters)]
    mi = torch.as_tensor([run.db_names.index(x) for x in names], device=dev)
    best, _ = ref_cem._cem_fused_body(
        run.ref_Cs, mi, poses[:, :, :3].contiguous(),
        poses[:, :, 3].contiguous(),
        torch.as_tensor(ref_cem._sigma6(sigma, n), device=dev), None, edge,
        None, run.ref_intr, ref_cem.CEM_TAU, iters, samples,
        ref_cem.cem_n_elite(samples), roi=tuple(mp["roi"]),
        occ_poses=poses if occ else None, radius=mp["coverage_radius"],
        noise=noise)
    return best


def _spawn_mismatch(run, boxes, new, gwc, spawned) -> int:
    """Detections spawned by one side and not the other: each of the
    program's new tracks is given the box its projected AABB overlaps
    most."""
    intr = run.ref_intr
    G_cw = np.linalg.inv(_G(gwc))
    picked = []
    for name, T in new:
        lo, hi = run.aabbs[name]
        P = G_cw @ T
        pc = ref_cem._aabb_corners(lo, hi) @ P[:3, :3].T + P[:3, 3]
        z = np.maximum(pc[:, 2], 0.1)
        u = intr.fx * pc[:, 0] / z + intr.cx
        v = intr.fy * pc[:, 1] / z + intr.cy
        picked.append(int(np.argmax([_iou((u.min(), v.min(), u.max(),
                                           v.max()), b) for b in boxes])))
    ref = {j for j, _ in spawned}
    return len(set(picked) ^ ref) + len(picked) - len(set(picked))


def _iou(a, bb) -> float:
    b = (bb.top_left_x, bb.top_left_y, bb.bottom_right_x, bb.bottom_right_y)
    ix = max(min(a[2], b[2]) - max(a[0], b[0]), 0.0)
    iy = max(min(a[3], b[3]) - max(a[1], b[1]), 0.0)
    inter = ix * iy
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) \
        - inter
    return inter / max(union, 1e-6)


def _against_truth(run) -> dict:
    """After the window's last whole sequence: each object's error against
    the ground truth (the track nearest it), beside the configuration's
    gates, the models retrieved wrong and the objects without a track."""
    acc = run.config["accuracy"]
    frames = run.traffic["frames"]
    done = [(k, h) for k, h in run.mapped[run.first_mapped:]
            if len(h) == frames] or run.mapped[:1]
    k, hist = done[-1]
    seq = run.seqs[k]
    tracks = _packet_tracks(hist[-1])
    trans, rot, wrong, missed = [], [], 0, 0
    for name, T in zip(seq["names"], seq["T_wm"]):
        if not tracks:
            missed += 1
            continue
        d = [np.linalg.norm(Te[:3, 3] - T[:3, 3]) for _, _, Te in tracks]
        j = int(np.argmin(d))
        _, got, Te = tracks[j]
        trans.append(float(d[j]))
        c = (np.trace(Te[:3, :3].T @ T[:3, :3]) - 1.0) / 2.0
        rot.append(math.degrees(math.acos(min(1.0, max(-1.0, c)))))
        wrong += got != name
    return {"models_wrong": [wrong, 0], "objects_missed": [missed, 0],
            "tracks": [len(tracks), len(seq["names"])],
            "trans_err_worst_m": [max(trans, default=None),
                                  acc["trans_err_m"]],
            "rot_err_mean_deg": [float(np.mean(rot)) if rot else None,
                                 acc["rot_err_mean_deg"]],
            "rot_err_worst_deg": [max(rot, default=None),
                                  acc["rot_err_worst_deg"]]}


def control(run):
    """The control's readings: the replay with TF32 products (the start
    poses' composition among them, see `_cem`) in the program's place,
    judged against the float32 replay."""
    worst = dict.fromkeys(run.traffic["limits"], 0.0)
    for i, t in _frames_checked(run):
        c = replay(run, i, t, precision="control")
        f = replay(run, i, t)
        ref = {j: r for j, r in f["spawned"]}
        got = {"spawn_mismatch": float(len({j for j, _ in c["spawned"]}
                                           ^ set(ref))),
               "models_wrong": float(sum(r.name != ref[j].name
                                         for j, r in c["spawned"]
                                         if j in ref))}
        m = min(c["best"].shape[0], f["best"].shape[0])
        got.update(pose_gaps(c["best"][:m, :, 3], c["best"][:m, :, :3],
                             f["best"][:m, :, 3], f["best"][:m, :, :3]))
        worst = {k: max(worst[k], got[k]) for k in worst}
    return worst
