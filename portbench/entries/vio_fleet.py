"""Fleet reprocessing of recorded tracks: batches of feature feeds (ids,
pixels and IMU of each stream's frames) through `Msckf.run_batched`, one
frame step vmapped over the batch's streams, in calls of a fixed number of
frames; the poses of each call are read back to the host, and the state
starts afresh for each new batch. The frontend and its kernels (K1, K2,
K6) are bypassed. The batches are made in set-up from the seed and taken
in turn.

The check, once the window has closed: every finished stream's trajectory
against the ground truth, and streams drawn from the seed against the
plain reference's filter run over the same feed."""
from __future__ import annotations

import time

import torch

from portbench.entries import vio_common as common
from portbench.reference.vio import check as ref
from portbench.scenes import vio as scenes


def setup(run):
    from visma_tpu_torch.filter import FilterConfig, Msckf, stack_states

    tr, sc = run.traffic, run.config["scene"]
    K = ref.cropped_camera(run.config["camera"])
    cam = run.config["camera"]
    run.shapes = common.shapes(run.config)
    run.batches = [scenes.feature_feeds(
        sc, K, cam["final_rows"], cam["out_cols"],
        scenes.sub_seed(run.seed, k), tr["streams"], sc["num_frames"],
        run.config["filter"]["max_tracks"], run.device)
        for k in range(tr["batches"])]
    cfg = ref.filter_config(run.config["filter"], K, cls=FilterConfig)
    run.kf = Msckf(cfg, device=run.device)
    run.stack = stack_states
    run.records = []
    run.note("inputs_s")
    _batch(run, 0, calls=2, keep=False)     # a capture, then a replay
    run.note("warmup_s")


def _batch(run, k: int, deadline: float = None, keep: bool = True,
           calls: int = None):
    """Batch k through its calls (the first `calls` of them) until the
    deadline; returns the stream-frames whose poses came back."""
    b = run.batches[k]
    seg = run.traffic["frames_per_call"]
    n = b["frames"]["ids"].shape[1]
    R0, p0, v0 = common.start_pose(b)
    with run.span("batch.init"):
        s0 = run.kf.init(R0=R0, p0=p0, v0=v0)
        cur = run.stack([s0] * run.traffic["streams"])
    rec = {"k": k, "p": [], "R": []}
    done = 0
    for j in range(0, n if calls is None else calls * seg, seg):
        with run.span("run_batched"):
            cur, out = run.kf.run_batched(
                cur, {key: v[:, j:j + seg] for key, v in b["frames"].items()})
        with run.span("readback"):
            rec["p"].append(out["p"].cpu())
            rec["R"].append(out["R"].cpu())
        done += out["p"].shape[0] * out["p"].shape[1]
        if deadline is not None and time.perf_counter() >= deadline:
            break
    if keep:
        run.records.append(rec)
    return done


def window(run, seconds: float):
    t0 = time.perf_counter()
    end = t0 + seconds
    k = 0
    while time.perf_counter() < end:
        run.frames += _batch(run, k % len(run.batches), deadline=end)
        k += 1
    run.window_s = time.perf_counter() - t0
    run.attempted = sum(len(r["p"]) for r in run.records)


def trace_unit(run):
    run.trace_frames = run.traffic["frames_per_call"] * run.traffic["streams"]

    def unit():
        _batch(run, 0, calls=1)
        run.attempted += 1
    return unit


def release(run):
    del run.kf
    run.failed = sum(int(not torch.isfinite(p).all()) for r in run.records
                     for p in r["p"])


def check(run):
    """[(name, value, limit)]: every finished stream's ATE against the
    ground truth, and the streams drawn from the seed, with the stream of
    the worst ATE, against the plain reference's filter over the same
    feed; that stream's reference ATE goes to the notes beside it."""
    lim = run.traffic["limits"]
    done = run.records
    B = run.traffic["streams"]
    worst, at = -1.0, 0
    for j, r in enumerate(done):
        p = torch.cat(r["p"], dim=1).numpy()
        truth = run.batches[r["k"]]["p"][:p.shape[1]]
        for s, ps in enumerate(p):
            a = ref.ate(ps, truth)
            if a > worst:
                worst, at = a, j * B + s
    out = [("ate_worst_m", worst, run.config["accuracy"]["ate_m"])]
    cfg = common.reference_filter_config(run.config)
    gaps = {"pos_gap_m": 0.0, "rot_gap_rad": 0.0}
    drawn = common.sample(run.seed, len(done) * B,
                          run.traffic["streams_checked"])
    for i in sorted(set(drawn) | {at}):
        r = done[i // B]
        b = run.batches[r["k"]]
        n = sum(p.shape[1] for p in r["p"])
        frames = {key: v[i % B, :n] for key, v in b["frames"].items()}
        p, R = ref.filter_run(cfg, *common.start_pose(b), frames)
        g = ref.pose_gaps(torch.cat(r["p"], dim=1)[i % B],
                          torch.cat(r["R"], dim=1)[i % B], p, R)
        gaps = {key: max(gaps[key], g[key]) for key in gaps}
        if i == at:
            run.notes["worst_stream"] = {
                "ate_m": worst, "reference_ate_m": ref.ate(
                    p.cpu().numpy(), b["p"][:n])}
    out += [(key, gaps[key], lim[key]) for key in gaps]
    return out


def control(run):
    """The control's readings: the reference filter with TF32 products
    over the streams the check draws, judged against the reference."""
    cfg = common.reference_filter_config(run.config)
    B = run.traffic["streams"]
    gaps = {"pos_gap_m": 0.0, "rot_gap_rad": 0.0}
    for i in common.sample(run.seed, len(run.records) * B,
                           run.traffic["streams_checked"]):
        r = run.records[i // B]
        b = run.batches[r["k"]]
        n = sum(p.shape[1] for p in r["p"])
        frames = {key: v[i % B, :n] for key, v in b["frames"].items()}
        pc, Rc = ref.filter_run(cfg, *common.start_pose(b), frames,
                                precision="control")
        p, R = ref.filter_run(cfg, *common.start_pose(b), frames)
        g = ref.pose_gaps(pc, Rc, p, R)
        gaps = {key: max(gaps[key], g[key]) for key in gaps}
    return gaps
