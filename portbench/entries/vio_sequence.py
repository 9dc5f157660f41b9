"""Recorded sequences reprocessed from raw frames, closed loop, one caller:
each sequence goes through the port's whole offline path, K6's
undistortion (`image.remap.bilinear_remap` through the rows the crop keeps
of the program's Corvis table), `VioPipeline.init` and `VioPipeline.run`,
and its trajectory is read back to the host. The sequences are made in
set-up from the run's seed and taken in turn.

The check, once the window has closed: every sequence's trajectory against
the ground truth (the configuration's accuracy), and for one sequence of
the last turn, drawn from the seed, the program's undistorted frames, its
tracker's state after every frame and its trajectory against the plain
reference (`portbench.reference.vio.check`)."""
from __future__ import annotations

import time

import torch

from portbench.entries import vio_common as common
from portbench.reference.vio import check as ref


def setup(run):
    from visma_tpu_torch.image.remap import bilinear_remap
    from visma_tpu_torch.image.undistort import Undistorter, AtanModel

    cam = run.config["camera"]
    run.shapes = dict(common.shapes(run.config),
                      remap_frames=run.config["scene"]["num_frames"],
                      remap_source_pixels=common.remap_source_pixels(
                          run.config))
    run.seqs = common.raw_sequences(run, run.traffic["sequences"])
    run.note("inputs_s")
    model = AtanModel(cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["s"],
                      in_rows=cam["in_rows"], in_cols=cam["in_cols"])
    und = Undistorter(model, mode=cam["mode"], out_rows=cam["out_rows"],
                      out_cols=cam["out_cols"], device=run.device)
    top = cam["crop_top"]
    run.table = und.remap[top:top + cam["final_rows"]]
    run.remap = bilinear_remap
    run.pipe = common.program_pipeline(run)
    run.note("program_s")
    run.records = []
    run.kept = {}
    for _ in range(2):            # the first captures, the second replays
        _sequence(run, 0, keep=False)
    run.note("warmup_s")
    run.records.clear()
    run.frames_per_unit = run.config["scene"]["num_frames"] - 1


def _sequence(run, k: int, keep: bool = True):
    s = run.seqs[k]
    with run.span("undistort"):
        und = run.remap(s["raw"], run.table)
        images = und.to(torch.float32)
    R0, p0, v0 = common.start_pose(s)
    with run.span("sequence.init"):
        st0 = run.pipe.init(images[0], R0=R0, p0=p0, v0=v0)
    with run.span("run"):
        _, outs = run.pipe.run(st0, images[1:], s["imu"]["gyro"],
                               s["imu"]["accel"], s["imu"]["dts"])
    with run.span("readback"):
        p, R = outs["p"].cpu(), outs["R"].cpu()
        healthy = bool(outs["healthy"].all().cpu())
    if keep:
        run.records.append({"k": k, "p": p, "R": R, "healthy": healthy})
        run.kept[k] = {"und": und,
                       "init_ids": st0.tracker.ids, "init_pos": st0.tracker.pos,
                       "obs_ids": outs["obs_ids"], "obs_xp": outs["obs_xp"],
                       "p": p, "R": R}


def window(run, seconds: float):
    t0 = time.perf_counter()
    end = t0 + seconds
    r = 0
    while True:
        _sequence(run, r % len(run.seqs))
        r += 1
        if time.perf_counter() >= end:
            break
    run.window_s = time.perf_counter() - t0
    run.frames = r * run.frames_per_unit
    run.attempted = r


def trace_unit(run):
    run.trace_frames = run.frames_per_unit
    run.attempted = 0

    def unit():
        _sequence(run, 0)
        run.attempted += 1
    return unit


def release(run):
    del run.pipe, run.remap, run.table
    run.failed = sum(not rec["healthy"] for rec in run.records)


def check(run):
    """[(name, value, limit)]: what is compared, each with its limit."""
    lim = run.traffic["limits"]
    cam = run.config["camera"]
    worst = max(ref.ate(rec["p"], run.seqs[rec["k"]]["p"][1:])
                for rec in run.records)
    out = [("ate_worst_m", worst, run.config["accuracy"]["ate_m"])]
    last = sorted(run.kept)
    k = last[common.sample(run.seed, len(last))[0]]
    kept, s = run.kept[k], run.seqs[k]
    und = ref.undistort(s["raw"], cam)
    out.append(("k6_max_diff", float((und.to(torch.int16)
                                      - kept["und"].to(torch.int16)).abs()
                                     .max()), lim["k6_max_diff"]))
    images = und.to(torch.float32)
    del und
    g = ref.tracker_gaps(images, kept["init_ids"], kept["init_pos"],
                         kept["obs_ids"], kept["obs_xp"],
                         common.front(run.config))
    out += [(n, g[n], lim[n]) for n in ("track_id_mismatch", "track_px_gap")]
    cfg = common.reference_filter_config(run.config)
    frames = dict(s["imu"], ids=kept["obs_ids"], xp=kept["obs_xp"],
                  valid=kept["obs_ids"] >= 0)
    p, R = ref.filter_run(cfg, *common.start_pose(s), frames)
    g = ref.pose_gaps(kept["p"], kept["R"], p, R)
    out += [(n, g[n], lim[n]) for n in ("pos_gap_m", "rot_gap_rad")]
    return out


def control(run):
    """The control's readings: the plain reference a precision below in
    the program's place, on the sequence the check draws, judged as the
    program is."""
    k = sorted(run.kept)[common.sample(run.seed, len(run.kept))[0]]
    s = run.seqs[k]
    images = ref.undistort(s["raw"], run.config["camera"]).to(torch.float32)
    return common.control_readings(run, images, s)
