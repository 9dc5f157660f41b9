"""An online caller, closed loop, one caller: undistorted frames of the
recorded sequences go one at a time through `VioPipeline.step` (one
`CallGraph` replay a frame), and the pose is read back to the host before
the next frame is handed over. Each step is timed from handing the frame
over until its pose is on the host. A sequence starts with
`VioPipeline.init` on its first frame.

The frames are undistorted in set-up by the benchmark's own plain remap,
so K6 and `StepGraph` are bypassed. The check, once the window has
closed: every whole pass's trajectory against the ground truth, and for
one pass drawn from the seed the tracker's state after every step and
every step's pose against the plain reference."""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.entries import vio_common as common
from portbench.reference.vio import check as ref


def setup(run):
    run.shapes = common.shapes(run.config)
    seqs = common.raw_sequences(run, run.traffic["sequences"])
    for s in seqs:
        s["images"] = ref.undistort(s.pop("raw"), run.config["camera"]) \
            .to(torch.float32)
    run.seqs = seqs
    run.note("inputs_s")
    run.pipe = common.program_pipeline(run)
    run.passes = []
    _pass(run, 0, steps=4)        # eager, capture, replays
    run.note("warmup_s")
    run.passes.clear()
    run.latencies_ms.clear()


def _pass(run, k: int, steps: int = None, deadline: float = None):
    """Steps through sequence k until `steps` steps or the deadline; keeps
    every step's pose and tracker state. Returns the steps taken."""
    s = run.seqs[k]
    imu = s["imu"]
    n = s["images"].shape[0] - 1 if steps is None else steps
    R0, p0, v0 = common.start_pose(s)
    with run.span("sequence.init"):
        st = run.pipe.init(s["images"][0], R0=R0, p0=p0, v0=v0)
    rec = {"k": k, "init_ids": st.tracker.ids, "init_pos": st.tracker.pos,
           "ids": [], "pos": [], "R": [], "p": []}
    run.passes.append(rec)
    for t in range(n):
        t0 = time.perf_counter()
        with run.span("step"):
            st = run.pipe.step(st, s["images"][t + 1], imu["gyro"][t],
                               imu["accel"][t], imu["dts"][t])
        with run.span("readback"):
            R, p = run.pipe.pose(st)
        run.latencies_ms.append((time.perf_counter() - t0) * 1e3)
        rec["R"].append(R)
        rec["p"].append(p)
        rec["ids"].append(st.tracker.ids)
        rec["pos"].append(st.tracker.pos)
        if deadline is not None and time.perf_counter() >= deadline:
            return t + 1
    return n


def window(run, seconds: float):
    t0 = time.perf_counter()
    end = t0 + seconds
    k = 0
    while time.perf_counter() < end:
        run.frames += _pass(run, k % len(run.seqs), deadline=end)
        k += 1
    run.window_s = time.perf_counter() - t0
    run.attempted = run.frames


def trace_unit(run):
    run.trace_frames = run.seqs[0]["images"].shape[0] - 1

    def unit():
        run.frames += _pass(run, 0)
        run.attempted = run.frames
    return unit


def release(run):
    del run.pipe
    run.failed = sum(int(not np.isfinite(p).all()) for rec in run.passes
                     for p in rec["p"])


def check(run):
    lim = run.traffic["limits"]
    done = [r for r in run.passes if r["p"]]
    worst = max(ref.ate(np.stack(r["p"]),
                        run.seqs[r["k"]]["p"][1:len(r["p"]) + 1])
                for r in done)
    out = [("ate_worst_m", worst, run.config["accuracy"]["ate_m"])]
    rec = done[common.sample(run.seed, len(done))[0]]
    s, n = run.seqs[rec["k"]], len(rec["p"])
    obs_ids, obs_xp = torch.stack(rec["ids"]), torch.stack(rec["pos"])
    g = ref.tracker_gaps(s["images"][:n + 1], rec["init_ids"],
                         rec["init_pos"], obs_ids, obs_xp,
                         common.front(run.config))
    out += [(m, g[m], lim[m]) for m in ("track_id_mismatch", "track_px_gap")]
    frames = {key: v[:n] for key, v in s["imu"].items()}
    frames.update(ids=obs_ids, xp=obs_xp, valid=obs_ids >= 0)
    p, R = ref.filter_run(common.reference_filter_config(run.config),
                          *common.start_pose(s), frames)
    g = ref.pose_gaps(torch.as_tensor(np.stack(rec["p"])),
                      torch.as_tensor(np.stack(rec["R"])), p, R)
    out += [(m, g[m], lim[m]) for m in ("pos_gap_m", "rot_gap_rad")]
    return out


def control(run):
    """The control's readings on a pass over the sequence the check draws
    (see vio_sequence.control)."""
    done = [r for r in run.passes if r["p"]]
    s = run.seqs[done[common.sample(run.seed, len(done))[0]]["k"]]
    return common.control_readings(run, s["images"], s)
