"""What the VIO entries share: the configuration's camera and filter, the
scenes they make, and the program's pipeline built from the
configuration."""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.vio import check as ref
from portbench.reference.vio.undistort import corvis_table
from portbench.scenes import vio as scenes


def shapes(config: dict) -> dict:
    """The sizes the roofline counts read."""
    cam, front = config["camera"], config["frontend"]
    return {"rows": cam["final_rows"], "cols": cam["out_cols"],
            "cell": front["cell"], "levels": front["levels"],
            "max_tracks": config["filter"]["max_tracks"],
            "lk_window": front["lk_window"], "lk_radius": front["lk_radius"],
            "lk_iters": front["lk_iters"]}


def remap_source_pixels(config: dict) -> int:
    """How many pixels of a raw frame the crop's rows of the Corvis table
    reach: the union of the four clamped taps of every valid entry (a
    frozen copy of chip_smoke.py's `remap_source_pixels` at 43be5d3), on
    the benchmark's own table."""
    cam = config["camera"]
    top = cam["crop_top"]
    tab = corvis_table(cam)[1][top:top + cam["final_rows"]]
    H, W = cam["in_rows"], cam["in_cols"]
    sx, sy = tab[..., 0], tab[..., 1]
    ok = sx >= 0
    x0 = np.clip(np.floor(sx[ok]), 0, W - 2).astype(np.int64)
    y0 = np.clip(np.nan_to_num(np.floor(sy[ok]), nan=0.0), 0,
                 H - 2).astype(np.int64)
    hit = np.zeros((H, W), bool)
    for dy in (0, 1):
        for dx in (0, 1):
            hit[y0 + dy, x0 + dx] = True
    return int(hit.sum())


def front(config: dict) -> dict:
    return dict(config["frontend"],
                max_tracks=config["filter"]["max_tracks"])


def raw_sequences(run, count: int):
    """`count` raw Corvis sequences, each from its own seed drawn from the
    run's, with their IMU on the device and the ground truth."""
    cam = run.config["camera"]
    K_out, _ = corvis_table(cam)
    inv = torch.as_tensor(scenes.inverse_atan_table(cam, K_out),
                          device=run.device)
    out = []
    for k in range(count):
        s = scenes.raw_sequence(run.config["scene"], cam, K_out, inv,
                                scenes.sub_seed(run.seed, k),
                                run.config["scene"]["num_frames"])
        s["imu"] = scenes.imu_frames(s, run.device)
        out.append(s)
    return out


def program_pipeline(run):
    """The program's VioPipeline at the configuration's settings."""
    from visma_tpu_torch.filter.config import FilterConfig
    from visma_tpu_torch.pipeline import VioPipeline

    K = ref.cropped_camera(run.config["camera"])
    cfg = ref.filter_config(run.config["filter"], K, cls=FilterConfig)
    fr = run.config["frontend"]
    return VioPipeline(cfg, levels=fr["levels"], cell=fr["cell"],
                       klt_radius=fr["lk_radius"], device=run.device)


def reference_filter_config(config: dict):
    return ref.filter_config(config["filter"],
                             ref.cropped_camera(config["camera"]))


def start_pose(seq: dict):
    """(R0, p0, v0) float32 numpy: the first frame's pose and velocity."""
    return (seq["R"][0].astype(np.float32), seq["p"][0].astype(np.float32),
            seq["v0"].astype(np.float32))


def sample(seed: int, n: int, k: int = 1, salt: int = 7):
    """k distinct indices below n drawn from the run's seed."""
    rng = np.random.default_rng(scenes.sub_seed(seed, 10_000 + salt))
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


def control_readings(run, images, s) -> dict:
    """Tracker and filter readings of `ref.control_run` on sequence s's
    frames, judged by the float32 reference as the program's outputs are."""
    cfg = reference_filter_config(run.config)
    fr = front(run.config)
    start = start_pose(s)
    ids0, pos0, ids, xp, valid, p, R = ref.control_run(images, cfg, fr,
                                                       *start, s["imu"])
    out = ref.tracker_gaps(images, ids0, pos0, ids, xp, fr)
    pr, Rr = ref.filter_run(cfg, *start, dict(s["imu"], ids=ids, xp=xp,
                                               valid=valid))
    out.update(ref.pose_gaps(p, R, pr, Rr))
    out["ate_m"] = ref.ate(p.cpu().numpy(), s["p"][1:])
    return out
