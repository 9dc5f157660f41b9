"""The VIO bench scene's filter with and without in-state SLAM landmarks,
the port against the JAX package on the same tracker observations.

    python tests/slam_reference_check.py dump obs.npz       # on the card
    JAX_PLATFORMS=cpu python tests/slam_reference_check.py compare obs.npz

`dump` runs chip_smoke.py's VIO scene (240 frames of 500x960, levels 4,
cell 32) through the port's VioPipeline with num_slam 0 and 16 and saves
the tracker's observations (the same in both runs: the tracker does not
read the filter), the IMU batches and both trajectories. `compare` feeds
those observations to the JAX package's Msckf and to the port's on the CPU
and prints each configuration's ATE beside the card's, with the position
error at a few frames. Not collected by pytest: it needs a file the card
wrote.
"""
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SLOTS = (0, 16)
FRAMES_SHOWN = [30, 60, 90, 120, 180, 238]


def dump(path):
    import torch

    from visma_tpu_torch.filter.config import FilterConfig
    from visma_tpu_torch.io.synthetic import SyntheticConfig, make_imu
    from visma_tpu_torch.io.synthetic_images import render_adversarial_frames
    from visma_tpu_torch.pipeline import VioPipeline

    syn = SyntheticConfig(num_frames=240, num_landmarks=240, rows=500,
                          cols=960, fx=486.405, fy=535.401, cx=469.199,
                          cy=257.916, seed=7)
    cfg = FilterConfig(window=8, max_tracks=96, max_updates=24, fx=syn.fx,
                       fy=syn.fy, cx=syn.cx, cy=syn.cy, pixel_noise=1.0)
    frames, gwc, _ = render_adversarial_frames(syn)
    imu = make_imu(syn)
    spf, N = imu["samples_per_frame"], syn.num_frames - 1
    dt = float(np.diff(imu["ts_state"])[0])
    out = dict(gwc=gwc, v0=imu["v0"], fx=syn.fx, fy=syn.fy, cx=syn.cx,
               cy=syn.cy,
               gyro=imu["gyro"][: N * spf].reshape(N, spf, 3)
               .astype(np.float32),
               accel=imu["accel"][: N * spf].reshape(N, spf, 3)
               .astype(np.float32),
               dts=np.full((N, spf), dt, np.float32))
    for ns in SLOTS:
        pipe = VioPipeline(replace(cfg, num_slam=ns), levels=4, cell=32)
        st0 = pipe.init(torch.as_tensor(frames[0], device=pipe.device),
                        R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])
        _, o = pipe.run(st0, frames[1:], out["gyro"], out["accel"],
                        out["dts"])
        out[f"p_{ns}"] = o["p"].cpu().numpy()
        for k in ("obs_ids", "obs_xp", "obs_valid"):
            out[k] = o[k].cpu().numpy()
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({torch.cuda.get_device_name(0)})")


def compare(path):
    import jax.numpy as jnp
    import torch

    from visma_tpu.filter import FilterConfig as JConfig, Msckf as JMsckf
    from visma_tpu_torch.filter.config import FilterConfig
    from visma_tpu_torch.filter.msckf import Msckf

    d = np.load(path)
    gwc = d["gwc"]
    frames = {"gyro": d["gyro"], "accel": d["accel"], "dts": d["dts"],
              "ids": d["obs_ids"], "xp": d["obs_xp"],
              "valid": d["obs_valid"]}
    init = dict(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=d["v0"])

    def errors(p):
        e = np.linalg.norm(p - gwc[1:, :, 3], axis=1)
        return float(np.sqrt(np.mean(e ** 2))), e[FRAMES_SHOWN]

    for ns in SLOTS:
        kw = dict(window=8, max_tracks=96, max_updates=24,
                  fx=float(d["fx"]), fy=float(d["fy"]), cx=float(d["cx"]),
                  cy=float(d["cy"]), pixel_noise=1.0, num_slam=ns)
        jkf = JMsckf(JConfig(**kw))
        _, jo = jkf.run(jkf.init(**init),
                        {k: jnp.asarray(v) for k, v in frames.items()})
        tkf = Msckf(FilterConfig(**kw), device="cpu")
        _, to = tkf.run(tkf.init(**init),
                        {k: torch.as_tensor(v) for k, v in frames.items()})
        for who, p in (("JAX package (CPU)", np.asarray(jo["p"])),
                       ("port (CPU)", to["p"].numpy()),
                       ("port (card)", d[f"p_{ns}"])):
            ate, e = errors(p)
            print(f"num_slam={ns:2d} {who:18s} ATE {ate * 100:.4f} cm; "
                  f"error at frames {FRAMES_SHOWN}: "
                  + " ".join(f"{x * 100:.3f}" for x in e) + " cm")


if __name__ == "__main__":
    {"dump": dump, "compare": compare}[sys.argv[1]](sys.argv[2])
