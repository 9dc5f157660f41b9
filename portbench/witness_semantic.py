"""Witnesses for the semantic cell's accuracy against the ground truth.
Never part of a benchmark run.

    python3 -m portbench.witness_semantic --seeds 2147488659 2147490020 \
        --frames 480 --every 60

For each seed, the scene of `sem.settled` and one mapper, three runs side
by side from the same detections, each frame's objects held to the ground
truth (the worst translation, m, and the worst rotation, deg):

* `graphed`: the program as the cell runs it (its CUDA graphs);
* `eager`: the program's eager path (`graph=False`), a second path of the
  program through the same spawn;
* `reference`: the plain reference's CEM (portbench/reference/semantic),
  started from the poses the graphed program handed back for its spawn
  frame and from then on fed its own poses, frame after frame, with the
  mapper's schedule (the spawn CEM until the objects are settled, then
  the settled one) and its draws.

Prints one JSON line a seed: each run's errors at frame 0 (the spawn) and
every `--every` frames after it."""
from __future__ import annotations

import argparse
import importlib
import json
import math

import numpy as np
import torch

from portbench import harness
from portbench.scenes import semantic as scenes


def _errors(run, poses_wm) -> list:
    """[worst translation m, worst rotation deg] of (n, 4, 4) world poses."""
    trans, rot = [], []
    for T_est, T in zip(poses_wm, run.T_wm):
        trans.append(float(np.linalg.norm(T_est[:3, 3] - T[:3, 3])))
        c = (np.trace(T_est[:3, :3].T @ T[:3, :3]) - 1.0) / 2.0
        rot.append(math.degrees(math.acos(min(1.0, max(-1.0, c)))))
    return [max(trans), max(rot)]


def _world(entry, run, t: int, poses_cm) -> np.ndarray:
    G = entry._G(run.gwcs[scenes.path_index(t, len(run.gwcs))])
    P = np.asarray(poses_cm, np.float64)
    bottom = np.tile([[[0.0, 0.0, 0.0, 1.0]]], (P.shape[0], 1, 1))
    return G[None] @ np.concatenate([P, bottom], axis=1)


def _program_world(entry, run, t: int) -> np.ndarray:
    h = run.mapper.history[t]
    if isinstance(h, tuple):
        return _world(entry, run, t, h[2].cpu().numpy())
    return np.stack([np.vstack([np.asarray(o["model_pose"]).reshape(3, 4),
                                [0.0, 0.0, 0.0, 1.0]]) for o in h])


def program(seed: int, frames: int, every: int, graph: bool,
            device: str = "cuda"):
    """The program's run: (errors at the checkpoints, the run, its mapper's
    spawn-frame poses in the camera of frame 0)."""
    bench = harness.load_bench()
    cell, config, traffic = harness.load_cell(bench, "sem.settled")
    traffic = dict(traffic, graph=graph)
    entry = importlib.import_module("portbench.entries.semantic_settled")
    run = harness.Run(bench, cell, config, traffic, seed, 0.0, False,
                      torch.device(device))
    entry.setup(run)
    while run.frame <= frames:
        entry._step(run)
    out = {t: _errors(run, _program_world(entry, run, t))
           for t in range(0, frames + 1, every)}
    spawn = np.linalg.inv(entry._G(run.gwcs[0])) \
        @ _program_world(entry, run, 0)
    return out, run, spawn[:, :3, :4]


def reference(run, spawn_cm, frames: int, every: int) -> dict:
    """The reference chained on its own poses from the spawn frame's."""
    entry = importlib.import_module("portbench.entries.semantic_settled")
    mp = run.config["mapper"]
    poses = torch.as_tensor(spawn_cm, dtype=torch.float32, device=run.device)
    out = {0: _errors(run, _world(entry, run, 0, spawn_cm))}
    age = 1                       # the spawn frame's CEM aged the objects
    for t in range(1, frames + 1):
        if age < mp["settle_age"]:
            # the sync step: the spawn schedule, seeded with the least age
            poses = entry.cem_frame(run, poses, t, mp["cem_iters"],
                                    mp["cem_samples"], mp["cem_sigma"], age)
        else:
            poses = entry.cem_frame(run, poses, t, mp["settled_iters"],
                                    mp["settled_samples"],
                                    mp["settled_sigma"], t)
        age += 1
        if t % every == 0:
            out[t] = _errors(run, _world(entry, run, t,
                                         poses.cpu().numpy()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=480)
    ap.add_argument("--every", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        graphed, run, spawn = program(seed, args.frames, args.every, True,
                                      args.device)
        eager, _, _ = program(seed, args.frames, args.every, False,
                              args.device)
        ref = reference(run, spawn, args.frames, args.every)
        print(json.dumps({"seed": seed, "gates": run.config["accuracy"],
                          "graphed": graphed, "eager": eager,
                          "reference": ref}), flush=True)
        del run
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
