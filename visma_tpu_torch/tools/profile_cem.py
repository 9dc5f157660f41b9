"""Profile of the settled fused-CEM dispatch (port of tools/profile_cem.py):
one CEM call at `iters` x `samples` with ROI windows, replayed from its
captured CUDA graph (`cem.fused_cem_executor`), timed drained and
repeated, best of `reps`; with `--trace`, its device time split into
categories from a torch.profiler trace of three dispatches.

    python -m visma_tpu_torch.tools.profile_cem [--iters 3] [--samples 24]
        [--roi 256 256] [--reps 20] [--trace] [--device cpu]

Categories of the device events, in the order the replay ran them:
  raster  K4's kernel (`chunk_raster_kernel`, vt_chunk_raster_batched)
  score   the fused edge score's two kernels (vt_edge_score)
  prep    the triangle setup before each K4 launch (`triangle_setup`:
          on the card csrc/tri_setup.cu's two launches): the launches
          before K4 that equal the setup's, a render alone at the
          dispatch's shapes captured and replayed, its length held to the
          launches the host queues before K4 in an eager render
          (`setup_launches`)
  other   the rest (the draws' transform, the EDT, the refit, copies)
Every K4 must follow a whole setup and the traced dispatches must be
alike, else the profile raises. Also prints the K4 and edge-score
launches a dispatch, counted through the replays, and on the card
(`setup_ms`) the setup of each of the two renders of an iteration timed
beside the PyTorch chain it replaced and beside K4.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from visma_tpu_torch.tools.common import best_ms, card_line
from visma_tpu_torch.utils.platform import configure_platform

CATEGORIES = ("raster", "score", "prep", "other")


def build_scene(iters: int, samples: int, sigma, roi, device):
    """The reference's 4-object scene on the bench camera (500x960, the
    bench's chair and desk): (run() -> one dispatch, renderer, the
    per-object inputs)."""
    from scipy.spatial.transform import Rotation

    from visma_tpu_torch.image.edges import depth_edge
    from visma_tpu_torch.io.procedural import bench_mesh_db
    from visma_tpu_torch.render import Intrinsics
    from visma_tpu_torch.render.raster import MultiMeshRenderer
    from visma_tpu_torch.semantic.cem import (CEM_TAU, cem_n_elite,
                                              fused_cem_executor)

    intr = Intrinsics(fx=486.405, fy=535.401, cx=469.199, cy=257.916,
                      rows=500, cols=960, z_near=0.05, z_far=8.0)
    mr = MultiMeshRenderer(intr, device=device)
    mr.set_meshes(bench_mesh_db())
    names = ["chair", "desk", "chair", "desk"]
    rng = np.random.default_rng(3)
    slots = [(-1.5, 2.75), (-0.65, 3.1), (0.65, 3.1), (1.5, 2.75)]
    poses = []
    for k in range(4):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("y", rng.uniform(-0.6, 0.6)
                                        ).as_matrix()
        x, z = slots[k]
        T[:3, 3] = [x, rng.uniform(-0.1, 0.1), z]
        poses.append(T[:3, :4])
    poses = torch.as_tensor(np.stack(poses), dtype=torch.float32,
                            device=device)
    mi = torch.as_tensor([mr.index(n) for n in names], dtype=torch.int64,
                         device=device)
    obs = depth_edge(torch.amin(mr.render_depth(poses, mi), dim=0))
    sig = torch.as_tensor(np.tile(np.concatenate(
        [np.full(3, sigma[1]), np.full(3, sigma[0])]), (4, 1)),
        dtype=torch.float32, device=device)
    run = fused_cem_executor(mr, CEM_TAU, iters, samples,
                             cem_n_elite(samples), tuple(roi), "poses")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def dispatch():
        return run(mi, poses[:, :, :3], poses[:, :, 3], sig, obs,
                   occ=poses, generator=gen)

    return dispatch, mr, (mi, poses, sig, obs)


RASTER = "chunk_raster_kernel"      # K4's device kernel (csrc/chunk_raster.cu)
SCORE = "edge_score_"               # edge_score_tiles, edge_score_finish


WARM_CALLS = 16     # calls of fn ahead of a trace's marker kernel


def traced(fn, n: int = 1):
    """(device events, host launch calls) of n calls of fn: the device
    events as (name, us) in the order they ran, the host's calls that
    queued them as names. Traced by `utils.trace.traced`: behind
    WARM_CALLS calls of fn and a marker kernel (the profiler drops a
    trace's first device records once a process has run for a while: 23
    kernels in chip_smoke.py's full run, H100; a render alone, the
    set-up's two launches and K4, makes a handful of records a call), the
    device events held to the host's launches and the replayed graphs'
    nodes."""
    from visma_tpu_torch.utils.trace import LAUNCH_API
    from visma_tpu_torch.utils.trace import traced as trace_of

    t = trace_of(lambda: [fn() for _ in range(n)],
                 warm=lambda: [fn() for _ in range(WARM_CALLS)])
    return ([(name, b - a) for name, a, b in t.ops],
            [name for name, _, _ in t.host_events
             if name.startswith(LAUNCH_API)])


def setup_sequences(mr, mi, poses, roi, samples: int) -> list:
    """The device kernels the triangle setup (`triangle_setup`) launches
    before K4 in the two ROI renders of a CEM iteration: each render alone
    at the dispatch's shapes (the n (n - 1) occluder windows, the n x
    samples hypothesis windows), captured into a CUDA graph as the
    dispatch is, and one replay traced: the name sequences, longest
    first.

    Each is held to the host's count: the same render called eagerly
    queues as many launches before K4 as the replay ran kernels before it,
    and its own trace holds them all; else this raises."""
    from visma_tpu_torch.render.raster import \
        rasterize_depth_chunked_multi_roi
    from visma_tpu_torch.semantic.cem import _roi_origins
    from visma_tpu_torch.utils.graphs import CallGraph

    n = poses.shape[0]
    out = []
    for reps in (n - 1, samples):
        p = poses.repeat_interleave(reps, dim=0)
        m = mi.repeat_interleave(reps)
        org = _roi_origins(p[:, :, 3], mr.intr, roi)

        def eager(a=p, b=m, c=org):
            return rasterize_depth_chunked_multi_roi(mr.Cs, a, b, c,
                                                     mr.intr, roi)

        render = CallGraph(lambda a, b, c: rasterize_depth_chunked_multi_roi(
            mr.Cs, a, b, c, mr.intr, roi))
        render(p, m, org)
        render(p, m, org)                   # the eager call, the capture
        torch.cuda.synchronize()
        # the replay's launches follow the copies of the three inputs in
        names = [name for name, _ in traced(lambda: render(p, m, org))[0]]
        names = names[3:]
        setup = names[:names.index(next(x for x in names if RASTER in x))]
        seq, host = traced(eager)
        k4 = next(i for i, (x, _) in enumerate(seq) if RASTER in x)
        host_before = len(host) - (len(seq) - k4)
        if not len(setup) == k4 == host_before:
            raise RuntimeError(
                f"profile_cem: the setup at {reps} windows an object ran "
                f"{len(setup)} kernels before K4 replayed and {k4} eagerly, "
                f"and the host queued {host_before} launches before K4")
        out.append(setup)
    return sorted(out, key=len, reverse=True)


def setup_times(mr, mi, poses, roi, samples: int) -> dict:
    """Device ms a call, 20 calls captured into one CUDA graph and replayed
    (`time_kernels.graph_ms`), of the two ROI renders of a CEM iteration
    at the dispatch's shapes (the n (n - 1) occluder windows, the n x
    samples hypothesis windows): `triangle_setup`, the PyTorch chain it
    replaced (the corner gather and `_prep_chunks_all`) and K4 on the
    setup's tables."""
    from visma_tpu_torch.render.raster import (
        SUB_ROI, _prep_chunks_all, _roi_intr, chunk_raster_batched,
        triangle_setup)
    from visma_tpu_torch.semantic.cem import _roi_origins
    from visma_tpu_torch.time_kernels import graph_ms

    n = poses.shape[0]
    intr = _roi_intr(mr.intr, roi)
    out = {}
    for name, reps in (("occluders", n - 1), ("hypotheses", samples)):
        p = poses.repeat_interleave(reps, dim=0)
        m = mi.repeat_interleave(reps)
        org = _roi_origins(p[:, :, 3], mr.intr, roi)
        tables = triangle_setup(mr.Cs, m, p, intr, origins=org,
                                sub_px=SUB_ROI)
        out[name] = {
            "windows": p.shape[0],
            "kernel_ms": graph_ms(lambda: triangle_setup(
                mr.Cs, m, p, intr, origins=org, sub_px=SUB_ROI)),
            "chain_ms": graph_ms(lambda: _prep_chunks_all(
                mr.Cs[m], p, intr, origins=org, sub_px=SUB_ROI)),
            "k4_ms": graph_ms(lambda: chunk_raster_batched(*tables, intr))}
    return out


def _same_op(name: str) -> str:
    """A device event's name with a copy named as a copy: a graph replays
    an eager "Memcpy DtoD" as a copy kernel ("memcpy32_post")."""
    return "memcpy" if name.lower().startswith("memcpy") else name


def categorize(seq, setups) -> list:
    """The category of each event of a dispatch's device sequence: K4 is
    raster, the edge score's two kernels score, the launches before each
    K4 that equal one of the setup's sequences (the capture replays them
    in their eager order) prep, the rest other. A K4 that no setup
    precedes raises."""
    cats = ["other"] * len(seq)
    for i, (name, _) in enumerate(seq):
        if RASTER in name:
            cats[i] = "raster"
            for setup in setups:
                n = len(setup)
                if n <= i and [_same_op(m) for m, _ in seq[i - n:i]] \
                        == [_same_op(m) for m in setup]:
                    cats[i - n:i] = ["prep"] * n
                    break
            else:
                raise RuntimeError(
                    f"profile_cem: the launches before K4 "
                    f"{[m for m, _ in seq[max(i - 40, 0):i]]} end in none "
                    f"of the setup's sequences {setups}")
        elif SCORE in name:
            cats[i] = "score"
    return cats


def trace(dispatch, setups, n: int = 3) -> dict:
    """Device time of n dispatches by category, the traced total and the
    top kernels (us). Each dispatch replays one graph, so the trace must
    hold n equal name sequences (the draws outside the graph included);
    else this raises."""
    seq, _ = traced(dispatch, n)
    per = len(seq) // n
    names = [_same_op(name) for name, _ in seq]
    if len(seq) != n * per or any(names[k * per:(k + 1) * per] != names[:per]
                                  for k in range(n)):
        raise RuntimeError(f"profile_cem: {len(seq)} device events over {n} "
                           "dispatches, not n equal sequences")
    cats = dict.fromkeys(CATEGORIES, 0.0)
    events = dict.fromkeys(CATEGORIES, 0)
    ops = {}
    for (name, us), cat in zip(seq, categorize(seq, setups)):
        cats[cat] += us
        events[cat] += 1
        us0, c0 = ops.get(name, (0.0, 0))
        ops[name] = (us0 + us, c0 + 1)
    total = sum(us for _, us in seq)
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:25]
    return {"dispatches": n, "total_us": total, "categories_us": cats,
            "categories_events": events, "events_per_dispatch": per,
            "setup_launches": [len(x) for x in setups],
            "top": [(k, us, c) for k, (us, c) in top]}


def profile_dispatch(iters: int, samples: int, sigma, roi, device,
                     reps: int = 20, traced: bool = False, log=print) -> dict:
    from visma_tpu_torch.image.edges import depth_edge
    from visma_tpu_torch.render.likelihood import edge_score
    from visma_tpu_torch.render.raster import chunk_raster_batched

    dispatch, mr, (mi, poses, sig, obs) = build_scene(
        iters, samples, sigma, roi, device)
    dispatch()                          # eager warm-up
    dispatch()                          # the capture
    # the launches of the timed dispatches, read as differences: a
    # caller's counts run on through this call
    counters = (chunk_raster_batched, edge_score, depth_edge)
    before = [f.launches for f in counters]
    ms = [round(best_ms(dispatch, device, 1), 4) for _ in range(reps)]
    out = {"iters": iters, "samples": samples, "roi": list(roi),
           "dispatch_ms_best": min(ms),
           "dispatch_ms_p50": sorted(ms)[len(ms) // 2], "dispatch_ms": ms,
           "launches_per_dispatch": {f.__name__: (f.launches - b) / reps
                                     for f, b in zip(counters, before)}}
    log(f"dispatch ms: best {out['dispatch_ms_best']} p50 "
        f"{out['dispatch_ms_p50']}; launches a dispatch "
        f"{out['launches_per_dispatch']}")
    if traced and device.type == "cuda":
        t = trace(dispatch, setup_sequences(mr, mi, poses, tuple(roi),
                                            samples))
        out["trace"] = t
        log(f"device op time over {t['dispatches']} dispatches: "
            f"{t['total_us'] / 1e3:.3f} ms")
        for k, v in sorted(t["categories_us"].items(), key=lambda kv: -kv[1]):
            log(f"  {k:8s} {v / t['dispatches'] / 1e3:8.4f} ms/dispatch "
                f"{100 * v / max(t['total_us'], 1e-9):5.1f}%")
    if device.type == "cuda":
        out["setup_ms"] = setup_times(mr, mi, poses, tuple(roi), samples)
        log(f"setup ms a call (graphed): {out['setup_ms']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--samples", type=int, default=24)
    ap.add_argument("--sigma", type=float, nargs=2, default=[0.05, 0.03])
    ap.add_argument("--roi", type=int, nargs=2, default=[256, 256])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = configure_platform(args.device)
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    log(card_line(dev))
    print(json.dumps(profile_dispatch(args.iters, args.samples, args.sigma,
                                      args.roi, dev, args.reps, args.trace,
                                      log=log)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
