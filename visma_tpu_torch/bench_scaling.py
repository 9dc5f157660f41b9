"""Weak-scaling harness of the port's distributed BA (port of
bench_scaling.py).

Measures the distributed BA paths at growing mesh sizes with the problem
growing with them (constant work a rank) and reports weak-scaling
efficiency:

  dense   landmark-sharded Schur reduction, the (6K)^2 reduced system
          all_reduced (dist/sharded_ba.py)
  pcg     matrix-free distributed PCG, O(6K) floats a CG iteration
          (dist/pcg_ba.py)
  submap  keyframe-sharded local solves; the sequence grows with the mesh
          (dist/submap_ba.py)

Beside each point's analytic all-reduce payload (`comm_floats_per_step`,
the reference's count) it reports the payload the mesh measured on one GN
step (`Mesh.counts`, counted through graph replays), less the step's one
cost scalar, which the analytic count leaves out.

    python -m visma_tpu_torch.bench_scaling [--devices 1 2 4 8]
        [--solvers dense pcg submap] [--reps 5] [--output PATH]
        [--device cpu]

On the card, size 1 runs twice in this process, on the group-less
one-rank mesh and on a one-rank nccl group (both capture their steps into
CUDA graphs); sizes above 1 run in that many spawned processes, gloo
ranks on the one card, as the dryrun's multi-rank check runs them. Ranks
that share one card (or the CPU) measure contention for it, not links:
weak-scaling numbers need one card a rank. Prints one JSON line a point
and the sweep; `--output` writes the sweep as one JSON file.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from functools import partial

import torch

SHARED_NOTE = ("ranks share one device: the sweep measures contention "
               "for it and the collectives' host round trips, not links")


def comm_floats_per_step(solver, total_poses, n, cg_iters=25,
                         landmarks_per_device=512, halo=2):
    """Analytic per-GN-step all-reduce payload (floats) each device
    contributes, from the collectives the reference issues (its
    docs/SCALING_MODEL.md has the derivation)."""
    K6 = 6 * total_poses
    if solver == "dense":
        # one all_reduce of the reduced camera system S (6K,6K) + rhs b (6K)
        return K6 * K6 + K6
    if solver == "pcg":
        # b + diag preconditioner once, then one 6K matvec a CG iteration
        return 2 * K6 + cg_iters * K6
    if solver == "submap":
        # zero during the local solves; the stitch gathers chunk poses
        # (6*Kc each) + owned landmark positions once a SOLVE
        Kc = total_poses // max(n, 1) + halo
        return 6 * Kc + 3 * landmarks_per_device
    raise ValueError(solver)


def _mesh_label(mesh) -> str:
    import torch.distributed as dist

    return "group-less" if mesh.group is None \
        else dist.get_backend(mesh.group)


def _shared_device(mesh) -> bool:
    if mesh.size == 1:
        return False
    return mesh.device.type != "cuda" or torch.cuda.device_count() < mesh.size


def _step_fn(solver, mesh, shard, cg_iters):
    """One GN step of `solver` on this rank's shard: a replay of its
    CallGraph where the mesh captures, the eager step elsewhere."""
    from visma_tpu_torch.dist import pcg_ba, sharded_ba
    from visma_tpu_torch.utils.graphs import CallGraph

    step = (partial(sharded_ba._sharded_step, mesh=mesh) if solver == "dense"
            else partial(pcg_ba._pcg_step, mesh=mesh, cg_iters=cg_iters))
    lam = torch.full((), 1e-3, dtype=torch.float32, device=mesh.device)
    if not mesh.graphed(None):
        return lambda: step(shard, lam)

    def call(s, d):
        new, cost = step(s, d)
        return new.R, new.p, new.X, cost

    graph = CallGraph(call, counts=(mesh.counts,))
    return lambda: graph(shard, lam)


def build(solver, mesh, total_poses, total_lm, cg_iters=25,
          submap_iters=4, n_chunks=None, serial=False):
    """(run_once, payload) for `solver` on `mesh`. `serial`: the same
    decomposition as an n_chunks-rank run, solved on this rank alone (the
    reference's n=1 variant), on the group-less one-rank mesh `mesh`.
    payload() counts one GN step's collectives (for submap: one solve's
    stitch) and returns its floats, the cost scalar left out."""
    from visma_tpu_torch.ba.problem import synthetic_ba_problem
    from visma_tpu_torch.dist.sharded_ba import _shard_problem
    from visma_tpu_torch.dist.submap_ba import (_local_solve,
                                                split_into_chunks,
                                                submap_ba_solve)

    prob, _ = synthetic_ba_problem(num_poses=total_poses,
                                   num_landmarks=total_lm, noise_px=0.5,
                                   pose_noise=0.02, device=mesh.device)

    def counted(fn, cost_floats):
        def payload():
            mesh.reset_counts()
            fn()
            c = dict(mesh.counts)
            return {"all_reduce": c["all_reduce_floats"] - cost_floats,
                    "all_gather": c["all_gather_floats"], "collectives":
                    {"all_reduce": c["all_reduce"],
                     "all_gather": c["all_gather"]}}
        return payload

    if solver == "submap":
        n_chunks = mesh.size if n_chunks is None else n_chunks
        chunks, _ = split_into_chunks(prob, n_chunks, halo=2)
        fields = ("R", "p", "X", "obs", "mask", "intr")

        def chunk(d):
            return chunks.__class__(*(getattr(chunks, f)[d]
                                      for f in fields))

        if serial:
            parts = [chunk(d) for d in range(n_chunks)]
            return (lambda: [_local_solve(c, submap_iters).p
                             for c in parts]), None
        mine = chunk(mesh.shard_rank())
        return (lambda: _local_solve(mine, submap_iters).p), counted(
            lambda: submap_ba_solve(prob, mesh, iters=submap_iters,
                                    polish_iters=0, halo=2), 0)
    shard, _ = _shard_problem(prob, mesh)
    run = _step_fn(solver, mesh, shard, cg_iters)
    # a GN step all_reduces its cost scalar once
    return run, counted(run, 1)


def time_interleaved(fns, device, reps):
    """Best-of-`reps` ms a call of each closure, the reps interleaved
    across closures so that noise on the shared device hits all alike.
    Each closure is called twice first (the eager warm-up and the
    capture of a graphed step)."""
    from visma_tpu_torch.tools.common import elapsed_ms

    for fn in fns:
        fn()
        fn()
    best = [float("inf")] * len(fns)
    for _ in range(reps):
        for i, fn in enumerate(fns):
            best[i] = min(best[i], elapsed_ms(fn, device))
    return best


def run_sweep(sizes, solvers, poses=16, landmarks_per_device=512, reps=5,
              cg_iters=25, submap_iters=4, verbose=True, device=None,
              log=print):
    """The sweep over meshes of the current process group (every rank of
    it calls this; sizes no larger than the group), or, without a group,
    the group-less one-rank mesh (sizes [1]). Returns rank 0's
    {"solvers": {solver: {"points": [...], "efficiency_weak",
    "efficiency_structural"}}, ...}; other ranks return None."""
    import torch.distributed as dist

    from visma_tpu_torch.dist.mesh import Mesh, make_mesh
    from visma_tpu_torch.utils.misc import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    me = dist.get_rank() if dist.is_initialized() else 0
    out = {"device": str(dev), "reps": reps, "solvers": {}}
    for solver in solvers:
        pts = []
        for n in sizes:
            mesh = make_mesh(n, device=dev)
            if mesh.rank is None:
                continue
            # weak scaling: the problem grows with the mesh (submap also
            # grows the sequence, its axis)
            total_poses = poses * n if solver == "submap" else poses
            total_lm = landmarks_per_device * n
            run, payload = build(solver, mesh, total_poses, total_lm,
                                 cg_iters, submap_iters)
            fns = [run]
            if n > 1 and me == 0:
                alone = Mesh(group=None, rank=0, size=1, device=dev)
                fns.append(build(solver, alone, total_poses, total_lm,
                                 cg_iters, submap_iters, n_chunks=n,
                                 serial=True)[0])
            times = time_interleaved(fns, dev, reps)
            measured = payload()
            if me != 0:
                continue
            pt = {"devices": n, "mesh": _mesh_label(mesh),
                  "poses": total_poses, "landmarks": total_lm,
                  "step_ms": times[0],
                  "comm_floats_per_step": comm_floats_per_step(
                      solver, total_poses, n, cg_iters,
                      landmarks_per_device),
                  "measured_floats": measured}
            if n > 1:
                # the same decomposition solved on one rank against the
                # n-rank mesh, interleaved best-of reps: ~1.0 means
                # distribution adds no structural cost
                pt["serial_ms"] = times[1]
                pt["structural_efficiency"] = times[1] / max(times[0], 1e-9)
            if _shared_device(mesh):
                out["note"] = SHARED_NOTE
            pts.append(pt)
            if verbose:
                log(json.dumps({"solver": solver, **pt}))
        if me != 0:
            continue
        entry = {"points": pts}
        if len(pts) > 1:
            entry["efficiency_weak"] = pts[0]["step_ms"] / max(
                pts[-1]["step_ms"], 1e-9)
            entry["efficiency_structural"] = pts[-1].get(
                "structural_efficiency")
        out["solvers"][solver] = entry
    return out if me == 0 else None


def _merge(sweeps):
    """The sweeps of the separate runs (group-less, nccl, gloo) as one:
    each solver's points in the order run."""
    out = {"runs": [], "solvers": {}}
    for s in sweeps:
        out["runs"].append({k: v for k, v in s.items() if k != "solvers"})
        for name, entry in s["solvers"].items():
            out["solvers"].setdefault(name, {"points": []})
            out["solvers"][name]["points"] += entry["points"]
    for entry in out["solvers"].values():
        pts = entry["points"]
        if len(pts) > 1:
            entry["efficiency_weak"] = pts[0]["step_ms"] / max(
                pts[-1]["step_ms"], 1e-9)
            entry["efficiency_structural"] = pts[-1].get(
                "structural_efficiency")
    return out


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker(rank, world, addr, out_path, kw_json) -> None:
    """One gloo rank of the spawned sweep (the `--worker` entry)."""
    import torch.distributed as dist

    kw = json.loads(kw_json)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                            world_size=world, rank=rank)
    try:
        res = run_sweep(log=lambda s: print(s, file=sys.stderr,
                                            flush=True), **kw)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as fp:
            json.dump(res, fp)


def gloo_sweep(sizes, device, timeout_s=900, **kw) -> dict:
    """run_sweep over max(sizes) spawned gloo ranks, all computing on
    `device` (the ranks of a size larger than a mesh sit it out)."""
    world = max(sizes)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sweep.json")
        addr = f"127.0.0.1:{_free_port()}"
        kw_json = json.dumps(dict(kw, sizes=list(sizes), device=str(device)))
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep
                   .join([root] + ([os.environ["PYTHONPATH"]]
                                   if os.environ.get("PYTHONPATH") else [])))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "visma_tpu_torch.bench_scaling",
             "--worker", str(r), str(world), addr, path, kw_json], env=env,
            cwd=root) for r in range(world)]
        try:
            for p in procs:
                p.wait(timeout=timeout_s)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [p.returncode for p in procs if p.returncode]
        if bad:
            raise RuntimeError(f"bench_scaling: gloo ranks exited {bad}")
        with open(path) as fp:
            return json.load(fp)


def nccl_sweep(device, **kw) -> dict:
    """run_sweep on a one-rank nccl group in this process."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        return run_sweep([1], device=device, **kw)
    finally:
        dist.destroy_process_group()


def sweep_all(sizes, solvers, device, **kw) -> dict:
    """Size 1 on the group-less mesh (and on one nccl rank on a card),
    sizes above 1 on spawned gloo ranks."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("bench_scaling.sweep_all makes its own groups: "
                           "call run_sweep inside an existing one")
    runs = []
    if 1 in sizes:
        runs.append(run_sweep([1], solvers, device=device, **kw))
        if device.type == "cuda":
            runs.append(nccl_sweep(device, solvers=solvers, **kw))
    big = [n for n in sizes if n > 1]
    if big:
        kw.pop("log", None)
        runs.append(gloo_sweep(big, device, solvers=solvers, **kw))
    return _merge(runs)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        r, world, addr, out_path, kw_json = argv[1:]
        _worker(int(r), int(world), addr, out_path, kw_json)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="mesh sizes")
    ap.add_argument("--landmarks-per-device", type=int, default=512)
    ap.add_argument("--poses", type=int, default=16,
                    help="keyframes (per device for submap)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--solvers", nargs="+",
                    default=["dense", "pcg", "submap"])
    ap.add_argument("--cg-iters", type=int, default=25)
    ap.add_argument("--output", default=None,
                    help="write the sweep as one JSON file here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    from visma_tpu_torch.utils.platform import configure_platform

    dev = configure_platform(args.device)
    sweep = sweep_all(sorted(args.devices), args.solvers, dev,
                      poses=args.poses,
                      landmarks_per_device=args.landmarks_per_device,
                      reps=args.reps, cg_iters=args.cg_iters)
    print(json.dumps(sweep))
    if args.output:
        with open(args.output, "w") as fp:
            json.dump(sweep, fp, indent=1)
        print(f"wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
