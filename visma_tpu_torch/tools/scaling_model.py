"""Weak-scaling prediction: measured per-shard compute x a modelled link
(port of tools/scaling_model.py).

One card cannot measure weak scaling end to end: ranks that share it
measure contention. What can be measured is the per-rank compute of one
distributed-BA GN step at the per-rank shard size (here on the group-less
one-rank mesh, its step replayed from a captured CUDA graph); what is
modelled is only the collective, whose payload is known exactly
(`bench_scaling.comm_floats_per_step`) and whose cost on a ring is the
standard alpha-beta term:

    eff(n) = t_compute / (t_compute + t_allreduce(n))
    t_allreduce(n) = 2 (n-1) alpha + 2 P (n-1) / n / W

with alpha the per-hop latency, W the per-direction link bandwidth and P
the payload bytes (a ring all-reduce: reduce-scatter + all-gather, each
(n-1) hops moving P/n). PCG issues `cg_iters` dependent 6K-float
all-reduces a GN step, so its latency term is multiplied by cg_iters + 2.

The link is not measured here, so its latency and bandwidth are required
arguments: the JSON names the values used as assumptions.

    python -m visma_tpu_torch.tools.scaling_model --link-latency-s 1e-6
        --link-bandwidth-bytes 4.5e10 [--hosts 2 4 8] [--output PATH]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from visma_tpu_torch.bench_scaling import comm_floats_per_step
from visma_tpu_torch.tools.common import best_ms, card_line
from visma_tpu_torch.utils.platform import configure_platform


def allreduce_time(payload_bytes, n, alpha, W, rounds=1):
    """Ring all-reduce: reduce-scatter + all-gather = 2(n-1) hops, each
    moving payload/n. `rounds` = number of dependent all-reduces."""
    if n <= 1:
        return 0.0
    bw = 2.0 * payload_bytes * (n - 1) / n / W
    lat = 2.0 * (n - 1) * alpha
    return rounds * (lat + bw)


def measure_compute(poses, landmarks_per_device, cg_iters, submap_iters,
                    device, reps=10) -> dict:
    """Per-rank GN-step compute (s) of each solver at the per-rank shard
    size, on the group-less one-rank mesh of `device` (its collectives
    are the identity, so this isolates compute): the dense and PCG steps
    replayed from their graphs, the submap's local solve per GN step."""
    from visma_tpu_torch.bench_scaling import build
    from visma_tpu_torch.dist.mesh import Mesh

    dev = device
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = Mesh(group=None, rank=0, size=1, device=dev)
    out = {}
    for solver in ("dense", "pcg", "submap"):
        run, _ = build(solver, mesh, poses, landmarks_per_device, cg_iters,
                       submap_iters)
        run()
        run()                          # the eager warm-up and the capture
        s = best_ms(run, dev, reps) / 1e3
        # submap communicates once a solve of submap_iters GN steps
        out[solver] = s / submap_iters if solver == "submap" else s
    return out


def model(comp: dict, hosts, poses, landmarks_per_device, cg_iters,
          submap_iters, alpha, W) -> dict:
    """Predicted efficiency curves from measured compute."""
    curves = {}
    for solver, t_c in comp.items():
        pts = []
        for n in hosts:
            P = comm_floats_per_step(
                solver, poses * n if solver == "submap" else poses, n,
                cg_iters, landmarks_per_device) * 4
            if solver == "pcg":
                # cg_iters dependent 6K-float all-reduces + 2 setup ones
                t_ar = allreduce_time(6 * poses * 4, n, alpha, W,
                                      rounds=cg_iters + 2)
            elif solver == "submap":
                # one stitch gather a solve, amortised over its GN steps
                t_ar = allreduce_time(P, n, alpha, W) / submap_iters
            else:
                t_ar = allreduce_time(P, n, alpha, W)
            pts.append({"hosts": n, "payload_bytes": int(P),
                        "t_allreduce_us": t_ar * 1e6,
                        "efficiency": t_c / (t_c + t_ar)})
        curves[solver] = {"t_compute_ms": t_c * 1e3, "points": pts}
    return curves


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--link-latency-s", type=float, required=True,
                    help="per-hop latency of the modelled link (s)")
    ap.add_argument("--link-bandwidth-bytes", type=float, required=True,
                    help="per-direction bandwidth of the modelled link "
                         "(bytes/s)")
    ap.add_argument("--poses", type=int, default=16)
    ap.add_argument("--landmarks-per-device", type=int, default=512)
    ap.add_argument("--cg-iters", type=int, default=25)
    ap.add_argument("--submap-iters", type=int, default=4)
    ap.add_argument("--hosts", type=int, nargs="+",
                    default=[2, 4, 8, 16, 32, 64])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = configure_platform(args.device)
    card = card_line(dev)
    print(card, file=sys.stderr)
    comp = measure_compute(args.poses, args.landmarks_per_device,
                           args.cg_iters, args.submap_iters, dev, args.reps)
    result = {
        "model": "eff(n) = t_compute / (t_compute + t_allreduce(n)); "
                 "ring all-reduce 2(n-1) hops",
        "assumptions": {"link_bw_bytes": args.link_bandwidth_bytes,
                        "link_alpha_s": args.link_latency_s},
        "compute_device": card,
        "operating_point": {"poses": args.poses, "landmarks_per_device":
                            args.landmarks_per_device,
                            "cg_iters": args.cg_iters,
                            "submap_iters": args.submap_iters},
        "curves": model(comp, args.hosts, args.poses,
                        args.landmarks_per_device, args.cg_iters,
                        args.submap_iters, args.link_latency_s,
                        args.link_bandwidth_bytes)}
    print(json.dumps(result))
    if args.output:
        with open(args.output, "w") as fp:
            json.dump(result, fp, indent=1)
        print(f"wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
