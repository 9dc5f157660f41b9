"""Submap (keyframe-sharded) distributed BA, the sequence-parallel axis
(port of visma_tpu/dist/submap_ba.py).

Complements dist/sharded_ba.py (landmark sharding): here the sequence is
partitioned. Each rank owns a contiguous keyframe chunk (map block) plus a
halo of keyframes shared with its right neighbour. Pipeline:

  1. local solve: rank d runs the damped-GN Schur BA on chunk d, with no
     collective; the chunk solutions are then all_gathered;
  2. stitch (on every rank alike): the relative pose across each shared
     boundary keyframe is measured in both neighbouring chunks; a pose
     graph over the chunk anchors (D nodes) aligns the chunks;
  3. apply: each chunk's poses/landmarks move by its anchor correction;
  4. polish: a few global landmark-sharded iterations.

Chunking trades global optimality for sequence-parallel throughput, the
standard submapping compromise. The bookkeeping and the stitch are host
numpy, as in the reference. The reference jits its local solver, a
`shard_map` + scan cached per mesh (`_jitted_local_solver`,
submap_ba.py:103-143). Here the local solve is `ba_solve`, which replays
its own cached graph a GN step on a CUDA device whatever the mesh's
backend (it makes no collective); the stitch's pose graph replays its
graph too, and the polish follows `Mesh.graphed`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from visma_tpu_torch.ba.gauss_newton import ba_solve
from visma_tpu_torch.ba.problem import BaProblem
from visma_tpu_torch.dist.mesh import Mesh


def split_into_chunks(prob: BaProblem, n_chunks: int, halo: int = 1):
    """Partition poses into n contiguous chunks with `halo` shared frames.

    Landmarks are duplicated into every chunk where they carry >= 2
    observations (each chunk optimizes its own copy, the halo-exchange
    analog); the chunk with most observations "owns" the landmark and
    writes it back at stitch time.

    Returns stacked per-chunk problems (leading axis = chunk) on the
    problem's device + bookkeeping {pose_idx (D,Kc), land_idx (D,Lc),
    land_valid (D,Lc), land_owner (D,Lc) bool}.
    """
    K = prob.num_poses
    L = prob.num_landmarks
    bounds = np.linspace(0, K, n_chunks + 1).astype(int)
    Kc = int(np.max(bounds[1:] - bounds[:-1])) + halo

    mask_np = prob.mask.cpu().numpy()
    votes = np.zeros((L, n_chunks), np.int32)
    for d in range(n_chunks):
        lo, hi = bounds[d], min(bounds[d + 1] + halo, K)
        votes[:, d] = mask_np[:, lo:hi].sum(axis=1)
    present = votes >= 2          # duplicated membership
    owner = votes.argmax(axis=1)  # write-back ownership
    Lc = max(int(present.sum(axis=0).max()), 1)

    pose_idx = np.zeros((n_chunks, Kc), np.int32)
    land_idx = np.zeros((n_chunks, Lc), np.int32)
    land_valid = np.zeros((n_chunks, Lc), bool)
    land_owner = np.zeros((n_chunks, Lc), bool)
    for d in range(n_chunks):
        lo, hi = bounds[d], min(bounds[d + 1] + halo, K)
        idx = np.arange(lo, hi)
        idx = np.pad(idx, (0, Kc - len(idx)), mode="edge")
        pose_idx[d] = idx
        mine = np.nonzero(present[:, d])[0]
        land_idx[d, : len(mine)] = mine
        land_valid[d, : len(mine)] = True
        land_owner[d, : len(mine)] = owner[mine] == d

    R = prob.R.cpu().numpy()[pose_idx]                  # (D,Kc,3,3)
    p = prob.p.cpu().numpy()[pose_idx]
    X = prob.X.cpu().numpy()[land_idx]
    obs = prob.obs.cpu().numpy()[land_idx[:, :, None],
                                 pose_idx[:, None, :]]  # (D,Lc,Kc,2)
    mask = mask_np[land_idx[:, :, None], pose_idx[:, None, :]] \
        & land_valid[:, :, None]
    # padded duplicate pose columns (mode="edge") must not double-count
    for d in range(n_chunks):
        seen = set()
        for c, g in enumerate(pose_idx[d]):
            if g in seen:
                mask[d, :, c] = False
            seen.add(g)

    dev = prob.R.device

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    chunks = BaProblem(
        R=f32(R), p=f32(p), X=f32(X), obs=f32(obs),
        mask=torch.as_tensor(mask, device=dev),
        intr=prob.intr.expand(n_chunks, 4))
    info = {"pose_idx": pose_idx, "land_idx": land_idx,
            "land_valid": land_valid, "land_owner": land_owner,
            "land_votes": votes, "bounds": bounds, "halo": halo}
    return chunks, info


def _local_solve(chunk: BaProblem, iters: int,
                 graph: Optional[bool] = None) -> BaProblem:
    """Damped-GN loop on one chunk (submap_ba.py:66-88): damping 1e-3, the
    scale anchor of the chunk's first and last pose, accept on a lower
    cost. That is `ba_solve`'s loop, step for step."""
    return ba_solve(chunk, iters=iters, graph=graph)[0]


def submap_ba_solve(prob: BaProblem, mesh: Mesh, iters: int = 10,
                    polish_iters: int = 3, halo: int = 1,
                    consensus: bool = True,
                    polish_solver: str = "auto",
                    graph: Optional[bool] = None) -> Tuple[BaProblem, dict]:
    """Keyframe-sharded BA over the mesh. Returns (stitched problem, info).

    polish_iters: after stitching, run a few global landmark-sharded
    iterations (dist/sharded_ba.py): submapping has solved the bulk of the
    nonlinearity chunk-locally in parallel; the polish removes the residual
    cross-chunk coupling the per-chunk gauges can't see.
    polish_solver: "dense" | "pcg" | "auto", forwarded to
    sharded_ba_solve; "auto" switches to the matrix-free PCG path past
    PCG_CROSSOVER_K keyframes.

    halo: shared boundary frames per chunk pair; with halo > 1 the stitch
    edge averages the relative transform over every shared frame (chordal
    rotation mean), damping single-frame estimation noise.

    consensus: landmarks duplicated across chunks are written back as the
    observation-count-weighted average of the corrected per-chunk
    estimates instead of owner-takes-all.

    graph: None replays captured graphs on a CUDA device (the local solve
    and the stitch always, the polish where the mesh captures), False is
    the eager loops; True on a mesh that cannot capture raises
    (`Mesh.graphed`).
    """
    polish_graph = mesh.graphed(graph)
    if prob.R.device != mesh.device:
        raise ValueError(f"the problem is on {prob.R.device}, the mesh's "
                         f"rank computes on {mesh.device}")
    D = mesh.size
    chunks, info = split_into_chunks(prob, D, halo=halo)
    info["consensus"] = consensus

    d = mesh.shard_rank()
    mine = _local_solve(BaProblem(*(getattr(chunks, f)[d] for f in
                                    ("R", "p", "X", "obs", "mask", "intr"))),
                        iters, graph)
    Kc, Lc = chunks.R.shape[1], chunks.X.shape[1]
    # one all_gather of the rank's (R, p, X), flattened
    flat = mesh.all_gather(torch.cat([mine.R.reshape(1, -1),
                                      mine.p.reshape(1, -1),
                                      mine.X.reshape(1, -1)], dim=1))
    R, p, X = flat.split([Kc * 9, Kc * 3, Lc * 3], dim=1)
    sol = chunks.replace(R=R.reshape(D, Kc, 3, 3), p=p.reshape(D, Kc, 3),
                         X=X.reshape(D, Lc, 3))
    stitched = _stitch(prob, sol, info, graph)
    if polish_iters > 0:
        from visma_tpu_torch.dist.sharded_ba import sharded_ba_solve

        stitched, _ = sharded_ba_solve(stitched, mesh, iters=polish_iters,
                                       solver=polish_solver,
                                       graph=polish_graph)
    return stitched, info


def _stitch(prob: BaProblem, sol: BaProblem, info,
            graph: Optional[bool] = None) -> BaProblem:
    """Pose-graph alignment of chunks via shared halo keyframes, then
    write corrected poses/landmarks back into the global problem."""
    from visma_tpu_torch.ba.pose_graph import pose_graph_solve
    from visma_tpu_torch.geom.rotations import project_so3

    dev = prob.R.device
    pose_idx = info["pose_idx"]
    bounds = info["bounds"]
    halo = info["halo"]
    K = prob.num_poses
    D = pose_idx.shape[0]
    R = sol.R.cpu().numpy()      # (D,Kc,3,3)
    p = sol.p.cpu().numpy()

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)

    # chunk-anchor graph: node d = correction T_d applied to chunk d.
    # Boundary keyframes b in [bounds[d+1], bounds[d+1]+halo) appear as
    # the halo (trailing) frames of chunk d and the leading frames of
    # chunk d+1. The edge measures the transform between the two chunk
    # estimates, averaged over all shared frames (chordal mean rotation,
    # arithmetic mean translation).
    ei, ej, Rm, pm = [], [], [], []
    for d in range(D - 1):
        R_acc = np.zeros((3, 3))
        p_acc = np.zeros(3)
        n = 0
        for b in range(bounds[d + 1], min(bounds[d + 1] + halo, K)):
            hit_l = np.nonzero(pose_idx[d] == b)[0]
            hit_r = np.nonzero(pose_idx[d + 1] == b)[0]
            if len(hit_l) == 0 or len(hit_r) == 0:
                continue
            # T_left = (R,p) of b per chunk d; correction satisfies
            # T_d * T_left == T_{d+1} * T_right
            Rl, pl = R[d, int(hit_l[0])], p[d, int(hit_l[0])]
            Rr, pr = R[d + 1, int(hit_r[0])], p[d + 1, int(hit_r[0])]
            # relative measurement between node frames: T_l T_r^-1
            R_rel = Rl @ Rr.T
            R_acc += R_rel
            p_acc += pl - R_rel @ pr
            n += 1
        if n == 0:
            raise ValueError("no shared boundary frame between chunks")
        R_rel = project_so3(f32(R_acc / n)).cpu().numpy()
        ei.append(d)
        ej.append(d + 1)
        # edge: T_j = T_i * (T_rel); with residual log(Tm^-1 Ti^-1 Tj),
        # measurement Tm = Ti^-1 Tj = T_rel
        Rm.append(R_rel)
        pm.append(p_acc / n)

    if D > 1:
        R0 = torch.eye(3, dtype=torch.float32, device=dev).expand(D, 3, 3)
        p0 = torch.zeros((D, 3), dtype=torch.float32, device=dev)
        Rc, pc = pose_graph_solve(
            R0, p0, torch.as_tensor(ei, dtype=torch.int32, device=dev),
            torch.as_tensor(ej, dtype=torch.int32, device=dev),
            f32(Rm), f32(pm), iters=8, graph=graph)
        Rc, pc = Rc.cpu().numpy(), pc.cpu().numpy()
    else:
        Rc = np.broadcast_to(np.eye(3, dtype=np.float32), (1, 3, 3))
        pc = np.zeros((1, 3), np.float32)

    # apply corrections and write back (chunk owns frames [lo, hi);
    # halo frame belongs to the right chunk)
    R_out = prob.R.cpu().numpy().copy()
    p_out = prob.p.cpu().numpy().copy()
    X_out = prob.X.cpu().numpy().copy()
    X_sol = sol.X.cpu().numpy()
    L = X_out.shape[0]
    X_acc = np.zeros((L, 3))
    w_acc = np.zeros(L)
    for d in range(D):
        lo, hi = bounds[d], bounds[d + 1]
        for local, g in enumerate(pose_idx[d]):
            if lo <= g < hi:
                R_out[g] = Rc[d] @ R[d, local]
                p_out[g] = Rc[d] @ p[d, local] + pc[d]
        if info.get("consensus", False):
            # observation-count-weighted average of every chunk's
            # corrected estimate of each duplicated landmark
            valid = info["land_valid"][d]
            li = info["land_idx"][d][valid]
            Xd = X_sol[d][valid] @ Rc[d].T + pc[d]
            w = info["land_votes"][li, d].astype(np.float64)
            np.add.at(X_acc, li, Xd * w[:, None])
            np.add.at(w_acc, li, w)
        else:
            own = info["land_owner"][d]
            li = info["land_idx"][d][own]
            Xd = X_sol[d][own]
            X_out[li] = Xd @ Rc[d].T + pc[d]
    if info.get("consensus", False):
        upd = w_acc > 0
        X_out[upd] = X_acc[upd] / w_acc[upd, None]

    return prob.replace(R=f32(R_out), p=f32(p_out), X=f32(X_out))
