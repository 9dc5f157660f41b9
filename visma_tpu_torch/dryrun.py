"""The multichip dryrun of the port: the twin of
`__graft_entry__.py::dryrun_multichip`, the reference's proof of its
distributed layer, with the reference's problems and gates unchanged.

Every rank of a mesh runs it (dist/__init__.py: each rank calls a solver
with the same whole problem and gets the whole solution back):

  * one GN step of `sharded_ba_step` against the single-device `ba_step`
    (max |dp| < 2e-4), 32 poses x 2048 landmarks;
  * the landmark-sharded dense solver, the matrix-free distributed PCG and
    the keyframe-sharded submap solver (halo 2, 6 polish iterations, a pcg
    polish) against the single-device `ba_solve(10)`: poses within 2e-2 m
    (submap 1.5e-2 m), total cost at most 1e-3 above;
  * a problem made by the filter from its own tracks (`Msckf.run` over a
    32-frame vision-only feed, `ba_problem_from_vio`, keyframes every 2
    frames): the dense solver against `ba_solve(8)`, 2e-2 m / 1e-3;
  * the two-stage pipeline (dist/pipeline_pp.py) on the 13-frame blob
    scene against `VioPipeline.run`, within 1e-5 m, its filter state on
    the rank's device (on one card: two CUDA streams of it);
  * the large instance, 128 poses x 8192 landmarks, `solver="auto"` (past
    PCG_CROSSOVER_K, so PCG with 40 CG iterations) against `ba_solve(8)`,
    3e-2 m / 2e-3.

Left out: the reference's weak-scaling sweep (`__graft_entry__.py:231-242`)
stands on `bench_scaling.py`, which the port has no twin of yet.

    python -m visma_tpu_torch.dryrun [--device cpu]

runs it in one process (a one-rank mesh); with COORDINATOR_ADDRESS,
NUM_PROCESSES and PROCESS_ID set in each process (dist/multihost.py), on
every rank of that process group.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

STEP_TOL = 2e-4
COST_TOL = 1e-3
POSE_TOL = {"dense": 2e-2, "pcg": 2e-2, "submap": 1.5e-2}
VIO_TOL = (2e-2, 1e-3)
LARGE_TOL = (3e-2, 2e-3)
PP_TOL = 1e-5


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def errors(sol, oracle) -> tuple:
    """(max |p - p_oracle|, relative cost excess over the oracle)."""
    from visma_tpu_torch.ba.gauss_newton import total_cost

    e = float((sol.p - oracle.p).abs().max())
    c = float(total_cost(oracle))
    return e, (float(total_cost(sol)) - c) / c


def step_parity(mesh, prob) -> float:
    """max |dp| between one sharded GN step and `ba_step` from the same
    point (damping 1e-3, the scale anchor of the first and last pose)."""
    from visma_tpu_torch.ba.gauss_newton import ba_step
    from visma_tpu_torch.dist.sharded_ba import sharded_ba_step

    lam = 1e-3
    dev = prob.R.device
    anchor = torch.linalg.norm(prob.p[-1] - prob.p[0])
    ref, _ = ba_step(prob, torch.tensor(lam, device=dev), anchor)
    got, _ = sharded_ba_step(prob, mesh, damping=lam)
    return float((got.p - ref.p).abs().max())


def solve(mesh, prob, solver: str):
    """The dryrun's call of each distributed solver: (solution, history)
    (submap: its info dict)."""
    from visma_tpu_torch.dist.pcg_ba import pcg_ba_solve
    from visma_tpu_torch.dist.sharded_ba import sharded_ba_solve
    from visma_tpu_torch.dist.submap_ba import submap_ba_solve

    if solver == "dense":
        return sharded_ba_solve(prob, mesh, iters=10, solver="dense")
    if solver == "pcg":
        return pcg_ba_solve(prob, mesh, iters=10, cg_iters=40)
    # submap trades global optimality for sequence parallelism; halo 2 and
    # 6 polish iterations bring it within ~2x of the dense path's pose
    # error (the reference's reasons, __graft_entry__.py:99-105)
    return submap_ba_solve(prob, mesh, iters=8, polish_iters=6, halo=2,
                           polish_solver="pcg")


def solver_parity(mesh, num_poses: int = 32, num_landmarks: int = 2048,
                  log=print, timer=None) -> dict:
    """The step and the three solvers against the single-device oracle on
    `synthetic_ba_problem(num_poses, num_landmarks, 0.5, 0.02)` on the
    mesh's device, gated; returns the errors, the solutions and, per
    solver, the mesh's collective counts over its call and `timer(fn)`'s
    reading of it (`timer` runs fn and returns (its result, ms); None
    times nothing)."""
    from visma_tpu_torch.ba.gauss_newton import ba_solve
    from visma_tpu_torch.ba.problem import synthetic_ba_problem

    prob, _ = synthetic_ba_problem(num_poses=num_poses,
                                   num_landmarks=num_landmarks, noise_px=0.5,
                                   pose_noise=0.02, device=mesh.device)
    out = {"step": step_parity(mesh, prob), "solutions": {}, "counts": {},
           "ms": {}}
    _check(out["step"] < STEP_TOL, "sharded GN step != single-device GN "
           f"step: max |dp| = {out['step']}")
    oracle, _ = ba_solve(prob, iters=10)
    for name in ("dense", "pcg", "submap"):
        mesh.counts.update(all_reduce=0, all_gather=0)
        run = lambda: solve(mesh, prob, name)  # noqa: E731
        (sol, hist), out["ms"][name] = (timer or (lambda f: (f(), None)))(run)
        out["counts"][name] = dict(mesh.counts)
        out[name] = errors(sol, oracle)
        out["solutions"][name] = (sol, hist)
    p = oracle.p.cpu().numpy()
    span = float(np.linalg.norm(p.max(0) - p.min(0)))
    log(f"dryrun_multichip({mesh.size}): {num_poses} poses / "
        f"{num_landmarks} landmarks (trajectory span {span:.2f} m)")
    log(f"  one-GN-step parity: max |dp| = {out['step']:.2e} "
        f"(tol {STEP_TOL})")
    log("  vs single-device oracle: max|p err| / rel cost excess =")
    for name, label in (("dense", "sharded dense:     "),
                        ("pcg", "pcg:               "),
                        ("submap", "submap+pcg-polish: ")):
        e, dc = out[name]
        log(f"    {label} {e:.2e} / {dc:+.2e}")
    # cost is the primary gate (the objective both must minimize); the pose
    # tolerance absorbs near-gauge flat directions (monocular scale is only
    # softly anchored), wider for submap, whose chunk-local gauges add
    # another soft mode before the polish
    for name in ("dense", "pcg", "submap"):
        e, dc = out[name]
        _check(e < POSE_TOL[name],
               f"{name} poses diverge from the oracle: {e}")
        _check(dc < COST_TOL, f"{name} converged to a worse optimum: {dc}")
    log(f"dryrun_multichip({mesh.size}): all three distributed BA paths "
        "reproduce the single-device solve (step tol 2e-4, pose tol "
        f"2e-2/1.5e-2, cost tol {COST_TOL})")
    return out


def vio_problem(device):
    """A BA problem produced by the filter from its own tracks: the
    reference's 32-frame vision-only feed (__graft_entry__.py:135-162)."""
    from visma_tpu_torch.ba.from_vio import ba_problem_from_vio
    from visma_tpu_torch.filter import FilterConfig, Msckf
    from visma_tpu_torch.filter.feed import pack_frames
    from visma_tpu_torch.io.synthetic import (SyntheticConfig, make_dataset,
                                              make_trajectory)

    syn = SyntheticConfig(num_frames=32, num_landmarks=120, pixel_noise=1.0,
                          seed=5)
    cfg = FilterConfig(window=8, max_tracks=64, fx=syn.fx, fy=syn.fy,
                       cx=syn.cx, cy=syn.cy, pixel_noise=1.0, use_imu=False)
    _, gwc = make_trajectory(syn)
    packed = pack_frames(cfg, make_dataset(syn), None, max_feats=64)
    frames = {k: torch.as_tensor(v, device=device)
              for k, v in packed.items() if k != "ts"}
    kf = Msckf(cfg, device=device)
    s0 = kf.init(R0=gwc[0, :, :3], p0=gwc[0, :, 3],
                 v0=(gwc[1, :, 3] - gwc[0, :, 3]) * syn.fps)
    _, outs = kf.run(s0, frames)
    prob, _ = ba_problem_from_vio(
        packed["ids"], packed["xp"], packed["valid"],
        outs["R"].cpu().numpy(), outs["p"].cpu().numpy(),
        (cfg.fx, cfg.fy, cfg.cx, cfg.cy), stride=2, device=device)
    _check(prob is not None, "VIO run produced too few usable tracks")
    return prob


def vio_parity(mesh, prob, iters: int = 8, what: str = "pipeline-produced",
               log=print) -> tuple:
    """The dense sharded solver against `ba_solve(iters)` on a problem the
    filter produced; gated at 2e-2 m / 1e-3."""
    from visma_tpu_torch.ba.gauss_newton import ba_solve
    from visma_tpu_torch.dist.sharded_ba import sharded_ba_solve

    oracle, _ = ba_solve(prob, iters=iters)
    sol, _ = sharded_ba_solve(prob, mesh, iters=iters, solver="dense")
    e, dc = errors(sol, oracle)
    log(f"  {what} problem ({prob.num_poses} kf / {prob.num_landmarks} lm "
        f"from the filter's own tracks): max|p err| {e:.2e} / rel cost "
        f"excess {dc:+.2e}")
    _check(e < VIO_TOL[0], f"sharded BA diverges on the VIO problem: {e}")
    _check(dc < VIO_TOL[1], f"worse optimum on the VIO problem: {dc}")
    return e, dc


def pp_parity(device, log=print) -> float:
    """The two-stage pipeline, both stages on `device` (two CUDA streams on
    a card), against `VioPipeline.run` on the reference's 13-frame blob
    scene (__graft_entry__.py:170-213); gated at 1e-5 m."""
    from visma_tpu_torch.dist.pipeline_pp import TwoStagePipeline
    from visma_tpu_torch.filter import FilterConfig
    from visma_tpu_torch.io.synthetic import SyntheticConfig, make_imu
    from visma_tpu_torch.io.synthetic_images import render_blob_frames
    from visma_tpu_torch.pipeline import VioPipeline

    syn = SyntheticConfig(num_frames=13, num_landmarks=80, rows=128,
                          cols=160, fx=120.0, fy=120.0, cx=80.0, cy=64.0,
                          seed=13)
    cfg = FilterConfig(window=6, max_tracks=32, max_updates=8, fx=syn.fx,
                       fy=syn.fy, cx=syn.cx, cy=syn.cy, pixel_noise=1.0)
    frames, gwc, _ = render_blob_frames(syn)
    imu = make_imu(syn)
    spf = imu["samples_per_frame"]
    dtf = float(np.diff(imu["ts_state"])[0])
    N = syn.num_frames - 1
    gyro = imu["gyro"][: N * spf].reshape(N, spf, 3)
    accel = imu["accel"][: N * spf].reshape(N, spf, 3)
    dts = np.full((N, spf), dtf, np.float32)
    init = dict(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])

    pipe = VioPipeline(cfg, levels=2, cell=20, device=device)
    _, ref = pipe.run(pipe.init(frames[0], **init), frames[1:], gyro, accel,
                      dts)
    pp = TwoStagePipeline(cfg, device, device, levels=2, cell=20, chunk=5)
    tr0, fs0 = pp.init(frames[0], **init)
    _, fs1, out = pp.run(tr0, fs0, frames[1:], gyro, accel, dts)
    e = float((out["p"] - ref["p"]).abs().max())
    _check(e < PP_TOL, f"two-stage pipeline diverges: {e}")
    _check(fs1.p.device == torch.device(device), "filter stage misplaced")
    log(f"  two-stage PP ({N} frames, chunk 5): max |p - ref| = {e:.1e} "
        f"(tol {PP_TOL}), both stages on {fs1.p.device}")
    return e


def large_instance(mesh, num_poses: int = 128, num_landmarks: int = 8192,
                   log=print) -> tuple:
    """Past the PCG crossover `solver="auto"` routes onto the matrix-free
    PCG (40 CG iterations), which must still reproduce `ba_solve(8)`;
    gated at 3e-2 m / 2e-3."""
    from visma_tpu_torch.ba.gauss_newton import ba_solve
    from visma_tpu_torch.ba.problem import synthetic_ba_problem
    from visma_tpu_torch.dist.sharded_ba import (PCG_CROSSOVER_K,
                                                 sharded_ba_solve)

    big, _ = synthetic_ba_problem(num_poses=num_poses,
                                  num_landmarks=num_landmarks, noise_px=0.5,
                                  pose_noise=0.02, device=mesh.device)
    _check(big.num_poses > PCG_CROSSOVER_K, "the large instance must pass "
           "the PCG crossover")
    oracle, _ = ba_solve(big, iters=8)
    sol, _ = sharded_ba_solve(big, mesh, iters=8, solver="auto", cg_iters=40)
    e, dc = errors(sol, oracle)
    log(f"  large instance ({num_poses} kf / {num_landmarks} lm, "
        f"auto->pcg): max|p err| {e:.2e} / rel cost excess {dc:+.2e}")
    _check(e < LARGE_TOL[0], f"large-instance PCG diverges: {e}")
    _check(dc < LARGE_TOL[1], f"large-instance PCG worse optimum: {dc}")
    return e, dc


def dryrun_multichip(mesh, num_poses: int = 32, num_landmarks: int = 2048,
                     large=(128, 8192), log=print, timer=None) -> dict:
    """Every part above on `mesh`, in the reference's order, with its
    printed lines; raises AssertionError on a missed gate. Returns the
    numbers (the solutions under "solutions"; `timer` as in
    `solver_parity`)."""
    out = solver_parity(mesh, num_poses, num_landmarks, log=log, timer=timer)
    out["vio"] = vio_parity(mesh, vio_problem(mesh.device), log=log)
    out["pp"] = pp_parity(mesh.device, log=log)
    out["large"] = large_instance(mesh, *large, log=log)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of this rank (default: the CUDA card)")
    args = ap.parse_args(argv)
    from visma_tpu_torch.dist import make_mesh
    from visma_tpu_torch.dist.multihost import initialize
    from visma_tpu_torch.utils.platform import configure_platform

    device = configure_platform(args.device)
    initialize(device=device)
    dryrun_multichip(make_mesh(device=device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
