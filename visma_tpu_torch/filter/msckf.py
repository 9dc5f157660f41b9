"""MSCKF orchestration (port of visma_tpu/filter/msckf.py).

`_frame_step` is the per-frame step (propagate -> clone -> ingest tracks ->
update); `Msckf.run` runs it over a packed sequence, and
`Msckf.run_batched` runs the same step under `torch.func.vmap` over B
streams, the reference's `vmap` inside its scan. On a CUDA device both
capture their step once into a CUDA graph and replay it once a frame
(`utils.graphs.StepGraph`), the counterpart of the reference's jit +
`lax.scan`; `Msckf(cfg, graph=False)` loops eagerly. Nothing in a step
reads a value back to the host, so a run on the GPU queues frames without
waiting; and no step writes into a freshly made buffer by index (blocks
are placed with `with_blocks`, `torch.cat`, `torch.where` and out-of-place
`index_put`), which vmap would refuse.

Parity notes (each pinned in tests/test_torch_filter.py):
  * `jnp.argmax` takes the first maximum (msckf.py:49,153): bool masks are
    cast to int before `torch.argmax`, which also returns the first.
  * `.at[].max` scatters (msckf.py:170-172) are
    `scatter_reduce("amax", include_self=True)`.
  * `lax.top_k` (msckf.py:228, :385) returns ties lowest index first: a
    stable descending sort does the same.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from visma_tpu_torch.filter.config import FilterConfig
from visma_tpu_torch.filter.imu import propagate, propagate_cv
from visma_tpu_torch.filter.slam import in_state, slam_promote, slam_update
from visma_tpu_torch.filter.state import FilterState, TrackTable, init_state
from visma_tpu_torch.filter.update import msckf_update
from visma_tpu_torch.geom.rotations import hat, rodrigues
from visma_tpu_torch.proto import FeatureStatus
from visma_tpu_torch.utils.graphs import StepGraph, run_eager, wants_graph
from visma_tpu_torch.utils.misc import (DivergenceError, finite_tree,
                                        resolve_device, with_blocks)

_EMPTY = int(FeatureStatus.EMPTY)
_INITIALIZING = int(FeatureStatus.INITIALIZING)
_READY = int(FeatureStatus.READY)
_INSTATE = int(FeatureStatus.INSTATE)
_KEEP = int(FeatureStatus.KEEP)
_GOODDROP = int(FeatureStatus.GOODDROP)
_REJECT = int(FeatureStatus.REJECT)


def top_k_stable(x: torch.Tensor, k: int):
    """`lax.top_k` over the last axis: values descending, ties lowest index
    first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def scatter_max(n: int, index: torch.Tensor, src: torch.Tensor):
    """`zeros(n).at[index].max(src)` for int32 src (msckf.py:170-172)."""
    out = torch.zeros(n, dtype=src.dtype, device=src.device)
    return out.scatter_reduce(0, index.long(), src, "amax", include_self=True)


def check_health(outs: Dict[str, torch.Tensor]) -> None:
    """Host-side gate on Msckf.run / VioPipeline.run outputs: raise a
    DivergenceError naming the FIRST non-finite frame."""
    healthy = outs.get("healthy")
    healthy = (np.asarray(True) if healthy is None
               else np.asarray(torch.as_tensor(healthy).cpu()))
    if healthy.all():
        return
    raise DivergenceError(int(np.argmin(healthy)))


def _frame_outputs(cfg: FilterConfig, s: FilterState) -> Dict[str, torch.Tensor]:
    """Per-frame export record: pose, track-table snapshot (feat_xp is the
    newest observed pixel), the health flag and, with SLAM landmarks, their
    ids and positions (msckf.py:36-67)."""
    tracks = s.tracks
    M = tracks.obs.shape[1]
    K = tracks.ids.shape[0]
    last = M - 1 - torch.argmax(tracks.mask.flip(1).to(torch.int32), dim=1)
    seen = torch.any(tracks.mask, dim=1)
    xp_last = torch.where(
        seen[:, None],
        tracks.obs[torch.arange(K, device=last.device), last],
        torch.zeros((), dtype=torch.float32, device=last.device))
    out = {
        "R": s.R, "p": s.p, "v": s.v,
        "feat_status": tracks.status,
        "feat_ids": tracks.ids,
        "feat_xw": tracks.xw,
        "feat_xp": xp_last,
        "healthy": finite_tree((s.R, s.p, s.v, s.bg, s.ba, s.P)),
    }
    if cfg.num_slam:
        out["lm_ids"] = s.lm_ids
        out["lm_xw"] = s.lm_xw
    return out


def _augment(cfg: FilterConfig, state: FilterState,
             omega=None) -> FilterState:
    """Roll the clone window left and clone the current camera pose into
    slot M-1 (msckf.py:70-132)."""
    M, D = cfg.window, cfg.dim
    dev = state.P.device
    R_bc, p_bc, td = state.R_bc, state.p_bc, state.td
    if omega is None:
        omega = torch.zeros(3, dtype=torch.float32, device=dev)

    R_b = rodrigues(state.R @ omega * td) @ state.R
    p_b = state.p + state.v * td
    cam_R = R_b @ R_bc
    cam_p = p_b + R_b @ p_bc
    win_R = torch.cat([state.win_R[1:], cam_R[None]], dim=0)
    win_p = torch.cat([state.win_p[1:], cam_p[None]], dim=0)
    win_valid = torch.cat([state.win_valid[1:],
                           torch.ones(1, dtype=torch.bool, device=dev)])

    # new index -> old index: clones shift left, the new clone duplicates
    # the IMU attitude/position error, the calibration tail stays put
    perm = torch.cat([torch.arange(15, device=dev),
                      torch.arange(21, 15 + 6 * M, device=dev),
                      torch.arange(0, 6, device=dev),
                      torch.arange(15 + 6 * M, D, device=dev)])
    P = state.P[perm][:, perm]

    if cfg.has_extrinsics or cfg.estimate_extrinsics or cfg.estimate_td:
        ra = 15 + 6 * (M - 1)
        rp = ra + 3
        blocks = [(rp, ra, -hat(state.R @ p_bc))]
        if cfg.estimate_extrinsics:
            c = cfg.ext_idx
            blocks += [(ra, c, cam_R), (rp, c + 3, state.R)]
        if cfg.estimate_td:
            c = cfg.td_idx
            blocks += [(ra, c, (state.R @ omega)[:, None]),
                       (rp, c, (state.v + state.R @ torch.linalg.cross(
                           omega, p_bc))[:, None])]
        J = with_blocks(torch.eye(D, dtype=torch.float32, device=dev),
                        blocks)
        P = J @ P @ J.T
    P = 0.5 * (P + P.T)
    return state.replace(win_R=win_R, win_p=win_p, win_valid=win_valid, P=P)


def _ingest(cfg: FilterConfig, tracks: TrackTable, ids, xp, valid):
    """Roll track observations with the window and ingest this frame's
    observations ids (F,), xp (F, 2), valid (F,) (msckf.py:135-215).

    Returns (tracks, lost (K,) bool)."""
    K, M = tracks.obs.shape[0], tracks.obs.shape[1]
    F = ids.shape[0]
    dev = ids.device
    i32 = torch.int32

    slot_live = tracks.ids >= 0
    eq = (tracks.ids[:, None] == ids[None, :]) & valid[None, :] \
        & slot_live[:, None]
    has_match = torch.any(eq, dim=1)
    match_idx = torch.argmax(eq.to(i32), dim=1)
    matched_xp = xp[match_idx]
    # the window rolls left; the newest column takes this frame's matches
    obs = torch.cat([tracks.obs[:, 1:],
                     torch.where(has_match[:, None], matched_xp,
                                 torch.zeros_like(matched_xp))[:, None]],
                    dim=1)
    mask = torch.cat([tracks.mask[:, 1:], has_match[:, None]], dim=1)
    newest = torch.arange(M, device=dev) == M - 1          # (M,)

    # new features fill empty slots by rank pairing
    known = torch.any(eq, dim=0)
    is_new = valid & ~known
    new_rank = torch.cumsum(is_new.to(i32), dim=0, dtype=i32) - 1
    empty = ~slot_live
    empty_rank = torch.cumsum(empty.to(i32), dim=0, dtype=i32) - 1
    n_new = torch.sum(is_new, dtype=i32)
    take = empty & (empty_rank < n_new)
    feat_for_rank = scatter_max(
        F, torch.where(is_new, new_rank, torch.full_like(new_rank, F - 1)),
        torch.arange(F, dtype=i32, device=dev) * is_new.to(i32))
    src = feat_for_rank[torch.clamp(empty_rank, 0, F - 1).long()]

    ids_new = torch.where(take, ids[src], tracks.ids)
    fresh_obs = torch.where(newest[:, None], xp[src][:, None],
                            torch.zeros((), device=dev))
    obs = torch.where(take[:, None, None], fresh_obs, obs)
    mask = torch.where(take[:, None], newest, mask)
    xw = torch.where(take[:, None], torch.zeros_like(tracks.xw), tracks.xw)

    nobs = torch.sum(mask, dim=1, dtype=i32)
    live = ids_new >= 0
    lost = live & ~mask[:, M - 1] & (nobs > 0)

    def c(v):
        return torch.full((K,), v, dtype=i32, device=dev)

    drop_status = torch.where(nobs >= cfg.min_track_obs, c(_GOODDROP),
                              c(_REJECT))
    has_xw = torch.any(xw != 0.0, dim=1)
    status = torch.where(
        ~live, c(_EMPTY),
        torch.where(lost, drop_status,
                    torch.where(nobs <= 1, c(_INITIALIZING),
                                torch.where(has_xw, c(_INSTATE),
                                            c(_READY)))))

    expired = live & (nobs == 0)
    ids_new = torch.where(expired, torch.full_like(ids_new, -1), ids_new)
    status = torch.where(expired, c(_EMPTY), status)
    return TrackTable(ids=ids_new, status=status, obs=obs, mask=mask,
                      xw=xw), lost


def _select_for_update(cfg: FilterConfig, tracks: TrackTable, lost):
    """Up to max_updates mature features, lost tracks first, then
    full-window tracks. Returns (sel (U,) slot indices, sel_valid (U,))."""
    M = tracks.obs.shape[1]
    i32 = torch.int32
    nobs = torch.sum(tracks.mask, dim=1, dtype=i32)
    live = tracks.ids >= 0
    mature = live & (nobs >= cfg.min_track_obs)
    full = mature & (nobs >= M)
    eligible = mature & (lost | full)
    score = eligible.to(i32) * (1000 + nobs + 1000 * lost.to(i32))
    top, sel = top_k_stable(score, cfg.max_updates)
    return sel, top > 0


class Msckf:
    """Facade: per-frame step + sequence runners."""

    def __init__(self, cfg: FilterConfig, device=None, graph: bool = None):
        """graph: as `VioPipeline`'s (None: `run` and `run_batched` replay
        a CUDA graph on a CUDA device and loop eagerly on the CPU; False:
        eager; True: `StepGraph`'s static buffers, on the CPU without
        capture)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self._graph = wants_graph(graph, self.device)
        # made by the first `run` / `run_batched` that replays a graph
        self.run_graph: Optional[StepGraph] = None
        self.batched_graph: Optional[StepGraph] = None

    def init(self, **kw) -> FilterState:
        return init_state(self.cfg, device=self.device, **kw)

    def step(self, state: FilterState, frame: Dict[str, torch.Tensor]
             ) -> FilterState:
        """frame: {gyro (S,3), accel (S,3), dts (S,), ids (F,), xp (F,2),
        valid (F,)}."""
        return _frame_step(self.cfg, state, frame)

    def _run_step(self, state: FilterState, frame):
        state = _frame_step(self.cfg, state, frame)
        return state, _frame_outputs(self.cfg, state)

    @functools.cached_property
    def _vstep(self):
        return torch.func.vmap(functools.partial(_frame_step, self.cfg))

    def _batched_step(self, states: FilterState, frames):
        states = self._vstep(states, frames)
        return states, {"R": states.R, "p": states.p}

    def run(self, state: FilterState, frames: Dict[str, torch.Tensor]):
        """Step over a packed sequence (leading axis = frames). Returns
        (final_state, outputs) with every `_frame_outputs` key stacked
        over frames."""
        if not self._graph:
            return run_eager(self._run_step, state, frames)
        if self.run_graph is None:
            self.run_graph = StepGraph(self._run_step)
        return self.run_graph.run(state, frames)

    def run_batched(self, states: FilterState,
                    frames: Dict[str, torch.Tensor]):
        """Throughput/serving mode: B independent streams (multi-camera
        rigs, fleet reprocessing), one frame step vmapped over all B
        streams per frame, so the per-stream linear algebra runs batched
        on the device.

        states: a FilterState whose tensors carry a leading axis B
        (`stack_states` over `init`); frames: {key: (B, N, ...)}. Returns
        (final states (B, ...), {R (B,N,3,3), p (B,N,3)}). Works with SLAM
        landmarks too: the vmap covers their hooks."""
        frames = {k: v.transpose(0, 1) for k, v in frames.items()}
        if not self._graph:
            states, outs = run_eager(self._batched_step, states, frames)
        else:
            if self.batched_graph is None:
                self.batched_graph = StepGraph(self._batched_step)
            states, outs = self.batched_graph.run(states, frames)
        return states, {k: v.transpose(0, 1).contiguous()
                        for k, v in outs.items()}


def _frame_step(cfg: FilterConfig, state: FilterState,
                frame: Dict[str, torch.Tensor]) -> FilterState:
    """One frame (msckf.py:319-417)."""
    i32 = torch.int32
    # 1. propagation to the frame time
    if cfg.use_imu:
        state = propagate(cfg, state, frame["gyro"], frame["accel"],
                          frame["dts"])
        # body rate at the frame (bias-corrected last unmasked sample)
        n = torch.sum(frame["dts"] > 0, dtype=i32)
        idx = torch.clamp(n - 1, 0, frame["gyro"].shape[0] - 1)
        # a device gather: indexing with the 0-d `idx` would read it back
        omega = (frame["gyro"].index_select(0, idx.reshape(1)).squeeze(0)
                 - state.bg) * (n > 0)
    else:
        state = propagate_cv(cfg, state, torch.sum(frame["dts"]))
        omega = None
    # 2. clone the camera pose into the window
    state = _augment(cfg, state, omega)
    # 2b. SLAM landmark update from this frame's observations of in-state
    # landmarks (the newest clone measures); in-state ids are then hidden
    # from the track table so no observation is used twice
    valid_tab = frame["valid"]
    if cfg.num_slam:
        state = slam_update(cfg, state, frame["ids"], frame["xp"],
                            frame["valid"])
        valid_tab = valid_tab & ~in_state(state.lm_ids, frame["ids"])
    # 3. ingest feature observations
    tracks, lost = _ingest(cfg, state.tracks, frame["ids"], frame["xp"],
                           valid_tab)
    state = state.replace(tracks=tracks)
    # 4. MSCKF update on mature tracks
    sel, sel_valid = _select_for_update(cfg, tracks, lost)
    sel_obs = tracks.obs[sel]
    sel_mask = tracks.mask[sel]
    state, used, rejected, X = msckf_update(cfg, state, sel_obs, sel_mask,
                                            sel_valid)
    # record triangulated points; retire consumed observations (see the
    # reference, msckf.py:357-417, for the lifecycle rules)
    M = cfg.window
    old = state.tracks
    xw = old.xw.index_put((sel,), torch.where(used[:, None], X, old.xw[sel]))
    sel_mask_now = old.mask[sel]
    still_seen = sel_mask_now[:, M - 1]
    keep = used & still_seen
    drop = used & ~still_seen

    # promote the best still-tracked consumed features into landmark slots;
    # promoted features leave the track table (their next observations feed
    # slam_update) and export INSTATE this frame
    prom_sel = torch.zeros_like(keep)
    if cfg.num_slam and cfg.max_promote:
        sel_mask_v = sel_mask & state.win_valid[None, :]
        nobs_sel = torch.sum(sel_mask_v, dim=1, dtype=i32)
        score = keep.to(i32) * (1 + nobs_sel)
        topv, topi = top_k_stable(score, cfg.max_promote)
        state, prom_done = slam_promote(
            cfg, state, X[topi], sel_obs[topi], sel_mask_v[topi],
            tracks.ids[sel][topi], topv > 0)
        prom_sel = prom_sel.index_put((topi,), prom_done)
        keep = keep & ~prom_sel
        drop = drop | prom_sel

    newest_only = torch.arange(M, device=sel.device) == M - 1
    new_sel_mask = torch.where(
        keep[:, None], sel_mask_now & newest_only,
        torch.where((drop | rejected)[:, None],
                    torch.zeros_like(sel_mask_now), sel_mask_now))

    def c(v):
        return torch.full_like(sel, v, dtype=i32)

    status = old.status.index_put((sel,), torch.where(
        prom_sel, c(_INSTATE),
        torch.where(drop, c(_GOODDROP),
                    torch.where(rejected, c(_REJECT),
                                torch.where(keep, c(_KEEP),
                                            old.status[sel])))))
    mask = old.mask.index_put((sel,), new_sel_mask)
    tracks = TrackTable(ids=old.ids, status=status, obs=old.obs, mask=mask,
                        xw=xw)
    return state.replace(tracks=tracks)
