# Frozen copy of the frame step of visma_tpu_torch/filter/msckf.py at
# 43be5d3 (`_augment`, `_ingest`, `_select_for_update`, `_frame_step`),
# without the SLAM landmark branches (the benchmark's configurations hold no
# landmark slots) and without the runners: the reference steps frame by frame,
# eagerly. Imports point into portbench.reference.vio.
"""One MSCKF frame: propagate -> clone -> ingest tracks -> update."""
from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.vio.config import FilterConfig
from portbench.reference.vio.imu import propagate, propagate_cv
from portbench.reference.vio.state import FilterState, TrackTable
from portbench.reference.vio.status import FeatureStatus
from portbench.reference.vio.update import msckf_update
from portbench.reference.vio.rotations import hat, rodrigues
from portbench.reference.vio.misc import with_blocks

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
    if cfg.num_slam:
        raise ValueError("the reference filter holds no SLAM landmarks")
    valid_tab = frame["valid"]
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

    prom_sel = torch.zeros_like(keep)      # no landmark slots to promote to

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
