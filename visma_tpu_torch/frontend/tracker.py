"""Track management: persistent ids over LK tracks + replenishment (port of
visma_tpu/frontend/tracker.py).

Parity traps (pinned in tests/test_torch_frontend.py):
  * `occupied.at[cell_y, cell_x].set(ok)` writes duplicate cells
    (tracker.py:90-91); JAX on the CPU applies the writes in slot order, so
    the highest slot index in a cell wins. The port picks that slot with
    `scatter_reduce("amax")` of slot indices.
  * the `.at[].max` rank pairing (tracker.py:103-105) is
    `scatter_reduce("amax", include_self=True)`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from visma_tpu_torch.filter.msckf import scatter_max
from visma_tpu_torch.filter.state import register_pytree
from visma_tpu_torch.frontend.detect import detect_features
from visma_tpu_torch.frontend.klt import track_features
from visma_tpu_torch.frontend.klt_fused import track_features_fused
from visma_tpu_torch.frontend.pyramid import build_pyramid
from visma_tpu_torch.utils.graphs import CallGraph, wants_graph


@dataclass(frozen=True)
class TrackerState:
    ids: torch.Tensor      # (K,) int32, -1 empty
    pos: torch.Tensor      # (K, 2) float32
    age: torch.Tensor      # (K,) int32
    next_id: torch.Tensor  # 0-d int32
    pyr: tuple             # previous frame pyramid


register_pytree(TrackerState)


def occupied_cells(pos: torch.Tensor, ok: torch.Tensor, cell: int,
                   gh: int, gw: int) -> torch.Tensor:
    """(gh, gw) bool: `zeros.at[cell_y, cell_x].set(ok)` with the last
    (highest) slot index winning each duplicate cell."""
    cell_x = torch.clamp((pos[:, 0] / cell).to(torch.int32), 0, gw - 1)
    cell_y = torch.clamp((pos[:, 1] / cell).to(torch.int32), 0, gh - 1)
    flat = (cell_y * gw + cell_x).long()
    K = pos.shape[0]
    slot = torch.arange(K, device=pos.device)
    winner = torch.full((gh * gw,), -1, dtype=torch.int64, device=pos.device)
    winner = winner.scatter_reduce(0, flat, slot, "amax", include_self=True)
    occupied = (winner >= 0) & ok[torch.clamp(winner, min=0)]
    return occupied.reshape(gh, gw)


class FeatureTracker:
    """LK tracker with fixed capacity and grid replenishment."""

    def __init__(self, max_features: int = 64, levels: int = 3,
                 radius: int = 5, cell: int = 16, fused: bool = None,
                 graph: bool = None):
        """fused: None or True tracks with the fused LK path
        (klt_fused.track_features_fused, one lk_track kernel launch per
        tracked frame); False with the windowed tracker (klt.track_features), the
        JAX package's default off the TPU (tracker.py:40-56): same math and
        gates, another window size and margin.
        graph: `utils.graphs.wants_graph`'s rule, applied to the image's
        device at each `step` (the tracker has no device of its own): None
        replays a CUDA graph on a CUDA device and steps eagerly on the CPU;
        False steps eagerly; True goes through `CallGraph`'s buffers (on
        the CPU without capture)."""
        self.max_features = max_features
        self.levels = levels
        self.radius = radius
        self.cell = cell
        self.fused = fused is None or bool(fused)
        self.graph = graph
        # made by the first `step` that goes through a graph
        self.step_graph: Optional[CallGraph] = None

    def init(self, image: torch.Tensor) -> TrackerState:
        """Initialize on the first frame: detect only."""
        pyr = tuple(build_pyramid(image, self.levels))
        xy, _score, valid = detect_features(image, self.max_features,
                                            self.cell)
        K = self.max_features
        dev = image.device
        ids = torch.where(valid, torch.arange(K, dtype=torch.int32,
                                              device=dev),
                          torch.full((K,), -1, dtype=torch.int32, device=dev))
        return TrackerState(ids=ids, pos=xy,
                            age=torch.zeros(K, dtype=torch.int32, device=dev),
                            next_id=torch.tensor(K, dtype=torch.int32,
                                                 device=dev),
                            pyr=pyr)

    def step(self, state: TrackerState, image: torch.Tensor):
        """Track into the new frame; returns (state, ids, xp, valid). The
        caller's state is not modified, and the state returned is the
        caller's own (a graph's outputs are cloned out of it)."""
        if not wants_graph(self.graph, image.device):
            return self._step_impl(state, image)
        if self.step_graph is None:
            self.step_graph = CallGraph(self._step_impl)
        return self.step_graph(state, image)

    def _step_impl(self, state: TrackerState, image: torch.Tensor):
        K = self.max_features
        i32 = torch.int32
        cur_pyr = tuple(build_pyramid(image, self.levels))
        live = state.ids >= 0
        track = track_features_fused if self.fused else track_features
        new_pos, ok = track(state.pyr, cur_pyr, state.pos, live,
                            radius=self.radius, levels=self.levels)
        ok = ok & live
        ids = torch.where(ok, state.ids, torch.full_like(state.ids, -1))
        age = torch.where(ok, state.age + 1, torch.zeros_like(state.age))

        # replenish: detect corners away from live tracks
        H, W = image.shape
        gh, gw = H // self.cell, W // self.cell
        occupied = occupied_cells(new_pos, ok, self.cell, gh, gw)
        det_xy, _det_score, det_valid = detect_features(
            image, K, self.cell, occupied=occupied)

        # assign detections to empty slots (rank pairing)
        empty = ids < 0
        empty_rank = torch.cumsum(empty.to(i32), dim=0, dtype=i32) - 1
        det_rank = torch.cumsum(det_valid.to(i32), dim=0, dtype=i32) - 1
        n_det = torch.sum(det_valid, dtype=i32)
        take = empty & (empty_rank < n_det)

        F = det_xy.shape[0]
        feat_for_rank = scatter_max(
            F, torch.where(det_valid, det_rank, torch.full_like(det_rank, F - 1)),
            torch.arange(F, dtype=i32, device=image.device) * det_valid.to(i32))
        src = feat_for_rank[torch.clamp(empty_rank, 0, F - 1).long()]

        new_id_for_slot = state.next_id + empty_rank
        ids = torch.where(take, new_id_for_slot, ids)
        pos = torch.where(take[:, None], det_xy[src], new_pos)
        age = torch.where(take, torch.zeros_like(age), age)
        next_id = state.next_id + torch.sum(take.to(i32), dtype=i32)

        out = TrackerState(ids=ids, pos=pos, age=age, next_id=next_id,
                           pyr=cur_pyr)
        return out, ids, pos, ids >= 0
