# Frozen copy of visma_tpu_torch/filter/state.py at 43be5d3; imports point into
# portbench.reference.vio. Part of the benchmark's plain reference.
"""Filter state (port of visma_tpu/filter/state.py).

Same fields, shapes and dtypes as the reference's pytrees, held as frozen
dataclasses of tensors; `replace` returns a new state, so a step never
mutates its input. Both dataclasses are registered as pytree nodes, so
`torch.func.vmap` maps over a state whose tensors carry a leading stream
axis (`stack_states`, `Msckf.run_batched`). See the reference module for
the error-state layout.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace as _replace

import torch
from torch.utils import _pytree as pytree

from portbench.reference.vio.status import FeatureStatus
from portbench.reference.vio.config import FilterConfig


@dataclass(frozen=True)
class TrackTable:
    """Fixed-capacity feature tracks aligned with the clone window.

    ids (K,) int32 (-1 = empty), status (K,) int32 FeatureStatus,
    obs (K, M, 2) f32, mask (K, M) bool, xw (K, 3) f32.
    """

    ids: torch.Tensor
    status: torch.Tensor
    obs: torch.Tensor
    mask: torch.Tensor
    xw: torch.Tensor

    @classmethod
    def empty(cls, K: int, M: int, device=None) -> "TrackTable":
        return cls(
            ids=torch.full((K,), -1, dtype=torch.int32, device=device),
            status=torch.full((K,), int(FeatureStatus.EMPTY),
                              dtype=torch.int32, device=device),
            obs=torch.zeros((K, M, 2), dtype=torch.float32, device=device),
            mask=torch.zeros((K, M), dtype=torch.bool, device=device),
            xw=torch.zeros((K, 3), dtype=torch.float32, device=device),
        )

    def replace(self, **kw) -> "TrackTable":
        return _replace(self, **kw)


@dataclass(frozen=True)
class FilterState:
    """Nominal state + covariance + track table (reference state.py:65-116)."""

    R: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    win_R: torch.Tensor
    win_p: torch.Tensor
    win_valid: torch.Tensor
    P: torch.Tensor
    tracks: TrackTable
    t: torch.Tensor
    R_bc: torch.Tensor
    p_bc: torch.Tensor
    td: torch.Tensor
    lm_ids: torch.Tensor
    lm_xw: torch.Tensor
    lm_missed: torch.Tensor

    def replace(self, **kw) -> "FilterState":
        return _replace(self, **kw)


def register_pytree(cls):
    """Register a frozen dataclass of tensors as a pytree node, its fields
    in declaration order."""
    names = [f.name for f in fields(cls)]
    pytree.register_pytree_node(
        cls, lambda obj: ([getattr(obj, n) for n in names], None),
        lambda children, _: cls(*children),
        serialized_type_name=f"{cls.__module__}.{cls.__qualname__}")


register_pytree(TrackTable)
register_pytree(FilterState)


def stack_states(states) -> FilterState:
    """B states -> one state whose every tensor has a leading axis B (the
    reference stacks with `jax.tree.map` over its pytrees)."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), *states)


def _vec(x, n: int, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device).reshape(n)


def init_state(cfg: FilterConfig, R0=None, p0=None, v0=None,
               t0: float = 0.0, device=None) -> FilterState:
    f32 = dict(dtype=torch.float32, device=device)
    calib = []
    if cfg.estimate_extrinsics:
        calib += [cfg.init_ext_att_std ** 2] * 3 + [cfg.init_ext_pos_std ** 2] * 3
    if cfg.estimate_td:
        calib += [cfg.init_td_std ** 2]
    diag = ([cfg.init_att_std ** 2] * 3 + [cfg.init_pos_std ** 2] * 3
            + [cfg.init_vel_std ** 2] * 3 + [cfg.init_bg_std ** 2] * 3
            + [cfg.init_ba_std ** 2] * 3 + [0.0] * (6 * cfg.window)
            + calib + [0.0] * (3 * cfg.num_slam))
    P = torch.diag(torch.tensor(diag, **f32))
    return FilterState(
        R=(torch.eye(3, **f32) if R0 is None
           else torch.as_tensor(R0, **f32).reshape(3, 3)),
        p=torch.zeros(3, **f32) if p0 is None else _vec(p0, 3, device),
        v=torch.zeros(3, **f32) if v0 is None else _vec(v0, 3, device),
        bg=torch.zeros(3, **f32),
        ba=torch.zeros(3, **f32),
        win_R=torch.eye(3, **f32).expand(cfg.window, 3, 3).clone(),
        win_p=torch.zeros((cfg.window, 3), **f32),
        win_valid=torch.zeros(cfg.window, dtype=torch.bool, device=device),
        P=P,
        tracks=TrackTable.empty(cfg.max_tracks, cfg.window, device),
        t=torch.tensor(t0, **f32),
        R_bc=torch.tensor(cfg.cam_R_bc, **f32),
        p_bc=torch.tensor(cfg.cam_p_bc, **f32),
        td=torch.tensor(cfg.td0, **f32),
        lm_ids=torch.full((cfg.num_slam,), -1, dtype=torch.int32,
                          device=device),
        lm_xw=torch.zeros((cfg.num_slam, 3), **f32),
        lm_missed=torch.zeros((cfg.num_slam,), dtype=torch.int32,
                              device=device),
    )
