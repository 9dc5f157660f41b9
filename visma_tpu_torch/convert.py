"""Carry state between the JAX reference and the port.

The system has no weights: what crosses over is state. `from_reference`
turns a reference `FilterState`, `TrackerState` or `PipelineState` whose
leaves are numpy arrays (for example `jax.tree.map(np.asarray, state)`),
or a nested dict with the same field names, into the port's state on a
device. `to_numpy` turns a port state back into nested dicts of numpy
arrays with the reference's field names, from which the reference's
dataclasses can be rebuilt. Neither direction imports jax.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from visma_tpu_torch.filter.state import FilterState, TrackTable
from visma_tpu_torch.frontend.tracker import TrackerState
from visma_tpu_torch.pipeline import PipelineState

_NESTED = {"tracks": TrackTable, "tracker": TrackerState,
           "filter": FilterState}


def _field(obj: Any, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def from_reference(obj: Any, cls, device=None):
    """Build the port's `cls` (FilterState, TrackTable, TrackerState or
    PipelineState) from a reference state with numpy (or array-like)
    leaves, keeping every leaf's dtype."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = _field(obj, f.name)
        if f.name in _NESTED:
            kw[f.name] = from_reference(v, _NESTED[f.name], device)
        elif f.name == "pyr":
            kw[f.name] = tuple(torch.as_tensor(np.asarray(a), device=device)
                               for a in v)
        else:
            kw[f.name] = torch.as_tensor(np.array(v), device=device)
    return cls(**kw)


def to_numpy(state) -> dict:
    """Port state -> nested dicts of numpy arrays (a tuple for `pyr`)."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = to_numpy(v)
        elif isinstance(v, tuple):
            out[f.name] = tuple(a.cpu().numpy() for a in v)
        else:
            out[f.name] = v.cpu().numpy()
    return out


__all__ = ["from_reference", "to_numpy"]
