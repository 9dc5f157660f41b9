"""Carry state between the JAX reference and the port.

The system has no weights: what crosses over is state. `from_reference`
turns a reference `FilterState`, `TrackerState` or `PipelineState` whose
leaves are numpy arrays (for example `jax.tree.map(np.asarray, state)`),
or a nested dict with the same field names, into the port's state on a
device. `to_numpy` turns a port state back into nested dicts of numpy
arrays with the reference's field names, from which the reference's
dataclasses can be rebuilt. For the semantic path,
`renderer_from_reference` / `renderer_to_numpy` carry a
`MultiMeshRenderer`'s camera and padded mesh stack (`Vs`, `Fs`, `Cs`,
names), and `tracks_from_reference` / `tracks_to_numpy` a mapper's object
tracks (poses, ages, scores). For the ingest path,
`undistorter_from_reference` / `undistorter_to_numpy` carry an
`Undistorter`'s camera model, sizes, output `K` and remap table, so that
one table can go through both packages' remaps. Neither direction imports jax: a reference
array crosses as `numpy.asarray` of it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from visma_tpu_torch.filter.state import FilterState, TrackTable
from visma_tpu_torch.frontend.tracker import TrackerState
from visma_tpu_torch.image.undistort import (AtanModel, RadTanModel,
                                             Undistorter)
from visma_tpu_torch.pipeline import PipelineState
from visma_tpu_torch.render.camera import Intrinsics
from visma_tpu_torch.render.raster import MultiMeshRenderer
from visma_tpu_torch.semantic.mapper import ObjectTrack

_NESTED = {"tracks": TrackTable, "tracker": TrackerState,
           "filter": FilterState}


def _field(obj: Any, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _has(obj: Any, name: str) -> bool:
    return name in obj if isinstance(obj, dict) else hasattr(obj, name)


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


def renderer_from_reference(ref: Any, device=None) -> MultiMeshRenderer:
    """The port's MultiMeshRenderer from a reference one (or a dict with
    `intr`, `names`, `Vs`, `Fs`): the same camera and the same padded,
    Morton-sorted stack, so mesh indices mean the same on both sides. The
    face corners are rebuilt from Vs and Fs. device: as for
    MultiMeshRenderer (None means the CUDA card)."""
    intr = _field(ref, "intr")
    intr = Intrinsics(**{f.name: _field(intr, f.name)
                         for f in dataclasses.fields(Intrinsics)})
    out = MultiMeshRenderer(intr, device=device)
    out.set_stack(np.asarray(_field(ref, "Vs")), np.asarray(_field(ref, "Fs")),
                  names=_field(ref, "names"))
    return out


def renderer_to_numpy(mr: MultiMeshRenderer) -> dict:
    """A port MultiMeshRenderer as a dict of its camera fields, names and
    numpy stack, from which the reference's can be filled (`Vs`, `Fs`,
    `Cs` are its attributes of the same names)."""
    return {"intr": dataclasses.asdict(mr.intr), "names": list(mr.names),
            "Vs": mr.Vs.cpu().numpy(), "Fs": mr.Fs.cpu().numpy(),
            "Cs": mr.Cs.cpu().numpy()}


_TRACK_FIELDS = tuple(f.name for f in dataclasses.fields(ObjectTrack))


def tracks_from_reference(tracks) -> dict:
    """A mapper's tracks ({oid: track} or an iterable of tracks, each an
    object or dict with oid, model_name, pose_wm, score, age, status) as
    the port's {oid: ObjectTrack}. Poses stay float64 numpy, as the
    mapper keeps its host mirror."""
    items = tracks.values() if isinstance(tracks, dict) else tracks
    out = {}
    for t in items:
        tr = ObjectTrack(oid=int(_field(t, "oid")),
                         model_name=str(_field(t, "model_name")),
                         pose_wm=np.array(_field(t, "pose_wm"), np.float64),
                         score=float(_field(t, "score")),
                         age=int(_field(t, "age")),
                         status=int(_field(t, "status")))
        out[tr.oid] = tr
    return out


def tracks_to_numpy(tracks) -> list:
    """The port's tracks as a list of dicts with the reference's field
    names, in oid order."""
    return [{k: (np.array(getattr(t, k)) if k == "pose_wm"
                 else getattr(t, k)) for k in _TRACK_FIELDS}
            for _, t in sorted(tracks.items())]


def undistorter_from_reference(ref: Any, device=None) -> Undistorter:
    """The port's Undistorter from a reference one (or a dict with `model`,
    `mode`, `out_rows`, `out_cols`, `K`, `remap`): the same camera model and
    the reference's own table, not a rebuilt one. The model is told apart
    by its fields (`s`: ATAN; `k1`: radial-tangential). device: as for
    Undistorter (None means the CUDA card)."""
    model = _field(ref, "model")
    cls = RadTanModel if _has(model, "k1") else AtanModel
    model = cls(**{f.name: _field(model, f.name)
                   for f in dataclasses.fields(cls)})
    return Undistorter.from_table(
        model, str(_field(ref, "mode")), int(_field(ref, "out_rows")),
        int(_field(ref, "out_cols")), np.asarray(_field(ref, "K")),
        np.asarray(_field(ref, "remap")), device=device)


def undistorter_to_numpy(und: Undistorter) -> dict:
    """A port Undistorter as a dict of its model fields, mode, sizes, `K`
    and the numpy table, from which the reference's can be filled."""
    return {"model": dataclasses.asdict(und.model), "mode": und.mode,
            "out_rows": und.out_rows, "out_cols": und.out_cols,
            "K": np.array(und.K), "remap": und.remap.cpu().numpy()}


__all__ = ["from_reference", "to_numpy", "renderer_from_reference",
           "renderer_to_numpy", "tracks_from_reference", "tracks_to_numpy",
           "undistorter_from_reference", "undistorter_to_numpy"]
