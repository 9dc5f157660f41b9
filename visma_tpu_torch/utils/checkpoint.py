"""Checkpoint / resume for filter, pipeline and BA state (port of
visma_tpu/utils/checkpoint.py).

`save_state` / `load_state` snapshot live state (FilterState,
PipelineState, TrackerState, BaProblem; dicts, tuples and lists of them)
in the reference's numpy container: `step_{n}.npz` with one key `leaf_{i}`
per leaf, plus `latest.json` holding `{"step": n}`. The reference writes
orbax when it is installed and this npz layout otherwise; the port writes
the npz layout only. The leaves come in the order of
`jax.tree_util.tree_flatten` of the reference's types: dataclass fields in
declaration order (the port's states are frozen dataclasses in the
reference's field order), tuples and lists in order, dicts by sorted key,
None with no leaf (`utils.misc.tree_leaves`). So a file the port writes
loads with the reference's `load_state`, and a file in the reference's npz
layout loads here.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from visma_tpu_torch.utils.misc import tree_leaves


def _rebuild(template, leaves):
    """`template`'s structure with its leaves taken from the iterator, in
    `tree_leaves` order."""
    if template is None:
        return None
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        new = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: new[k] for k in template}
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return _like(template, next(leaves))


def _like(template, arr: np.ndarray):
    """`arr` as the template leaf's kind: a tensor on its device with its
    dtype, a numpy array of its dtype, or a Python scalar of its type."""
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(arr, dtype=template.dtype,
                               device=template.device)
    if isinstance(template, np.ndarray):
        return arr.astype(template.dtype)
    return type(template)(arr)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save_state(path: str, tree, step: int = 0) -> None:
    """Snapshot `tree` to `path` (a directory). Reads every leaf back to
    the host. `latest.json` is replaced in one rename, after the snapshot
    is written, so a reader, or a process killed mid-save, never finds it
    empty or naming a step that is not on disk."""
    os.makedirs(path, exist_ok=True)
    flat = {f"leaf_{i}": _host(x) for i, x in enumerate(tree_leaves(tree))}
    np.savez(os.path.join(path, f"step_{step}.npz"), **flat)
    tmp = os.path.join(path, "latest.json.tmp")
    with open(tmp, "w") as fp:
        json.dump({"step": step}, fp)
    os.replace(tmp, os.path.join(path, "latest.json"))


def latest_step(path: str) -> int:
    with open(os.path.join(path, "latest.json")) as fp:
        return int(json.load(fp)["step"])


def load_state(path: str, template, step: int = None):
    """Restore into the structure of `template` (the same tree shape); each
    leaf lands on the template leaf's device with its dtype."""
    if step is None:
        step = latest_step(path)
    n = len(tree_leaves(template))
    with np.load(os.path.join(path, f"step_{step}.npz")) as data:
        if len(data.files) != n:
            raise ValueError(f"{path} step {step} holds {len(data.files)} "
                             f"leaves, the template {n}")
        arrays = [data[f"leaf_{i}"] for i in range(n)]
    return _rebuild(template, iter(arrays))
