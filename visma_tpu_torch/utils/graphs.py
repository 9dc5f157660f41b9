"""Captured CUDA graphs, the port's counterpart of the reference's
`jax.jit`: `StepGraph` replays a step once a frame over a sequence, or
once a GN step over a solver's LM loop (jit + `lax.scan`,
visma_tpu/pipeline.py:84-116, visma_tpu/filter/msckf.py:254-305,
visma_tpu/ba/gauss_newton.py:176-194, visma_tpu/dist/sharded_ba.py:
101-121, visma_tpu/dist/pcg_ba.py:157-178, visma_tpu/ba/pose_graph.py:
94), `CallGraph` replays a whole function once a call (the reference's
jitted executors and steps, visma_tpu/semantic/cem.py:329-372, :508-551,
visma_tpu/semantic/mapper.py:760-785, visma_tpu/ba/gauss_newton.py:162,
visma_tpu/dist/sharded_ba.py:95-97).

A step is `body(state, x) -> (state, out)` over pytrees of tensors (the
port's states are registered pytree nodes). `run_eager` loops it over the
leading axis of the inputs and stacks the outputs. `StepGraph.run` does
the same through static buffers:

  * the state and one frame's inputs live in buffers made once; each frame
    the host copies its inputs in, the step reads only the buffers and ends
    by copying its new state back into the state buffers, so one graph
    serves every frame. The caller's start state is copied in, never
    aliased, and the final state handed back is a copy;
  * on a CUDA device the first `warmup` frames run eagerly on a side
    stream (they are real frames: they create the cuBLAS / cuSOLVER
    handles and workspaces and the step's cached constants outside
    capture; those constants are `utils.misc.device_constant`s, never
    freed, since every replay reads them by address), the next frame is
    captured on that stream into a private memory pool and replayed, and
    every later frame is a replay. The host
    never waits for the device: no `torch.cuda.graph` context (it
    synchronises on entry). A capture that fails raises
    `GraphCaptureError` naming the line of the port that failed; nothing
    falls back to eager work;
  * the graph is kept per shapes, dtypes and devices of the state and of a
    frame's inputs (not per sequence length), so a later run of the same
    shapes copies its start state in and replays from its first frame;
  * after each frame the host copies the step's outputs into the
    preallocated (N, ...) record;
  * a CUDA graph replays kernels without running the Python that counts
    them: the launches a capture records (`_kernels.launch_counts`) are
    taken back out of the counters and added once a replay. The same holds
    for the dicts of counters a runner is given (`counts`: a mesh's
    collectives, `dist.mesh.Mesh.counts`): a capture counts 0 in them, a
    replay what its capture counted;
  * on the CPU the same copy-in / step / copy-out runs with no capture.

`CallGraph(fn)(*inputs)` is the same machinery for `fn(*inputs) ->
outputs`: the inputs are copied into buffers made once per shapes, dtypes
and devices of the inputs; on a CUDA device `warmup` eager calls on a side
stream come first, then one capture, and each later call is one replay.
The outputs are cloned out of the graph's memory on every call: a replay
writes the same addresses again, so a caller that kept the last call's
outputs would see them change. On the CPU the call runs on the buffers
without capture and its outputs pass through static output buffers too,
so that a caller's aliasing shows there as well.
"""
from __future__ import annotations

import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from visma_tpu_torch import _kernels

_TORCH = str(Path(torch.__file__).parent)


class GraphCaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph."""


def wants_graph(graph: Optional[bool], device: torch.device) -> bool:
    """A runner's `graph` argument: None means a graph on a CUDA device and
    the eager loop on the CPU; True or False asks for one or the other (a
    graph asked for on the CPU runs `StepGraph`'s buffers without
    capture)."""
    return device.type == "cuda" if graph is None else bool(graph)


def run_eager(body: Callable, state, xs):
    """`body` over the leading axis of every input leaf of `xs`, one eager
    step a frame; returns (final state, the outputs stacked over frames)."""
    leaves, spec = pytree.tree_flatten(xs)
    outs = []
    for i in range(leaves[0].shape[0]):
        state, out = body(state, pytree.tree_unflatten(
            [x[i] for x in leaves], spec))
        outs.append(pytree.tree_flatten(out))
    stacked = [torch.stack(col) for col in zip(*(o[0] for o in outs))]
    return state, pytree.tree_unflatten(stacked, outs[0][1])


def _signature(leaves) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _take_back(counts: dict, before: dict) -> dict:
    """What `counts` counted since `before` (a copy of it), taken back out
    of it."""
    delta = {k: n - before.get(k, 0) for k, n in counts.items()}
    for k, n in delta.items():
        counts[k] -= n
    return delta


def _failed_at(exc: BaseException) -> str:
    """The innermost line outside PyTorch in the traceback of `exc`: the
    op of the step that failed."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if not f.filename.startswith(_TORCH)]
    if not frames:
        return "an unknown line"
    f = frames[-1]
    return f"{f.filename}:{f.lineno} ({f.line})"


@dataclass
class _Entry:
    """The buffers, and once captured the graph, of one run shape."""
    s_spec: object
    x_spec: object
    state: list                  # static state buffers, one a state leaf
    inputs: list                 # static buffers of one frame's inputs
    stream: Optional[torch.cuda.Stream]   # warm-ups and capture (CUDA)
    warm: int = 0                # eager frames stepped on these buffers
    graph: Optional[torch.cuda.CUDAGraph] = None
    outputs: Optional[list] = None        # the captured step's outputs
    out_spec: object = None
    launches: Optional[tuple] = None      # what a replay counts


class _Captures:
    """What the two runners share: the side stream of a run shape's
    warm-ups and capture, the capture itself, and its record."""

    def __init__(self, counts=()):
        self.counts = tuple(counts)  # dicts of counters the step adds to
        self.captures = 0            # graphs captured by this runner
        self.capture_ms = []         # host ms of each capture
        self.pool_bytes = []         # device memory each capture reserved

    @staticmethod
    def _side_stream(device: torch.device):
        """The stream of a run shape's warm-ups and capture; None on the
        CPU, where nothing is captured."""
        return torch.cuda.Stream(device) if device.type == "cuda" else None

    def _capture(self, stream, fn: Callable):
        """`fn()` captured on `stream` into a new CUDA graph, in its own
        memory pool, without making the host wait. Returns (graph, what
        fn returned, what a replay counts: `_replayed`'s argument). Raises
        `GraphCaptureError` naming the line that failed."""
        cur = torch.cuda.current_stream(stream.device)
        on_card = stream.device.type == "cuda"
        reserved = torch.cuda.memory_reserved(stream.device) if on_card else 0
        graph = torch.cuda.CUDAGraph()
        before = _kernels.launch_counts()
        before_counts = [dict(c) for c in self.counts]
        stream.wait_stream(cur)
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                out = fn()
            except Exception as exc:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass      # the capture was invalidated by `exc`
                raise GraphCaptureError(
                    f"CUDA graph capture failed at {_failed_at(exc)}: "
                    f"{type(exc).__name__}: {exc}") from exc
            finally:
                # what the Python counted launched nothing yet
                launches = (_kernels.take_back_launches(before),
                            [_take_back(c, b) for c, b in
                             zip(self.counts, before_counts)])
            try:
                graph.capture_end()
            except RuntimeError as exc:
                raise GraphCaptureError(
                    f"CUDA graph capture failed at its end: {exc}") from exc
        cur.wait_stream(stream)
        self.capture_ms.append((time.perf_counter() - t0) * 1e3)
        self.pool_bytes.append(
            torch.cuda.memory_reserved(stream.device) - reserved
            if on_card else 0)
        self.captures += 1
        return graph, out, launches

    def _replayed(self, launches) -> None:
        """Count one replay: the kernel launches and the counts its
        capture recorded."""
        kernels, counted = launches
        _kernels.add_launches(kernels)
        for c, delta in zip(self.counts, counted):
            for k, n in delta.items():
                c[k] += n

    @staticmethod
    def _on_side(stream, fn: Callable):
        """fn() without capture: on the CPU as it is, on CUDA on the side
        stream, ordered after the copies in and before the copies out."""
        if stream is None:
            return fn()
        cur = torch.cuda.current_stream(stream.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            out = fn()
        cur.wait_stream(stream)
        return out


class StepGraph(_Captures):
    """`body` run over a sequence through static buffers, captured once a
    run shape into a CUDA graph on a CUDA device (see the module)."""

    warmup = 2           # eager frames before a run shape's capture

    def __init__(self, body: Callable, counts=()):
        super().__init__(counts)
        self.body = body
        self._entries = {}

    def run(self, state, xs):
        """(final state, the step's outputs stacked over the leading axis
        of `xs`), as `run_eager(self.body, state, xs)` returns them."""
        s_leaves, s_spec = pytree.tree_flatten(state)
        x_leaves, x_spec = pytree.tree_flatten(xs)
        n = x_leaves[0].shape[0]
        if n == 0:
            raise ValueError("StepGraph.run: an empty sequence")
        key = (str(s_spec), str(x_spec), _signature(s_leaves),
               _signature([x[0] for x in x_leaves]))
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = _Entry(
                s_spec=s_spec, x_spec=x_spec,
                state=[t.clone() for t in s_leaves],
                inputs=[torch.empty_like(x[0],
                                         memory_format=torch.contiguous_format)
                        for x in x_leaves],
                stream=self._side_stream(x_leaves[0].device))
        else:
            for b, t in zip(entry.state, s_leaves):
                b.copy_(t)
        record = None
        for i in range(n):
            for b, x in zip(entry.inputs, x_leaves):
                b.copy_(x[i])
            if entry.graph is None and entry.stream is not None \
                    and entry.warm >= self.warmup:
                try:
                    entry.graph, (entry.outputs, entry.out_spec), \
                        entry.launches = self._capture(
                            entry.stream, lambda: self._step(entry))
                except GraphCaptureError:
                    del self._entries[key]
                    raise
            if entry.graph is not None:
                entry.graph.replay()
                self._replayed(entry.launches)
                outs, out_spec = entry.outputs, entry.out_spec
            else:
                entry.warm += 1
                outs, out_spec = self._on_side(entry.stream,
                                               lambda: self._step(entry))
            if record is None:
                record = [torch.empty((n, *t.shape), dtype=t.dtype,
                                      device=t.device) for t in outs]
            for r, t in zip(record, outs):
                r[i].copy_(t)
        final = pytree.tree_unflatten([b.clone() for b in entry.state],
                                      entry.s_spec)
        return final, pytree.tree_unflatten(record, out_spec)

    def _step(self, entry: _Entry):
        """One step on the static buffers: the body, then its new state
        copied into the state buffers. Returns (output leaves, spec)."""
        state = pytree.tree_unflatten(entry.state, entry.s_spec)
        new, out = self.body(state, pytree.tree_unflatten(entry.inputs,
                                                          entry.x_spec))
        new_leaves, new_spec = pytree.tree_flatten(new)
        if str(new_spec) != str(entry.s_spec) \
                or _signature(new_leaves) != _signature(entry.state):
            raise ValueError("StepGraph: the step changed the state's "
                             "structure, shapes or dtypes")
        # a leaf that shares memory with a state buffer it is not would be
        # overwritten by the copies below before it is read: copy it first
        held = {_storage(b) for b in entry.state if b.numel()}
        new_leaves = [t if t is b or _storage(t) not in held else t.clone()
                      for b, t in zip(entry.state, new_leaves)]
        out_leaves, out_spec = pytree.tree_flatten(out)
        out_leaves = [t.clone() if t.numel() and _storage(t) in held else t
                      for t in out_leaves]
        for b, t in zip(entry.state, new_leaves):
            if t is not b:
                b.copy_(t)
        return out_leaves, out_spec


@dataclass
class _CallEntry:
    """The buffers, and once captured the graph, of one input shape."""
    spec: object
    inputs: list                 # static buffers of the inputs
    stream: Optional[torch.cuda.Stream]   # warm-ups and capture (CUDA)
    warm: int = 0                # eager calls made on these buffers
    graph: Optional[torch.cuda.CUDAGraph] = None
    outputs: Optional[list] = None        # static outputs (see the module)
    out_spec: object = None
    launches: Optional[tuple] = None      # what a replay counts


class CallGraph(_Captures):
    """`fn(*inputs)` through static buffers, captured once per input shape
    into a CUDA graph on a CUDA device and replayed once a call (see the
    module). `fn` returns a tensor or a pytree of tensors."""

    warmup = 1           # eager calls before an input shape's capture

    def __init__(self, fn: Callable, counts=()):
        super().__init__(counts)
        self.fn = fn
        self._entries = {}

    def __call__(self, *inputs):
        leaves, spec = pytree.tree_flatten(inputs)
        key = (str(spec), _signature(leaves))
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = _CallEntry(
                spec=spec,
                inputs=[torch.empty_like(t,
                                         memory_format=torch.contiguous_format)
                        for t in leaves],
                stream=self._side_stream(leaves[0].device))
        for b, t in zip(entry.inputs, leaves):
            b.copy_(t)
        if entry.graph is None and entry.stream is not None \
                and entry.warm >= self.warmup:
            try:
                entry.graph, (entry.outputs, entry.out_spec), \
                    entry.launches = self._capture(
                        entry.stream, lambda: self._call(entry))
            except GraphCaptureError:
                del self._entries[key]
                raise
        if entry.graph is not None:
            entry.graph.replay()
            self._replayed(entry.launches)
        else:
            entry.warm += 1
            outs, out_spec = self._on_side(entry.stream,
                                           lambda: self._call(entry))
            if entry.outputs is None:
                entry.outputs = [torch.empty_like(t) for t in outs]
                entry.out_spec = out_spec
            for b, t in zip(entry.outputs, outs):
                b.copy_(t)
        return pytree.tree_unflatten([t.clone() for t in entry.outputs],
                                     entry.out_spec)

    def _call(self, entry: _CallEntry):
        """fn on the static input buffers. Returns (output leaves, spec)."""
        return pytree.tree_flatten(
            self.fn(*pytree.tree_unflatten(entry.inputs, entry.spec)))
