"""Cross-stage pipeline parallelism: the frontend as one stage, the filter
as another (port of visma_tpu/dist/pipeline_pp.py).

The sequence is cut into chunks; the frontend stage (pyramid + KLT +
detection, the image-heavy half) runs a chunk and emits the small (ids,
xp, valid) feature tables; the filter stage (IMU propagation + EKF
update) consumes them. The host issues frontend(c+1) before filter(c), so
the two stages of neighbouring chunks can overlap:

  * on one CUDA device (one card) the stages run on two streams of it: a
    CUDA event recorded after each frontend chunk is what the filter's
    stream waits on, and every tensor that crosses streams is marked with
    `record_stream` for the caching allocator;
  * on two devices each stage's state lives on its own device and the
    feature tables cross with non-blocking copies;
  * on the CPU the stages run one after the other, in the same order.

Each stage is the reference's jit + scan over a chunk (pipeline_pp.py:
49-74): on a CUDA device a `utils.graphs.StepGraph` made once per
pipeline, captured once a frame shape (so the last, shorter chunk replays
the same graph) and replayed once a frame on its stage's stream;
`graph=False` loops each stage eagerly (`run_eager`). The stacked
records and final states a stage's runner hands back are marked for the
other stream like the eager loop's tensors. Nothing in `run` reads back
to the host. The stage boundary changes placement and ordering, not the
math: the result equals `VioPipeline.run` on the same inputs
(tests/test_torch_pp.py; on the card, bit for bit in `chip_smoke.py`).
"""
from __future__ import annotations

import contextlib

import torch

from visma_tpu_torch.filter.config import FilterConfig
from visma_tpu_torch.filter.msckf import _frame_step
from visma_tpu_torch.filter.state import init_state
from visma_tpu_torch.frontend.tracker import FeatureTracker
from visma_tpu_torch.utils.graphs import StepGraph, run_eager, wants_graph
from visma_tpu_torch.utils.misc import (finite_tree, resolve_device,
                                        tree_leaves)

_FEATS = ("ids", "xp", "valid")


def _mark(x, stream) -> None:
    """Tell the caching allocator that `stream` uses every CUDA tensor of
    x on the stream's device, so its memory is not reused before the
    stream is done with it."""
    if stream is None:
        return
    for t in tree_leaves(x):
        if isinstance(t, torch.Tensor) and t.device == stream.device:
            t.record_stream(stream)


def _on(stream):
    return torch.cuda.stream(stream) if stream is not None \
        else contextlib.nullcontext()


class TwoStagePipeline:
    """VioPipeline split at the frontend/filter seam."""

    def __init__(self, cfg: FilterConfig, dev_frontend, dev_filter,
                 levels: int = 3, cell: int = 16, klt_radius: int = 5,
                 chunk: int = 32, fused_klt: bool = None,
                 graph: bool = None):
        """fused_klt: as `VioPipeline`'s (None or True: the fused LK path;
        False: the windowed tracker, the JAX package's default off the
        TPU). graph: as `VioPipeline`'s, for each stage on its device
        (None: a replayed `StepGraph` on a CUDA device, the eager loop on
        the CPU; False: the eager loops; True: the graphs' static buffers,
        on the CPU without capture)."""
        self.cfg = cfg
        self.dev_a = resolve_device(dev_frontend)
        self.dev_b = resolve_device(dev_filter)
        self.chunk = chunk
        self.tracker = FeatureTracker(max_features=cfg.max_tracks,
                                      levels=levels, radius=klt_radius,
                                      cell=cell, fused=fused_klt, graph=graph)
        self.frontend_graph = (StepGraph(self._frontend_body)
                               if wants_graph(graph, self.dev_a) else None)
        self.filter_graph = (StepGraph(self._filter_body)
                             if wants_graph(graph, self.dev_b) else None)

    def init(self, image0, R0=None, p0=None, v0=None):
        tr = self.tracker.init(torch.as_tensor(image0, dtype=torch.float32,
                                               device=self.dev_a))
        fs = init_state(self.cfg, R0=R0, p0=p0, v0=v0, device=self.dev_b)
        return tr, fs

    def _frontend_body(self, tr, image):
        """The frontend's step: the tracker (its `_step_impl`: a graphed
        `step` would nest a capture) -> the frame's feature table."""
        tr, *obs = self.tracker._step_impl(tr, image)
        return tr, dict(zip(_FEATS, obs))

    def _filter_body(self, fs, frame):
        fs = _frame_step(self.cfg, fs, frame)
        return fs, {"R": fs.R, "p": fs.p,
                    "healthy": finite_tree((fs.R, fs.p, fs.v, fs.bg, fs.ba,
                                            fs.P))}

    def _frontend_chunk(self, tr, images):
        """The tracker over a chunk -> per-frame feature tables, stacked."""
        if self.frontend_graph is None:
            return run_eager(self._frontend_body, tr, images)
        return self.frontend_graph.run(tr, images)

    def _filter_chunk(self, fs, feats, gyro, accel, dts):
        frames = {"gyro": gyro, "accel": accel, "dts": dts,
                  **{k: feats[k] for k in _FEATS}}
        if self.filter_graph is None:
            return run_eager(self._filter_body, fs, frames)
        return self.filter_graph.run(fs, frames)

    def _stream(self, dev):
        return torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def run(self, tr_state, f_state, images, gyro, accel, dts):
        """Chunk-pipelined run. images (N,H,W); gyro/accel (N,S,3);
        dts (N,S): arrays or tensors (a tensor already on its stage's
        device is not copied). Returns (tr_state, f_state, outs {R, p,
        healthy})."""
        a, b = self.dev_a, self.dev_b
        sa, sb = self._stream(a), self._stream(b)
        # the side streams start after the work that made the inputs
        for s, dev in ((sa, a), (sb, b)):
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(dev))
        _mark((tr_state, images), sa)
        _mark((f_state, gyro, accel, dts), sb)

        def f32(x, dev):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        N = images.shape[0]
        C = self.chunk
        starts = list(range(0, N, C))
        feats_q = []  # frontend outputs in flight
        outs = []

        def submit_frontend(lo):
            nonlocal tr_state
            hi = min(lo + C, N)
            with _on(sa):
                tr_state, feats = self._frontend_chunk(
                    tr_state, f32(images[lo:hi], a))
                ev = None
                if sa is not None:
                    ev = torch.cuda.Event()
                    ev.record(sa)
            feats_q.append((lo, hi, feats, ev))

        # prime the pipeline: frontend(chunk 0) in flight before the
        # filter consumes anything; from then on frontend(c+1) is issued
        # before filter(c)
        submit_frontend(0)
        for idx in range(len(starts)):
            if idx + 1 < len(starts):
                submit_frontend(starts[idx + 1])
            lo, hi, feats, ev = feats_q.pop(0)
            with _on(sb):
                feats = self._to_filter(feats, ev, sb)
                f_state, out = self._filter_chunk(
                    f_state, feats, f32(gyro[lo:hi], b),
                    f32(accel[lo:hi], b), f32(dts[lo:hi], b))
            outs.append(out)

        # hand everything back to the caller's streams
        for s, dev in ((sa, a), (sb, b)):
            if s is not None:
                cur = torch.cuda.current_stream(dev)
                cur.wait_stream(s)
                _mark((tr_state, f_state, outs), cur)
        merged = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        return tr_state, f_state, merged

    def _to_filter(self, feats, ev, sb):
        """The frontend chunk's tables, ready for the filter's stream."""
        if self.dev_a == self.dev_b:
            if sb is not None:
                sb.wait_event(ev)
                _mark(feats, sb)
            return feats
        if ev is not None:
            # a copy out of a CUDA device runs on that device's current
            # stream: order it after the frontend chunk
            copy_stream = torch.cuda.current_stream(self.dev_a)
            copy_stream.wait_event(ev)
            _mark(feats, copy_stream)
        return {k: v.to(self.dev_b, non_blocking=self.dev_b.type == "cuda")
                for k, v in feats.items()}
