"""Full VIO pipeline: images + IMU -> trajectory (port of
visma_tpu/pipeline.py).

One step per frame: pyramid, pyramidal LK (fused, kernel lk_track, unless
`fused_klt=False` asks for the windowed tracker), corner detection and
replenishment (kernel corner_score), then the MSCKF frame step. The frames
are undistorted already (image.undistort, kernel bilinear_remap). `run`
steps over a device-staged sequence: on a CUDA device it captures the step
into one CUDA graph and replays it once a frame (`utils.graphs.StepGraph`,
the counterpart of the reference's jit + scan); `graph=False` asks for the
eager loop. Nothing in a step reads a value back to the host, so the GPU
is fed without waiting. `step` stays eager: the reference jits it call by
call, and a graph there would need static state buffers that the caller
owns.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from visma_tpu_torch.filter.config import FilterConfig
from visma_tpu_torch.filter.msckf import Msckf, _frame_outputs, _frame_step
from visma_tpu_torch.filter.state import FilterState, register_pytree
from visma_tpu_torch.frontend.tracker import FeatureTracker, TrackerState
from visma_tpu_torch.utils.graphs import StepGraph, run_eager, wants_graph
from visma_tpu_torch.utils.misc import resolve_device


@dataclass(frozen=True)
class PipelineState:
    tracker: TrackerState
    filter: FilterState


register_pytree(PipelineState)


class VioPipeline:
    def __init__(self, cfg: FilterConfig, levels: int = 3, cell: int = 16,
                 klt_radius: int = 5, fused_klt: bool = None, device=None,
                 graph: bool = None):
        """graph: None replays `run`'s step from a CUDA graph on a CUDA
        device and loops it eagerly on the CPU; False always loops
        eagerly; True always goes through `StepGraph`'s static buffers
        (on the CPU without capture)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tracker = FeatureTracker(max_features=cfg.max_tracks,
                                      levels=levels, radius=klt_radius,
                                      cell=cell, fused=fused_klt)
        self.msckf = Msckf(cfg, device=self.device, graph=graph)
        self.run_graph = (StepGraph(self._run_step)
                          if wants_graph(graph, self.device) else None)

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def init(self, image0, R0=None, p0=None, v0=None) -> PipelineState:
        tr = self.tracker.init(self._tensor(image0))
        fs = self.msckf.init(R0=R0, p0=p0, v0=v0)
        return PipelineState(tracker=tr, filter=fs)

    def step_full(self, state: PipelineState, image, gyro, accel, dts):
        """Per-frame step; also returns the tracker's raw (ids, xp, valid)
        observations. The two stages are profiler ranges named `frontend`
        and `filter` (visma_tpu_torch/profile_pipeline.py reads them)."""
        with record_function("frontend"):
            tr_state, ids, xp, valid = self.tracker.step(state.tracker,
                                                         self._tensor(image))
        with record_function("filter"):
            frame = {"gyro": self._tensor(gyro), "accel": self._tensor(accel),
                     "dts": self._tensor(dts), "ids": ids, "xp": xp,
                     "valid": valid}
            f_state = _frame_step(self.cfg, state.filter, frame)
        return PipelineState(tracker=tr_state, filter=f_state), \
            (ids, xp, valid)

    def step(self, state: PipelineState, image, gyro, accel, dts
             ) -> PipelineState:
        """image (H, W) f32 grayscale (undistorted); gyro/accel (S, 3);
        dts (S,) with 0-padding."""
        return self.step_full(state, image, gyro, accel, dts)[0]

    def pose(self, state: PipelineState) -> Tuple[np.ndarray, np.ndarray]:
        return state.filter.R.cpu().numpy(), state.filter.p.cpu().numpy()

    def _run_step(self, state: PipelineState, x: Dict[str, torch.Tensor]):
        """`run`'s step: the frame step, the `_frame_outputs` record and the
        tracker's observations (the reference's `scan_fn`,
        pipeline.py:101-108)."""
        state, (ids, xp, valid) = self.step_full(
            state, x["image"], x["gyro"], x["accel"], x["dts"])
        out = _frame_outputs(self.cfg, state.filter)
        out.update({"obs_ids": ids, "obs_xp": xp, "obs_valid": valid})
        return state, out

    def run(self, state: PipelineState, images, gyro, accel, dts):
        """Run over a sequence: images (N, H, W); gyro/accel (N, S, 3);
        dts (N, S). Returns (final state, outputs): the `_frame_outputs`
        record per frame plus the tracker's observations obs_ids (N, F),
        obs_xp (N, F, 2), obs_valid (N, F), each stacked over frames.
        `state` is not modified."""
        xs = {"image": self._tensor(images), "gyro": self._tensor(gyro),
              "accel": self._tensor(accel), "dts": self._tensor(dts)}
        if self.run_graph is None:
            return run_eager(self._run_step, state, xs)
        return self.run_graph.run(state, xs)


def export_packets(cfg: FilterConfig, outs: Dict[str, torch.Tensor],
                   ts: np.ndarray):
    """Convert Msckf.run / VioPipeline.run outputs into vlslam Packets with
    the reference wire conventions (pipeline.py:121-149): row-major 3x4 gwc,
    zero wg, Feature.xp the track's last observed pixel."""
    from visma_tpu_torch.proto import Feature, FeatureStatus, Packet

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    R, p = host(outs["R"]), host(outs["p"])
    all_ids, all_status = host(outs["feat_ids"]), host(outs["feat_status"])
    all_xw, all_xp = host(outs["feat_xw"]), host(outs["feat_xp"])
    packets = []
    for i in range(len(ts)):
        gwc = np.concatenate([R[i], p[i][:, None]], axis=1)
        ids = all_ids[i]
        feats = [Feature(id=int(ids[k]),
                         status=FeatureStatus(int(all_status[i][k])),
                         xp=all_xp[i][k].astype(np.float64),
                         xw=all_xw[i][k].astype(np.float64))
                 for k in np.nonzero(ids >= 0)[0]]
        packets.append(Packet(ts=float(ts[i]), gwc=gwc.reshape(-1),
                              features=feats, wg=np.zeros(2)))
    return packets
