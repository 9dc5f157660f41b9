"""Named-event profiler (port of visma_tpu/utils/timer.py; reference parity:
feh::Timer, core/utils.h:45-129).

Tick/Tock pairs accumulate per-event durations; printing reports the
average per event like the reference's operator<<. For the GPU runtime:
`tock(block_on=tensor)` synchronises the tensor's CUDA device before the
clock stops (PyTorch returns before the device finishes, so the host clock
would otherwise measure the enqueue), and `device_trace` is a
`torch.profiler` scope.
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional

import torch


class Timer:
    def __init__(self, name: str = "timer"):
        self.name = name
        self._start: Dict[str, float] = {}
        self._total = defaultdict(float)
        self._count = defaultdict(int)

    def tick(self, event: str) -> None:
        self._start[event] = time.perf_counter()

    def tock(self, event: str, block_on=None) -> float:
        """Stop the clock for `event`; if `block_on` is a CUDA tensor, wait
        for its device first."""
        if isinstance(block_on, torch.Tensor) and block_on.is_cuda:
            torch.cuda.synchronize(block_on.device)
        dt = time.perf_counter() - self._start[event]
        self._total[event] += dt
        self._count[event] += 1
        return dt

    @contextmanager
    def scope(self, event: str):
        self.tick(event)
        try:
            yield
        finally:
            self.tock(event)

    def mean_ms(self, event: str) -> float:
        """Average milliseconds per occurrence (LookUp parity)."""
        n = self._count[event]
        return (self._total[event] / n * 1e3) if n else 0.0

    def report(self) -> Dict[str, Dict[str, float]]:
        return {e: {"mean_ms": self.mean_ms(e), "count": self._count[e],
                    "total_s": self._total[e]}
                for e in self._total}

    def __str__(self) -> str:
        lines = [f"=== {self.name} ==="]
        for e in sorted(self._total):
            lines.append(f"{e:<30s} {self.mean_ms(e):10.3f} ms "
                         f"x{self._count[e]}")
        return "\n".join(lines)


@contextmanager
def device_trace(logdir: Optional[str] = None):
    """torch.profiler scope: CPU and, where there is a card, CUDA
    activities; writes `logdir/trace.json` (Chrome trace format) on exit,
    the program's spans (`utils.trace`) among its ranges. With logdir=None
    it does nothing."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from visma_tpu_torch.utils import trace

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    trace.ranges(True)
    try:
        with profile(activities=acts) as prof:
            yield
    finally:
        trace.ranges(False)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
