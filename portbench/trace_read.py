"""Reading a traced window from torch.profiler.

A frozen copy, at 43be5d3, of the reading in visma_tpu_torch/utils/trace.py
(`traced`, `_trace`, `Trace.check`, `busy_ms`): an untraced warm call, then
a marker kernel, and only what the host launched after the marker's launch
is kept, the records' correlation ids tying each device operation to its
launch. The traced device operations are held to the host's count of
launches, copies, sets and the operations the program's graph replays ran
(`visma_tpu_torch.utils.graphs.replayed`, a counter of the program); a take
that lost records is taken again, up to three times.

Beside the copy: the spans the benchmark opens around its calls into the
program (`Spans`), on the host's clock, placed on the trace's clock by the
marker's launch, so that each idle gap of the device can be named by what
the host was doing. Only the device's activity and the CUDA runtime's calls
are traced: recording the host's PyTorch ops as well slowed a graphed VIO
frame from about 2.2 to 3.9 ms on an H100's host.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

MARK = "spin_kernel"                  # torch.cuda._sleep's kernel
LAUNCH_API = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")
GRAPH_API = ("cudaGraphLaunch", "cuGraphLaunch")


class Spans:
    """(name, start ns, end ns) of the benchmark's calls into the program,
    on `time.perf_counter_ns`, kept while `on`."""

    def __init__(self):
        self.on = False
        self.rows = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.rows.append((name, t0, time.perf_counter_ns()))


@dataclass
class Window:
    """One traced window: its device operations and the host's counts."""
    ops: list                   # (name, start us, end us), in start order
    host_launches: int          # kernel launches, copies and sets issued
    graph_launches: int         # CUDA graph launches issued
    replays: int                # of them, the program's graph replays
    replay_ops: int             # the device operations those replays ran
    spans: list                 # (name, start us, end us) of the spans
    window_s: float             # host clock around the traced call
    plain_s: float              # the same call untraced, just before
    mark_end: float             # the marker kernel's end on the device, us
    lost: list = field(default_factory=list)

    def check(self) -> str:
        n, host, g = len(self.ops), self.host_launches, self.graph_launches
        line = (f"{n} device ops traced, the host issued {host} launches, "
                f"copies and sets and {g} graph launches")
        if g == self.replays:
            line += f" of {self.replay_ops} device ops"
            lost = n != host + self.replay_ops
        else:
            lost = n < host + g
        if lost:
            raise RuntimeError(f"the trace lost device records: {line}")
        return line

    def intervals(self) -> list:
        """The union of the operations' intervals, merged, in us."""
        merged = []
        for _, a, b in self.ops:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) / 1e6

    def span_s(self) -> float:
        """The device's span of the traced call: from the marker kernel's
        end to the end of the last operation."""
        if not self.ops:
            return 0.0
        return (max(b for _, _, b in self.ops) - self.mark_end) / 1e6

    def device_ops(self, k: int = 10) -> list:
        """[name, seconds] of the k operations with the most device time."""
        acc = {}
        for name, a, b in self.ops:
            acc[name] = acc.get(name, 0.0) + (b - a) / 1e6
        return [[n, s] for n, s in sorted(acc.items(),
                                          key=lambda r: -r[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """[span, seconds] of the k longest gaps between device work, each
        named by the innermost benchmark span open at its middle."""
        iv = self.intervals()
        gaps = [(b0, a1) for (_, b0), (a1, _) in zip(iv, iv[1:]) if a1 > b0]
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            mid = 0.5 * (a + b)
            inside = [s for s in self.spans if s[1] <= mid <= s[2]]
            name = (min(inside, key=lambda s: s[2] - s[1])[0]
                    if inside else "outside")
            out.append([name, (b - a) / 1e6])
        return out


TAKES = 3                             # takes before a lost trace raises


def traced(fn, spans: Spans) -> Window:
    """Trace fn() behind an untraced and a traced warm call of it and a
    marker kernel, held to the host's count; raises when TAKES takes in a
    row lost records. `spans` records fn's spans."""
    lost = []
    while True:
        w = _trace(fn, spans)
        try:
            w.check()
        except RuntimeError as exc:
            lost.append(str(exc))
            if len(lost) == TAKES:
                raise RuntimeError(f"{TAKES} takes: {lost}") from exc
            continue
        w.lost = lost
        return w


def _trace(fn, spans: Spans) -> Window:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from visma_tpu_torch.utils.graphs import replayed

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        mark_ns = time.perf_counter_ns()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        before = replayed()
        spans.rows, spans.on = [], True
        t0 = time.perf_counter()
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            spans.on = False
        window_s = time.perf_counter() - t0
        after_fn = replayed()
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3,
               e.correlation_id())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append(row)
        elif e.device_type() == DeviceType.CPU:
            host.append(row)
    marks = {r[3] for r in device if MARK in r[0]}
    mark_end = max((r[2] for r in device if r[3] in marks), default=0.0)
    launch = [r for r in host if r[3] in marks and r[0].startswith(LAUNCH_API)]
    if not launch:
        raise RuntimeError("the trace lost its marker kernel")
    after = max(r[2] for r in launch)
    # the marker's launch began about when the host's clock read mark_ns
    shift = min(r[1] for r in launch) - mark_ns / 1e3
    host = sorted((r for r in host if r[1] > after), key=lambda r: r[1])
    mine = {r[3] for r in host if r[0].startswith(LAUNCH_API + GRAPH_API)}
    ops = sorted((r[:3] for r in device if r[3] in mine), key=lambda r: r[1])
    return Window(
        ops=ops,
        host_launches=sum(r[0].startswith(LAUNCH_API) for r in host),
        graph_launches=sum(r[0].startswith(GRAPH_API) for r in host),
        replays=after_fn["graphs"] - before["graphs"],
        replay_ops=after_fn["ops"] - before["ops"],
        spans=[(n, a / 1e3 + shift, b / 1e3 + shift)
               for n, a, b in spans.rows],
        window_s=window_s, plain_s=plain_s, mark_end=mark_end)
