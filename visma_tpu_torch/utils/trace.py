"""Device traces that keep their first kernels.

torch.profiler drops the first device records of a trace once a process
has run for a while (none in a fresh process; on an H100, late in a long
process, 23 of a traced call's first 154 kernels). A trace begun on the
work it measures then loses that work's first kernels, and a busy time or
an op count read from it comes out short. `traced(fn)` therefore runs an
untraced warm call first, then a marker kernel, and keeps only what the
host launched after the marker's launch (the records' correlation ids tie
each device operation to its launch); a trace that lost its marker
raises.

It also counts the host's calls that put work on the device after the
marker's launch (the profiler's CUDA activity records the runtime's
calls): each kernel launch, copy and set is one device operation, and each replay of a
`utils.graphs` runner's graph runs the operations its capture recorded
(`graphs.replayed()`). `Trace.check` holds the traced operations to that
count, exactly; a launch of another graph makes it a lower bound. The
profiler has lost records inside a trace (on an H100, once a process
had run the two-stage pipeline's streams: up to 540 of 80,303 a take,
with selection by the clock), so `traced` takes a trace that fails the
check again, up to `takes` times, and keeps the failed takes' counts in
`Trace.lost`.

Only the CUDA activity is traced unless `cpu=True` asks for the host's
ops and ranges too, which slows an eager run under the profiler about
twice (a 64-frame eager VIO run on an H100's host: 5.8 s against 3.1 s).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from visma_tpu_torch.utils.graphs import replayed

MARK = "spin_kernel"                  # torch.cuda._sleep's kernel
# the host's calls that queue exactly one device operation each
LAUNCH_API = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")
GRAPH_API = ("cudaGraphLaunch", "cuGraphLaunch")


@dataclass
class Trace:
    """The device operations of one traced call and the host's count."""
    ops: list                   # (name, start us, end us), in start order
    host_launches: int          # kernel launches, copies and sets issued
    graph_launches: int         # CUDA graph launches issued
    replays: int = 0            # of them, `utils.graphs` runners' replays
    replay_ops: int = 0         # the device operations those replays ran
    host_events: list = field(default_factory=list)   # (name, start us,
    # end us) of the host's events after the marker: the runtime's calls,
    # and with cpu=True the ops and `record_function` ranges
    lost: list = field(default_factory=list)   # earlier takes' check lines

    def spans(self) -> list:
        """(start, end) of every operation that took time, in us."""
        return [(a, b) for _, a, b in self.ops if b > a]

    def busy_ms(self):
        """(the union of the operations' intervals, their sum) in ms; the
        union counts time two streams overlap once. (None, None) for an
        empty trace."""
        spans = self.spans()
        if not spans:
            return None, None
        union, total, lo, hi = 0.0, 0.0, *spans[0]
        for a, b in spans:
            total += b - a
            if a > hi:
                union += hi - lo
                lo, hi = a, b
            else:
                hi = max(hi, b)
        return (union + hi - lo) / 1e3, total / 1e3

    def check(self) -> str:
        """Raise unless the traced operations match the host's count;
        returns the two counts as a line."""
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

    def top(self, k: int = 15) -> list:
        """The k device operations with the most time: (name, total us,
        count)."""
        return _top(self.ops, k)

    def host_ms(self, names) -> dict:
        """{name: total ms} of the host events named in `names` (e.g. the
        `record_function` ranges of a cpu=True trace)."""
        out = {}
        for name, a, b in self.host_events:
            if name in names:
                out[name] = out.get(name, 0.0) + (b - a) / 1e3
        return out

    def host_top(self, k: int = 15) -> list:
        """The k host events with the most time, nested time included:
        (name, total us, count)."""
        return _top(self.host_events, k)


def _top(events, k: int) -> list:
    acc = {}
    for name, a, b in events:
        us, c = acc.get(name, (0.0, 0))
        acc[name] = (us + b - a, c + 1)
    return sorted(((n, us, c) for n, (us, c) in acc.items()),
                  key=lambda r: -r[1])[:k]


def traced(fn: Callable, warm: Optional[Callable] = None,
           annotations=(), cpu: bool = False, takes: int = 3) -> Trace:
    """Trace fn() on the card behind `warm()` (fn itself by default) and a
    marker kernel, held to the host's count (see the module); raises when
    `takes` traces in a row fail the check. `annotations`: the names of
    `record_function` ranges inside fn, which the trace also projects onto
    the device and which are not operations. `cpu`: trace the host's ops
    and ranges as well."""
    lost = []
    while True:
        trace = _trace(fn, warm, annotations, cpu)
        try:
            trace.check()
        except RuntimeError as exc:
            lost.append(str(exc))
            if len(lost) == takes:
                raise RuntimeError(f"{takes} takes: {lost}") from exc
            continue
        trace.lost = lost
        return trace


def _trace(fn, warm, annotations, cpu) -> Trace:
    """One take of `traced`. fn's host events are those after the marker's
    launch on the host clock; its device operations are those the host
    events launched (the records' correlation ids: a graph launch's id is
    on every operation it runs), so that no clock offset between the
    device's records and the host's moves work across the marker. Reads
    the profiler's raw events (the tree of `prof.events()` costs the host
    about 80 times as much)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        (warm or fn)()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        before = replayed()
        fn()
        torch.cuda.synchronize()
        after_fn = replayed()
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3,
               e.correlation_id())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and row[0] not in annotations:
                device.append(row)
        elif e.device_type() == DeviceType.CPU:
            host.append(row)
    marks = {r[3] for r in device if MARK in r[0]}
    launch = [r for r in host if r[3] in marks and r[0].startswith(LAUNCH_API)]
    if not launch:
        raise RuntimeError("the trace lost its marker kernel")
    after = max(r[2] for r in launch)
    host = sorted((r for r in host if r[1] > after), key=lambda r: r[1])
    # the launches' ids (a cpu=True trace's ops carry ids of their own)
    mine = {r[3] for r in host if r[0].startswith(LAUNCH_API + GRAPH_API)}
    ops = sorted((r[:3] for r in device if r[3] in mine), key=lambda r: r[1])
    return Trace(
        ops=ops,
        host_launches=sum(r[0].startswith(LAUNCH_API) for r in host),
        graph_launches=sum(r[0].startswith(GRAPH_API) for r in host),
        replays=after_fn["graphs"] - before["graphs"],
        replay_ops=after_fn["ops"] - before["ops"],
        host_events=[r[:3] for r in host])
