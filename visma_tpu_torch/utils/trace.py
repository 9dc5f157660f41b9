"""The port's tracing: host spans, stage marks on the device, and device
traces that keep their first kernels.

**Spans and stages.** `span(name)` records a host span (name, start ns,
end ns) on `time.perf_counter_ns` into `rows`, a buffer of the newest
`ROWS` spans. It records only while a torch profiler is active or after
`enable()`; off, a span costs one flag test and returns a shared null
context (nothing allocated, nothing appended). After `ranges(True)`, as
`utils.timer.device_trace` asks for its Chrome trace, a span under an
active profiler also opens `record_function(name)`, so that the trace
keeps named ranges; by default it does not: with the ranges, one of four
CUDA-only traces of 239 online VIO steps on an H100 lost 1-2% of its
device records in each of three takes (none of four without them). While
recording, the interpreter's garbage collections are spans too:
`host.gc`.

`stage(name, device)` is a span that, while recording on a CUDA device,
also puts a begin mark and an end mark on the current stream: a
do-nothing kernel whose device function names the mark's id
(`csrc/stage_mark.cu`, `stage_mark<id>`; `MARKS` maps an id to its stage
and end). A stage entered inside a CUDA graph capture captures its marks
as kernel nodes, so every replay runs them; the graph runtime
(`utils.graphs`) therefore captures a marked variant of a graph once
recording is on and keeps the graph captured off node for node as it
was. On the CPU, and off, nothing is launched.

The spans of the port, and the stages (`STAGES`):

  vio.init, vio.run, vio.step, vio.pose     pipeline.py
  vio.undistort                             image/remap.py (K6's call)
  msckf.run_batched                         filter/msckf.py
  semantic.step, .dedup, .spawn, .retrieve, .refine, .readback
                                            semantic/mapper.py
  graph.copy_in, graph.launch, graph.copy_out, graph.capture
                                            utils/graphs.py
  host.gc                                   the garbage collector
  stages frontend, filter                   VioPipeline.step_full,
                                            Msckf's batched step
  stages cem.edt, cem.occluders, cem.raster, cem.score, cem.select
                                            semantic/cem.py
  stage retrieve (a retrieval's device work) semantic/cem.py

**Device traces.** torch.profiler drops the first device records of a
trace once a process has run for a while (none in a fresh process; on an
H100, late in a long process, 23 of a traced call's first 154 kernels). A
trace begun on the work it measures then loses that work's first
kernels, and a busy time or an op count read from it comes out short.
`traced(fn)` therefore runs an untraced warm call first, then a marker
kernel, and keeps only what the host launched after the marker's launch
(the records' correlation ids tie each device operation to its launch); a
trace that lost its marker raises. The program's spans of the traced call
are placed on the trace's clock by the marker's launch, and the stage
marks among its operations split its device time by stage
(`Trace.stages`); `Trace.idle_by_span` names each idle gap of the device
by the innermost span open on the host.

It also counts the host's calls that put work on the device after the
marker's launch (the profiler's CUDA activity records the runtime's
calls): each kernel launch, copy and set is one device operation, and
each replay of a `utils.graphs` runner's graph runs the operations its
capture recorded (`graphs.replayed()`). `Trace.check` holds the traced
operations to that count, exactly; a launch of another graph makes it a
lower bound. The profiler has lost records inside a trace (on an H100,
once a process had run the two-stage pipeline's streams: up to 540 of
80,303 a take, with selection by the clock), so `traced` takes a trace
that fails the check again, up to `takes` times, and keeps the failed
takes' counts in `Trace.lost`. Only the CUDA activity is traced.
"""
from __future__ import annotations

import collections
import gc
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
from torch.autograd import profiler as _prof

ROWS = 1 << 17                         # spans kept, the newest
rows = collections.deque(maxlen=ROWS)  # (name, start ns, end ns)

STAGES = ("frontend", "filter", "cem.edt", "cem.occluders", "cem.raster",
          "cem.score", "cem.select", "retrieve")
_STAGE_ID = {name: i for i, name in enumerate(STAGES)}
# mark id -> (stage, "begin" or "end"): stage i begins with 2i, ends 2i+1
MARKS = {2 * i + end: (name, ("begin", "end")[end])
         for i, name in enumerate(STAGES) for end in (0, 1)}
MARK_KERNEL = re.compile(r"stage_mark<(\d+)>")

_enabled = False
_ranges = False


def ranges(on: bool) -> None:
    """Whether a span under an active profiler also opens a
    `record_function` range of its name (for a Chrome trace)."""
    global _ranges
    _ranges = bool(on)


def enable() -> None:
    """Record spans (and stage marks) without a profiler: for tools and
    operators that time the program with its spans on."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def recording() -> bool:
    """Whether spans record now: a torch profiler is active, or
    `enable()` was called."""
    return _enabled or _prof._is_profiler_enabled


class _Off:
    """The null context a span is while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_armed = False                  # _gc_event is in gc.callbacks
_gc_start: Optional[int] = None


def _gc_event(phase: str, info: dict) -> None:
    """gc.callbacks hook: a collection while recording is a host.gc span."""
    global _gc_start
    if phase == "start":
        _gc_start = time.perf_counter_ns() if recording() else None
    elif _gc_start is not None:
        rows.append(("host.gc", _gc_start, time.perf_counter_ns()))
        _gc_start = None


class _Span:
    __slots__ = ("name", "start", "ranged")

    def __init__(self, name: str):
        global _armed
        self.name = name
        self.ranged = None
        if not _armed:
            gc.callbacks.append(_gc_event)
            _armed = True

    def __enter__(self):
        if _ranges and _prof._is_profiler_enabled:
            self.ranged = _prof.record_function(self.name)
            self.ranged.__enter__()
        self.start = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        rows.append((self.name, self.start, time.perf_counter_ns()))
        if self.ranged is not None:
            self.ranged.__exit__(*exc)
        return False


def span(name: str):
    """`with span(name):` records a host span while recording is on."""
    if not (_enabled or _prof._is_profiler_enabled):
        return _OFF
    return _Span(name)


class _Stage(_Span):
    __slots__ = ("begin", "device")

    def __init__(self, name: str, device: torch.device):
        super().__init__(name)
        self.begin = 2 * _STAGE_ID[name] if device.type == "cuda" else None
        self.device = device

    def __enter__(self):
        super().__enter__()
        if self.begin is not None:
            _launch_mark(self.begin, self.device)

    def __exit__(self, *exc):
        if self.begin is not None:
            _launch_mark(self.begin + 1, self.device)
        return super().__exit__(*exc)


def stage(name: str, device: torch.device):
    """`with stage(name, device):` a span that, while recording on a CUDA
    device, also puts a begin and an end mark on the current stream (see
    the module). `name` is one of `STAGES`."""
    if not (_enabled or _prof._is_profiler_enabled):
        return _OFF
    return _Stage(name, device)


def _launch_mark(mark: int, device: torch.device) -> None:
    from visma_tpu_torch import _kernels

    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    _kernels.check(_kernels.library().vt_stage_mark(
        mark, torch._C._cuda_getCurrentRawStream(index)), "stage_mark")


_loaded = False


def prepare(device: torch.device) -> None:
    """Load the marks' device functions before a capture that records
    them (a function first loaded inside a capture could fail it)."""
    global _loaded
    if _loaded or device.type != "cuda":
        return
    from visma_tpu_torch import _kernels

    _kernels.check(_kernels.library().vt_stage_mark_load(),
                   "stage_mark_load")
    _loaded = True


def span_totals(since_ns: int) -> list:
    """(name, total ms, count) of the spans recorded since `since_ns` on
    `time.perf_counter_ns`, most time first, nested time included."""
    return [(n, us / 1e3, c) for n, us, c in _top(
        [(n, a / 1e3, b / 1e3) for n, a, b in rows if a > since_ns], None)]


def off_against_on(fn: Callable, pairs: int = 8) -> dict:
    """{False: [...], True: [...]}: host seconds of fn(), the device
    drained before and after, with recording off and with `enable()`, in
    `pairs` pairs whose first call alternates (what recording costs when
    it is on; `span_totals` reads the spans the calls with recording on
    left). Recording is left off."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    out = {False: [], True: []}
    try:
        for k in range(pairs):
            for on in ((False, True) if k % 2 == 0 else (True, False)):
                (enable if on else disable)()
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                out[on].append(time.perf_counter() - t0)
    finally:
        disable()
    return out


# ------------------------------------------------------------ device traces

MARK = "spin_kernel"                  # torch.cuda._sleep's kernel
# the host's calls that queue exactly one device operation each
LAUNCH_API = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")
GRAPH_API = ("cudaGraphLaunch", "cuGraphLaunch")


def _segments(ops):
    """(stage, the operations between its begin and end mark) of every
    stage segment among `ops` ((name, start us, end us) in start order,
    one stream)."""
    open_at = {}
    for i, (name, _, _) in enumerate(ops):
        m = MARK_KERNEL.search(name)
        if m is None or int(m.group(1)) not in MARKS:
            continue
        st, end = MARKS[int(m.group(1))]
        if end == "begin":
            open_at[st] = i
        elif st in open_at:
            yield st, ops[open_at.pop(st) + 1:i]


def stage_split(ops) -> dict:
    """{stage: (device ms, segments, ops a segment)} of the stage marks
    among `ops` (`_segments`). Every replay of a graph gives a stage the
    same operations, so its segments' op counts repeat with one period (a
    stage entered twice a replay, as `cem.select` is, alternates two
    counts); a stage whose counts do not reads (None, segments, None)."""
    counts, ms = {}, {}
    for st, inner in _segments(ops):
        counts.setdefault(st, []).append(len(inner))
        ms[st] = ms.get(st, 0.0) + sum(y - x for _, x, y in inner) / 1e3
    out = {}
    for st, c in counts.items():
        period = next((p for p in range(1, len(c) // 2 + 1)
                       if len(c) % p == 0
                       and all(c[k] == c[k % p] for k in range(len(c)))),
                      None if len(c) > 1 else 1)
        out[st] = ((ms[st], len(c), c[:period]) if period is not None
                   else (None, len(c), None))
    return out


def stage_top(ops, k: int = 3) -> dict:
    """{stage: its k device operations with the most time, (name, total
    us, count)}."""
    inner = {}
    for st, seg in _segments(ops):
        inner.setdefault(st, []).extend(seg)
    return {st: _top(seg, k) for st, seg in inner.items()}


def _innermost(spans) -> list:
    """[(start, end, name)], in order: the pieces of time in which `name`
    is the innermost of `spans` ((name, start, end)) open, the one that
    started last; no piece where none is open."""
    order = sorted(spans, key=lambda s: (s[1], -s[2]))
    xs = sorted({x for _, a, b in spans for x in (a, b)})
    out, stack, k = [], [], 0
    for x0, x1 in zip(xs, xs[1:]):
        while k < len(order) and order[k][1] <= x0:
            stack.append(order[k])
            k += 1
        while stack and stack[-1][2] <= x0:
            stack.pop()
        if stack:
            out.append((x0, x1, stack[-1][0]))
    return out


def idle_by_span(ops, spans, start: float, end: float) -> dict:
    """{span name: idle us} over [start, end] us: each microsecond in
    which no operation of `ops` ran goes to the innermost span of `spans`
    ((name, start us, end us)) open on the host then, or to "outside"
    where none is."""
    busy = []
    for _, a, b in sorted(ops, key=lambda r: r[1]):
        a, b = max(a, start), min(b, end)
        if b <= a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    gaps, t = [], start
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if end > t:
        gaps.append((t, end))
    pieces = _innermost(spans)
    out, j = {}, 0
    for g0, g1 in gaps:
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        named = 0.0
        for a, b, name in pieces[j:]:
            if a >= g1:
                break
            us = min(b, g1) - max(a, g0)
            if us > 0:
                out[name] = out.get(name, 0.0) + us
                named += us
        if g1 - g0 > named:
            out["outside"] = out.get("outside", 0.0) + (g1 - g0 - named)
    return out


@dataclass
class Trace:
    """The device operations of one traced call and the host's count."""
    ops: list                   # (name, start us, end us), in start order
    host_launches: int          # kernel launches, copies and sets issued
    graph_launches: int         # CUDA graph launches issued
    replays: int = 0            # of them, `utils.graphs` runners' replays
    replay_ops: int = 0         # the device operations those replays ran
    host_events: list = field(default_factory=list)   # (name, start us,
    # end us) of the runtime's calls after the marker
    spans: list = field(default_factory=list)   # the program's spans of
    # the traced call, (name, start us, end us) on the trace's clock
    mark_end: float = 0.0       # the marker kernel's end, us
    replay_us: float = 0.0      # device time of the graph launches' ops
    lost: list = field(default_factory=list)   # earlier takes' check lines

    def intervals(self) -> list:
        """(start, end) of every operation that took time, in us."""
        return [(a, b) for _, a, b in self.ops if b > a]

    def busy_ms(self):
        """(the union of the operations' intervals, their sum) in ms; the
        union counts time two streams overlap once. (None, None) for an
        empty trace."""
        spans = self.intervals()
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

    def span_ms(self) -> list:
        """(name, total ms, count) of the program's spans, most time
        first, nested time included."""
        return [(n, us / 1e3, c) for n, us, c in _top(self.spans, None)]

    def stages(self) -> dict:
        """`stage_split` of the traced operations."""
        return stage_split(self.ops)

    def stage_top(self, k: int = 3) -> dict:
        """`stage_top` of the traced operations."""
        return stage_top(self.ops, k)

    def marks_us(self) -> float:
        """Device time of the stage marks."""
        return sum(b - a for name, a, b in self.ops
                   if MARK_KERNEL.search(name))

    def idle_by_span(self) -> dict:
        """{span: idle us} of the device span, from the marker kernel's end
        to the last operation's end (`idle_by_span`)."""
        if not self.ops:
            return {}
        return idle_by_span(self.ops, self.spans, self.mark_end,
                            max(b for _, _, b in self.ops))


def _top(events, k: Optional[int]) -> list:
    acc = {}
    for name, a, b in events:
        us, c = acc.get(name, (0.0, 0))
        acc[name] = (us + b - a, c + 1)
    return sorted(((n, us, c) for n, (us, c) in acc.items()),
                  key=lambda r: -r[1])[:k]


def traced(fn: Callable, warm: Optional[Callable] = None,
           takes: int = 3) -> Trace:
    """Trace fn() on the card behind `warm()` (fn itself by default) and a
    marker kernel, held to the host's count (see the module); raises when
    `takes` traces in a row fail the check."""
    lost = []
    while True:
        trace = _trace(fn, warm)
        try:
            trace.check()
        except RuntimeError as exc:
            lost.append(str(exc))
            if len(lost) == takes:
                raise RuntimeError(f"{takes} takes: {lost}") from exc
            continue
        trace.lost = lost
        return trace


def _trace(fn, warm) -> Trace:
    """One take of `traced`. fn's host events are those after the marker's
    launch on the host clock; its device operations are those the host
    events launched (the records' correlation ids: a graph launch's id is
    on every operation it runs), so that no clock offset between the
    device's records and the host's moves work across the marker. Reads
    the profiler's raw events (the tree of `prof.events()` costs the host
    about 80 times as much)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from visma_tpu_torch.utils.graphs import replayed

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        (warm or fn)()
        torch.cuda.synchronize()
        mark_ns = time.perf_counter_ns()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        before = replayed()
        fn()
        torch.cuda.synchronize()
        after_fn = replayed()
    program = [r for r in rows if r[1] > mark_ns]
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
    launch = [r for r in host if r[3] in marks and r[0].startswith(LAUNCH_API)]
    if not launch:
        raise RuntimeError("the trace lost its marker kernel")
    after = max(r[2] for r in launch)
    mark_end = max(r[2] for r in device if r[3] in marks)
    # the marker's launch began about when the host's clock read mark_ns
    shift = min(r[1] for r in launch) - mark_ns / 1e3
    host = sorted((r for r in host if r[1] > after), key=lambda r: r[1])
    mine = {r[3] for r in host if r[0].startswith(LAUNCH_API + GRAPH_API)}
    graphs = {r[3] for r in host if r[0].startswith(GRAPH_API)}
    ops = sorted((r[:3] for r in device if r[3] in mine), key=lambda r: r[1])
    return Trace(
        ops=ops,
        host_launches=sum(r[0].startswith(LAUNCH_API) for r in host),
        graph_launches=sum(r[0].startswith(GRAPH_API) for r in host),
        replays=after_fn["graphs"] - before["graphs"],
        replay_ops=after_fn["ops"] - before["ops"],
        host_events=[r[:3] for r in host],
        spans=[(n, a / 1e3 + shift, b / 1e3 + shift) for n, a, b in program],
        mark_end=mark_end,
        replay_us=sum(r[2] - r[1] for r in device if r[3] in graphs))
