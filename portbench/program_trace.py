"""Reading the program's own tracing into a traced window.

The program (`visma_tpu_torch.utils.trace`) records host spans, (name,
start ns, end ns) on `time.perf_counter_ns`, into its buffer `rows` while
a torch profiler is active, and launches stage marks on the device: a
do-nothing kernel `stage_mark<id>` before and after each stage, `MARKS`
naming each id's stage and end. The readers here place the program's
spans on the trace's clock with the shift the benchmark's own spans got
(`trace_read.Spans`: the same rows, raw and shifted), keep those that
start after the marker kernel's end, and read:

* host ms in named spans, a unit;
* the stage split: the device operations between a stage's begin mark
  and its end mark, from the window's operations alone. Every replay of a
  graph runs a stage's operations again, so the segments' op counts
  repeat with one period (a stage entered twice a replay alternates two
  counts); where they do not, the split reads None;
* idle time by span: each idle microsecond of the device span (the
  marker's end to the last operation's end, as `readers.idle_share`
  counts it) goes to the innermost program span open on the host then.

The split and the attribution are the benchmark's own copies of the
arithmetic of `stage_split` and `idle_by_span` in the program's module, so
that a later change of the program cannot move what these metrics are
computed from. A program without the recorder (no `rows` or no `MARKS`)
gives nothing to read: every reader returns None and raises nothing."""
from __future__ import annotations

import re

from portbench.readers import traced

MARK_KERNEL = re.compile(r"stage_mark<(\d+)>")
GRAPH_RUNTIME = "graph."              # the graph runtime's span names


def recorder():
    """The program's recorder module, or None where it has none."""
    try:
        from visma_tpu_torch.utils import trace
    except ImportError:
        return None
    if not hasattr(trace, "rows") or not hasattr(trace, "MARKS"):
        return None
    return trace


def program_spans(run):
    """(name, start us, end us) of the program's spans in the kept window,
    on the trace's clock; None where there is nothing to read."""
    rec = recorder()
    if rec is None or not traced(run):
        return None
    w = run.window
    if not w.spans or not run.span.rows:
        return None
    shift = w.spans[0][1] - run.span.rows[0][1] / 1e3
    rows = [(n, a / 1e3 + shift, b / 1e3 + shift) for n, a, b in
            list(rec.rows)]
    return [r for r in rows if r[1] > w.mark_end]


def span_ms_per_unit(run, names):
    """Host ms a unit in the program's spans named in `names`."""
    rows = program_spans(run)
    if rows is None:
        return None
    return sum(b - a for n, a, b in rows if n in names) / 1e3 \
        / run.trace_frames


def span_count(run, name: str):
    """How many of the program's spans in the kept window are `name`."""
    rows = program_spans(run)
    if rows is None:
        return None
    return sum(n == name for n, _, _ in rows)


def stage_split(ops, marks: dict) -> dict:
    """{stage: (device us, segments, op counts of one period)} of the
    stage marks among `ops` ((name, start us, end us) in start order);
    (None, segments, None) for a stage whose counts do not repeat."""
    counts, us, open_at = {}, {}, {}
    for i, (name, _, _) in enumerate(ops):
        m = MARK_KERNEL.search(name)
        if m is None or int(m.group(1)) not in marks:
            continue
        stage, end = marks[int(m.group(1))]
        if end == "begin":
            open_at[stage] = i
            continue
        i0 = open_at.pop(stage, None)
        if i0 is None:
            continue
        inner = ops[i0 + 1:i]
        counts.setdefault(stage, []).append(len(inner))
        us[stage] = us.get(stage, 0.0) + sum(b - a for _, a, b in inner)
    out = {}
    for stage, c in counts.items():
        period = next((p for p in range(1, len(c) // 2 + 1)
                       if len(c) % p == 0
                       and all(c[k] == c[k % p] for k in range(len(c)))),
                      None if len(c) > 1 else 1)
        out[stage] = ((us[stage], len(c), c[:period]) if period is not None
                      else (None, len(c), None))
    return out


def stage_ms_per_unit(run, stage: str):
    """Device ms a unit of a stage's operations; None where the window
    has no such stage or its counts do not repeat."""
    rec = recorder()
    if rec is None or not traced(run):
        return None
    got = stage_split(run.window.ops, rec.MARKS).get(stage)
    if got is None or got[0] is None:
        return None
    return got[0] / 1e3 / run.trace_frames


def _innermost(spans) -> list:
    """[(start, end, name)] in order: where `name` is the innermost span
    open (the one that started last); nothing where none is open."""
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


def idle_by_span(run):
    """{span name: idle us} of the device span (see the module), "outside"
    where no program span is open; None where there is nothing to read."""
    spans = program_spans(run)
    if spans is None:
        return None
    w = run.window
    if not w.ops:
        return None
    start, end = w.mark_end, max(b for _, _, b in w.ops)
    gaps, t = [], start
    for a, b in w.intervals():
        a, b = max(a, start), min(b, end)
        if b <= a:
            continue
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


def idle_in_graph_runtime_share(run):
    """% of the traced device span idle while the host's innermost
    program span is one of the graph runtime's (`graph.*`)."""
    idle = idle_by_span(run)
    if idle is None:
        return None
    span = run.window.span_s()
    if span <= 0:
        return None
    us = sum(v for k, v in idle.items() if k.startswith(GRAPH_RUNTIME))
    return 100.0 * us / 1e6 / span
