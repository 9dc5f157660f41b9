"""The readers of the program's own tracing (`portbench.program_trace`) on
a hand-built traced window and hand-built program spans: the spans placed
on the trace's clock by the benchmark's own spans' shift and kept from the
marker's end on, host ms in named spans, the stage split from the stage
marks, the idle time of the graph runtime's spans never above the idle
share, and nothing read (no error) from a program without a recorder."""
import collections
import types

import pytest

from portbench import program_trace as pt
from portbench import readers
from portbench.trace_read import Spans, Window

MARKS = {0: ("frontend", "begin"), 1: ("frontend", "end"),
         2: ("filter", "begin"), 3: ("filter", "end"),
         12: ("cem.select", "begin"), 13: ("cem.select", "end")}


def _mark(i):
    return f"void stage_mark<{i}>()"


def _run(ops, program_rows, frames=2):
    """A traced run: the benchmark's span "run" raw at 1,000,000 ns and
    placed at 100 us on the trace's clock (a shift of -900 us), the marker
    ending at 105 us."""
    span = Spans()
    span.rows = [("run", 1_000_000, 1_200_000)]
    window = Window(ops=ops, host_launches=len(ops), graph_launches=0,
                    replays=0, replay_ops=0, spans=[("run", 100.0, 300.0)],
                    window_s=2e-4, plain_s=2e-4, mark_end=105.0)
    recorder = types.SimpleNamespace(rows=collections.deque(program_rows),
                                     MARKS=MARKS)
    return types.SimpleNamespace(window=window, span=span, trace=True,
                                 trace_frames=frames), recorder


# two frames: [frontend: k, k] [filter: q], a copy between replays
OPS = [(_mark(0), 110, 111), ("k1", 111, 120), ("k2", 120, 125),
       (_mark(1), 125, 126), (_mark(2), 126, 127), ("q", 127, 147),
       (_mark(3), 147, 148), ("memcpy", 180, 182),
       (_mark(0), 200, 201), ("k1", 201, 210), ("k2", 210, 215),
       (_mark(1), 215, 216), (_mark(2), 216, 217), ("q", 217, 237),
       (_mark(3), 237, 238)]
# the program's spans, raw ns: one before the marker (dropped), then per
# frame graph.launch, and graph.copy_out in the gap 148-180 us
ROWS = [("graph.capture", 950_000, 1_000_000),
        ("graph.launch", 1_009_000, 1_010_000),
        ("graph.copy_out", 1_048_000, 1_078_000),
        ("host.gc", 1_060_000, 1_070_000),
        ("graph.copy_in", 1_082_000, 1_090_000),
        ("graph.launch", 1_090_000, 1_099_000)]


@pytest.fixture
def run(monkeypatch):
    r, rec = _run(OPS, ROWS)
    monkeypatch.setattr(pt, "recorder", lambda: rec)
    return r


def test_spans_placed_and_kept(run):
    rows = pt.program_spans(run)
    assert [n for n, _, _ in rows] == ["graph.launch", "graph.copy_out",
                                       "host.gc", "graph.copy_in",
                                       "graph.launch"]
    assert rows[1][1:] == pytest.approx((148.0, 178.0))
    assert pt.span_ms_per_unit(run, ("graph.copy_in", "graph.copy_out")) \
        == pytest.approx((30 + 8) / 1e3 / 2)
    assert pt.span_count(run, "graph.capture") == 0
    assert pt.span_count(run, "graph.launch") == 2


def test_stage_split(run):
    assert pt.stage_ms_per_unit(run, "frontend") == pytest.approx(
        (14 + 14) / 1e3 / 2)
    assert pt.stage_ms_per_unit(run, "filter") == pytest.approx(
        40 / 1e3 / 2)
    assert pt.stage_ms_per_unit(run, "cem.raster") is None
    split = pt.stage_split(OPS, MARKS)
    assert split["frontend"][1:] == (2, [2])
    # a replay that ran another op count in a stage reads None
    odd = OPS[:-1] + [("extra", 237, 238), (_mark(3), 238, 239)]
    assert pt.stage_split(odd, MARKS)["filter"] == (None, 2, None)


def test_idle_of_the_graph_runtime(run):
    """The device span runs 105-238 us; idle: 105-110 (outside, then the
    first launch from 109), 148-180 (copy_out, the gc inside it, then
    178-180 outside), 182-200 (copy_in 182-190, launch 190-199, outside
    199-200)."""
    idle = pt.idle_by_span(run)
    assert idle == {"outside": pytest.approx(4 + 2 + 1),
                    "graph.copy_out": pytest.approx(20),
                    "host.gc": pytest.approx(10),
                    "graph.copy_in": pytest.approx(8),
                    "graph.launch": pytest.approx(1 + 9)}
    share = pt.idle_in_graph_runtime_share(run)
    assert share == pytest.approx(100 * (20 + 8 + 10) / 133)
    assert share <= readers.idle_share(run)
    assert readers.idle_share(run) == pytest.approx(
        100 * sum(idle.values()) / 133)


def test_nothing_to_read_without_a_recorder(monkeypatch):
    r, _ = _run(OPS, ROWS)
    monkeypatch.setattr(pt, "recorder", lambda: None)
    for read in (pt.program_spans, pt.idle_by_span,
                 pt.idle_in_graph_runtime_share,
                 lambda x: pt.stage_ms_per_unit(x, "filter"),
                 lambda x: pt.span_ms_per_unit(x, ("graph.copy_in",)),
                 lambda x: pt.span_count(x, "graph.capture")):
        assert read(r) is None


def test_recorder_of_this_checkout():
    """The program here has the recorder: its buffer and mark table."""
    rec = pt.recorder()
    assert rec is not None and rec.MARKS[2] == ("filter", "begin")
