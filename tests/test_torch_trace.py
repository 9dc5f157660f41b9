"""The port's tracing (`visma_tpu_torch.utils.trace`): the span recorder
off (nothing recorded, nothing allocated) and on (nested rows, times that
only go forward, the buffer's bound, `host.gc` rows), stages on the CPU
(no mark launched), the graph runtime's spans once a frame or a call, the
marked variant of a graph on stand-in streams and graphs, and the
arithmetic of the stage split and of the idle time named by span.

The card tests (marker `cuda`, skipped without a CUDA device; no JAX
imported, so `--noconftest` runs them on the card): a graph captured with
recording off has the node count of the step without stage code, the
marked variant two nodes more a stage segment and bit for bit the same
outputs, every marked replay the same op count a stage, and the eager
step under recording the same stage op counts as the replays.
"""
import collections
import contextlib
import gc
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from visma_tpu_torch.utils import graphs, trace
from visma_tpu_torch.utils.graphs import CallGraph, StepGraph


@pytest.fixture(autouse=True)
def _recording_off():
    trace.disable()
    yield
    trace.disable()


def _names(rows):
    """The span names of `rows`, without the collections a test may hit."""
    return [r[0] for r in rows if r[0] != "host.gc"]


def test_off_records_nothing_and_allocates_nothing():
    """Off, a span and a stage are the shared null context: no row, and
    10,000 of each allocate nothing."""
    cpu = torch.device("cpu")
    assert not trace.recording()
    assert trace.span("vio.step") is trace.span("graph.launch")
    assert trace.stage("filter", cpu) is trace.span("vio.step")
    n = len(trace.rows)

    def loop():
        for _ in range(10_000):
            with trace.span("vio.step"):
                pass
            with trace.stage("frontend", cpu):
                pass

    loop()
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        loop()
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 512
    assert len(trace.rows) == n


def test_on_nested_rows_forward_and_bounded(monkeypatch):
    """On, spans nest: the inner row lies inside the outer one, every row
    ends after it starts, later rows start later; the buffer keeps the
    newest `ROWS` rows."""
    assert trace.rows.maxlen == trace.ROWS
    monkeypatch.setattr(trace, "rows", collections.deque(maxlen=5))
    gc.disable()                                 # no host.gc row here
    try:
        trace.enable()
        assert trace.recording()
        with trace.span("vio.run"):
            with trace.span("graph.launch"):
                pass
            with trace.stage("filter", torch.device("cpu")):
                pass
        rows = list(trace.rows)
        assert _names(rows) == ["graph.launch", "filter", "vio.run"]
        (_, a0, b0), (_, a1, b1), (_, a, b) = rows
        assert a <= a0 <= b0 <= a1 <= b1 <= b
        for k in range(7):
            with trace.span(f"s{k}"):
                pass
        assert _names(trace.rows) == ["s2", "s3", "s4", "s5", "s6"]
        starts = [r[1] for r in trace.rows]
        assert starts == sorted(starts)
        trace.disable()
        with trace.span("vio.step"):
            pass
        assert _names(trace.rows)[-1] == "s6"
    finally:
        gc.enable()


def test_gc_rows(monkeypatch):
    """While recording, a collection is a `host.gc` row inside the span it
    interrupted; off, none."""
    monkeypatch.setattr(trace, "rows", collections.deque(maxlen=64))
    trace.enable()
    with trace.span("vio.step"):
        gc.collect()
    gcs = [r for r in trace.rows if r[0] == "host.gc"]
    step = next(r for r in trace.rows if r[0] == "vio.step")
    assert gcs and all(step[1] <= r[1] <= r[2] <= step[2] for r in gcs)
    trace.disable()
    n = len(trace.rows)
    gc.collect()
    assert len(trace.rows) == n


def test_stage_on_the_cpu_launches_nothing(monkeypatch):
    """A stage on the CPU records its span and launches no mark; on a CUDA
    device (the launch stood in for) it launches its begin and end mark,
    `MARKS` naming them."""
    launched = []
    monkeypatch.setattr(trace, "_launch_mark",
                        lambda mark, device: launched.append(mark))
    monkeypatch.setattr(trace, "rows", collections.deque(maxlen=8))
    trace.enable()
    with trace.stage("cem.raster", torch.device("cpu")):
        pass
    assert launched == [] and _names(trace.rows) == ["cem.raster"]
    with trace.stage("cem.raster", torch.device("cuda", 0)):
        pass
    assert [trace.MARKS[m] for m in launched] == [("cem.raster", "begin"),
                                                   ("cem.raster", "end")]
    trace.disable()
    with trace.stage("cem.raster", torch.device("cuda", 0)):
        pass
    assert len(launched) == 2


def test_ranges_only_when_asked():
    """Under a profiler a span records its row; it opens a
    `record_function` range of its name only after `ranges(True)`."""
    from torch.profiler import ProfilerActivity, profile

    try:
        for on in (False, True):
            trace.ranges(on)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                assert trace.recording()
                with trace.span("vio.pose"):
                    torch.ones(2).add_(1)
            assert trace.rows[-1][0] == "vio.pose"
            assert ("vio.pose" in {e.name for e in prof.events()}) == on
    finally:
        trace.ranges(False)
    assert not trace.recording()


def _step(state, x):
    return state + x, {"s": state * x}


@pytest.mark.parametrize("runner", ["step", "call"])
def test_runners_record_copies_and_launch_once(runner, monkeypatch):
    """`StepGraph.run` on CPU buffers records `graph.copy_in`,
    `graph.launch` and `graph.copy_out` once a frame, `CallGraph` once a
    call, and no `graph.capture` (the CPU captures nothing)."""
    monkeypatch.setattr(trace, "rows", collections.deque(maxlen=256))
    since = time.perf_counter_ns()
    trace.enable()
    if runner == "step":
        StepGraph(_step).run(torch.zeros(3), torch.ones(5, 3))
        n = 5
    else:
        cg = CallGraph(lambda a, b: a * b + 1)
        for _ in range(3):
            cg(torch.ones(3), torch.full((3,), 2.0))
        n = 3
    counts = {k: c for k, _, c in trace.span_totals(since) if k != "host.gc"}
    assert counts == {"graph.copy_in": n, "graph.launch": n,
                      "graph.copy_out": n}


class _StubStream:
    device = torch.device("cpu")

    def wait_stream(self, other):
        pass


class _StubGraph:
    """Stands in for torch.cuda.CUDAGraph: the step runs once while it is
    "captured", a replay runs nothing."""

    def capture_begin(self, capture_error_mode="global"):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


@pytest.fixture
def stub_cuda(monkeypatch):
    """The CUDA branches of StepGraph and CallGraph on stand-in streams
    and graphs."""
    monkeypatch.setattr(graphs._Captures, "_side_stream",
                        staticmethod(lambda device: _StubStream()))
    monkeypatch.setattr(graphs.torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(graphs.torch.cuda, "current_stream",
                        lambda device=None: _StubStream())
    monkeypatch.setattr(graphs.torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())


def test_marked_variant_on_stub_graphs(stub_cuda, monkeypatch):
    """One graph a recording state: recording off captures the step once
    (`captures`), the first run with recording on captures a marked
    variant once (`marked_captures`, no warm-up: the buffers are warm)
    inside a `graph.capture` span, and each state replays its own graph
    from then on."""
    monkeypatch.setattr(trace, "rows", collections.deque(maxlen=1024))
    sg = StepGraph(_step)
    sg.run(torch.zeros(()), torch.ones(5))
    assert (sg.captures, sg.marked_captures) == (1, 0)
    (entry,) = sg._entries.values()
    assert set(entry.variants) == {False}
    trace.enable()
    _, out = sg.run(torch.zeros(()), torch.ones(5))
    assert (sg.captures, sg.marked_captures) == (1, 1)
    assert _names(trace.rows).count("graph.capture") == 1
    assert set(entry.variants) == {False, True}
    sg.run(torch.zeros(()), torch.ones(5))
    trace.disable()
    sg.run(torch.zeros(()), torch.ones(5))
    assert (sg.captures, sg.marked_captures) == (1, 1)
    assert _names(trace.rows).count("graph.capture") == 1

    cg = CallGraph(lambda a: a + 1)
    trace.enable()
    for _ in range(3):          # a warm-up, the marked capture, a replay
        cg(torch.ones(2))
    trace.disable()
    cg(torch.ones(2))           # the unmarked capture: the buffers are warm
    cg(torch.ones(2))
    assert (cg.captures, cg.marked_captures) == (1, 1)


def _ops(*rows):
    return [(f"void stage_mark<{r}>()" if isinstance(r, int) else r, a, b)
            for r, a, b in rows]


def test_stage_split_and_idle_by_span():
    """The stage split reads the operations between a stage's begin and
    end marks; a stage entered twice a replay alternates two counts and
    still reads; counts that do not repeat read None. Idle time goes to
    the innermost span open on the host, "outside" where none is."""
    ops = _ops((0, 0, 1), ("k", 1, 3), ("k", 3, 4), (1, 4, 5),
               (12, 5, 6), ("a", 6, 8), (13, 8, 9),
               (12, 9, 10), ("b", 10, 11), ("c", 11, 12), (13, 12, 13),
               (0, 13, 14), ("k", 14, 16), ("k", 16, 17), (1, 17, 18),
               (12, 18, 19), ("a", 19, 21), (13, 21, 22),
               (12, 22, 23), ("b", 23, 24), ("c", 24, 25), (13, 25, 26))
    split = trace.stage_split(ops)
    assert split["frontend"] == (pytest.approx(6e-3), 2, [2])
    assert split["cem.select"] == (pytest.approx(8e-3), 4, [1, 2])
    assert trace.stage_top(ops, 1) == {"frontend": [("k", 6.0, 4)],
                                       "cem.select": [("a", 4.0, 2)]}
    odd = _ops((2, 0, 1), ("x", 1, 2), (3, 2, 3), (2, 3, 4), (3, 4, 5),
               (2, 5, 6), ("x", 6, 7), ("y", 7, 8), (3, 8, 9))
    assert trace.stage_split(odd)["filter"] == (None, 3, None)

    busy = [("k", 0, 10), ("k", 20, 30), ("k", 50, 60)]
    spans = [("vio.step", 5, 45), ("graph.copy_in", 12, 18),
             ("host.gc", 14, 16), ("graph.launch", 18, 25)]
    idle = trace.idle_by_span(busy, spans, 0.0, 70.0)
    assert idle == {"vio.step": pytest.approx(2 + 15),
                    "graph.copy_in": pytest.approx(4),
                    "host.gc": pytest.approx(2),
                    "graph.launch": pytest.approx(2),
                    "outside": pytest.approx(5 + 10)}
    t = trace.Trace(ops=busy, host_launches=3, graph_launches=0,
                    spans=spans, mark_end=0.0)
    assert t.idle_by_span() == {k: pytest.approx(v) for k, v in
                                trace.idle_by_span(busy, spans, 0.0,
                                                   60.0).items()}


def test_undistort_span_on_the_cpu(monkeypatch):
    """K6's call is the `vio.undistort` span (its plain path here)."""
    from visma_tpu_torch.image.remap import bilinear_remap

    monkeypatch.setattr(trace, "rows", collections.deque(maxlen=8))
    trace.enable()
    table = torch.zeros((4, 5, 2))
    bilinear_remap(torch.ones((6, 7)), table)
    assert _names(trace.rows) == ["vio.undistort"]


# ------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: stage marks launch only there")
    return torch.device("cuda", 0)


def _vio_scene(dev, frames=12):
    """profile_pipeline's scene, `frames` frames, on the card."""
    from visma_tpu_torch.filter.config import FilterConfig
    from visma_tpu_torch.io.synthetic import SyntheticConfig, make_imu
    from visma_tpu_torch.io.synthetic_images import render_adversarial_frames

    syn = SyntheticConfig(num_frames=frames, num_landmarks=240, rows=500,
                          cols=960, fx=486.405, fy=535.401, cx=469.199,
                          cy=257.916, seed=7)
    cfg = FilterConfig(window=8, max_tracks=96, max_updates=24, fx=syn.fx,
                       fy=syn.fy, cx=syn.cx, cy=syn.cy, pixel_noise=1.0)
    images, gwc, _ = render_adversarial_frames(syn)
    imu = make_imu(syn)
    spf, N = imu["samples_per_frame"], frames - 1
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    seq = (t(images[1:]), t(imu["gyro"][:N * spf].reshape(N, spf, 3)),
           t(imu["accel"][:N * spf].reshape(N, spf, 3)),
           t(np.full((N, spf), float(np.diff(imu["ts_state"])[0]))))
    init = dict(image0=t(images[0]), R0=gwc[0, :, :3], p0=gwc[0, :, 3],
                v0=imu["v0"])
    return cfg, seq, init


def _ops_of(runner) -> int:
    """The device operations the off graph of a runner's one entry runs."""
    (entry,) = runner._entries.values()
    return entry.variants[False].launches[-1]


def _assert_equal(a, b):
    for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)):
        assert torch.equal(x, y)


def _split(runner_fn):
    """The stage split of one traced call (its marked variant captured
    before the trace), every stage's counts repeating."""
    trace.enable()
    runner_fn()
    runner_fn()
    trace.disable()
    got = trace.traced(runner_fn)
    split = got.stages()
    assert split and all(ms is not None for ms, _, _ in split.values())
    return {k: (seg, ops) for k, (_, seg, ops) in split.items()}, got


@pytest.mark.cuda
def test_vio_marks_on_the_card(card, monkeypatch):
    """VioPipeline.run's graph: off, node for node the step without stage
    code; the marked variant 4 nodes more (frontend and filter, a begin
    and an end each) with bit-for-bit outputs; a traced run of replays
    gives every frame the same op count a stage, and the eager loop under
    recording the same counts."""
    import visma_tpu_torch.pipeline as P

    cfg, seq, init = _vio_scene(card)
    N = seq[0].shape[0]

    def make(graph):
        pipe = P.VioPipeline(cfg, levels=4, cell=32, device=card, graph=graph)
        st0 = pipe.init(init["image0"], R0=init["R0"], p0=init["p0"],
                        v0=init["v0"])
        return pipe, (lambda: pipe.run(st0, *seq))

    pipe, run = make(None)
    off = run()
    with monkeypatch.context() as m:
        m.setattr(P, "stage", lambda name, device: contextlib.nullcontext())
        bare, bare_run = make(None)
        bare_run()
    assert _ops_of(pipe.run_graph) == _ops_of(bare.run_graph)
    trace.enable()
    on = run()
    trace.disable()
    (entry,) = pipe.run_graph._entries.values()
    assert entry.variants[True].launches[-1] == _ops_of(pipe.run_graph) + 4
    _assert_equal(on, off)
    _assert_equal(run(), off)

    graphed, _ = _split(run)
    assert graphed == {"frontend": (N, graphed["frontend"][1]),
                       "filter": (N, graphed["filter"][1])}
    assert all(len(ops) == 1 for _, ops in graphed.values())
    _, eager_run = make(False)
    eager, _ = _split(eager_run)
    assert eager == graphed


@pytest.mark.cuda
def test_cem_marks_on_the_card(card, monkeypatch):
    """The fused CEM's executor: off, node for node the body without
    stage code; the marked variant two nodes more a stage segment with
    bit-for-bit outputs; its replays and the eager body under recording
    give the same stage op counts."""
    from visma_tpu_torch.io.procedural import bench_mesh_db
    from visma_tpu_torch.io.synthetic_semantic import (BENCH_INTRINSICS,
                                                       bench_scene)
    from visma_tpu_torch.render.camera import Intrinsics
    from visma_tpu_torch.render.raster import MultiMeshRenderer
    from visma_tpu_torch.semantic import cem as C
    from visma_tpu_torch.image.edges import depth_edge

    intr = Intrinsics(**BENCH_INTRINSICS)
    db = bench_mesh_db()

    def renderer():
        r = MultiMeshRenderer(intr, device=card)
        r.set_meshes(db)
        return r

    names, _, _, _, poses = bench_scene(1)
    mr = renderer()
    mi = np.array([mr.index(n) for n in names])
    d = mr.render_depth(poses, np.broadcast_to(mi, poses.shape[:2]).copy())
    obs = depth_edge(d.amin(dim=1))[0]
    init = poses[0].copy()
    init[:, 0, 3] += 0.02
    iters, S = 3, 24
    noise = torch.randn((iters, len(names), S, 6), device=card,
                        generator=torch.Generator(card).manual_seed(5))

    def call(r, graph):
        return lambda: C.refine_pose_cem_batched(
            r, obs, init, mi, iters=iters, samples=S,
            init_sigma=(0.05, 0.03), roi=(256, 384), occluder_poses=init,
            noise=noise, device=card, graph=graph)

    run = call(mr, True)
    off = [run(), run(), run()][-1]
    execs = list(mr._cem_exec_cache.values())
    with monkeypatch.context() as m:
        m.setattr(C, "stage", lambda name, device: contextlib.nullcontext())
        bare = renderer()
        [call(bare, True)() for _ in range(3)]
        assert _ops_of(execs[0].graph) == _ops_of(
            list(bare._cem_exec_cache.values())[0].graph)
    graphed, _ = _split(run)
    segments = sum(seg for seg, _ in graphed.values())
    assert segments == 1 + 5 * iters        # edt; occluders, raster,
    # score and select twice each iteration
    (entry,) = execs[0].graph._entries.values()
    assert entry.variants[True].launches[-1] \
        == _ops_of(execs[0].graph) + 2 * segments
    trace.enable()
    on = run()
    trace.disable()
    _assert_equal(on, off)
    eager, _ = _split(call(mr, False))
    assert eager == graphed
