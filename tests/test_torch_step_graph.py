"""The VIO step's compiled form outside `run` on the CPU: `VioPipeline.step`,
`Msckf.step` and `FeatureTracker.step` through `utils.graphs.CallGraph`
(`graph=True`: on the CPU the graph's static buffers without capture)
against their eager code (`graph=False`) bit for bit and against the JAX
package's jitted steps; the caller's state never aliased; the launch
counts and captures on stand-in streams and graphs, with no capture nested
inside a runner's; and the sharded solvers' graph caches keyed by the
mesh's value."""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from visma_tpu.filter import FilterConfig as JConfig
from visma_tpu.filter import Msckf as JMsckf
from visma_tpu.pipeline import VioPipeline as JPipeline

from visma_tpu_torch import _kernels
from visma_tpu_torch.dist import sharded_ba as TS
from visma_tpu_torch.dist.mesh import make_mesh
from visma_tpu_torch.dist.pipeline_pp import TwoStagePipeline
from visma_tpu_torch.filter import FilterConfig, Msckf
from visma_tpu_torch.frontend import detect, klt_fused
from visma_tpu_torch.frontend.tracker import FeatureTracker
from visma_tpu_torch.pipeline import VioPipeline
from visma_tpu_torch.utils.graphs import CallGraph, StepGraph

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_graphs import (  # noqa: E402,F401 (fixtures)
    FRAMES, _assert_trees_equal, _pipe, scene, stub_cuda)

POS_TOL_M = 1.2e-7     # test_torch_graphs.py::test_vio_helper_path_matches_jax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(scene, i):
    """Tracked frame i's (image, gyro, accel, dts) as float32 CPU
    tensors."""
    f = scene["feed"]
    return tuple(torch.as_tensor(x, dtype=torch.float32) for x in (
        scene["frames"][i + 1], f["gyro"][i], f["accel"][i], f["dts"][i]))


def _step_all(pipe, scene, st=None):
    """`pipe.step` over the scene's tracked frames: every state."""
    if st is None:
        st = pipe.init(scene["frames"][0], **scene["init"])
    states = []
    for i in range(FRAMES - 1):
        st = pipe.step(st, *_inputs(scene, i))
        states.append(st)
    return states


@pytest.fixture(scope="module")
def stepped(scene):
    """The scene stepped frame by frame through `VioPipeline.step`, eager
    and through the CallGraph's buffers, without and with SLAM slots."""
    out = {}
    for num_slam in (0, 4):
        for graph in (False, True):
            pipe = _pipe(scene, graph, num_slam)
            out[num_slam, graph] = dict(pipe=pipe,
                                        states=_step_all(pipe, scene))
    return out


def _frames(scene, states):
    """The filter's inputs of each tracked frame: the feed and the
    tracker's observations as the stepped states hold them."""
    return [{"gyro": g, "accel": a, "dts": d, "ids": s.tracker.ids,
             "xp": s.tracker.pos, "valid": s.tracker.ids >= 0}
            for (_, g, a, d), s in zip(
                (_inputs(scene, i) for i in range(FRAMES - 1)), states)]


@pytest.mark.parametrize("num_slam", [0, 4], ids=["vio", "slam4"])
def test_pipeline_step_graph_equals_eager(stepped, scene, num_slam):
    """(a) `VioPipeline(graph=True).step`, one CallGraph over the whole
    frame, equals `graph=False` bit for bit in every frame's state, and
    both equal the graphed `run`'s final state."""
    eager, graphed = stepped[num_slam, False], stepped[num_slam, True]
    assert eager["pipe"].step_graph is None
    cg = graphed["pipe"].step_graph
    assert isinstance(cg, CallGraph) and cg.captures == 0
    assert len(cg._entries) == 1
    for a, b in zip(eager["states"], graphed["states"]):
        _assert_trees_equal(a, b)
    pipe = _pipe(scene, True, num_slam)
    final, _ = pipe.run(pipe.init(scene["frames"][0], **scene["init"]),
                        scene["frames"][1:], **scene["feed"])
    _assert_trees_equal(final, graphed["states"][-1])
    # the tracker's own graph is never entered by the pipeline's step
    assert graphed["pipe"].tracker.step_graph is None


@pytest.mark.parametrize("num_slam", [0, 4], ids=["vio", "slam4"])
def test_msckf_step_graph_equals_eager(stepped, scene, num_slam):
    """(a) `Msckf(graph=True).step` equals `graph=False` bit for bit on
    the scene's observations, frame by frame."""
    cfg = FilterConfig(**scene["kw"], num_slam=num_slam)
    eager = Msckf(cfg, device="cpu", graph=False)
    graphed = Msckf(cfg, device="cpu", graph=True)
    se = sg = eager.init(**scene["init"])
    for frame in _frames(scene, stepped[num_slam, False]["states"]):
        se, sg = eager.step(se, frame), graphed.step(sg, frame)
        _assert_trees_equal(se, sg)
    assert eager.step_graph is None
    assert len(graphed.step_graph._entries) == 1


@pytest.mark.parametrize("fused", [False, True], ids=["windowed", "fused"])
def test_tracker_step_graph_equals_eager(scene, fused):
    """(a) `FeatureTracker(graph=True).step` equals `graph=False` bit for
    bit: state, ids, positions and validity of every frame; `graph=None`
    steps eagerly on a CPU image."""
    kw = dict(max_features=32, levels=3, cell=16, fused=fused)
    eager, graphed = FeatureTracker(**kw, graph=False), \
        FeatureTracker(**kw, graph=True)
    default = FeatureTracker(**kw)
    img0 = torch.as_tensor(scene["frames"][0])
    te = tg = eager.init(img0)
    for i in range(FRAMES - 1):
        img = _inputs(scene, i)[0]
        out_e, out_g = eager.step(te, img), graphed.step(tg, img)
        _assert_trees_equal(out_e, out_g)
        te, tg = out_e[0], out_g[0]
    default.step(default.init(img0), _inputs(scene, 0)[0])
    assert eager.step_graph is None and default.step_graph is None
    assert isinstance(graphed.step_graph, CallGraph)


def test_pipeline_step_matches_jax(stepped, scene):
    """(b) The JAX package's jitted `VioPipeline.step` over the same
    frames (the windowed tracker on both sides): the same track decisions
    in every frame (tracker ids, track-table ids and statuses) and
    positions within 1.2e-7 m."""
    jp = JPipeline(JConfig(**scene["kw"]), levels=3, cell=16,
                   fused_klt=False)
    js = jp.init(jnp.asarray(scene["frames"][0]), **scene["init"])
    for i, ts in enumerate(stepped[0, True]["states"]):
        js = jp.step(js, *(jnp.asarray(x.numpy())
                           for x in _inputs(scene, i)))
        for name, a, b in (
                ("tracker ids", ts.tracker.ids, js.tracker.ids),
                ("track ids", ts.filter.tracks.ids, js.filter.tracks.ids),
                ("status", ts.filter.tracks.status, js.filter.tracks.status)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"frame {i}: {name}")
        np.testing.assert_allclose(ts.filter.p.numpy(),
                                   np.asarray(js.filter.p), rtol=0,
                                   atol=POS_TOL_M, err_msg=f"frame {i}")


def test_msckf_step_matches_jax(stepped, scene):
    """(b) The JAX package's jitted `Msckf.step` on the same observations:
    the same track-table decisions in every frame and positions within
    1.2e-7 m."""
    graphed = Msckf(FilterConfig(**scene["kw"]), device="cpu", graph=True)
    jkf = JMsckf(JConfig(**scene["kw"]))
    ts, js = graphed.init(**scene["init"]), jkf.init(**scene["init"])
    for i, frame in enumerate(_frames(scene, stepped[0, True]["states"])):
        ts = graphed.step(ts, frame)
        js = jkf.step(js, {k: jnp.asarray(v.numpy())
                           for k, v in frame.items()})
        for f in ("ids", "status", "mask"):
            np.testing.assert_array_equal(
                getattr(ts.tracks, f).numpy(),
                np.asarray(getattr(js.tracks, f)), err_msg=f"frame {i}: {f}")
        np.testing.assert_allclose(ts.p.numpy(), np.asarray(js.p), rtol=0,
                                   atol=POS_TOL_M, err_msg=f"frame {i}")


def test_caller_state_never_aliased(scene):
    """(c) The state passed in is unchanged after `step`; a kept state
    stepped again gives the same result; a returned state is not written
    by the next call (the graph's buffers are copied into and cloned out
    of, never handed over)."""
    pipe = _pipe(scene, True, 4)
    st0 = pipe.init(scene["frames"][0], **scene["init"])
    kept = [t.clone() for t in pytree.tree_leaves(st0)]
    st1 = pipe.step(st0, *_inputs(scene, 0))
    for t, t0 in zip(pytree.tree_leaves(st0), kept):
        assert torch.equal(t, t0)
    _assert_trees_equal(pipe.step(st0, *_inputs(scene, 0)), st1)
    got1 = [t.clone() for t in pytree.tree_leaves(st1)]
    st2 = pipe.step(st1, *_inputs(scene, 1))
    pipe.step(st2, *_inputs(scene, 2))
    for t, t0 in zip(pytree.tree_leaves(st1), got1):
        assert torch.equal(t, t0)
    held = {t.untyped_storage().data_ptr()
            for e in pipe.step_graph._entries.values()
            for t in e.inputs + e.outputs}
    assert not held & {t.untyped_storage().data_ptr()
                       for t in pytree.tree_leaves(st2) if t.numel()}


def _fused_pipe(scene):
    """The scene's pipeline with the fused tracker (K2), graph=True."""
    return VioPipeline(FilterConfig(**scene["kw"]), levels=3, cell=16,
                       fused_klt=True, device="cpu", graph=True)


@pytest.fixture
def counted_frontend(stub_cuda, monkeypatch):
    """stub_cuda, and K1's and K2's wrappers counting on the CPU as they
    count a launch on the card (their CPU path counts nothing)."""
    k1, k2 = detect.corner_score, klt_fused.lk_track
    for mod, name, counter in ((detect, "corner_cells", k1),
                               (klt_fused, "lk_track", k2)):
        wrapper = getattr(mod, name)

        def counting(*a, _w=wrapper, _c=counter, **k):
            _c.launches += 1
            return _w(*a, **k)

        monkeypatch.setattr(mod, name, counting)
    saved = {w: w.launches for w in _kernels._COUNTED}
    for w in saved:
        w.launches = 0
    yield k1, k2
    for w, n in saved.items():
        w.launches = n


def test_step_captures_once_a_shape(scene, counted_frontend):
    """(d) On stand-in streams and graphs: `VioPipeline.step`'s first call
    runs eagerly, the second captures (its launches taken back out) and
    replays, later calls replay; K1 and K2 count one a call through the
    replays. Another IMU sample count is another shape: one more capture
    after one more eager call. `Msckf.step` and `FeatureTracker.step`
    capture once a shape the same way."""
    k1, k2 = counted_frontend
    pipe = _fused_pipe(scene)
    st = pipe.init(scene["frames"][0], **scene["init"])
    k1.launches = 0
    n = 4
    for i in range(n):
        st = pipe.step(st, *_inputs(scene, i))
    assert pipe.step_graph.captures == 1
    assert (k1.launches, k2.launches) == (n, n)
    img, g, a, d = _inputs(scene, 0)
    for _ in range(3):
        pipe.step(st, img, g[:-1], a[:-1], d[:-1])
    assert pipe.step_graph.captures == 2
    assert len(pipe.step_graph._entries) == 2
    assert (k1.launches, k2.launches) == (n + 3, n + 3)

    kf = Msckf(FilterConfig(**scene["kw"]), device="cpu", graph=True)
    fs = kf.init(**scene["init"])
    frame = {"gyro": g, "accel": a, "dts": d, "ids": st.tracker.ids,
             "xp": st.tracker.pos, "valid": st.tracker.ids >= 0}
    for _ in range(3):
        kf.step(fs, frame)
    assert kf.step_graph.captures == 1

    tr = FeatureTracker(max_features=32, levels=3, cell=16, graph=True)
    k1.launches = k2.launches = 0
    ts = tr.init(torch.as_tensor(scene["frames"][0]))
    for _ in range(3):
        tr.step(ts, img)
    assert tr.step_graph.captures == 1
    assert (k1.launches, k2.launches) == (1 + 3, 3)


def test_runners_never_enter_the_tracker_graph(scene, counted_frontend,
                                               monkeypatch):
    """(d) `VioPipeline.run` and `TwoStagePipeline.run`, each stage a
    StepGraph captured on stand-in graphs, step the tracker through
    `_step_impl`: a `FeatureTracker.step` there would nest its CallGraph's
    capture inside the runner's. K1 counts `init` + one a frame, K2 one a
    tracked frame, through the replays."""
    def nested(*a, **k):
        raise AssertionError("FeatureTracker.step inside a runner's step")

    monkeypatch.setattr(FeatureTracker, "step", nested)
    k1, k2 = counted_frontend
    N = FRAMES - 1
    pipe = _fused_pipe(scene)
    pipe.run(pipe.init(scene["frames"][0], **scene["init"]),
             scene["frames"][1:], **scene["feed"])
    assert pipe.run_graph.captures == 1
    assert (k1.launches, k2.launches) == (1 + N, N)
    assert pipe.tracker.step_graph is None

    k1.launches = k2.launches = 0
    pp = TwoStagePipeline(FilterConfig(**scene["kw"]), "cpu", "cpu",
                          levels=3, cell=16, chunk=3, graph=True)
    f = scene["feed"]
    pp.run(*pp.init(scene["frames"][0], **scene["init"]),
           scene["frames"][1:], f["gyro"], f["accel"], f["dts"])
    assert isinstance(pp.frontend_graph, StepGraph)
    assert (pp.frontend_graph.captures, pp.filter_graph.captures) == (1, 1)
    assert (k1.launches, k2.launches) == (1 + N, N)
    assert pp.tracker.step_graph is None


def _stub_step(mesh):
    """A stand-in GN step that all_reduces its cost once."""
    def step(shard, lam):
        return shard, mesh.all_reduce(lam * 0)
    return step


def test_sharded_caches_keyed_by_mesh_value(monkeypatch):
    """(f) Two `make_mesh()` meshes are equal in value: they share one
    `_RUNS` and one `_STEPS` entry, and the cached runner counts the
    collectives of the mesh it is called with. The cache holds 16
    entries, the reference's `lru_cache(maxsize=16)`: a 17th key drops the
    least recently used."""
    from collections import OrderedDict

    from visma_tpu_torch.ba.problem import synthetic_ba_problem

    monkeypatch.setattr(TS, "_RUNS", OrderedDict())
    monkeypatch.setattr(TS, "_STEPS", OrderedDict())
    a, b = make_mesh(device="cpu"), make_mesh(device="cpu")
    assert a is not b and TS.mesh_key(a) == TS.mesh_key(b)
    prob = synthetic_ba_problem(4, 24, 0.5, 0.02, 0, device="cpu")[0]
    sols = [TS.sharded_ba_solve(prob, m, iters=3, solver="dense",
                                graph=True) for m in (a, b)]
    steps = [TS.sharded_ba_step(prob, m, graph=True) for m in (a, b)]
    assert list(TS._RUNS) == [(TS.mesh_key(a), "dense")]
    assert list(TS._STEPS) == [TS.mesh_key(a)]
    for x, y in (sols, steps):
        for u, v in zip(pytree.tree_leaves(x), pytree.tree_leaves(y)):
            assert torch.equal(u, v)
    for m in (a, b):
        m.reset_counts()
    TS.sharded_ba_solve(prob, a, iters=3, solver="dense", graph=True)
    TS.sharded_ba_solve(prob, b, iters=3, solver="dense", graph=True)
    assert a.counts == b.counts and a.counts["all_reduce"] > 0

    first = TS._RUNS.copy()
    for i in range(TS._CACHE_SIZE):
        TS.lm_runner(a, ("stub", i), _stub_step(a), True)
    assert len(TS._RUNS) == TS._CACHE_SIZE
    assert not set(first) & set(TS._RUNS)
    assert (TS.mesh_key(a), "stub", 0) in TS._RUNS
    TS.lm_runner(a, ("stub", 0), _stub_step(a), True)   # now most recent
    TS.lm_runner(a, ("stub", TS._CACHE_SIZE), _stub_step(a), True)
    assert (TS.mesh_key(a), "stub", 0) in TS._RUNS
    assert (TS.mesh_key(a), "stub", 1) not in TS._RUNS
