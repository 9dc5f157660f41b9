"""The semantic mapper's executors (`cem.fused_cem_executor`,
`cem.retrieval_executor`, `mapper.exclusive_min_executor`: the port's
captured CUDA graphs, the reference's jitted executors) on the CPU, where
`utils.graphs.CallGraph` runs its static buffers without capture: bit for
bit the eager functions, the mapper with `graph=True` bit for bit the
mapper with `graph=False` (every history packet, every frame its own), the
caches dropped with the mesh stack, and, on stand-in streams and graphs,
a failed capture and the launch counts of a capture and its replays. The
scene is tests/test_torch_semantic.py's (96x128, 2-3 objects)."""
import contextlib
import json

import numpy as np
import pytest
import torch

from test_torch_semantic import (  # noqa: F401  (scene: the shared fixture)
    N_STEPS, TI, _t, mesh_db, run_port, scene)
from visma_tpu_torch import _kernels
from visma_tpu_torch.render import likelihood, raster
from visma_tpu_torch.render.raster import MultiMeshRenderer
from visma_tpu_torch.semantic import cem as TCEM
from visma_tpu_torch.semantic.mapper import (_exclusive_min_depths,
                                             exclusive_min_executor)
from visma_tpu_torch.utils import graphs
from visma_tpu_torch.utils.graphs import GraphCaptureError

ITERS, S, ROI, TAU, RADIUS = 2, 8, (48, 64), 10.0, 2
NAMES = ["stool", "cabinet"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: one torch thread beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _cem_inputs(s, shift):
    """The scene's poses moved by `shift` m along x: (mesh_idx, R0, t0,
    sig0, obs) and the moved poses."""
    init = s["poses"].copy()
    init[:, 0, 3] += shift
    n = init.shape[0]
    return (_t(s["mi"]).long(), _t(init[:, :, :3]).contiguous(),
            _t(init[:, :, 3]).contiguous(),
            _t(TCEM._sigma6((0.08, 0.04), n)), _t(s["obs"])), init


def _occ(s, mode, init):
    if mode == "poses":
        return _t(init)
    if mode == "depths":
        return _exclusive_min_depths(s["tr"].Cs, _t(init), _t(s["mi"]), TI)
    return None


def _body(Cs, args, occ, mode, roi, generator=None, noise=None):
    """The eager `_cem_fused_body` on (mesh_idx, R0, t0, sig0, obs)."""
    mi, R0, t0, sig0, obs = args
    return TCEM._cem_fused_body(
        Cs, mi, R0, t0, sig0, occ if mode == "depths" else None, obs,
        generator, TI, TAU, ITERS, S, TCEM.cem_n_elite(S), roi=roi,
        occ_poses=occ if mode == "poses" else None, radius=RADIUS,
        noise=noise)


def _eager(s, args, occ, mode, roi, seed):
    return _body(s["tr"].Cs, args, occ, mode, roi, generator=_gen(seed))


@pytest.mark.parametrize("mode,roi", [("none", ROI), ("none", None),
                                      ("poses", ROI), ("depths", ROI),
                                      ("depths", None)],
                         ids=["none-window", "none-full", "poses-window",
                              "depths-window", "depths-full"])
def test_cem_executor_equals_eager_body(scene, mode, roi):
    """Two calls of the executor (a warm-up, then the call that a card
    would capture and replay) on other inputs, each bit for bit the eager
    body's with the same generator seed; the first call's outputs are
    still its own after the second (they are cloned out of the static
    buffers)."""
    s = scene
    run = TCEM.fused_cem_executor(s["tr"], TAU, ITERS, S, TCEM.cem_n_elite(S),
                                  roi, mode, RADIUS)
    assert run is TCEM.fused_cem_executor(
        s["tr"], TAU, ITERS, S, TCEM.cem_n_elite(S), roi, mode, RADIUS)
    outs = []
    for shift, seed in ((0.03, 3), (-0.02, 4)):
        args, init = _cem_inputs(s, shift)
        occ = _occ(s, mode, init)
        got = run(*args, occ=occ, generator=_gen(seed))
        want = _eager(s, args, occ, mode, roi, seed)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
        outs.append((got, [w.clone() for w in want]))
    for got, want in outs:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert not np.array_equal(outs[0][0][0].numpy(), outs[1][0][0].numpy())
    assert run.graph.captures == 0 and len(run.graph._entries) == 1


def test_cem_executor_takes_noise_and_checks_its_mode(scene):
    """A caller's draws go in as they are (the eager body fed the same
    `noise`); occluders given to the wrong mode raise."""
    s = scene
    args, init = _cem_inputs(s, 0.01)
    noise = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (ITERS, 3, S, 6)).astype(np.float32))
    run = TCEM.fused_cem_executor(s["tr"], TAU, ITERS, S, TCEM.cem_n_elite(S),
                                  ROI, "poses", RADIUS)
    got = run(*args, occ=_t(init), noise=noise)
    want = _body(s["tr"].Cs, args, _t(init), "poses", ROI, noise=noise)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    with pytest.raises(ValueError, match="occ_mode"):
        run(*args, generator=_gen(0))
    with pytest.raises(ValueError, match="requires roi"):
        TCEM.fused_cem_executor(s["tr"], TAU, ITERS, S, 2, None, "poses")
    with pytest.raises(ValueError, match="not one of"):
        TCEM.fused_cem_executor(s["tr"], TAU, ITERS, S, 2, ROI, "all")


def test_refine_batched_graph_argument(scene):
    """refine_pose_cem_batched(graph=True) goes through the executor and
    equals graph=False (the eager body) bit for bit; None on the CPU is
    the eager body."""
    s = scene
    init = s["poses"].copy()
    init[:, 0, 3] += 0.03
    kw = dict(iters=ITERS, samples=S, init_sigma=(0.08, 0.04), seed=3,
              roi=ROI, occluder_poses=init, device="cpu")
    cache = s["tr"].__dict__.setdefault("_cem_exec_cache", {})
    cache.clear()
    eager = TCEM.refine_pose_cem_batched(s["tr"], s["obs"], init, s["mi"],
                                         graph=False, **kw)
    default = TCEM.refine_pose_cem_batched(s["tr"], s["obs"], init, s["mi"],
                                           **kw)
    assert not cache
    graphed = TCEM.refine_pose_cem_batched(s["tr"], s["obs"], init, s["mi"],
                                           graph=True, **kw)
    assert list(cache) == [(TAU, ITERS, S, TCEM.cem_n_elite(S), ROI, "poses",
                            RADIUS)]
    for a, b, c in zip(eager, default, graphed):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), c.numpy())


def _retrieval_args(s, B):
    rng = np.random.default_rng(7)
    hyps = np.tile(s["poses"][:1], (B, 1, 1))
    hyps[:, :, 3] += rng.uniform(-0.05, 0.05, (B, 3)).astype(np.float32)
    obs = _t(s["obs"])
    dt = likelihood.edge_distance_transform(obs)
    return (_t(hyps), torch.arange(B) % 2, torch.tensor([20.0, 10.0]), dt,
            obs, torch.tensor([30.0, 15.0, 70.0, 50.0]))


def test_retrieval_executor_equals_scores(scene):
    s = scene
    args = _retrieval_args(s, 8)
    run = TCEM.retrieval_executor(s["tr"], ROI, 8)
    assert run is TCEM.retrieval_executor(s["tr"], ROI, 8)
    want = TCEM.retrieval_scores(s["tr"], ROI, *args)
    for _ in range(2):
        np.testing.assert_array_equal(run(*args).numpy(), want.numpy())
    # another detection's box, a device tensor: not captured
    other = args[:5] + (torch.tensor([0.0, 0.0, 64.0, 48.0]),)
    np.testing.assert_array_equal(
        run(*other).numpy(),
        TCEM.retrieval_scores(s["tr"], ROI, *other).numpy())


def test_occluder_executor_equals_eager(scene):
    """Keyed by the number of tracks: 3 and 2 make two entries."""
    s = scene
    run = exclusive_min_executor(s["tr"])
    for k in (3, 2, 3):
        poses, mi = _t(s["poses"][:k]), _t(s["mi"][:k])
        np.testing.assert_array_equal(
            run(poses, mi).numpy(),
            _exclusive_min_depths(s["tr"].Cs, poses, mi, TI).numpy())
    assert len(run._entries) == 2 and run is exclusive_min_executor(s["tr"])


def test_set_meshes_drops_the_executors(scene):
    """After set_meshes with another database the executors are made anew
    and render the new meshes: the same call equals the eager body on the
    new stack and differs from the old result."""
    s = scene
    tr = MultiMeshRenderer(TI, device="cpu")
    tr.set_meshes(s["db"])
    args, init = _cem_inputs(s, 0.03)
    occ = _t(init)
    run = TCEM.fused_cem_executor(tr, TAU, ITERS, S, TCEM.cem_n_elite(S),
                                  ROI, "poses", RADIUS)
    before = run(*args, occ=occ, generator=_gen(3))
    retr = TCEM.retrieval_executor(tr, ROI, 8)
    occ_run = exclusive_min_executor(tr)
    big = {k: (V * 1.3, F) for k, (V, F) in mesh_db().items()}
    tr.set_meshes(big)
    for cache in raster.EXECUTOR_CACHES:
        assert cache not in tr.__dict__
    run2 = TCEM.fused_cem_executor(tr, TAU, ITERS, S, TCEM.cem_n_elite(S),
                                   ROI, "poses", RADIUS)
    assert run2 is not run
    assert TCEM.retrieval_executor(tr, ROI, 8) is not retr
    assert exclusive_min_executor(tr) is not occ_run
    after = run2(*args, occ=occ, generator=_gen(3))
    want = _body(tr.Cs, args, occ, "poses", ROI, generator=_gen(3))
    np.testing.assert_array_equal(after[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(after[1].numpy(), want[1].numpy())
    assert not np.array_equal(after[1].numpy(), before[1].numpy())


@pytest.fixture(scope="module")
def mapper_pairs(scene):
    """The two-object scene through the port's mapper with graph=True and
    graph=False, sync (async_frames 0) and async (3)."""
    T = [scene["T"][0], scene["T"][2]]
    return {(a, g): run_port(a, NAMES, T, scene["db"], graph=g)[0]
            for a in (0, 3) for g in (False, True)}


@pytest.mark.parametrize("async_frames", [0, 3], ids=["sync", "async"])
def test_mapper_graph_equals_eager(mapper_pairs, async_frames, tmp_path):
    """graph=True (the executors' buffers) equals graph=False bit for bit:
    every history packet and the result JSON; packets of different frames
    differ (a packet holding the executor's static output would read the
    last frame's pose)."""
    eager, graphed = (mapper_pairs[async_frames, g] for g in (False, True))
    assert not eager.graphed and graphed.graphed
    assert eager.graphs() == {} and graphed.captures == 0
    paths = []
    for m, name in ((eager, "eager"), (graphed, "graph")):
        paths.append(tmp_path / f"{name}.json")
        m.write_result_json(str(paths[-1]))
    assert paths[0].read_text() == paths[1].read_text()
    packets = json.loads(paths[1].read_text())
    assert len(packets) == N_STEPS
    poses = [[o["model_pose"] for o in p] for p in packets]
    for a, b in zip(poses, poses[1:]):
        assert a != b
    for oid in eager.tracks:
        te, tg = eager.tracks[oid], graphed.tracks[oid]
        np.testing.assert_array_equal(te.pose_wm, tg.pose_wm)
        assert te.score == tg.score and te.age == tg.age
    keys = {(c, k[:5] if c == "_cem_exec_cache" else k)
            for c, k in graphed.graphs()}
    assert ("_retr_exec_cache", ((64, 64), 16)) in keys
    assert ("_cem_exec_cache", (10.0, 3, 12, 3, (64, 64))) in keys
    assert ("_cem_exec_cache", (10.0, 2, 8, 2, (64, 64))) in keys


def test_mapper_warmup_makes_every_executor(scene):
    """warmup(n) makes the executors the scene's frames then use: both
    schedules with occluders in the window and the retrieval over the
    whole database x retrieval_yaws; stepping the scene afterwards makes
    no new runner entry (on the card: no capture after warmup)."""
    from test_torch_semantic import MAPPER_KW, _boxes, _scene_frames, gwc_at
    from visma_tpu_torch.proto import BoundingBox, BoundingBoxList
    from visma_tpu_torch.semantic.mapper import SemanticMapper

    m = SemanticMapper(TI, scene["db"], async_frames=3, device="cpu",
                       graph=True, **MAPPER_KW)
    assert m.warmup(2) > 0 and not m.tracks and not m.history
    entries = {k: len(g._entries) for k, g in m.graphs().items()}
    assert {c for c, _ in entries} == {"_cem_exec_cache", "_retr_exec_cache"}
    assert sorted(k[1][5] for k in entries if k[0] == "_cem_exec_cache") \
        == ["poses", "poses"]
    T = [scene["T"][0], scene["T"][2]]
    frames, poses0 = _scene_frames(m.mrenderer, NAMES, T)
    for i in range(N_STEPS):
        m.step(gwc_at(i), frames[i],
               bboxes=_boxes(m._mesh_aabb, NAMES, poses0, BoundingBox,
                             BoundingBoxList) if i == 0 else None)
    assert {k: len(g._entries) for k, g in m.graphs().items()} == entries
    assert m.captures == 0 and m.capture_ms == []


class _StubStream:
    device = torch.device("cpu")

    def wait_stream(self, other):
        pass


class _StubGraph:
    """Stands in for torch.cuda.CUDAGraph: the call runs once while it is
    "captured" (its launches counted, as the Python of a real capture
    counts them), a replay runs nothing."""

    def capture_begin(self):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


@pytest.fixture
def stub_cuda(monkeypatch):
    """CallGraph's CUDA branches on stand-in streams and graphs, and
    counting stand-ins over K4's and edge_score's wrappers (whose CPU path
    counts nothing): each raises its wrapper's own counter."""
    monkeypatch.setattr(graphs._Captures, "_side_stream",
                        staticmethod(lambda device: _StubStream()))
    monkeypatch.setattr(graphs.torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(graphs.torch.cuda, "current_stream",
                        lambda device=None: _StubStream())
    monkeypatch.setattr(graphs.torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    for mod, name in ((raster, "chunk_raster_batched"),
                      (raster, "chunk_raster_frame"),
                      (likelihood, "edge_score")):
        wrapper = getattr(mod, name)

        def counting(*a, _w=wrapper, **k):
            _w.launches += 1
            return _w(*a, **k)

        monkeypatch.setattr(mod, name, counting)


def test_failed_capture_raises_naming_the_line(scene, stub_cuda,
                                               monkeypatch):
    """A CEM executor whose body fails while it is captured raises
    GraphCaptureError naming the line, keeps no entry, and runs nothing
    eagerly in its place."""
    s = scene
    tr = MultiMeshRenderer(TI, device="cpu")
    tr.set_meshes(s["db"])
    edt = TCEM.edge_distance_transform
    calls = []

    def failing_edt(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return edt(*a, **k)

    monkeypatch.setattr(TCEM, "edge_distance_transform", failing_edt)
    run = TCEM.fused_cem_executor(tr, TAU, ITERS, S, TCEM.cem_n_elite(S),
                                  ROI, "none", RADIUS)
    args, _ = _cem_inputs(s, 0.0)
    run(*args, generator=_gen(0))
    with pytest.raises(GraphCaptureError,
                       match="test_torch_semantic_graph.py:[0-9]+ .*raise "
                             "RuntimeError"):
        run(*args, generator=_gen(0))
    assert run.graph.captures == 0 and not run.graph._entries
    assert len(calls) == 2


def test_launches_counted_through_replays(scene, stub_cuda):
    """After the warm-up call, one capture (counted 0) with its replay and
    one more replay: K4 2 and edge_score 1 a CEM iteration each replay,
    K3 none."""
    s = scene
    tr = MultiMeshRenderer(TI, device="cpu")
    tr.set_meshes(s["db"])
    run = TCEM.fused_cem_executor(tr, TAU, ITERS, S, TCEM.cem_n_elite(S),
                                  ROI, "poses", RADIUS)
    args, init = _cem_inputs(s, 0.0)
    wrappers = _kernels._COUNTED
    k4 = next(w for w in wrappers if w.__name__ == "chunk_raster_batched")
    k3 = next(w for w in wrappers if w.__name__ == "chunk_raster_frame")
    score = next(w for w in wrappers if w.__name__ == "edge_score")
    saved = {w: w.launches for w in (k4, k3, score)}
    try:
        run(*args, occ=_t(init), generator=_gen(0))
        assert (k4.launches - saved[k4], score.launches - saved[score]) \
            == (2 * ITERS, ITERS)
        for w in (k4, k3, score):
            w.launches = 0
        run(*args, occ=_t(init), generator=_gen(0))
        assert run.graph.captures == 1
        assert (k4.launches, score.launches, k3.launches) \
            == (2 * ITERS, ITERS, 0)
        run(*args, occ=_t(init), generator=_gen(0))
        assert run.graph.captures == 1
        assert (k4.launches, score.launches, k3.launches) \
            == (4 * ITERS, 2 * ITERS, 0)
    finally:
        for w, n in saved.items():
            w.launches = n
