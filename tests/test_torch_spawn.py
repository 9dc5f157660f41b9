"""The semantic mapper on detection frames, from an empty map, on the CPU
at a small camera (96x128, windows of 48x64) with the small procedural
meshes of test_torch_semantic.py under the benchmark's model names and a
seeded three-object room (the benchmark's `sem.spawn` scene, cut down):

* the plain reference's retrieval (portbench/reference/semantic/
  retrieve.py) against `SemanticMapper.retrieve_shape`;
* a spawn frame and a settled sync frame of the eager mapper against the
  benchmark's replay of them by the reference, with the same draws;
* `reset()`: a second sequence bit for bit a new mapper's, on the same
  renderer and executors;
* `warmup` over counts: every occluder mode, and a growing map then
  makes no new executor shape;
* the spans `semantic.dedup` / `semantic.readback` and the stage
  `retrieve`, recorded only while recording is on, and the mapper's count
  of CEM windows."""
import json
import types

import numpy as np
import pytest
import torch

from portbench.entries import semantic_spawn as entry
from portbench.reference.semantic import raster as ref_raster
from portbench.reference.semantic import retrieve as ref_retrieve
from portbench.reference.semantic import score as ref_score
from portbench.scenes import semantic as scenes
from test_torch_semantic import mesh_db as small_meshes
from visma_tpu_torch.render.camera import Intrinsics
from visma_tpu_torch.semantic.mapper import SemanticMapper
from visma_tpu_torch.utils import trace

CAM = dict(fx=100.0, fy=110.0, cx=63.5, cy=47.5, rows=96, cols=128,
           z_near=0.05, z_far=8.0)
MAPPER = dict(cem_iters=2, cem_samples=6, cem_sigma=[0.15, 0.08],
              roi=[48, 64], retrieval_yaws=4, settle_age=2, settled_iters=2,
              settled_samples=4, settled_sigma=[0.05, 0.03], async_frames=2,
              roi_spawn=True, coverage_radius=2)
FRAMES = 6            # objects first seen at frames 0, 0 and 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: one torch thread beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _recording_off():
    trace.disable()
    yield
    trace.disable()


def _db():
    small = small_meshes()
    return {"chair": small["stool"], "desk": small["cabinet"]}


@pytest.fixture(scope="module")
def room():
    """The benchmark entry's `run` for two seeded sequences of a
    three-object room (slots in the small camera's view)."""
    db = _db()
    Vs, Fs = ref_raster.pad_mesh_stack([db[n] for n in db])
    run = types.SimpleNamespace(
        config={"camera": CAM, "mapper": MAPPER,
                "scene": {"slots": [[-1.1, 2.6], [0.55, 2.9], [-0.2, 3.9]],
                          "strafe_step_m": 0.015, "distinct_poses": 4}},
        traffic={"first_detections": 2, "detect_every": 2,
                 "frames": FRAMES},
        seed=2 ** 31 + 91, device=torch.device("cpu"), db_names=list(db),
        aabbs={n: (V.astype(np.float64).min(0), V.astype(np.float64).max(0))
               for n, (V, _) in db.items()},
        ref_intr=ref_raster.Intrinsics(**CAM),
        ref_Cs=torch.as_tensor(ref_raster.face_corner_stack(Vs, Fs)),
        gwcs=scenes.strafe(4, 0.015))
    run.seqs = [entry._sequence(run, k) for k in range(2)]
    assert [len(b.bounding_boxes) for b in run.seqs[0]["boxes"]] \
        == [2, 2, 3, 3, 3, 3]
    assert all(bool(s["edges"].sum() > 50) for s in run.seqs)
    return run


def _mapper(graph=False):
    mp = {k: tuple(v) if isinstance(v, list) else v
          for k, v in MAPPER.items()}
    mp["init_sigma"] = mp.pop("cem_sigma")
    return SemanticMapper(Intrinsics(**CAM), _db(), device="cpu",
                          graph=graph, **mp)


def _map(mapper, seq, boxes_after=FRAMES):
    """Step the sequence's frames, its boxes on the first `boxes_after`
    frames only; returns the mapper's history list."""
    for t in range(FRAMES):
        k = scenes.path_index(t, 4)
        mapper.step(scenes.strafe(4, 0.015)[k], seq["edges"][k],
                    seq["boxes"][t] if t < boxes_after else None)
    return mapper.history


def test_reference_retrieval_equals_retrieve_shape(room):
    """Every detection of the room's first pose: the same model and yaw,
    the same start pose and, on the CPU's plain raster and score, the
    same score; each retrieval counts its hypotheses as CEM windows."""
    m = _mapper()
    seq = room.seqs[0]
    edge = seq["edges"][0]
    dt = ref_score.edge_distance_transform(edge)
    picks = set()
    for bb in seq["boxes"][FRAMES - 1].bounding_boxes:
        name, T, score = m.retrieve_shape(bb, edge)
        r = ref_retrieve.retrieve(bb, edge, dt, room.ref_Cs, room.db_names,
                                  room.aabbs, room.ref_intr,
                                  tuple(MAPPER["roi"]),
                                  MAPPER["retrieval_yaws"])
        assert name == r.name
        np.testing.assert_allclose(T, r.pose_cm, rtol=0, atol=1e-6)
        np.testing.assert_allclose(score, r.score, rtol=1e-6)
        picks.add(name)
    assert m.counts["cem_windows"] == 3 * len(_db()) * MAPPER["retrieval_yaws"]


def test_spawn_and_settled_frames_equal_the_reference_replay(room):
    """The eager mapper's frame 2 (a new object: dedup, retrieval, the
    spawn CEM of three tracks) and frame 5 (every track settled, the sync
    path) against the benchmark's reference replay from the packets of
    the frames before: the same spawns and models, the same poses. Every
    frame took the sync path, four of them the spawn schedule."""
    m = _mapper()
    hist = _map(m, room.seqs[0])
    assert [len(p) for p in hist] == [2, 2, 3, 3, 3, 3]
    room.mapped = [(0, hist)]
    for t in (2, 5):
        got = entry.replay(room, 0, t)
        assert got["spawn_mismatch"] == 0 and got["models_wrong"] == 0
        assert got["pos_gap_m"] <= 1e-6 and got["rot_gap_rad"] <= 1e-6
    assert all(isinstance(p, list) for p in hist)
    spawn = MAPPER["cem_samples"] * MAPPER["cem_iters"]
    settled = MAPPER["settled_samples"] * MAPPER["settled_iters"]
    assert m.counts["cem_windows"] == (2 * 2 * spawn + 2 * 3 * spawn
                                       + 2 * 3 * settled
                                       + 3 * 2 * MAPPER["retrieval_yaws"])


def test_reset_keeps_the_executors_and_equals_a_new_mapper(room):
    """A second sequence after reset(): bit for bit a new mapper's run of
    it (sync and async frames), through the same renderer and the same
    executor objects; the counts run on across the reset."""
    a = _mapper(graph=True)
    _map(a, room.seqs[0], boxes_after=1)
    renderer = a.mrenderer
    runners = {k: id(g) for k, g in a.graphs().items()}
    first = a.history
    assert any(isinstance(p, tuple) for p in first)
    a.reset()
    assert a.history is not first and not a.tracks and a.history == []
    assert all(isinstance(p, list) for p in first)
    _map(a, room.seqs[1], boxes_after=1)
    b = _mapper(graph=True)
    _map(b, room.seqs[1], boxes_after=1)
    a.finalize()
    b.finalize()
    assert json.dumps(a.history) == json.dumps(b.history)
    assert a.counts["cem_windows"] == 2 * b.counts["cem_windows"] > 0
    assert a.mrenderer is renderer
    now = {k: id(g) for k, g in a.graphs().items()}
    assert {k: now[k] for k in runners} == runners
    assert [o["id"] for o in a.history[-1]] == [0, 1]


def _entries(m):
    """{(cache, key): {input shape key: calls}} of the mapper's runners."""
    return {k: {s: e.warm for s, e in g._entries.items()}
            for k, g in m.graphs().items()}


@pytest.fixture(scope="module")
def warmed():
    """A graphed mapper after warmup(range(1, 4)), and its runners' input
    shapes then."""
    m = _mapper(graph=True)
    assert m.warmup(range(1, 4)) > 0 and not m.tracks
    return m, _entries(m)


def test_warmup_over_counts_makes_every_mode(warmed):
    """warmup over counts makes the CEM of both schedules in both window
    occluder modes, "poses" and "none"; warmup(2) keeps to "poses"."""
    _, before = warmed
    modes = {(k[1][2], k[1][5]) for k in before
             if k[0] == "_cem_exec_cache"}
    assert modes == {(6, "poses"), (6, "none"), (4, "poses"), (4, "none")}
    w = _mapper(graph=True)
    w.warmup(2)
    assert {k[1][5] for k in w.graphs() if k[0] == "_cem_exec_cache"} \
        == {"poses"}


def test_growing_map_makes_no_new_shape(room, warmed):
    """After warmup(range(1, 4)), mapping the room (the first two objects
    alone until they settle, whose footprints are then disjoint, then the
    third, then frames without detections) adds no executor and no input
    shape to any, and runs the occluder-free CEM of two tracks that
    `warmup(2)` leaves to a live frame."""
    m, before = warmed
    m.reset()
    seq = room.seqs[0]
    for t in range(FRAMES + 2):
        k = scenes.path_index(t, 4)
        boxes = (seq["boxes"][0] if t < 4 else
                 seq["boxes"][FRAMES - 1] if t < FRAMES else None)
        m.step(room.gwcs[k], seq["edges"][k], boxes)
    after = _entries(m)
    assert {k: set(v) for k, v in after.items()} \
        == {k: set(v) for k, v in before.items()}
    used = {(k[1][2], k[1][5], s[1][0][0][0]) for k, v in after.items()
            for s, n in v.items()
            if k[0] == "_cem_exec_cache" and n > before[k][s]}
    assert (4, "none", 2) in used and (6, "poses", 3) in used
    assert m.captures == 0


def test_spans_stage_and_counts(room, monkeypatch):
    """Recording on: a detection frame leaves a `semantic.dedup` span a
    box, a `semantic.spawn`, `semantic.retrieve` and `retrieve` span a new
    object and one `semantic.readback`; the count adds the frame's CEM
    windows. Off: the spans are the null context and nothing is recorded;
    the count still counts."""
    import collections
    monkeypatch.setattr(trace, "rows", collections.deque(maxlen=4096))
    assert trace.STAGES[-1] == "retrieve"
    assert trace.MARKS[14] == ("retrieve", "begin")
    assert trace.MARKS[12] == ("cem.select", "begin")
    m = _mapper()
    assert m.counts == {"cem_windows": 0}
    seq = room.seqs[0]
    trace.enable()
    m.step(room.gwcs[0], seq["edges"][0], seq["boxes"][0])
    trace.disable()
    names = [r[0] for r in trace.rows if r[0] != "host.gc"]
    for name, n in (("semantic.dedup", 2), ("semantic.spawn", 2),
                    ("semantic.retrieve", 2), ("retrieve", 2),
                    ("semantic.readback", 1), ("semantic.step", 1)):
        assert names.count(name) == n, name
    S, it, yaws = MAPPER["cem_samples"], MAPPER["cem_iters"], \
        MAPPER["retrieval_yaws"]
    assert m.counts == {"cem_windows": 2 * S * it + 2 * 2 * yaws}
    rows = len(trace.rows)
    assert trace.span("semantic.dedup") is trace.span("semantic.readback")
    m.step(room.gwcs[1], seq["edges"][1], seq["boxes"][1])
    assert len(trace.rows) == rows
    assert m.counts == {"cem_windows": 2 * (2 * S * it) + 2 * 2 * yaws}
    assert len(m.tracks) == 2
