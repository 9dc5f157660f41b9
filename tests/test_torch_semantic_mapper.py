"""The port's semantic mapper run through several frames against the JAX
reference's (sync and async, fed the reference's draws), the result JSON
and the state converters: the `mapper_runs` cases of
tests/test_torch_semantic.py, whose scene and helpers they share. They
have a file of their own so that under `--dist loadfile` their fixture,
the slowest of the fast tier, runs on a worker beside the rest of the
semantic tests instead of after them. Tolerances as in that file."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_semantic import (  # noqa: F401  (scene: the shared fixture)
    CAP, JI, MAPPER_KW, N_STEPS, POSE_TOL, TI, KW, JaxDraws, _boxes,
    _scene_frames, gwc_at, run_port, scene)
from visma_tpu.proto import BoundingBox as JBox, BoundingBoxList as JBoxes
from visma_tpu.semantic.mapper import SemanticMapper as JMapper
from visma_tpu_torch import convert
from visma_tpu_torch.semantic import cem as TCEM
from visma_tpu_torch.semantic.mapper import ObjectTrack, SemanticMapper


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The mapper's tensors are small: one torch thread is faster than
    many beside the suite's other workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mapper_runs(scene):
    """The two-object scene through the port's mapper (sync and async,
    and async through the executors, `graph=True`, fed the reference's
    draws) and through the reference's (async)."""
    names = ["stool", "cabinet"]
    T = [scene["T"][0], scene["T"][2]]
    mp = pytest.MonkeyPatch()
    mp.setattr(TCEM, "_draw", JaxDraws())
    try:
        t_async, frames = run_port(3, names, T, scene["db"])
        t_sync, _ = run_port(0, names, T, scene["db"])
        t_graph, _ = run_port(3, names, T, scene["db"], graph=True)
    finally:
        mp.undo()
    jm = JMapper(JI, scene["db"], async_frames=3, **MAPPER_KW)
    jm.mrenderer.capacity = CAP
    poses0 = np.stack([t[:3, :4] for t in T]).astype(np.float32)
    for i in range(N_STEPS):
        jm.step(gwc_at(i), jnp.asarray(frames[i].numpy()),
                bboxes=_boxes(jm._mesh_aabb, names, poses0, JBox, JBoxes)
                if i == 0 else None)
    return dict(t_async=t_async, t_sync=t_sync, t_graph=t_graph, jm=jm,
                names=names, T=T)


def test_mapper_retrieves_and_settles_like_the_reference(mapper_runs):
    """Spawn with retrieval (no class matches a model), settle, async
    steady state: the same models, ages and, fed the same draws, poses
    within 2e-3 of the reference's."""
    r = mapper_runs
    ta, jm = r["t_async"], r["jm"]
    # the host mirror is stale until finalize(): poses stay on the device
    assert ta._dev is not None and ta._dev["pending"] > 0
    assert isinstance(ta.history[-1], tuple)
    ta.finalize()
    jm.finalize()
    assert [t.model_name for t in ta.tracks.values()] == r["names"]
    assert [t.model_name for t in jm.tracks.values()] == r["names"]
    for k in range(2):
        tt, jt = ta.tracks[k], jm.tracks[k]
        assert (tt.age, tt.status, tt.oid) == (jt.age, jt.status, jt.oid)
        np.testing.assert_allclose(tt.pose_wm, jt.pose_wm, atol=POSE_TOL)
        assert abs(tt.score - jt.score) < 5e-3
        # coarse: at this resolution depth along the ray is weakly seen
        assert np.linalg.norm(tt.pose_wm[:3, 3] - r["T"][k][:3, 3]) < 0.15


def test_mapper_graph_run_matches_the_reference(mapper_runs, tmp_path):
    """The slice as a whole: the mapper through its executors (the CEM,
    the retrieval; on the CPU their buffers), fed the reference's draws,
    within POSE_TOL of the reference's in every packet, and bit for bit
    the eager port's result JSON."""
    r = mapper_runs
    tg, ta, jm = r["t_graph"], r["t_async"], r["jm"]
    assert tg.graphed and not ta.graphed and tg.graphs()
    paths = [tmp_path / f"{k}.json" for k in ("graph", "eager", "jax")]
    for m, path in zip((tg, ta, jm), paths):
        m.write_result_json(str(path))
    assert paths[0].read_text() == paths[1].read_text()
    tj, jj = (json.loads(p.read_text()) for p in (paths[0], paths[2]))
    assert len(tj) == len(jj) == N_STEPS
    for pt, pj in zip(tj, jj):
        assert [(o["id"], o["model_name"]) for o in pt] \
            == [(o["id"], o["model_name"]) for o in pj]
        for ot, oj in zip(pt, pj):
            np.testing.assert_allclose(ot["model_pose"], oj["model_pose"],
                                       atol=POSE_TOL)
    for k in range(2):
        np.testing.assert_allclose(tg.tracks[k].pose_wm, jm.tracks[k].pose_wm,
                                   atol=POSE_TOL)


def test_mapper_async_equals_sync(mapper_runs):
    ta, ts = mapper_runs["t_async"], mapper_runs["t_sync"]
    ta.finalize()
    ts.finalize()
    assert ts._dev is None
    for k in range(2):
        np.testing.assert_allclose(ta.tracks[k].pose_wm,
                                   ts.tracks[k].pose_wm, atol=5e-4)


def test_mapper_result_json_matches(mapper_runs, tmp_path):
    r = mapper_runs
    tp, jp = tmp_path / "t.json", tmp_path / "j.json"
    r["t_async"].write_result_json(str(tp))
    r["jm"].write_result_json(str(jp))
    tj, jj = json.loads(tp.read_text()), json.loads(jp.read_text())
    assert len(tj) == len(jj) == N_STEPS
    for pt, pj in zip(tj, jj):
        assert [sorted(o) for o in pt] == [sorted(o) for o in pj]
        for ot, oj in zip(pt, pj):
            assert {k: ot[k] for k in ("id", "model_name", "status")} \
                == {k: oj[k] for k in ("id", "model_name", "status")}
            np.testing.assert_allclose(ot["model_pose"], oj["model_pose"],
                                       atol=POSE_TOL)


def test_convert_renderer_and_tracks(scene, mapper_runs):
    """A reference MultiMeshRenderer's mesh stack and a reference mapper's
    tracks become the port's, and back."""
    tr = convert.renderer_from_reference(scene["jr"], device="cpu")
    assert tr.intr == TI and tr.names == scene["jr"].names
    for a in ("Vs", "Fs", "Cs"):
        np.testing.assert_array_equal(getattr(tr, a).numpy(),
                                      np.asarray(getattr(scene["jr"], a)))
    back = convert.renderer_to_numpy(tr)
    assert back["intr"] == KW and back["names"] == tr.names
    np.testing.assert_array_equal(back["Cs"], np.asarray(scene["jr"].Cs))
    d = tr.render_depth(scene["poses"], scene["mi"])
    np.testing.assert_array_equal(
        d.numpy(), scene["tr"].render_depth(scene["poses"],
                                            scene["mi"]).numpy())

    jm = mapper_runs["jm"]
    jm.finalize()
    tracks = convert.tracks_from_reference(jm.tracks)
    assert list(tracks) == list(jm.tracks)
    for oid, t in tracks.items():
        assert isinstance(t, ObjectTrack)
        assert (t.model_name, t.age, t.status) == (
            jm.tracks[oid].model_name, jm.tracks[oid].age,
            jm.tracks[oid].status)
        np.testing.assert_array_equal(t.pose_wm, jm.tracks[oid].pose_wm)
    rows = convert.tracks_to_numpy(tracks)
    assert [r["oid"] for r in rows] == sorted(tracks)
    again = convert.tracks_from_reference(rows)
    np.testing.assert_array_equal(again[1].pose_wm, tracks[1].pose_wm)
    # the port's mapper carries on from the reference's tracks
    tm = SemanticMapper(TI, scene["db"], device="cpu", **MAPPER_KW)
    tm.tracks = tracks
    tm._next_id = len(tracks)
    frames, _ = _scene_frames(tm.mrenderer, mapper_runs["names"],
                              mapper_runs["T"])
    tm.step(gwc_at(N_STEPS - 1), frames[-1])
    for k in range(2):
        assert np.linalg.norm(tm.tracks[k].pose_wm[:3, 3]
                              - mapper_runs["T"][k][:3, 3]) < 0.15
        assert tm.tracks[k].age == tracks[k].age
