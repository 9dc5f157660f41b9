"""The check sees a broken timed path: a run driven with a fault planted in
the program underneath comes out not correct. CPU rehearsals at a small
size; the look for a chip is skipped."""
import pytest

from portbench import harness

SEQ = {"config": {"scene": {"num_frames": 6}}, "traffic": {"sequences": 1}}
FLEET = {"config": {"scene": {"num_frames": 30}},
         "traffic": {"batches": 1, "streams": 4, "frames_per_call": 6,
                     "streams_checked": 1}}
# a tiny camera and CEM; the replay's gaps decide
SEM = {"config": {
    "camera": {"fx": 60.8, "fy": 66.9, "cx": 58.6, "cy": 32.2, "rows": 63,
               "cols": 120},
    "mapper": {"cem_iters": 2, "cem_samples": 4, "roi": [32, 48],
               "retrieval_yaws": 2, "settled_iters": 2, "settled_samples": 4,
               "async_frames": 2},
    "scene": {"objects": 2, "distinct_poses": 3, "warmup_frames": 3}},
    "traffic": {"frames_checked": 1}}


def _unchanged(cfg, state, frame):
    return state


def _altered_outputs(real):
    def outputs(cfg, state):
        out = dict(real(cfg, state))
        out["p"] = out["p"] + 0.01
        return out
    return outputs


def _half_batch(real):
    def step(self, states, frames):
        import torch
        from torch.utils._pytree import tree_map
        new, out = real(self, states, frames)
        B = states.p.shape[0]
        keep = torch.arange(B, device=states.p.device) < B // 2

        def pick(a, b):
            k = keep.reshape((B,) + (1,) * (a.dim() - 1))
            return torch.where(k, a, b)
        new = tree_map(pick, new, states)
        return new, {k: pick(v, states.p if k == "p" else states.R)
                     for k, v in out.items()}
    return step


@pytest.mark.parametrize("workload, size", [
    ("vio.seq", SEQ), ("vio.online", SEQ), ("vio.fleet64", FLEET),
    ("sem.settled", SEM)], ids=["seq", "online", "fleet64", "settled"])
def test_sound_run_is_correct(workload, size):
    assert harness.rehearse(workload, 2 ** 31 + 11, 0.2,
                            **size)["correct"] is True


@pytest.mark.parametrize("workload, size", [
    ("vio.seq", SEQ), ("vio.online", SEQ), ("vio.fleet64", FLEET)],
    ids=["seq", "online", "fleet64"])
def test_state_left_unchanged(monkeypatch, workload, size):
    import visma_tpu_torch.filter.msckf as msckf
    import visma_tpu_torch.pipeline as pipeline
    monkeypatch.setattr(pipeline, "_frame_step", _unchanged)
    monkeypatch.setattr(msckf, "_frame_step", _unchanged)
    assert harness.rehearse(workload, 2 ** 31 + 12, 0.2,
                            **size)["correct"] is False


@pytest.mark.parametrize("workload, size", [("vio.seq", SEQ),
                                            ("vio.fleet64", FLEET)],
                         ids=["seq", "fleet64"])
def test_answer_altered(monkeypatch, workload, size):
    import visma_tpu_torch.filter.msckf as msckf
    import visma_tpu_torch.pipeline as pipeline
    monkeypatch.setattr(pipeline, "_frame_outputs",
                        _altered_outputs(pipeline._frame_outputs))
    monkeypatch.setattr(msckf.Msckf, "_batched_step",
                        _altered_batched(msckf.Msckf._batched_step))
    assert harness.rehearse(workload, 2 ** 31 + 13, 0.2,
                            **size)["correct"] is False


def _altered_batched(real):
    """Every stream's position moved 10 cm where the batched step produces
    it: past the fleet's limit of 3 cm, which the filter's drift over noisy
    feeds (2.2 mm) and the control (18 cm) set."""
    def step(self, states, frames):
        new, out = real(self, states, frames)
        return new, dict(out, p=out["p"] + 0.1)
    return step


def test_online_pose_altered(monkeypatch):
    import visma_tpu_torch.pipeline as pipeline
    real = pipeline.VioPipeline.pose

    def pose(self, state):
        R, p = real(self, state)
        return R, p + 0.01
    monkeypatch.setattr(pipeline.VioPipeline, "pose", pose)
    assert harness.rehearse("vio.online", 2 ** 31 + 14, 0.2,
                            **SEQ)["correct"] is False


def test_fleet_half_batch_left_out(monkeypatch):
    import visma_tpu_torch.filter.msckf as msckf
    monkeypatch.setattr(msckf.Msckf, "_batched_step",
                        _half_batch(msckf.Msckf._batched_step))
    assert harness.rehearse("vio.fleet64", 2 ** 31 + 15, 0.2,
                            **FLEET)["correct"] is False


def test_tracker_answer_altered(monkeypatch):
    """A tracked pixel moved where the tracker produces it."""
    import visma_tpu_torch.frontend.tracker as tracker
    real = tracker.FeatureTracker._step_impl

    def step(self, state, image):
        st, ids, xp, valid = real(self, state, image)
        xp = xp + 0.5
        return st.__class__(ids=st.ids, pos=xp, age=st.age,
                            next_id=st.next_id, pyr=st.pyr), ids, xp, valid
    monkeypatch.setattr(tracker.FeatureTracker, "_step_impl", step)
    assert harness.rehearse("vio.seq", 2 ** 31 + 16, 0.2,
                            **SEQ)["correct"] is False


def _async_unchanged(self, tracks, G, G_cw, edge_map, *args):
    """A settled step that leaves the device-resident poses as they were."""
    self.history.append(("dev", G.copy(), self._dev["poses"],
                         [(tr.oid, tr.model_name, tr.status)
                          for tr in tracks]))
    for tr in tracks:
        tr.age += 1


def _cem_altered(real):
    def run(*args, **kw):
        poses, scores = real(*args, **kw)
        return poses + 0.01, scores
    return run


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_semantic_faults(monkeypatch, fault):
    import visma_tpu_torch.semantic.mapper as mapper
    if fault == "unchanged":
        monkeypatch.setattr(mapper.SemanticMapper, "_step_async",
                            _async_unchanged)
    else:
        monkeypatch.setattr(mapper, "_cem_run",
                            _cem_altered(mapper._cem_run))
    assert harness.rehearse("sem.settled", 2 ** 31 + 17, 0.1,
                            **SEM)["correct"] is False
