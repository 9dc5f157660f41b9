"""Parity of the port's in-state SLAM landmarks (visma_tpu_torch.filter.slam
and its hooks in the frame step) with the JAX reference on the CPU: the same
seeded numpy inputs through both, with the tolerance stated in each test."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from visma_tpu.filter import FilterConfig as JConfig, Msckf as JMsckf
from visma_tpu.filter import slam as jslam
from visma_tpu.filter.state import init_state as j_init_state
from visma_tpu.geom import rotations as jrot
from visma_tpu.io.synthetic import (SyntheticConfig, make_dataset, make_imu,
                                    make_trajectory)
from visma_tpu.proto import FeatureStatus

from visma_tpu_torch import convert
from visma_tpu_torch.filter import msckf as tmsckf, slam as tslam
from visma_tpu_torch.filter.config import FilterConfig
from visma_tpu_torch.filter.feed import pack_frames
from visma_tpu_torch.filter.state import FilterState

# hand-built states: a window of 4 clones, 3 landmark slots
SMALL = dict(window=4, max_tracks=8, max_updates=4, fx=400.0, fy=400.0,
             cx=320.0, cy=240.0, num_slam=3, slam_max_missed=2,
             max_promote=3)


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def to_port(jstate):
    return convert.from_reference(jax.tree.map(np.asarray, jstate),
                                  FilterState)


def _hand_state(cfg, seed=0):
    """A JAX FilterState with a valid random clone window looking down +z,
    an SPD covariance with cross terms, landmarks 5 and 9 in slots 0 and 2
    (slot 1 empty) about 3 m ahead of the newest clone."""
    rng = np.random.default_rng(seed)
    M, D, s0 = cfg.window, cfg.dim, cfg.slam_idx
    s = j_init_state(cfg)
    win_R = np.asarray(jrot.rodrigues(
        rng.normal(scale=0.05, size=(M, 3)).astype(np.float32)))
    win_p = (np.linspace(0, 0.3, M)[:, None] * [1.0, 0.2, 0.0]
             ).astype(np.float32)
    G = rng.normal(size=(D, D))
    P = 1e-4 * (G @ G.T) / D + 1e-4 * np.eye(D)
    live = np.array([True, False, True])
    dead = np.repeat(~live, 3)
    P[s0:][dead] = 0.0                      # empty slots: zero rows/columns
    P[:, s0:][:, dead] = 0.0
    lm_xw = (rng.normal(scale=[0.8, 0.5, 0.3], size=(3, 3))
             + win_p[-1] + [0.0, 0.0, 3.0]).astype(np.float32)
    lm_xw[1] = 0.0
    return s.replace(win_R=jnp.asarray(win_R), win_p=jnp.asarray(win_p),
                     win_valid=jnp.ones(M, bool),
                     P=jnp.asarray(P.astype(np.float32)),
                     lm_ids=jnp.asarray([5, -1, 9], jnp.int32),
                     lm_xw=jnp.asarray(lm_xw))


def _observe(cfg, s, ids_seen, noise=0.5, seed=1):
    """Frame observations (F = 8): ids_seen observed at their projection
    into the newest clone plus noise, two features that are not landmarks,
    the rest invalid."""
    rng = np.random.default_rng(seed)
    F = 8
    ids = np.full(F, -1, np.int32)
    xp = np.zeros((F, 2), np.float32)
    valid = np.zeros(F, bool)
    Rc, pc = np.asarray(s.win_R[-1]), np.asarray(s.win_p[-1])
    lm_ids, lm_xw = np.asarray(s.lm_ids), np.asarray(s.lm_xw)
    for j, fid in enumerate(ids_seen):
        X = lm_xw[list(lm_ids).index(fid)]
        Xc = Rc.T @ (X - pc)
        ids[j] = fid
        xp[j] = [cfg.fx * Xc[0] / Xc[2] + cfg.cx,
                 cfg.fy * Xc[1] / Xc[2] + cfg.cy]
        xp[j] += rng.normal(scale=noise, size=2)
        valid[j] = True
    ids[5:7] = [40, 41]
    xp[5:7] = [[100.0, 120.0], [300.0, 200.0]]
    valid[5:7] = True
    return ids, xp, valid


def _assert_slam_close(ts, js, atol=1e-5):
    np.testing.assert_array_equal(_np(ts.lm_ids), np.asarray(js.lm_ids))
    np.testing.assert_array_equal(_np(ts.lm_missed), np.asarray(js.lm_missed))
    for name in ("R", "p", "win_R", "win_p", "lm_xw", "P"):
        np.testing.assert_allclose(_np(getattr(ts, name)),
                                   np.asarray(getattr(js, name)),
                                   atol=atol, err_msg=name)


def test_in_state_mask():
    lm_ids = np.asarray([3, -1, 7, -1], np.int32)
    ids = np.asarray([7, 1, 3, -1, 3, 9], np.int32)
    got = _np(tslam.in_state(_t(lm_ids), _t(ids)))
    np.testing.assert_array_equal(
        got, np.asarray(jslam.in_state(jnp.asarray(lm_ids),
                                       jnp.asarray(ids))))
    np.testing.assert_array_equal(got, [True, False, True, False, True,
                                        False])


@pytest.mark.parametrize("schmidt", [False, True])
def test_slam_update_matches_jax(schmidt):
    """Landmark 9 observed with 0.5 px noise, landmark 5 unseen: lm_ids and
    the missed counters equal, pose, landmarks and P within 1e-5. In
    Schmidt mode the landmark block of the state does not move."""
    kw = dict(SMALL, schmidt=schmidt)
    jcfg, tcfg = JConfig(**kw), FilterConfig(**kw)
    js = _hand_state(jcfg)
    ids, xp, valid = _observe(jcfg, js, [9])
    ref = jax.jit(jslam.slam_update, static_argnums=0)(
        jcfg, js, jnp.asarray(ids), jnp.asarray(xp), jnp.asarray(valid))
    got = tslam.slam_update(tcfg, to_port(js), _t(ids), _t(xp), _t(valid))
    _assert_slam_close(got, ref)
    np.testing.assert_array_equal(_np(got.lm_missed), [1, 0, 0])
    moved = np.abs(_np(got.p) - np.asarray(js.p)).max()
    assert moved > 1e-6, "the landmark update did not correct the pose"
    if schmidt:
        np.testing.assert_array_equal(_np(got.lm_xw), np.asarray(js.lm_xw))


def test_slam_update_slot_drop():
    """test_slam.py:120's lifecycle: a landmark unseen for slam_max_missed
    + 1 frames frees its slot and zeroes its covariance rows and columns,
    the same frame in both."""
    jcfg, tcfg = JConfig(**SMALL), FilterConfig(**SMALL)
    js = _hand_state(jcfg)
    ids, xp, valid = _observe(jcfg, js, [9])     # 5 is never seen
    jstep = jax.jit(jslam.slam_update, static_argnums=0)
    ts = to_port(js)
    for _ in range(tcfg.slam_max_missed + 1):
        js = jstep(jcfg, js, jnp.asarray(ids), jnp.asarray(xp),
                   jnp.asarray(valid))
        ts = tslam.slam_update(tcfg, ts, _t(ids), _t(xp), _t(valid))
        _assert_slam_close(ts, js)
    np.testing.assert_array_equal(_np(ts.lm_ids), [-1, -1, 9])
    s0 = tcfg.slam_idx
    P = _np(ts.P)
    assert not P[s0:s0 + 3].any() and not P[:, s0:s0 + 3].any()


def _candidates(cfg, s, seed=2):
    """Three promotion candidates seen through the window: a fresh feature
    (id 20), one whose id is already a landmark (9: refused), and one seen
    twice (id 21), refused because the first took the last empty slot."""
    rng = np.random.default_rng(seed)
    M = cfg.window
    win_R, win_p = np.asarray(s.win_R), np.asarray(s.win_p)
    X = (rng.normal(scale=[0.6, 0.4, 0.3], size=(3, 3))
         + [0.0, 0.0, 3.0]).astype(np.float32)
    Xc = np.einsum("mji,cmj->cmi", win_R, X[:, None] - win_p)
    obs = np.stack([cfg.fx * Xc[..., 0] / Xc[..., 2] + cfg.cx,
                    cfg.fy * Xc[..., 1] / Xc[..., 2] + cfg.cy], -1)
    obs = (obs + rng.normal(scale=0.5, size=obs.shape)).astype(np.float32)
    mask = np.ones((3, M), bool)
    mask[2, :M - 2] = False
    X = (X + rng.normal(scale=0.01, size=X.shape)).astype(np.float32)
    return (X, obs, mask, np.asarray([20, 9, 21], np.int32),
            np.asarray([True, True, True]))


@pytest.mark.parametrize("schmidt", [False, True])
def test_slam_promote_matches_jax(schmidt):
    """Delayed initialization into the one empty slot: the same candidates
    promote, lm_ids equal, the new landmark and P within 1e-5 (the QR's
    column signs are free; what the test compares is invariant to them)."""
    kw = dict(SMALL, schmidt=schmidt)
    jcfg, tcfg = JConfig(**kw), FilterConfig(**kw)
    js = _hand_state(jcfg)
    cand = _candidates(jcfg, js)
    ref, done_j = jax.jit(jslam.slam_promote, static_argnums=0)(
        jcfg, js, *[jnp.asarray(c) for c in cand])
    got, done_t = tslam.slam_promote(tcfg, to_port(js), *[_t(c) for c in cand])
    np.testing.assert_array_equal(_np(done_t), np.asarray(done_j))
    np.testing.assert_array_equal(_np(done_t), [True, False, False])
    _assert_slam_close(got, ref)
    np.testing.assert_array_equal(_np(got.lm_ids), [5, 20, 9])
    # the third candidate was refused for want of a slot after the first
    s0 = tcfg.slam_idx
    assert (np.diag(_np(got.P))[s0 + 3:s0 + 6] > 0).all()


# ---------------------------------------------------------------------------
# The whole filter: test_slam.py's scene cut to 24 frames
# ---------------------------------------------------------------------------

class _SlamScene:
    def __init__(self, schmidt, num_frames=24):
        syn = SyntheticConfig(num_frames=num_frames, num_landmarks=120,
                              pixel_noise=0.5, seed=3)
        kw = dict(window=8, max_tracks=96, max_updates=24, imu_per_frame=8,
                  fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy,
                  pixel_noise=0.5, num_slam=16, schmidt=schmidt)
        self.tcfg = FilterConfig(**kw)
        imu = make_imu(syn)
        self.frames = {k: v for k, v in pack_frames(
            self.tcfg, make_dataset(syn), imu, max_feats=96).items()
            if k != "ts"}
        _, self.gwc = make_trajectory(syn)
        self.init = dict(R0=self.gwc[0, :, :3], p0=self.gwc[0, :, 3],
                         v0=imu["v0"])
        # the reference steps frame by frame through its jitted step (one
        # compile; Msckf.run scans the same step)
        jkf = JMsckf(JConfig(**kw))
        js, out = jkf.init(**self.init), []
        for i in range(num_frames):
            js = jkf.step(js, {k: jnp.asarray(v[i])
                               for k, v in self.frames.items()})
            out.append([np.asarray(x) for x in (js.p, js.tracks.status,
                                                js.lm_ids, js.lm_xw)])
        self.jp, self.jstatus, self.jlm_ids, self.jlm_xw = (
            np.stack(x) for x in zip(*out))


@pytest.fixture(scope="module", params=[False, True], ids=["full", "schmidt"])
def slam_scene(request):
    return _SlamScene(request.param)


def test_run_matches_jax(slam_scene):
    """24 frames with 16 landmark slots: lm_ids and feat_status equal on
    every frame, p within 1e-5 m, lm_xw within 1e-4 m; landmarks promote,
    INSTATE is exported, and Msckf.run's outputs carry lm_ids / lm_xw."""
    sc = slam_scene
    tk = tmsckf.Msckf(sc.tcfg, device="cpu")
    final, to = tk.run(tk.init(**sc.init),
                       {k: _t(v) for k, v in sc.frames.items()})
    tmsckf.check_health(to)
    np.testing.assert_array_equal(_np(to["lm_ids"]), sc.jlm_ids)
    np.testing.assert_array_equal(_np(to["feat_status"]), sc.jstatus)
    np.testing.assert_allclose(_np(to["p"]), sc.jp, atol=1e-5)
    np.testing.assert_allclose(_np(to["lm_xw"]), sc.jlm_xw, atol=1e-4)
    assert (sc.jlm_ids[-1] >= 0).sum() >= 8
    assert (sc.jstatus == int(FeatureStatus.INSTATE)).any()
    P = _np(final.P)
    np.testing.assert_allclose(P, P.T, atol=1e-6)
    if sc.tcfg.schmidt:
        # test_slam.py:85's property: a landmark keeps its estimate from
        # its promotion on
        ids, xw = _np(to["lm_ids"]), _np(to["lm_xw"])
        for j in range(ids.shape[1]):
            live = np.flatnonzero(ids[:, j] >= 0)
            if live.size >= 2 and (ids[live, j] == ids[live[0], j]).all():
                np.testing.assert_array_equal(xw[live, j], xw[live[:1], j]
                                              .repeat(live.size, 0))
