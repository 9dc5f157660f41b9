"""Parity of the PyTorch port's filter (visma_tpu_torch.filter, .geom) with
the JAX reference on the CPU: the same seeded numpy inputs through both,
with the tolerance stated in each test."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from visma_tpu.filter import FilterConfig as JConfig, Msckf as JMsckf
from visma_tpu.filter import imu as jimu, msckf as jmsckf
from visma_tpu.filter import triangulate as jtri, update as jupd
from visma_tpu.filter.state import FilterState as JFilterState
from visma_tpu.filter.state import TrackTable as JTrackTable
from visma_tpu.geom import rotations as jrot
from visma_tpu.io.synthetic import (SyntheticConfig, make_dataset, make_imu,
                                    make_trajectory)

from visma_tpu_torch import convert
from visma_tpu_torch.filter import imu as timu, msckf as tmsckf
from visma_tpu_torch.filter import triangulate as ttri, update as tupd
from visma_tpu_torch.filter.config import FilterConfig
from visma_tpu_torch.filter.feed import pack_frames
from visma_tpu_torch.filter.state import FilterState
from visma_tpu_torch.geom import rotations as trot


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def to_port(jstate):
    return convert.from_reference(jax.tree.map(np.asarray, jstate),
                                  FilterState)


def to_jax(tstate):
    d = convert.to_numpy(tstate)
    tracks = JTrackTable(**{k: jnp.asarray(v) for k, v in d.pop("tracks").items()})
    return JFilterState(tracks=tracks, **{k: jnp.asarray(v) for k, v in d.items()})


class _Scene:
    """TestEndToEnd's synthetic scene (60 frames, window 8, 96 tracks, 24
    updates, noise 0.5) with the JAX filter's state after 14 frames. The
    JAX side runs jitted, so each shape compiles once per module."""

    def __init__(self, num_frames=60, noise=0.5):
        syn = SyntheticConfig(num_frames=num_frames, num_landmarks=120,
                              pixel_noise=noise, seed=3)
        kw = dict(window=8, max_tracks=96, max_updates=24, fx=syn.fx,
                  fy=syn.fy, cx=syn.cx, cy=syn.cy, pixel_noise=max(noise, 0.5))
        self.jcfg, self.tcfg = JConfig(**kw), FilterConfig(**kw)
        imu = make_imu(syn)
        frames = pack_frames(self.tcfg, make_dataset(syn), imu, max_feats=96)
        self.frames = {k: v for k, v in frames.items() if k != "ts"}
        _, self.gwc = make_trajectory(syn)
        self.init = dict(R0=self.gwc[0, :, :3], p0=self.gwc[0, :, 3],
                         v0=imu["v0"])
        self.jkf = JMsckf(self.jcfg)
        js = self.jkf.init(**self.init)
        for i in range(14):
            js = self.jkf.step(js, self.frame(i))
        self.mid = js                       # JAX state after frames 0..13

    def frame(self, i):
        return {k: jnp.asarray(v[i]) for k, v in self.frames.items()}

    def tframe(self, i):
        return {k: _t(v[i]) for k, v in self.frames.items()}


@pytest.fixture(scope="module")
def scene():
    return _Scene()


def _assert_state_close(ts, js, atol_pose, atol_P):
    for name in ("R", "p", "v", "bg", "ba", "win_R", "win_p"):
        np.testing.assert_allclose(_np(getattr(ts, name)),
                                   np.asarray(getattr(js, name)),
                                   atol=atol_pose, err_msg=name)
    np.testing.assert_allclose(_np(ts.P), np.asarray(js.P), atol=atol_P)
    np.testing.assert_array_equal(_np(ts.win_valid), np.asarray(js.win_valid))


class TestGeom:
    def test_rodrigues_hat_vee(self):
        """f32 elementwise formulas: 1e-6 absolute on unit-scale entries."""
        rng = np.random.default_rng(0)
        w = rng.normal(size=(64, 3)).astype(np.float32)
        w[:8] *= 1e-8            # small-angle branch
        w[8:16] *= 1e-3
        np.testing.assert_allclose(_np(trot.rodrigues(_t(w))),
                                   np.asarray(jrot.rodrigues(w)), atol=1e-6)
        np.testing.assert_allclose(_np(trot.hat(_t(w))),
                                   np.asarray(jrot.hat(w)), atol=0)
        R = rng.normal(size=(16, 3, 3)).astype(np.float32)
        np.testing.assert_allclose(_np(trot.vee(_t(R))),
                                   np.asarray(jrot.vee(R)), atol=0)


def _imu_batch():
    rng = np.random.default_rng(1)
    gyro = rng.normal(scale=0.3, size=(8, 3)).astype(np.float32)
    accel = (rng.normal(scale=0.5, size=(8, 3)) + [0, 0, 9.81]).astype(np.float32)
    dts = np.full(8, 1 / 240, np.float32)
    dts[6:] = 0.0            # masked tail samples
    return gyro, accel, dts


class TestImu:
    def test_propagate_matches_jax(self, scene):
        """The port folds the IMU samples left to right where the reference
        runs an associative scan: f32 association order only, so 1e-6 on
        the pose and 1e-7 absolute on P (entries up to ~1e-2)."""
        gyro, accel, dts = _imu_batch()
        ref = jax.jit(jimu.propagate, static_argnums=0)(
            scene.jcfg, scene.mid, gyro, accel, dts)
        got = timu.propagate(scene.tcfg, to_port(scene.mid), _t(gyro),
                             _t(accel), _t(dts))
        _assert_state_close(got, ref, 1e-6, 1e-7)
        np.testing.assert_allclose(_np(got.t), np.asarray(ref.t), atol=1e-6)

    def test_propagate_matches_sequential_step(self, scene):
        """Against the reference's single-sample `_step` folded over the
        batch, and the port's own `_step` against it: same tolerances."""
        gyro, accel, dts = _imu_batch()
        jstep = jax.jit(jimu._step, static_argnums=0)
        ref, mine = scene.mid, to_port(scene.mid)
        for k in range(len(dts)):
            ref = jstep(scene.jcfg, ref, gyro[k], accel[k], dts[k])
            mine = timu._step(scene.tcfg, mine, _t(gyro[k]), _t(accel[k]),
                              _t(dts[k]))
        _assert_state_close(mine, ref, 1e-6, 1e-7)
        got = timu.propagate(scene.tcfg, to_port(scene.mid), _t(gyro),
                             _t(accel), _t(dts))
        _assert_state_close(got, ref, 1e-6, 1e-7)

    def test_propagate_cv(self, scene):
        cfg_j = JConfig(**{**scene.jcfg.__dict__, "use_imu": False})
        cfg_t = FilterConfig(**{**scene.tcfg.__dict__, "use_imu": False})
        ref = jax.jit(jimu.propagate_cv, static_argnums=0)(
            cfg_j, scene.mid, jnp.float32(1 / 30))
        got = timu.propagate_cv(cfg_t, to_port(scene.mid),
                                _t(np.float32(1 / 30)))
        _assert_state_close(got, ref, 1e-6, 1e-7)


def _window_problem(U=24, M=8, seed=0):
    """Random clone window looking at points ~3 m ahead, noisy masked
    observations, a few degenerate features."""
    rng = np.random.default_rng(seed)
    cfg = dict(window=M, fx=400.0, fy=400.0, cx=320.0, cy=240.0)
    th = rng.normal(scale=0.05, size=(M, 3)).astype(np.float32)
    win_R = np.asarray(jrot.rodrigues(th))
    win_p = (np.linspace(0, 0.4, M)[:, None]
             * np.array([1.0, 0.2, 0.0])).astype(np.float32)
    X = (rng.normal(scale=[1.0, 0.7, 0.5], size=(U, 3))
         + [0, 0, 3.0]).astype(np.float32)
    Xc = np.einsum("mji,umj->umi", win_R, X[:, None] - win_p)
    obs = np.stack([400 * Xc[..., 0] / Xc[..., 2] + 320,
                    400 * Xc[..., 1] / Xc[..., 2] + 240], -1)
    obs = (obs + rng.normal(scale=0.5, size=obs.shape)).astype(np.float32)
    mask = rng.random((U, M)) > 0.25
    mask[0] = False                  # no observations
    mask[1] = False
    mask[1, 3] = True                # a single observation
    obs[2, :, :] = obs[2, :1, :]     # identical rays
    return cfg, obs, mask, win_R, win_p


class TestTriangulateUpdate:
    def test_triangulate(self):
        """Adjugate solves and 3 GN steps in f32: flags equal; accepted
        points to 1e-4 m at ~3 m and their mean reprojection error to
        1e-3 px. A rejected feature with one ray is singular up to the
        1e-6 ridge, so its point is only held to being finite."""
        kw, obs, mask, win_R, win_p = _window_problem()
        jcfg, tcfg = JConfig(**kw), FilterConfig(**kw)
        Xj, okj, errj = jax.jit(jax.vmap(lambda o, m: jtri.triangulate(
            jcfg, o, m, win_R, win_p)))(obs, mask)
        Xt, okt, errt = ttri.triangulate(tcfg, _t(obs), _t(mask), _t(win_R),
                                         _t(win_p))
        ok = np.asarray(okj)
        np.testing.assert_array_equal(_np(okt), ok)
        assert ok.sum() >= 16 and not ok[:3].any()
        np.testing.assert_allclose(_np(Xt)[ok], np.asarray(Xj)[ok], atol=1e-4)
        np.testing.assert_allclose(_np(errt)[ok], np.asarray(errj)[ok],
                                   atol=1e-3)
        assert np.isfinite(_np(Xt)).all()

    def test_jacobians_and_nullspace_project(self):
        """Jacobians 1e-3 absolute on entries up to ~1e2 (pixels per metre
        or radian); after three Householder reflections 2e-3, the same
        scale with three more f32 passes."""
        kw, obs, mask, win_R, win_p = _window_problem()
        jcfg, tcfg = JConfig(**kw), FilterConfig(**kw)
        X = np.asarray(jax.jit(jax.vmap(lambda o, m: jtri.triangulate(
            jcfg, o, m, win_R, win_p)))(obs, mask)[0])
        rj, Hxj, Hfj = jax.jit(jax.vmap(lambda x, o, m: jupd.feature_jacobians(
            jcfg, x, o, m, win_R, win_p)))(X, obs, mask)
        rt, Hxt, Hft = tupd.feature_jacobians(tcfg, _t(X), _t(obs), _t(mask),
                                              _t(win_R), _t(win_p))
        for a, b in ((rt, rj), (Hxt, Hxj), (Hft, Hfj)):
            np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-3)
        rpj, Hpj = jax.jit(jax.vmap(jupd.nullspace_project))(rj, Hxj, Hfj)
        rpt, Hpt = tupd.nullspace_project(_t(np.asarray(rj)),
                                          _t(np.asarray(Hxj)),
                                          _t(np.asarray(Hfj)))
        np.testing.assert_allclose(_np(rpt), np.asarray(rpj), atol=2e-3)
        np.testing.assert_allclose(_np(Hpt), np.asarray(Hpj), atol=2e-3)
        # masked (all-zero) features stay exact zeros
        assert not _np(rpt)[0].any() and not _np(Hpt)[0].any()

    def test_msckf_update(self, scene):
        """The selected features of a mid-run state, updated by both. dx
        and P are compared through the corrected state: 1e-5 on pose
        (m, rad) and 1e-6 on P; Q and R of the stacked QR are not, their
        signs are free."""
        jcfg = scene.jcfg

        @jax.jit
        def prepare(js, fr):
            js = jimu.propagate(jcfg, js, fr["gyro"], fr["accel"], fr["dts"])
            js = jmsckf._augment(jcfg, js)
            tracks, lost = jmsckf._ingest(jcfg, js.tracks, fr["ids"],
                                          fr["xp"], fr["valid"])
            sel, sel_valid = jmsckf._select_for_update(jcfg, tracks, lost)
            return (js.replace(tracks=tracks), tracks.obs[sel],
                    tracks.mask[sel], sel_valid)

        js, *args = prepare(scene.mid, scene.frame(14))
        assert int(np.asarray(args[2]).sum()) >= 4
        ref, used_j, rej_j, Xj = jax.jit(jupd.msckf_update, static_argnums=0)(
            jcfg, js, *args)
        got, used_t, rej_t, Xt = tupd.msckf_update(
            scene.tcfg, to_port(js), *[_t(a) for a in args])
        np.testing.assert_array_equal(_np(used_t), np.asarray(used_j))
        np.testing.assert_array_equal(_np(rej_t), np.asarray(rej_j))
        assert np.asarray(used_j).sum() >= 4
        np.testing.assert_allclose(_np(Xt), np.asarray(Xj), atol=1e-4)
        _assert_state_close(got, ref, 1e-5, 1e-6)


class TestParityTraps:
    def test_argmax_first_maximum(self):
        m = np.array([[0, 1, 1, 0], [0, 0, 0, 0], [1, 1, 1, 1]], bool)
        np.testing.assert_array_equal(
            _np(torch.argmax(_t(m).to(torch.int32), dim=1)),
            np.asarray(jnp.argmax(m, axis=1)))

    def test_scatter_max_duplicates(self):
        rng = np.random.default_rng(0)
        idx = rng.integers(0, 6, 20).astype(np.int32)
        src = rng.integers(0, 50, 20).astype(np.int32)
        ref = jnp.zeros(8, jnp.int32).at[idx].max(src)
        np.testing.assert_array_equal(
            _np(tmsckf.scatter_max(8, _t(idx), _t(src))), np.asarray(ref))

    def test_top_k_ties_lowest_index_first(self):
        score = np.array([0, 1003, 1003, 0, 2005, 1003, 0, 2005, 0, 0],
                         np.int32)
        vj, ij = jax.lax.top_k(jnp.asarray(score), 7)
        vt, it = tmsckf.top_k_stable(_t(score), 7)
        np.testing.assert_array_equal(_np(vt), np.asarray(vj))
        np.testing.assert_array_equal(_np(it), np.asarray(ij))


class TestFrameSteps:
    def test_steps_from_converted_state(self, scene):
        """Start both from the same converted mid-run state and run 6
        frame steps: track tables equal, pose 1e-5, P 1e-6, and the state
        converts back to a JAX FilterState that steps like the original."""
        js, ts = scene.mid, to_port(scene.mid)
        for i in range(14, 20):
            js = scene.jkf.step(js, scene.frame(i))
            ts = tmsckf._frame_step(scene.tcfg, ts, scene.tframe(i))
            for name in ("ids", "status", "mask"):
                np.testing.assert_array_equal(
                    _np(getattr(ts.tracks, name)),
                    np.asarray(getattr(js.tracks, name)), err_msg=name)
        _assert_state_close(ts, js, 1e-5, 1e-6)
        back = to_jax(ts)
        assert back.tracks.ids.dtype == js.tracks.ids.dtype
        nxt_j = scene.jkf.step(js, scene.frame(20))
        nxt_b = scene.jkf.step(back, scene.frame(20))
        np.testing.assert_allclose(np.asarray(nxt_b.p), np.asarray(nxt_j.p),
                                   atol=1e-5)


class TestEndToEnd:
    def test_run_matches_jax(self, scene):
        """tests/test_filter.py::TestEndToEnd size (60 frames, window 8,
        96 tracks, noise 0.5): the port passes the reference's 3 cm ATE
        gate, and its trajectory stays within 1e-3 m of JAX's (f32 sum
        order through 60 filter updates)."""
        # the reference stepped frame by frame (its jitted step is already
        # compiled for the fixture; Msckf.run scans the same step)
        js, jo = scene.jkf.init(**scene.init), []
        for i in range(len(scene.frames["dts"])):
            js = scene.jkf.step(js, scene.frame(i))
            jo.append((np.asarray(js.p), np.asarray(js.tracks.ids),
                       np.asarray(js.tracks.status)))
        jp, jids, jstatus = (np.stack(x) for x in zip(*jo))
        tk = tmsckf.Msckf(scene.tcfg, device="cpu")
        final, to = tk.run(tk.init(**scene.init),
                           {k: _t(v) for k, v in scene.frames.items()})
        tmsckf.check_health(to)
        p = _np(to["p"])
        ate = float(np.sqrt(np.mean(np.sum((p - scene.gwc[:, :, 3]) ** 2, 1))))
        assert ate < 0.03, ate
        np.testing.assert_allclose(p, jp, atol=1e-3)
        np.testing.assert_array_equal(_np(to["feat_ids"]), jids)
        np.testing.assert_array_equal(_np(to["feat_status"]), jstatus)
        P = _np(final.P)
        np.testing.assert_allclose(P, P.T, atol=1e-6)

    def test_health_gate_names_first_bad_frame(self):
        from visma_tpu_torch.utils.misc import DivergenceError

        with pytest.raises(DivergenceError) as e:
            tmsckf.check_health({"healthy": torch.tensor([True, True, False,
                                                          False])})
        assert e.value.frame == 2
