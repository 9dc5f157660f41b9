"""`Msckf.run_batched` (B independent streams, one frame step vmapped over
the streams per frame) against `Msckf.run` on each stream and against the
JAX reference's `run_batched`, on the CPU.

The streams are different (one seed each): the reference's own test
broadcasts one stream, which cannot catch streams mixed along the batch
axis. Tolerance 1e-5 on the positions (tests/test_filter.py:211-213): the
batched step does the same arithmetic, but batched matrix products and
factorisations may block their sums differently. Against the reference,
the tolerance of each test."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visma_tpu.ba.gauss_newton import ba_solve as j_ba_solve, total_cost
from visma_tpu.ba.problem import synthetic_ba_problem as j_synthetic
from visma_tpu.filter import FilterConfig as JConfig, Msckf as JMsckf
from visma_tpu_torch.filter import FilterConfig, Msckf, stack_states
from visma_tpu_torch.filter.feed import pack_frames
from visma_tpu_torch.io.synthetic import (SyntheticConfig, make_dataset,
                                          make_imu, make_trajectory)
from visma_tpu_torch.io.synthetic_images import render_adversarial_frames

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the BA phase's workloads)

TOL = 1e-5
SMALL = dict(window=6, max_tracks=48, max_updates=12, pixel_noise=0.5)


def _streams(seeds, num_frames=20, **kw):
    """One synthetic feed with IMU per seed, packed as numpy, with its
    initial pose and velocity."""
    syn0 = SyntheticConfig(num_frames=num_frames, num_landmarks=120,
                           pixel_noise=0.5, seed=seeds[0])
    cfg = dict(SMALL, fx=syn0.fx, fy=syn0.fy, cx=syn0.cx, cy=syn0.cy, **kw)
    out = []
    for seed in seeds:
        syn = SyntheticConfig(num_frames=num_frames, num_landmarks=120,
                              pixel_noise=0.5, seed=seed)
        imu = make_imu(syn)
        _, gwc = make_trajectory(syn)
        packed = pack_frames(FilterConfig(**cfg), make_dataset(syn), imu,
                             max_feats=48)
        out.append(({k: v for k, v in packed.items() if k != "ts"},
                    dict(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])))
    return cfg, out


def _run_both(cfg, streams):
    kf = Msckf(FilterConfig(**cfg), device="cpu")
    frames = {k: torch.as_tensor(np.stack([f[k] for f, _ in streams]))
              for k in streams[0][0]}
    states = [kf.init(**init) for _, init in streams]
    final, outs = kf.run_batched(stack_states(states), frames)
    singles = [kf.run(s, {k: torch.as_tensor(v) for k, v in f.items()})
               for s, (f, _) in zip(states, streams)]
    return final, outs, singles


@pytest.fixture(scope="module")
def three():
    cfg, streams = _streams([0, 1, 2])
    return cfg, streams, _run_both(cfg, streams)


def test_run_batched_equals_run_per_stream(three):
    """Three streams of three seeds: every row of the batched outputs and
    of the final state is its own stream's `run`."""
    _, streams, (final, outs, singles) = three
    N = len(streams[0][0]["ids"])
    assert outs["R"].shape == (3, N, 3, 3) and outs["p"].shape == (3, N, 3)
    for b, (s, o) in enumerate(singles):
        np.testing.assert_allclose(outs["p"][b].numpy(), o["p"].numpy(),
                                   atol=TOL)
        np.testing.assert_allclose(outs["R"][b].numpy(), o["R"].numpy(),
                                   atol=TOL)
        np.testing.assert_allclose(final.P[b].numpy(), s.P.numpy(), atol=TOL)
        np.testing.assert_array_equal(final.tracks.ids[b].numpy(),
                                      s.tracks.ids.numpy())
    # the streams really differ (one trajectory, other landmarks and
    # noise): a mix-up along the batch axis would show, 100x the tolerance
    for b in range(3):
        for c in range(3):
            if b != c:
                assert (outs["p"][b] - singles[c][1]["p"]).abs().max() \
                    > 100 * TOL


def test_run_batched_matches_the_reference(three):
    """The same three streams through the reference's vmapped scan, 1e-4
    (20 frames; tests/test_torch_filter.py holds `run` to the reference
    at 1e-3 over 60)."""
    cfg, streams, (_, outs, _) = three
    jk = JMsckf(JConfig(**cfg))
    states = [jk.init(**init) for _, init in streams]
    jstates = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    jframes = {k: jnp.asarray(np.stack([f[k] for f, _ in streams]))
               for k in streams[0][0]}
    _, jouts = jk.run_batched(jstates, jframes)
    np.testing.assert_allclose(outs["p"].numpy(), np.asarray(jouts["p"]),
                               atol=1e-4)


def test_run_batched_with_slam_landmarks():
    """num_slam=4 over two streams: the vmap covers the landmark update and
    the promote step; rows equal `run` to 1e-5 and landmarks go live."""
    cfg, streams = _streams([3, 4], num_frames=24, num_slam=4)
    final, outs, singles = _run_both(cfg, streams)
    for b, (s, o) in enumerate(singles):
        np.testing.assert_allclose(outs["p"][b].numpy(), o["p"].numpy(),
                                   atol=TOL)
        np.testing.assert_array_equal(final.lm_ids[b].numpy(),
                                      s.lm_ids.numpy())
        np.testing.assert_allclose(final.lm_xw[b].numpy(), s.lm_xw.numpy(),
                                   atol=TOL)
    assert (final.lm_ids >= 0).any(dim=1).all()


def test_chip_smoke_ba_phase_on_the_cpu(monkeypatch):
    """chip_smoke.py's BA phase at small sizes on the CPU, its timers
    replaced: (a) a GN step against the CPU step and a solve against the
    JAX package's cost and poses, computed here; (c) VIO -> BA on a small
    adversarial scene with its gates; (f) `run_batched` over 3 streams in
    calls of 5 frames, the rows held to `run`, single steps to
    `Msckf.step`."""
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, reps=1, warmup=0: (fn(), 0.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "sync_counter", lambda fn: (fn(), 0)[1])
    dev = torch.device("cpu")

    jp, _ = j_synthetic(8, 64, 0.5, 0.02)
    jsol, _ = j_ba_solve(jp, iters=6)
    a = chip_smoke.ba_synthetic(dev, 8, 64, 6, float(total_cost(jsol)),
                                np.asarray(jsol.p))
    assert a["step_max_dp_m"] == 0.0 and abs(a["cost_rel"]) < 1e-3

    # the bench scene's camera scaled to 200x320 over 30 frames: smaller
    # scenes give BA too few landmarks to hold the filter's trajectory
    # (the JAX package's solve on them does the same)
    syn = SyntheticConfig(num_frames=30, num_landmarks=240, rows=200,
                          cols=320, fx=486.405 / 3, fy=535.401 * 0.4,
                          cx=469.199 / 3, cy=257.916 * 0.4, seed=7)
    frames, gwc, _ = render_adversarial_frames(syn)
    imu = make_imu(syn)
    spf, N = imu["samples_per_frame"], syn.num_frames - 1
    dt = float(np.diff(imu["ts_state"])[0])
    cfg = FilterConfig(window=6, max_tracks=48, max_updates=12, fx=syn.fx,
                       fy=syn.fy, cx=syn.cx, cy=syn.cy, pixel_noise=1.0)
    scene = {"cfg": cfg, "frames": frames, "gwc": gwc, "imu": imu,
             "images": torch.as_tensor(frames[1:]),
             "gyro": torch.as_tensor(imu["gyro"][: N * spf]
                                     .reshape(N, spf, 3)),
             "accel": torch.as_tensor(imu["accel"][: N * spf]
                                      .reshape(N, spf, 3)),
             "dts": torch.full((N, spf), dt)}
    _, c = chip_smoke.vio_to_ba(dev, scene, levels=3, cell=32, stride=3)
    assert c["frames"] == N and c["keyframes"] == 11 and c["landmarks"] >= 40

    f = chip_smoke.batched_streams(dev, B=3, n_frames=12, max_tracks=48,
                                   max_updates=12, window=6, segment=5)
    assert len(f["step_dp_m"]) == 3 and max(f["step_dp_m"]) <= TOL
    assert f["run_dp_30_stream_0_m"] <= TOL \
        and f["run_dp_30_stream_2_m"] <= TOL
