"""The PyTorch port's VIO slice as a whole (visma_tpu_torch.pipeline)
against the JAX reference's VioPipeline(fused_klt=True) on the CPU, its LK
kernel in interpret mode."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import visma_tpu.frontend.klt_fused as JKF
import visma_tpu.frontend.tracker as JTR
from visma_tpu.filter import FilterConfig as JConfig
from visma_tpu.io.synthetic import SyntheticConfig, make_imu
from visma_tpu.io.synthetic_images import render_blob_frames
from visma_tpu.pipeline import VioPipeline as JPipeline

from visma_tpu_torch import convert
from visma_tpu_torch.filter.config import FilterConfig
from visma_tpu_torch.filter.msckf import check_health
from visma_tpu_torch.pipeline import PipelineState, VioPipeline, export_packets


@pytest.fixture(scope="module")
def runs():
    """8 tracked frames of 128x160 blob imagery through both pipelines
    (3 levels, cell 16, window 6, 32 tracks) from the same first frame."""
    syn = SyntheticConfig(num_frames=9, num_landmarks=80, rows=128, cols=160,
                          fx=120.0, fy=120.0, cx=80.0, cy=64.0, seed=13)
    kw = dict(window=6, max_tracks=32, max_updates=8, fx=syn.fx, fy=syn.fy,
              cx=syn.cx, cy=syn.cy, pixel_noise=1.0)
    frames, gwc, _ = render_blob_frames(syn)
    imu = make_imu(syn)
    spf = imu["samples_per_frame"]
    dt = float(np.diff(imu["ts_state"])[0])
    N = syn.num_frames - 1
    gyro = imu["gyro"][: N * spf].reshape(N, spf, 3)
    accel = imu["accel"][: N * spf].reshape(N, spf, 3)
    dts = np.full((N, spf), dt, np.float32)
    init = dict(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])

    orig = JKF.track_features_fused

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(JTR, "track_features_fused", interp)
    try:
        jp = JPipeline(JConfig(**kw), levels=3, cell=16, fused_klt=True)
        js0 = jp.init(jnp.asarray(frames[0]), **init)
        _, jo = jp.run(js0, frames[1:], gyro, accel, dts)
        jo = {k: np.asarray(v) for k, v in jo.items()}
    finally:
        mp.undo()

    tp = VioPipeline(FilterConfig(**kw), levels=3, cell=16, device="cpu")
    ts0 = tp.init(frames[0], **init)
    tfinal, to = tp.run(ts0, frames[1:], gyro, accel, dts)
    return dict(jo=jo, to=to, tp=tp, tfinal=tfinal, gwc=gwc, js0=js0,
                frames=frames, gyro=gyro, accel=accel, dts=dts, syn=syn)


def test_track_ids_equal_per_frame(runs):
    """The frontend makes the same decisions: ids, validity, track
    statuses and track-table ids are equal in every frame."""
    jo, to = runs["jo"], runs["to"]
    for key in ("obs_ids", "obs_valid", "feat_ids", "feat_status",
                "healthy"):
        np.testing.assert_array_equal(to[key].numpy(), jo[key], err_msg=key)
    assert jo["obs_valid"].sum(axis=1).min() >= 16


def test_observations_and_trajectory_close(runs):
    """Observed pixels to 1e-4 px (LK float order); positions to 1e-5 m
    and rotations to 1e-5 over 8 frames; ATE within the reference's gate."""
    jo, to = runs["jo"], runs["to"]
    np.testing.assert_allclose(to["obs_xp"].numpy(), jo["obs_xp"], atol=1e-4)
    np.testing.assert_allclose(to["feat_xp"].numpy(), jo["feat_xp"],
                               atol=1e-4)
    np.testing.assert_allclose(to["p"].numpy(), jo["p"], atol=1e-5)
    np.testing.assert_allclose(to["R"].numpy(), jo["R"], atol=1e-5)
    check_health(to)
    p = to["p"].numpy()
    ate = float(np.sqrt(np.mean(np.sum((p - runs["gwc"][1:, :, 3]) ** 2, 1))))
    assert ate < 0.08, ate


def test_step_matches_run_and_converted_start(runs):
    """step() over the frames reproduces run(), starting from the JAX
    initial state carried across by convert.from_reference."""
    import jax

    tp = runs["tp"]
    st = convert.from_reference(jax.tree.map(np.asarray, runs["js0"]),
                                PipelineState)
    for i in range(len(runs["dts"])):
        st = tp.step(st, runs["frames"][i + 1], runs["gyro"][i],
                     runs["accel"][i], runs["dts"][i])
    np.testing.assert_allclose(st.filter.p.numpy(), runs["to"]["p"][-1].numpy(),
                               atol=1e-6)
    back = convert.to_numpy(st)
    assert back["tracker"]["pyr"][0].shape == (128, 160)
    np.testing.assert_array_equal(back["filter"]["tracks"]["ids"],
                                  runs["tfinal"].filter.tracks.ids.numpy())


def test_export_packets_decodable(runs, tmp_path):
    """export_packets -> vlslam Dataset file -> VlslamDatasetLoader: the
    reloaded poses are the filter's, every exported feature is live."""
    from visma_tpu.io import VlslamDatasetLoader
    from visma_tpu.proto import CameraInfo, Dataset

    syn, to = runs["syn"], runs["to"]
    N = to["p"].shape[0]
    ts = np.arange(1, N + 1, dtype=np.float64) / 30.0
    packets = export_packets(FilterConfig(), to, ts)
    out = Dataset(description="visma_tpu_torch output",
                  camera=CameraInfo(rows=syn.rows, cols=syn.cols,
                                    parameters=np.array([syn.fx, syn.fy,
                                                         syn.cx, syn.cy])),
                  packets=packets)
    (tmp_path / "dataset").write_bytes(out.encode())
    loader = VlslamDatasetLoader(str(tmp_path))
    assert len(loader) == N
    fr = loader.grab(N - 1, load_image=False)
    np.testing.assert_allclose(fr.gwc[:, 3], to["p"][N - 1].numpy(), atol=1e-6)
    n_live = int((to["feat_ids"][N - 1] >= 0).sum())
    assert len(loader.dataset.packets[N - 1].features) == n_live > 0


def test_cuda_device_never_falls_back(runs):
    """Asking for a CUDA device on a host without one fails instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        tp = VioPipeline(FilterConfig(), levels=3, cell=16, device="cuda")
        tp.init(runs["frames"][0])
