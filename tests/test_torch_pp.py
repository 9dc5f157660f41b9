"""The port's two-stage pipeline (visma_tpu_torch.dist.pipeline_pp) on the
13-frame 128x160 blob scene of tests/test_pp.py: against the port's own
`VioPipeline.run`, equal (0.0: the stage boundary changes placement and
order, not the math), and against the JAX package's `TwoStagePipeline`
on two of its virtual CPU devices with the windowed tracker on both sides
(`fused_klt=False`, the reference's tracker off the TPU), within 1e-6 in
positions and rotations (measured 2.4e-7 m and 4.2e-7; the whole pipeline
in tests/test_torch_ingest.py differs by 1.2e-7 m over 11 frames)."""
import numpy as np
import pytest
import torch

from visma_tpu_torch.dist.pipeline_pp import TwoStagePipeline
from visma_tpu_torch.filter.config import FilterConfig
from visma_tpu_torch.io.synthetic import SyntheticConfig, make_imu
from visma_tpu_torch.io.synthetic_images import render_blob_frames
from visma_tpu_torch.pipeline import VioPipeline

REF_TOL_M = 1e-6
CFG = dict(window=6, max_tracks=32, max_updates=8, pixel_noise=1.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are small: one torch thread is faster than many
    beside the suite's other workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """tests/test_pp.py's make_scene, made with the port's copies of the
    scene generators (equal to the reference's: tests/test_torch_import.py),
    so that this file imports no JAX outside the reference's case and runs
    on the card's machine."""
    syn = SyntheticConfig(num_frames=13, num_landmarks=80, rows=128,
                          cols=160, fx=120.0, fy=120.0, cx=80.0, cy=64.0,
                          seed=13)
    frames, gwc, _ = render_blob_frames(syn)
    imu = make_imu(syn)
    spf = imu["samples_per_frame"]
    dt = float(np.diff(imu["ts_state"])[0])
    N = syn.num_frames - 1
    gyro = np.stack([imu["gyro"][i * spf:(i + 1) * spf] for i in range(N)])
    accel = np.stack([imu["accel"][i * spf:(i + 1) * spf]
                      for i in range(N)])
    dts = np.full((N, spf), dt, np.float32)
    cfg = FilterConfig(fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy, **CFG)
    return dict(cfg=cfg, frames=frames, gwc=gwc, imu=imu,
                seq=(frames[1:], gyro, accel, dts))


def _init_kw(s):
    return dict(R0=s["gwc"][0, :, :3], p0=s["gwc"][0, :, 3],
                v0=s["imu"]["v0"])


def _two_stage(s, dev, chunk, **kw):
    pp = TwoStagePipeline(s["cfg"], dev, dev, levels=2, cell=20, chunk=chunk,
                          **kw)
    tr0, fs0 = pp.init(s["frames"][0], **_init_kw(s))
    return pp.run(tr0, fs0, *s["seq"])


def _single(s, dev, **kw):
    pipe = VioPipeline(s["cfg"], levels=2, cell=20, device=dev, **kw)
    st0 = pipe.init(s["frames"][0], **_init_kw(s))
    return pipe.run(st0, *s["seq"])


@pytest.fixture(scope="module")
def single(scene):
    return _single(scene, "cpu")


@pytest.mark.parametrize("chunk", [1, 5, 12])
def test_two_stage_equals_vio_pipeline(scene, single, chunk):
    """Chunks of 1, 5 (not dividing the 12 frames) and 12: poses, health
    and both final states equal `VioPipeline.run`'s."""
    final, outs = single
    tr, fs, got = _two_stage(scene, "cpu", chunk)
    N = len(scene["seq"][0])
    assert got["p"].shape == (N, 3) and got["R"].shape == (N, 3, 3)
    for k in ("R", "p", "healthy"):
        np.testing.assert_array_equal(got[k].numpy(), outs[k].numpy())
    assert bool(got["healthy"].all())
    np.testing.assert_array_equal(fs.P.numpy(), final.filter.P.numpy())
    np.testing.assert_array_equal(tr.ids.numpy(), final.tracker.ids.numpy())
    np.testing.assert_array_equal(tr.pos.numpy(), final.tracker.pos.numpy())


def test_two_stage_matches_reference(scene):
    """Against the JAX package's two-device pipeline (chunk 5), both with
    the windowed tracker."""
    import jax

    from visma_tpu.dist.pipeline_pp import TwoStagePipeline as JTwoStage
    from visma_tpu.filter import FilterConfig as JConfig

    c = scene["cfg"]
    devs = jax.devices()
    jpp = JTwoStage(JConfig(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, **CFG),
                    devs[0], devs[1], levels=2, cell=20, chunk=5)
    tr0, fs0 = jpp.init(scene["frames"][0], **_init_kw(scene))
    _, _, ref = jpp.run(tr0, fs0, *scene["seq"])
    _, _, got = _two_stage(scene, "cpu", 5, fused_klt=False)
    assert np.abs(got["p"].numpy() - np.asarray(ref["p"])).max() <= REF_TOL_M
    assert np.abs(got["R"].numpy() - np.asarray(ref["R"])).max() <= REF_TOL_M
    np.testing.assert_array_equal(got["healthy"].numpy(),
                                  np.asarray(ref["healthy"]))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_two_streams_equal_one_stream_on_the_card(scene, card):
    """Both stages on one card, on two CUDA streams: bit for bit the
    single-stream `VioPipeline.run`, with the hand kernels on the path."""
    _, outs = _single(scene, card)
    _, fs, got = _two_stage(scene, card, 5)
    torch.cuda.synchronize()
    for k in ("R", "p", "healthy"):
        np.testing.assert_array_equal(got[k].cpu().numpy(),
                                      outs[k].cpu().numpy())
    assert fs.P.device == card
