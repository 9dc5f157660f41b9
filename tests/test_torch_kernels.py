"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU with nvcc (the kernels build on first use); every test
skips without a CUDA device. On a machine with one:

    python -m pytest tests/test_torch_kernels.py -m cuda -p no:xdist
"""
import numpy as np
import pytest
import torch

from visma_tpu_torch.frontend import detect as tdet, klt_fused as tkf
from visma_tpu_torch.frontend.pyramid import build_pyramid

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _texture(H, W, seed):
    """Bilinearly upsampled uniform noise (smooth texture, 0-255)."""
    rng = np.random.default_rng(seed)
    small = torch.as_tensor(rng.uniform(0, 255, (1, 1, H // 8 + 1, W // 8 + 1)),
                            dtype=torch.float32)
    big = torch.nn.functional.interpolate(small, size=(H, W), mode="bilinear",
                                          align_corners=False)[0, 0]
    noise = torch.as_tensor(rng.normal(0, 2.0, (H, W)), dtype=torch.float32)
    return (big + noise).contiguous()


@pytest.mark.parametrize("shape", [(500, 960), (131, 77)])
def test_corner_score_matches_plain(dev, shape):
    """Every pixel, edges included, to 1e-4 of the largest score (the
    kernel is built without FMA contraction and sums in the plain order)."""
    img = _texture(*shape, seed=1).to(dev)
    n0 = tdet.corner_score.launches
    got = tdet.corner_score(img)
    ref = tdet.corner_score_plain(img)
    torch.cuda.synchronize()
    assert tdet.corner_score.launches == n0 + 1
    tol = 1e-4 * max(1.0, float(ref.max()))
    assert float((got - ref).abs().max()) <= tol
    assert int((got > 0).sum()) > 100


def _lk_args(prev_pyr, cur_pyr, pts, lv, shift, win=24, r=5):
    Hl, Wl = prev_pyr[lv].shape
    wl = min(win, Hl - Hl % 8 or Hl, Wl - Wl % 8 or Wl)
    pts_l = pts / 2.0 ** lv
    est = pts_l + torch.tensor(shift, device=pts.device) / 2.0 ** lv
    oP = tkf.window_origin(pts_l, wl, Hl, Wl)
    oC = tkf.window_origin(est, wl, Hl, Wl)
    return (prev_pyr[lv], cur_pyr[lv], oP, oC, tkf._starts(pts_l, r, oP),
            tkf._starts(est, r, oC), wl, r, 8)


def test_lk_level_matches_plain(dev):
    """Each level of a 500x960 pyramid, 96 features: displacement to
    1e-3 px and residual to 1e-3 where both accept; at most 1 of 96 ok
    flags may differ (f32 sum order at det > 1e-6)."""
    img0 = _texture(500, 960, seed=2).to(dev)
    img1 = torch.roll(img0, shifts=(2, -3), dims=(0, 1)).contiguous()
    p0, p1 = build_pyramid(img0, 4), build_pyramid(img1, 4)
    pts, _, valid = tdet.detect_features(img0, 96, 32)
    assert int(valid.sum()) == 96
    for lv in range(4):
        args = _lk_args(p0, p1, pts, lv, (-2.6, 1.7))
        n0 = tkf.lk_level.launches
        uk, rk, okk = tkf.lk_level(*args)
        up, rp, okp = tkf.lk_level_plain(*args)
        torch.cuda.synchronize()
        assert tkf.lk_level.launches == n0 + 1
        assert int((okk != okp).sum()) <= 1
        both = okk & okp
        assert float((uk - up)[:, both].abs().max()) <= 1e-3
        assert float((rk - rp)[both].abs().max()) <= 1e-3


def test_track_features_fused_kernel_vs_plain_on_host(dev):
    """The whole 4-level track with the kernel on the card against the
    plain version on the host, same inputs: 1e-3 px, at most 1 ok flip."""
    img0 = _texture(500, 960, seed=3)
    img1 = torch.roll(img0, shifts=(-3, 4), dims=(0, 1)).contiguous()
    pts, _, valid = tdet.detect_features(img0, 96, 32)
    pc = (build_pyramid(img0, 4), build_pyramid(img1, 4))
    pg = tuple([p.to(dev) for p in pyr] for pyr in pc)
    nk, okk = tkf.track_features_fused(pg[0], pg[1], pts.to(dev),
                                       valid.to(dev), levels=4)
    npl, okp = tkf.track_features_fused(pc[0], pc[1], pts, valid, levels=4)
    okk = okk.cpu()
    assert int((okk != okp).sum()) <= 1
    both = okk & okp
    assert int(both.sum()) >= 48
    assert float((nk.cpu() - npl)[both].abs().max()) <= 1e-3


def test_wrappers_raise_on_bad_input(dev):
    img = torch.zeros(64, 64, device=dev)
    with pytest.raises(ValueError):
        tdet.corner_score(img, window=7)
    org = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    st = torch.zeros((2, 3), device=dev)          # K mismatch
    with pytest.raises(ValueError):
        tkf.lk_level(img, img, org, org, st, st, 24)
    with pytest.raises(ValueError):
        tkf.lk_level(img, img.cpu(), org, org, st[:, :2].repeat(1, 2),
                     st[:, :2].repeat(1, 2), 24)


def test_pipeline_runs_through_kernels(dev):
    """A short VioPipeline run on the card launches K1 once per frame and
    K2 levels + 1 times per tracked frame, and matches the host run."""
    from visma_tpu.io.synthetic import SyntheticConfig, make_imu
    from visma_tpu.io.synthetic_images import render_blob_frames
    from visma_tpu_torch.filter.config import FilterConfig
    from visma_tpu_torch.pipeline import VioPipeline

    syn = SyntheticConfig(num_frames=9, num_landmarks=80, rows=128, cols=160,
                          fx=120.0, fy=120.0, cx=80.0, cy=64.0, seed=13)
    cfg = FilterConfig(window=6, max_tracks=32, max_updates=8, fx=syn.fx,
                       fy=syn.fy, cx=syn.cx, cy=syn.cy)
    frames, gwc, _ = render_blob_frames(syn)
    imu = make_imu(syn)
    spf = imu["samples_per_frame"]
    N = syn.num_frames - 1
    gyro = imu["gyro"][: N * spf].reshape(N, spf, 3)
    accel = imu["accel"][: N * spf].reshape(N, spf, 3)
    dts = np.full((N, spf), float(np.diff(imu["ts_state"])[0]), np.float32)
    init = dict(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])

    outs = {}
    for d in (dev, torch.device("cpu")):
        pipe = VioPipeline(cfg, levels=3, cell=16, device=d)
        k1, k2 = tdet.corner_score.launches, tkf.lk_level.launches
        _, outs[d.type] = pipe.run(pipe.init(frames[0], **init), frames[1:],
                                   gyro, accel, dts)
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert tdet.corner_score.launches - k1 == N + 1
            assert tkf.lk_level.launches - k2 == N * 4
    np.testing.assert_array_equal(outs["cuda"]["obs_ids"].cpu().numpy(),
                                  outs["cpu"]["obs_ids"].numpy())
    np.testing.assert_allclose(outs["cuda"]["p"].cpu().numpy(),
                               outs["cpu"]["p"].numpy(), atol=1e-4)
