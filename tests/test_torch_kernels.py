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
from visma_tpu_torch.image import edges as ted
from visma_tpu_torch.io.procedural import bench_mesh_db
from visma_tpu_torch.io.synthetic_semantic import BENCH_INTRINSICS
from visma_tpu_torch.render import raster as trs
from visma_tpu_torch.render.camera import Intrinsics

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
    from visma_tpu_torch.io.synthetic import SyntheticConfig, make_imu
    from visma_tpu_torch.io.synthetic_images import render_blob_frames
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


# ---------------------------------------------------------------------------
# The semantic path's kernels: chunk raster (frame, batched) and depth edge
# ---------------------------------------------------------------------------

BENCH_INTR = Intrinsics(**BENCH_INTRINSICS)


def _bench_stack(dev):
    r = trs.MultiMeshRenderer(BENCH_INTR, device=dev)
    r.set_meshes(bench_mesh_db())
    return r


def _scene_poses(n, seed):
    """n model->camera poses in front of the bench camera: yaw about y,
    a small tilt, 2.2-3.5 m away."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    poses = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        poses[i, :, :3] = Rotation.from_euler(
            "yx", [rng.uniform(-np.pi, np.pi), rng.uniform(-0.1, 0.1)]
        ).as_matrix()
        poses[i, :, 3] = [rng.uniform(-1.2, 1.2), rng.uniform(-0.1, 0.1),
                          rng.uniform(2.2, 3.5)]
    return poses


def _assert_depth_equal(got, ref, what):
    """Coverage masks identical; depths to 1e-6 relative (the kernel and
    the plain version evaluate the same planes in the same order without
    FMA contraction; only the final reciprocal may round apart)."""
    fg, fr = torch.isfinite(got), torch.isfinite(ref)
    flips = int((fg != fr).sum())
    assert flips == 0, f"{what}: {flips} coverage flips"
    assert int(fg.sum()) > 1000, what
    err = float(((got - ref)[fg] / ref[fg]).abs().max())
    assert err <= 1e-6, f"{what}: relative depth error {err}"


def _assert_depth_close(got, ref, what):
    """Two roundings of the same surface: coverage equal on >= 99.9 % of
    pixels, and depths within 1e-3 m on >= 99.5 % of the pixels both cover
    (at a silhouette a plane that rounds the other way hands the pixel to
    another triangle of the mesh, which may lie far behind; the thin parts
    of the chair at a random yaw put 0.2 % of its pixels there)."""
    fg, fr = torch.isfinite(got), torch.isfinite(ref)
    assert float((fg == fr).float().mean()) >= 0.999, what
    both = fg & fr
    assert int(both.sum()) > 1000, what
    far = ((got - ref)[both].abs() > 1e-3).float().mean()
    assert float(far) <= 5e-3, f"{what}: {float(far)} of pixels differ"


def test_chunk_raster_frame_matches_plain_and_brute(dev):
    """K3 at 500x960, one pose per bench mesh: against the plain pair
    evaluation (exact coverage) and the barycentric oracle, which divides
    per pixel where the planes do not."""
    r = _bench_stack(dev)
    poses = torch.as_tensor(_scene_poses(2, 1), device=dev)
    mi = torch.tensor([0, 1], device=dev)
    n0 = trs.chunk_raster_frame.launches
    got = trs.rasterize_depth_chunked_multi(r.Cs, poses, mi, BENCH_INTR)
    torch.cuda.synchronize()
    assert trs.chunk_raster_frame.launches == n0 + 2
    ref = trs.rasterize_depth_chunked_multi_plain(r.Cs, poses, mi, BENCH_INTR)
    _assert_depth_equal(got, ref, "frame")
    for m in range(2):
        F = r.Fs[m].long()
        brute = trs.rasterize_depth_brute(r.Vs[m], F, poses[m], BENCH_INTR,
                                          chunk=64)
        _assert_depth_close(got[m], brute, f"brute, mesh {m}")


def test_chunk_raster_batched_matches_plain_and_crop(dev):
    """K4 on 20 windows of 256x384 against the plain version, and the ROI
    property: a window equals the crop of K3's full frame at its origin
    (the same planes up to the rounding of the subtracted origin)."""
    r = _bench_stack(dev)
    n, roi = 20, (256, 384)
    poses = torch.as_tensor(_scene_poses(n, 2), device=dev)
    mi = torch.as_tensor(np.arange(n) % 2, device=dev)
    rng = np.random.default_rng(3)
    org = torch.as_tensor(np.stack([rng.integers(0, 960 - 384, n),
                                    rng.integers(0, 500 - 256, n)], 1),
                          dtype=torch.float32, device=dev)
    n0 = trs.chunk_raster_batched.launches
    got = trs.rasterize_depth_chunked_multi_roi(r.Cs, poses, mi, org,
                                                BENCH_INTR, roi)
    torch.cuda.synchronize()
    assert trs.chunk_raster_batched.launches == n0 + 1
    ref = trs.rasterize_depth_chunked_multi_roi_plain(r.Cs, poses, mi, org,
                                                      BENCH_INTR, roi)
    _assert_depth_equal(got, ref, "roi windows")
    full = trs.rasterize_depth_chunked_multi(r.Cs, poses[:4], mi[:4],
                                             BENCH_INTR)
    for b in range(4):
        x0, y0 = int(org[b, 0]), int(org[b, 1])
        crop = full[b, y0:y0 + roi[0], x0:x0 + roi[1]]
        if int(torch.isfinite(crop).sum()) > 1000:
            _assert_depth_close(got[b], crop, f"crop of window {b}")


@pytest.mark.parametrize("shape", [(24, 256, 384), (3, 500, 960),
                                   (2, 2, 37, 53)])
def test_depth_edge_matches_plain(dev, shape):
    """K5 on rendered-like depth (planes with holes and +inf background):
    equal to 1e-6 (same sum order, no FMA contraction)."""
    rng = np.random.default_rng(4)
    H, W = shape[-2:]
    yy, xx = np.mgrid[0:H, 0:W]
    d = (2.0 + 0.002 * xx + 0.001 * yy)[None] \
        + rng.uniform(0, 1.5, (int(np.prod(shape[:-2])), 1, 1))
    d = np.where(rng.uniform(size=d.shape) < 0.02, np.inf, d)
    d[:, : H // 3] = np.inf
    d[:, :, : W // 5] = -1.0
    d = torch.as_tensor(d.reshape(shape), dtype=torch.float32, device=dev)
    n0 = ted.depth_edge.launches
    got = ted.depth_edge(d)
    ref = ted.depth_edge_plain(d)
    torch.cuda.synchronize()
    assert ted.depth_edge.launches == n0 + 1
    assert got.shape == d.shape
    assert float((got - ref).abs().max()) <= 1e-6
    assert float(ref.max()) == 1.0 and float(ref.sum()) > 10


def test_semantic_wrappers_raise_on_bad_input(dev):
    planes = torch.zeros((2, 3, 12, 128), device=dev)
    ids = torch.zeros((2, 4, 3), dtype=torch.int32, device=dev)
    counts = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    small = Intrinsics(fx=50.0, fy=50.0, cx=16.0, cy=16.0, rows=32, cols=32)
    with pytest.raises(ValueError):                 # one pose only
        trs.chunk_raster_frame(planes, ids, counts, small)
    with pytest.raises(ValueError):                 # ids of the wrong grid
        trs.chunk_raster_batched(planes, ids[:, :3], counts[:, :3], small)
    with pytest.raises(ValueError):                 # ids not int32
        trs.chunk_raster_batched(planes, ids.long(), counts, small)
    out = trs.chunk_raster_batched(planes, ids, counts, small)
    assert torch.isinf(out).all() and out.shape == (2, 32, 32)
