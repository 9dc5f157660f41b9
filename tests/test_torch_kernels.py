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
from visma_tpu_torch.image import edges as ted, remap as trm
from visma_tpu_torch.image.undistort import corvis_undistorter
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


def test_lk_track_matches_plain(dev):
    """One launch for 4 levels, the forward-backward pass and the gates
    against lk_track_plain on the card, 96 features of a 500x960 pyramid
    with every 5th invalid and four at the frame's edge: 1e-3 px where both
    accept, at most 1 ok flip; invalid features come back unchanged."""
    img0 = _texture(500, 960, seed=5).to(dev)
    img1 = torch.roll(img0, shifts=(3, -2), dims=(0, 1)).contiguous()
    p0, p1 = build_pyramid(img0, 4), build_pyramid(img1, 4)
    pts, _, valid = tdet.detect_features(img0, 96, 32)
    pts = pts.clone()
    pts[:4] = torch.tensor([[2.0, 3.5], [957.5, 497.0], [480.0, 1.0],
                            [0.5, 250.0]], device=dev)
    valid = valid.clone()
    valid[::5] = False
    n0, l0 = tkf.lk_track.launches, tkf.lk_level.launches
    nk, okk = tkf.lk_track(p0, p1, pts, valid, levels=4)
    torch.cuda.synchronize()
    assert tkf.lk_track.launches == n0 + 1 and tkf.lk_level.launches == l0
    npl, okp = tkf.lk_track_plain(p0, p1, pts, valid, levels=4)
    assert int((okk != okp).sum()) <= 1
    both = okk & okp
    assert int(both.sum()) >= 40
    assert float((nk - npl)[both].abs().max()) <= 1e-3
    assert not bool(okk[~valid].any())
    assert torch.equal(nk[~valid], pts[~valid])
    # fewer levels, and a pyramid whose top level is too small and skipped
    small = (build_pyramid(img0[:96, :112].contiguous(), 4),
             build_pyramid(img1[:96, :112].contiguous(), 4))
    assert tkf.level_windows(small[0], 4, 5, 24)[3][2] == 0
    sp = torch.tensor([[30.0, 40.0], [80.5, 50.25], [60.0, 20.0]], device=dev)
    sv = torch.ones(3, dtype=torch.bool, device=dev)
    for pyr, lv in ((small, 4), ((p0, p1), 1), ((p0, p1), 2)):
        a, oka = tkf.lk_track(*pyr, sp, sv, levels=lv)
        b, okb = tkf.lk_track_plain(*pyr, sp, sv, levels=lv)
        assert torch.equal(oka, okb)
        assert float((a - b).abs().max()) <= 1e-3
    e, oke = tkf.lk_track(p0, p1, pts[:0], valid[:0], levels=4)
    assert e.shape == (0, 2) and oke.shape == (0,)


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
    pyr = [img, img[::2, ::2].contiguous()]
    pts = torch.full((4, 2), 30.0, device=dev)
    ok = torch.ones(4, dtype=torch.bool, device=dev)
    tkf.lk_track(pyr, pyr, pts, ok, levels=2)
    for bad in (dict(pts=pts[:, :1]),                    # not (K, 2)
                dict(valid=ok.to(torch.uint8)),          # not bool
                dict(valid=ok[:3]),                      # K mismatch
                dict(levels=3),                          # pyramid too short
                dict(levels=9),
                dict(cur=[img, img[::2, ::2]]),          # not contiguous
                dict(cur=[img.cpu(), pyr[1].cpu()]),     # another device
                dict(cur=[img.double(), pyr[1]]),        # not float32
                dict(radius=16),                         # > 1024 threads
                dict(win=120)):                          # > 48 KB shared
        kw = dict(pts=pts, valid=ok, cur=pyr, levels=2, radius=5, win=24)
        kw.update(bad)
        with pytest.raises(ValueError):
            tkf.lk_track(pyr, kw["cur"], kw["pts"], kw["valid"],
                         radius=kw["radius"], levels=kw["levels"],
                         win=kw["win"])
    tiny = [torch.zeros(12, 12, device=dev)]
    with pytest.raises(ValueError, match="too small"):
        tkf.lk_track(tiny, tiny, pts, ok, levels=1)


def test_pipeline_runs_through_kernels(dev):
    """A short VioPipeline run on the card launches K1 once per frame and
    K2 once per tracked frame (all levels and the forward-backward pass in
    one launch), and matches the host run."""
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
        k1, k2 = tdet.corner_score.launches, tkf.lk_track.launches
        _, outs[d.type] = pipe.run(pipe.init(frames[0], **init), frames[1:],
                                   gyro, accel, dts)
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert tdet.corner_score.launches - k1 == N + 1
            assert tkf.lk_track.launches - k2 == N
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


def test_chunk_raster_on_windows_made_to_hurt_the_cull(dev):
    """K4 on the adversarial windows of chip_smoke.py (silhouettes along
    subtile borders, objects overflowing the window, near and far clipping
    inside it, an empty window) and K3 on the same poses as full frames:
    exact coverage and 1e-6 relative depth against plain."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from visma_tpu_torch.io.synthetic_semantic import bench_scene
    from visma_tpu_torch.semantic.cem import _roi_origins

    r = _bench_stack(dev)
    roi = (256, 384)
    names, _, _, _, all_poses = bench_scene(1, 4)
    mean = torch.as_tensor(all_poses[0], device=dev)
    mi = torch.as_tensor([r.index(n) for n in names], device=dev)
    org = _roi_origins(mean[:, :, 3], BENCH_INTR, roi)
    a_pose, a_mi, a_org = chip_smoke.adversarial_windows(mean, mi, org, roi)
    got = trs.rasterize_depth_chunked_multi_roi(r.Cs, a_pose, a_mi, a_org,
                                                BENCH_INTR, roi)
    ref = trs.rasterize_depth_chunked_multi_roi_plain(r.Cs, a_pose, a_mi,
                                                      a_org, BENCH_INTR, roi)
    torch.cuda.synchronize()
    _assert_depth_equal(got, ref, "adversarial windows")
    assert bool(torch.isinf(got[-1]).all())
    pick = torch.tensor([0, 16, 17, 18, 19, 20, 21], device=dev)
    full = trs.rasterize_depth_chunked_multi(r.Cs, a_pose[pick], a_mi[pick],
                                             BENCH_INTR)
    full_ref = trs.rasterize_depth_chunked_multi_plain(
        r.Cs, a_pose[pick], a_mi[pick], BENCH_INTR)
    _assert_depth_equal(full, full_ref, "adversarial poses, full frames")


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
    planes = torch.zeros((2, 3, 128, 12), device=dev)
    ids = torch.zeros((2, 4, 3), dtype=torch.int32, device=dev)
    counts = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    small = Intrinsics(fx=50.0, fy=50.0, cx=16.0, cy=16.0, rows=32, cols=32)
    with pytest.raises(ValueError):                 # one pose only
        trs.chunk_raster_frame(planes, ids, counts, small)
    with pytest.raises(ValueError):                 # ids of the wrong grid
        trs.chunk_raster_batched(planes, ids[:, :3], counts[:, :3], small)
    with pytest.raises(ValueError):                 # ids not int32
        trs.chunk_raster_batched(planes, ids.long(), counts, small)
    with pytest.raises(ValueError):                 # the lane-major layout
        trs.chunk_raster_batched(planes.transpose(2, 3).contiguous(), ids,
                                 counts, small)
    with pytest.raises(ValueError):                 # not 16-byte aligned
        trs.chunk_raster_batched(
            torch.zeros(2 * 3 * 128 * 12 + 1, device=dev)[1:].reshape(
                2, 3, 128, 12), ids, counts, small)
    out = trs.chunk_raster_batched(planes, ids, counts, small)
    assert torch.isinf(out).all() and out.shape == (2, 32, 32)


# ---------------------------------------------------------------------------
# K6: bilinear remap
# ---------------------------------------------------------------------------

def _random_table(rng, oh, ow, H, W, dev):
    t = np.stack([rng.uniform(1, W - 2, (oh, ow)),
                  rng.uniform(1, H - 2, (oh, ow))], -1).astype(np.float32)
    t[3, :, 0] = -1.0
    t[5, 7] = np.nan
    return torch.as_tensor(t, device=dev)


@pytest.mark.parametrize("shape", [(600, 960), (3, 131, 77), (2, 50, 60, 3),
                                   (2, 3, 40, 44, 1)])
def test_bilinear_remap_f32_matches_plain(dev, shape):
    """f32, with batch and channel axes: equal to the plain version (no FMA
    contraction, the same order), invalid and NaN entries 0."""
    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.uniform(0, 255, shape).astype(np.float32),
                          device=dev)
    chan = len(shape) >= 3 and shape[-1] <= 4
    H, W = shape[-3:-1] if chan else shape[-2:]
    table = _random_table(rng, 37, 53, H, W, dev)
    n0 = trm.bilinear_remap.launches
    got = trm.bilinear_remap(img, table)
    ref = trm.bilinear_remap_plain(img, table)
    torch.cuda.synchronize()
    assert trm.bilinear_remap.launches == n0 + 1
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert float((got - ref).abs().max()) <= 1e-5 * 255
    row = got[..., 3, :, :] if chan else got[..., 3, :]
    assert float(row.abs().max()) == 0.0


@pytest.mark.parametrize("shape", [(8, 600, 960, 3), (5, 131, 77)])
def test_bilinear_remap_u8_matches_plain(dev, shape):
    """u8 storage: 0 differing bytes, through the Corvis table's row slice
    or a random table; a sliced, non-contiguous batch is made contiguous
    by the wrapper."""
    rng = np.random.default_rng(1)
    img = torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8),
                          device=dev)
    if shape[1:3] == (600, 960):
        table = corvis_undistorter(device=dev).remap[50:550]
    else:
        table = _random_table(rng, 64, 40, shape[1], shape[2], dev)
    got = trm.bilinear_remap(img, table)
    ref = trm.bilinear_remap_plain(img, table)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and torch.equal(got, ref)
    every_other = img[::2]
    assert not every_other.is_contiguous()
    assert torch.equal(trm.bilinear_remap(every_other, table), ref[::2])


def test_bilinear_remap_ties_and_other_dtypes(dev):
    """Exact .5 values round half to even in the kernel as in torch.round;
    int32 and float16 go through the f32 kernel and are cast."""
    y, x = np.mgrid[0:48, 0:64]
    board = torch.as_tensor(((y + x) % 2 * 255).astype(np.uint8), device=dev)
    half = torch.as_tensor(np.stack([x + 0.5, y + 0.5], -1)[:-1, :-1]
                           .astype(np.float32), device=dev)
    got = trm.bilinear_remap(board, half)
    assert torch.equal(got, trm.bilinear_remap_plain(board, half))
    assert set(got.unique().tolist()) == {128}
    rng = np.random.default_rng(2)
    table = _random_table(rng, 20, 30, 48, 64, dev)
    for img in (torch.as_tensor(rng.integers(-50, 400, (48, 64)),
                                device=dev).to(torch.int32),
                torch.as_tensor(rng.uniform(0, 1, (48, 64)),
                                device=dev).to(torch.float16)):
        n0 = trm.bilinear_remap.launches
        got = trm.bilinear_remap(img, table)
        assert trm.bilinear_remap.launches == n0 + 1
        assert got.dtype == img.dtype
        assert torch.equal(got, trm.bilinear_remap_plain(img, table))


def test_bilinear_remap_refuses_mixed_devices(dev):
    img = torch.zeros((8, 8), device=dev)
    with pytest.raises(ValueError, match="CUDA device"):
        trm.bilinear_remap(img, torch.zeros((4, 4, 2)))
