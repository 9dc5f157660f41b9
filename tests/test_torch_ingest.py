"""The PyTorch port's sequence-ingest slice as a whole (raw frames ->
Undistorter -> crop -> VioPipeline, `pack_frames`, and the undistort_images /
run_vio command-line tools) against the JAX reference on the CPU, at a small
size: 80x112 raw frames, a 72x96 table cropped to 64x96, 12 frames, 2
pyramid levels, 24 tracks. Both sides track with the windowed tracker
(`fused_klt=False`, the reference's default off the TPU). Tolerances are
stated per test."""
import json
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from visma_tpu.cli import run_vio as j_run_vio
from visma_tpu.cli import undistort_images as j_undistort_images
from visma_tpu.filter import FilterConfig as JConfig
from visma_tpu.filter.feed import pack_frames as j_pack_frames
from visma_tpu.image import AtanModel as JAtan, Undistorter as JUndistorter
from visma_tpu.io.synthetic import (SyntheticConfig, make_dataset, make_imu)
from visma_tpu.io.synthetic_images import render_blob_frames
from visma_tpu.pipeline import VioPipeline as JPipeline

from visma_tpu_torch.cli import run_vio, undistort_images
from visma_tpu_torch.filter.config import FilterConfig
from visma_tpu_torch.filter.feed import pack_frames
from visma_tpu_torch.image import AtanModel, Undistorter
from visma_tpu_torch.io import VlslamDatasetLoader, glob_by_timestamp
from visma_tpu_torch.pipeline import VioPipeline

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the inverse warp that makes raw frames)

CALIB = (0.55, 0.8, 0.5, 0.52, 0.6)     # fx, fy, cx, cy (relative), s
RAW = (80, 112)
OUT = (72, 96)
CROP = (4, 64)                          # top row, rows kept
N_FRAMES = 12


@pytest.fixture(scope="module")
def scene():
    """12 blob frames rendered with the undistorter's output camera, warped
    to raw distorted u8 frames by the inverse ATAN map, with IMU."""
    und = Undistorter(AtanModel(*CALIB, *RAW), "crop", *OUT, device="cpu")
    full, cropped = chip_smoke.ingest_camera(
        und, *CROP, num_frames=N_FRAMES, num_landmarks=80, seed=11)
    frames, gwc, _ = render_blob_frames(full)
    raw = chip_smoke.warp_to_raw(frames, chip_smoke.inverse_atan_table(und),
                                 torch.device("cpu")).numpy()
    assert raw.shape == (N_FRAMES, *RAW) and raw.dtype == np.uint8
    imu = make_imu(full)
    spf = imu["samples_per_frame"]
    N = N_FRAMES - 1
    feed = dict(gyro=imu["gyro"][: N * spf].reshape(N, spf, 3),
                accel=imu["accel"][: N * spf].reshape(N, spf, 3),
                dts=np.full((N, spf), float(np.diff(imu["ts_state"])[0]),
                            np.float32))
    kw = dict(window=6, max_tracks=24, max_updates=8, fx=cropped.fx,
              fy=cropped.fy, cx=cropped.cx, cy=cropped.cy, pixel_noise=1.0)
    init = dict(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])
    return dict(und=und, raw=raw, gwc=gwc, imu=imu, feed=feed, kw=kw,
                init=init, full=full, cropped=cropped)


@pytest.fixture(scope="module")
def runs(scene):
    """The raw frames through both packages: undistort, crop, run."""
    top, rows = CROP
    jund = JUndistorter(JAtan(*CALIB, *RAW), "crop", *OUT)
    jimg = np.asarray(jund(jnp.asarray(scene["raw"])))[:, top:top + rows]
    jp = JPipeline(JConfig(**scene["kw"]), levels=2, cell=16,
                   fused_klt=False)
    js0 = jp.init(jnp.asarray(jimg[0].astype(np.float32)), **scene["init"])
    _, jo = jp.run(js0, jimg[1:].astype(np.float32), **scene["feed"])
    jo = {k: np.asarray(v) for k, v in jo.items()}

    und = scene["und"]
    timg = und(scene["raw"])[:, top:top + rows]
    tp = VioPipeline(FilterConfig(**scene["kw"]), levels=2, cell=16,
                     fused_klt=False, device="cpu")
    ts0 = tp.init(timg[0].to(torch.float32), **scene["init"])
    _, to = tp.run(ts0, timg[1:].to(torch.float32), **scene["feed"])
    return dict(jimg=jimg, timg=timg.numpy(), jo=jo,
                to={k: v.numpy() for k, v in to.items()})


def test_undistorted_frames_within_one_grey_level(runs):
    """Each side through its own table (they differ by 1e-4 px): every
    byte within 1 grey level; measured: 1.4e-5 of the bytes differ."""
    diff = np.abs(runs["jimg"].astype(int) - runs["timg"].astype(int))
    assert runs["timg"].shape == (N_FRAMES, CROP[1], OUT[1])
    assert diff.max() <= 1
    assert (diff > 0).mean() < 2e-3


def test_track_counts_equal_per_frame(runs):
    """The frontends make the same decisions on those frames: ids and
    validity equal in every frame, and there is something to track."""
    jo, to = runs["jo"], runs["to"]
    for key in ("obs_ids", "obs_valid", "feat_ids", "healthy"):
        np.testing.assert_array_equal(to[key], jo[key], err_msg=key)
    assert jo["obs_valid"].sum(axis=1).min() >= 8


def test_trajectories_close(runs, scene):
    """Positions within 1e-4 m and rotations within 1e-4 over 11 frames
    (measured: 1.2e-7 m and 3.6e-7), tracked pixels within 1e-2 px
    (measured: 2.7e-4: a one-grey-level difference in a frame moves a
    tracked point), and both near the ground truth."""
    jo, to = runs["jo"], runs["to"]
    np.testing.assert_allclose(to["p"], jo["p"], atol=1e-4)
    np.testing.assert_allclose(to["R"], jo["R"], atol=1e-4)
    np.testing.assert_allclose(to["obs_xp"], jo["obs_xp"], atol=1e-2)
    truth = scene["gwc"][1:, :, 3]
    for p in (to["p"], jo["p"]):
        assert np.sqrt(np.mean(np.sum((p - truth) ** 2, axis=1))) < 0.02


# ---------------------------------------------------------------------------
# pack_frames
# ---------------------------------------------------------------------------

def _assert_packed_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _feed_case_plain():
    syn = SyntheticConfig(num_frames=10, num_landmarks=60, seed=4)
    ds, imu = make_dataset(syn), make_imu(syn)
    kw = dict(window=6, max_tracks=32)
    got = pack_frames(FilterConfig(**kw), ds, imu, max_feats=40)
    _assert_packed_equal(got, j_pack_frames(JConfig(**kw), ds, imu,
                                            max_feats=40))
    assert got["dts"][1:].sum(axis=1) == pytest.approx(1 / syn.fps, rel=1e-5)
    assert got["valid"].any() and got["ids"].shape == (10, 40)


def _feed_case_vision_only():
    syn = SyntheticConfig(num_frames=6, num_landmarks=30, seed=5)
    ds = make_dataset(syn)
    got = pack_frames(FilterConfig(), ds, None)
    _assert_packed_equal(got, j_pack_frames(JConfig(), ds, None))
    assert (got["gyro"] == 0).all() and got["dts"][1, -1] > 0


def _feed_case_ts_override():
    """Packets stamped in microseconds, IMU in seconds: the normalised
    timeline passed as `ts` selects the right samples on both sides."""
    syn = SyntheticConfig(num_frames=8, num_landmarks=30, seed=6)
    ds, imu = make_dataset(syn), make_imu(syn)
    ts = np.array([p.ts for p in ds.packets])
    for p in ds.packets:
        p.ts = p.ts * 1e6
    got = pack_frames(FilterConfig(), ds, imu, ts=ts)
    _assert_packed_equal(got, j_pack_frames(JConfig(), ds, imu, ts=ts))
    np.testing.assert_array_equal(got["ts"], ts)
    assert (got["dts"][1:].sum(axis=1) > 0).all()
    with pytest.raises(ValueError, match="stamps for"):
        pack_frames(FilterConfig(), ds, imu, ts=ts[:-1])


def _feed_case_stamp_units_error():
    """Microsecond frames against second IMU stamps without the override:
    the timelines do not overlap, and both sides say so."""
    syn = SyntheticConfig(num_frames=8, num_landmarks=30, seed=6)
    ds, imu = make_dataset(syn), make_imu(syn)
    for p in ds.packets:
        p.ts = 1.5e15 + p.ts * 1e6
    for fn, cfg in ((pack_frames, FilterConfig()), (j_pack_frames, JConfig())):
        with pytest.raises(ValueError, match="does not overlap"):
            fn(cfg, ds, imu)


FEED_CASES = [_feed_case_plain, _feed_case_vision_only,
              _feed_case_ts_override, _feed_case_stamp_units_error]


@pytest.mark.parametrize("case", FEED_CASES,
                         ids=[c.__name__[11:] for c in FEED_CASES])
def test_pack_frames_equals_reference(case):
    case()


# ---------------------------------------------------------------------------
# The command-line tools
# ---------------------------------------------------------------------------

def _report(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    return json.loads(lines[0])


def _both_reports(capsys, args, port_extra=()):
    j_run_vio.main(list(args))
    ref = _report(capsys)
    run_vio.main([*args, "--device", "cpu", *port_extra])
    return _report(capsys), ref


def test_run_vio_synthetic_feature_feed(capsys, tmp_path):
    """`--synthetic 20`, feature-feed: the same report keys, the same frame
    count, ATE within 1e-4 m of the reference CLI's; the exported dataset
    loads with the port's loader."""
    got, ref = _both_reports(capsys, ["--synthetic", "20"],
                             ["--output", str(tmp_path / "est")])
    assert got.keys() == ref.keys() and got["frames"] == ref["frames"] == 20
    assert abs(got["ate_rmse_m"] - ref["ate_rmse_m"]) <= 1e-4
    assert got["ate_rmse_m"] < 0.05
    est = VlslamDatasetLoader(str(tmp_path / "est"))
    assert len(est) == 20 and np.isfinite(est.pose(19)).all()


def test_run_vio_synthetic_images(capsys):
    """`--synthetic 20 --images`: the whole pipeline on rendered frames,
    windowed tracker on both sides; ATE within 1e-4 m."""
    args = ["--synthetic", "20", "--images", "--max-tracks", "48"]
    got, ref = _both_reports(capsys, args, ["--fused-klt", "off"])
    assert got.keys() == ref.keys() and got["frames"] == ref["frames"] == 19
    assert abs(got["ate_rmse_m"] - ref["ate_rmse_m"]) <= 1e-4
    assert got["ate_rmse_m"] < 0.01


@pytest.fixture(scope="module")
def raw_sequence(scene, tmp_path_factory):
    """The scene's raw frames as a VISMA directory: PNGs named by
    microsecond stamp, a `dataset` with those stamps, an IMU npz stamped in
    seconds, and a calibration file."""
    root = tmp_path_factory.mktemp("ingest")
    seq, npz = chip_smoke.write_raw_sequence(
        str(root), scene["raw"], scene["gwc"], scene["cropped"], scene["imu"],
        scene["full"].fps)
    calib = root / "calib.txt"
    calib.write_text(" ".join(str(v) for v in CALIB)
                     + f"\n{RAW[1]} {RAW[0]}\ncrop\n{OUT[1]} {OUT[0]}\n")
    return dict(root=root, seq=seq, npz=npz, calib=str(calib))


def test_undistort_images_cli(raw_sequence, capsys):
    """Both tools on the same directory with the same calibration file:
    the same file names, each byte within 1 grey level."""
    root = raw_sequence["root"]
    args = [raw_sequence["seq"], "--calib", raw_sequence["calib"]]
    j_undistort_images.main([*args, "--output", str(root / "und_ref")])
    undistort_images.main([*args, "--output", str(root / "und"),
                           "--device", "cpu"])
    assert "output K: fx=" in capsys.readouterr().out
    import cv2

    got = glob_by_timestamp(str(root / "und"), ".png")
    ref = glob_by_timestamp(str(root / "und_ref"), ".png")
    assert [Path(p).name for p in got] == [Path(p).name for p in ref]
    assert len(got) == N_FRAMES
    for a, b in zip(got, ref):
        ia, ib = cv2.imread(a), cv2.imread(b)
        assert ia.shape == ib.shape == (*OUT, 3)
        assert np.abs(ia.astype(int) - ib.astype(int)).max() <= 1
    with pytest.raises(ValueError, match="calibration is for"):
        undistort_images.main([str(root / "und"), "--calib",
                               raw_sequence["calib"], "--device", "cpu",
                               "--output", str(root / "twice")])


def test_run_vio_images_from_disk(raw_sequence, scene, capsys):
    """undistort_images, then `run_vio --images` on its output, through
    both packages' tools: microsecond frame stamps against second IMU
    stamps, the same report keys, ATE within 1e-3 m of each other, and an
    exported dataset of 11 packets stamped in seconds."""
    root = raw_sequence["root"]
    und_dir = root / "und_full"
    undistort_images.main([raw_sequence["seq"], "--calib",
                           raw_sequence["calib"], "--output", str(und_dir),
                           "--device", "cpu"])
    # the tool keeps all 72 rows of a calibration file's output: the camera
    # of the whole output frame goes into the sequence's dataset
    (und_dir / "dataset").write_bytes(chip_smoke.raw_sequence_dataset(
        scene["gwc"], scene["full"], scene["full"].fps).encode())
    capsys.readouterr()
    args = ["--dataroot", str(und_dir), "--imu", raw_sequence["npz"],
            "--images", "--levels", "2", "--cell", "16", "--max-tracks", "32",
            "--window", "6", "--pixel-noise", "1.0"]
    got, ref = _both_reports(capsys, args,
                             ["--fused-klt", "off", "--output",
                              str(root / "est")])
    assert got.keys() == ref.keys()
    assert got["frames"] == ref["frames"] == N_FRAMES - 1
    assert abs(got["ate_rmse_m"] - ref["ate_rmse_m"]) <= 1e-3
    assert got["ate_rmse_m"] < 0.02
    est = VlslamDatasetLoader(str(root / "est"))
    assert len(est.dataset.packets) == N_FRAMES - 1
    stamps = np.array([p.ts for p in est.dataset.packets])
    assert abs(stamps[0] - (chip_smoke.EPOCH_US * 1e-6 + 1 / 30)) < 1e-3
    assert np.all(np.diff(stamps) > 0.03)


@pytest.mark.parametrize("flags, message", [
    # `--ba dense` runs since ba/ is ported (tests/test_torch_ba.py), and
    # `--ba sharded` since dist/ is (tests/test_torch_dist.py): nothing of
    # run_vio is refused any more, so the case, which keeps its id, holds
    # that the flag runs and that no message says it is not ported
    pytest.param(["--ba", "sharded"], "--ba sharded is not ported yet",
                 id="flags1---ba sharded is not ported yet"),
])
def test_run_vio_refuses_what_is_not_ported(flags, message, capsys):
    """No fallback and no refusal left: the flag runs on the device asked
    for, and nothing reports it as not ported."""
    report = run_vio.main(["--synthetic", "8", "--device", "cpu", *flags])
    assert report["frames"] == 8
    assert message not in capsys.readouterr().err


def test_run_vio_wants_the_card():
    """Without --device the tools run on the CUDA card and raise where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_vio.main(["--synthetic", "8"])
    with pytest.raises(RuntimeError, match="CUDA"):
        undistort_images.main(["."])


def test_chip_smoke_ingest_phase_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The functions of chip_smoke.py's ingest phase at a small size on the
    CPU, its timers replaced: the geometry check (blob centroids within
    0.25 px of their projections after warp, undistortion and crop), the
    kernel checks (trivial here: the wrapper is its plain version), the
    run, and the tools from disk."""
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, reps=1, warmup=0: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "graph_ms",
                        lambda fn, reps=1, replays=1: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "CLI_FRAMES", 8)
    dev = torch.device("cpu")
    raw_size, crop = (360, 576), (30, 300)
    calib = (0.561859, 0.901540, 0.491896, 0.512629, 0.709402)
    und = Undistorter(AtanModel(*calib, *raw_size), "crop", *raw_size,
                      device="cpu")
    inv = chip_smoke.inverse_atan_table(und)
    assert chip_smoke.ingest_geometry(dev, und, crop, inv,
                                      num_landmarks=80) <= 0.25

    full, cropped = chip_smoke.ingest_camera(und, *crop, num_frames=10,
                                             num_landmarks=120, seed=7)
    frames, gwc, _ = render_blob_frames(full)
    imu = make_imu(full)
    raw = chip_smoke.warp_to_raw(frames, inv, dev)
    kernels = []
    chip_smoke.remap_kernel_checks(dev, und, crop, raw, kernels, reps=1)
    assert kernels[0]["name"] == "bilinear_remap" \
        and kernels[0]["u8_differing_bytes"] == 0
    cfg = FilterConfig(window=6, max_tracks=32, max_updates=8, fx=cropped.fx,
                       fy=cropped.fy, cx=cropped.cx, cy=cropped.cy,
                       pixel_noise=1.0)
    res = chip_smoke.ingest_run(dev, und, crop, raw, gwc, imu, cfg, levels=2,
                                cell=16)
    assert res["ate"] < 0.01 and res["n_frames"] == 10

    calib_file = tmp_path / "calib.txt"
    calib_file.write_text(" ".join(map(str, calib))
                          + "\n576 360\ncrop\n576 360\n")
    report = chip_smoke.ingest_cli(
        str(tmp_path), raw[:8].numpy(), gwc, full, imu, full.fps, levels=2,
        device_args=["--device", "cpu"],
        und_args=["--calib", str(calib_file)])
    assert report["frames"] == 7
    capsys.readouterr()
