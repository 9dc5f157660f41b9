"""Parity of the PyTorch port's undistortion (visma_tpu_torch.image.remap,
.image.undistort) with the JAX reference on the CPU: the same seeded numpy
inputs through `visma_tpu.image.bilinear_remap`, through the TPU kernel
`bilinear_remap_pallas` in interpret mode (as tests/test_image.py runs it)
and through the port, whose wrapper takes its plain version for a CPU
tensor. Tolerances are stated per case."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from visma_tpu.image import (AtanModel as JAtan, RadTanModel as JRadTan,
                             Undistorter as JUndistorter,
                             bilinear_remap as j_remap,
                             bilinear_remap_pallas as j_remap_pallas)
from visma_tpu.image.undistort import (corvis_undistorter as j_corvis,
                                       undistorter_from_file as j_from_file)

from visma_tpu_torch import convert
from visma_tpu_torch.image import (CORVIS_ATAN_CALIB, AtanModel, RadTanModel,
                                   Undistorter, bilinear_remap,
                                   bilinear_remap_plain, corvis_undistorter,
                                   undistorter_from_file)


def checkerboard(h, w, sq=16):
    y, x = np.mgrid[0:h, 0:w]
    return (((y // sq) + (x // sq)) % 2 * 255).astype(np.uint8)


def identity_table(h, w, shift=0.0):
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([x + shift, y + shift], axis=-1).astype(np.float32)


def random_table(rng, oh, ow, H, W):
    return np.stack([rng.uniform(1, W - 2, (oh, ow)),
                     rng.uniform(1, H - 2, (oh, ow))], -1).astype(np.float32)


def _port(img, table):
    return bilinear_remap(torch.as_tensor(img), torch.as_tensor(table)).numpy()


def _jax(img, table):
    return np.asarray(j_remap(jnp.asarray(img), jnp.asarray(table)))


def _case_f32_invalid_rows():
    """f32 (100, 128), some table rows invalid: the XLA gather, the TPU
    kernel (interpret) and the port agree to 1e-4 on a 0-1 image."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (100, 128)).astype(np.float32)
    table = random_table(rng, 96, 128, 100, 128)
    table[10, :, 0] = -1
    got = _port(img, table)
    pallas = np.asarray(j_remap_pallas(jnp.asarray(img), jnp.asarray(table),
                                       interpret=True))
    np.testing.assert_allclose(got, _jax(img, table), atol=1e-4)
    np.testing.assert_allclose(got, pallas, atol=1e-4)
    assert (got[10] == 0).all() and got.dtype == np.float32


def _case_u8_batch_channels():
    """u8 (2, 40, 40, 3) through a random table: equal bytes."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (2, 40, 40, 3), dtype=np.uint8)
    table = random_table(rng, 30, 36, 40, 40)
    got = _port(img, table)
    assert got.shape == (2, 30, 36, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _jax(img, table))


def _case_identity_table():
    """Identity table: the interior comes back exactly, in f32 and u8."""
    img = checkerboard(64, 96)
    table = identity_table(64, 96)
    for src in (img, img.astype(np.float32)):
        got = _port(src, table)
        np.testing.assert_array_equal(got, src)
        np.testing.assert_array_equal(got, _jax(src, table))


def _case_half_pixel_ties():
    """A checkerboard through identity + half a pixel gives exact .5
    values (127.5, 63.75 + 63.75, ...): round half to even on both sides,
    equal bytes."""
    img = checkerboard(48, 64, sq=1)
    table = identity_table(48, 64, shift=0.5)[:-1, :-1]
    got = _port(img, table)
    np.testing.assert_array_equal(got, _jax(img, table))
    # 0.25 * (255 + 255) = 127.5 -> 128 (even), never 127
    assert set(np.unique(got)) == {128}
    tie = _port(np.array([[0, 1], [0, 1]], np.uint8),
                np.array([[[0.5, 0.0]]], np.float32))
    assert tie.item() == 0      # 0.5 -> 0 (even), where half-up gives 1


def _case_slice_of_table():
    """A crop of rows is a slice of the table: the reference's two steps
    (remap, then slice) give the port's one step (remap of the slice)."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (3, 50, 60), dtype=np.uint8)
    table = random_table(rng, 50, 60, 50, 60)
    two_step = _jax(img, table)[:, 7:41]
    np.testing.assert_array_equal(_port(img, table[7:41]), two_step)
    sliced = torch.as_tensor(table)[7:41]
    assert sliced.is_contiguous() and sliced.storage_offset() > 0
    np.testing.assert_array_equal(
        bilinear_remap(torch.as_tensor(img), sliced).numpy(), two_step)


def _case_channel_rule():
    """The reference's shape rule, copied: a last axis of 1-4 on >= 3 dims
    is the channel axis, so a (B, H, W) batch with W = 3 is one image of 3
    channels, and W = 5 is a batch."""
    rng = np.random.default_rng(5)
    for shape in ((6, 7, 3), (6, 7, 5), (2, 6, 7, 1), (2, 3, 6, 7, 4)):
        img = rng.uniform(0, 255, shape).astype(np.float32)
        chan = shape[-1] <= 4
        H, W = shape[-3:-1] if chan else shape[-2:]
        table = random_table(rng, 4, 5, H, W)
        got, ref = _port(img, table), _jax(img, table)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-4)


def _case_other_dtypes():
    """int32 rounds, clips to [0, 255] and casts back; float16 goes through
    f32 arithmetic and is cast, as the reference casts."""
    rng = np.random.default_rng(6)
    table = random_table(rng, 12, 14, 20, 24)
    ints = rng.integers(-50, 400, (20, 24)).astype(np.int32)
    got = _port(ints, table)
    assert got.dtype == np.int32 and got.min() >= 0 and got.max() <= 255
    np.testing.assert_array_equal(got, _jax(ints, table))
    half = rng.uniform(0, 1, (20, 24)).astype(np.float16)
    got = _port(half, table)
    assert got.dtype == np.float16
    np.testing.assert_allclose(got.astype(np.float32),
                               _jax(half, table).astype(np.float32),
                               atol=1e-3)


def _case_non_finite_entries():
    """A NaN entry is invalid and gives 0; a huge entry clamps into the
    frame: nothing indexes outside."""
    img = np.arange(30, dtype=np.float32).reshape(5, 6)
    table = np.array([[[np.nan, 2.0], [2.0, np.nan], [1e9, 1e9],
                       [np.inf, 1.0]]], np.float32)
    got = _port(img, table)
    assert got[0, 0] == 0 and np.isfinite(got[0, 2])
    assert got[0, 2] == img[4, 5]      # both taps clamp to the last pixel
    u8 = _port(img.astype(np.uint8), table)
    assert u8[0, 0] == 0 and u8[0, 2] == 29


def _case_wrapper_takes_plain_on_cpu():
    """On a CPU tensor the wrapper is its plain version and counts no
    launch; bad shapes raise."""
    rng = np.random.default_rng(7)
    img = torch.as_tensor(rng.uniform(0, 255, (2, 9, 11)).astype(np.float32))
    table = torch.as_tensor(random_table(rng, 5, 6, 9, 11))
    before = bilinear_remap.launches
    assert torch.equal(bilinear_remap(img, table),
                       bilinear_remap_plain(img, table))
    assert bilinear_remap.launches == before
    with pytest.raises(ValueError, match="oh, ow, 2"):
        bilinear_remap(img, table[..., 0])
    with pytest.raises(ValueError, match="2x2"):
        bilinear_remap(img[:, :1], table)


REMAP_CASES = [_case_f32_invalid_rows, _case_u8_batch_channels,
               _case_identity_table, _case_half_pixel_ties,
               _case_slice_of_table, _case_channel_rule, _case_other_dtypes,
               _case_non_finite_entries, _case_wrapper_takes_plain_on_cpu]


@pytest.mark.parametrize("case", REMAP_CASES,
                         ids=[c.__name__[6:] for c in REMAP_CASES])
def test_bilinear_remap(case):
    case()


# ---------------------------------------------------------------------------
# Undistorter
# ---------------------------------------------------------------------------

def _compare_tables(port: Undistorter, ref: JUndistorter, tol=1e-3,
                    nudged=0):
    """Valid masks differ on <= 0.01 % of pixels; where both are valid the
    tables agree to `tol` px except on at most `nudged` pixels, where one
    side's border nudge (0.01 px) fired and the other's did not. Returns
    the measured (mask differences, max difference, pixels over tol)."""
    jt, tt = np.asarray(ref.remap), port.remap.numpy()
    assert tt.dtype == np.float32 and tt.shape == jt.shape
    jv, tv = jt[..., 0] >= 0, tt[..., 0] >= 0
    flips = int((jv != tv).sum())
    assert flips <= 1e-4 * jv.size, flips
    d = np.abs(jt - tt).max(axis=-1)[jv & tv]
    over = int((d > tol).sum())
    assert over <= nudged, (over, float(d.max()))
    assert d.max() <= 0.0101
    return flips, float(d.max()), over


def _case_corvis_K_and_table():
    """Corvis: output K equal to 1e-6 relative (both solve it in float64 on
    the host), the cropped K is the VIO scene's camera, and the (600, 960)
    table agrees to 1e-3 px. Measured: 0 mask differences, 1.9e-4 px
    everywhere except the two ends of row 308, which the crop solve puts
    exactly on the frame edge: float32 rounding decides which side nudges
    them by 0.01 px."""
    ref, port = j_corvis(), corvis_undistorter(device="cpu")
    np.testing.assert_allclose(port.K, ref.K, rtol=1e-6)
    K = port.K.copy()
    K[1, 2] -= CORVIS_ATAN_CALIB["crop_top"]
    np.testing.assert_allclose([K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
                               [486.405, 535.401, 469.199, 257.916], atol=0.5)
    assert port.remap.shape == (600, 960, 2)
    _compare_tables(port, ref, nudged=2)


def _case_full_mode():
    """`full` mode at another output size: invalid pixels exist on both
    sides in the same places."""
    m = CORVIS_ATAN_CALIB
    args = (m["fx"], m["fy"], m["cx"], m["cy"], m["s"], 600, 960)
    ref = JUndistorter(JAtan(*args), "full", 480, 640)
    port = Undistorter(AtanModel(*args), "full", 480, 640, device="cpu")
    np.testing.assert_allclose(port.K, ref.K, rtol=1e-6)
    assert (np.asarray(ref.remap)[..., 0] < 0).sum() > 1000
    _compare_tables(port, ref)


def _case_crop_small_and_no_mode():
    """`crop` at a small size, and a mode that is neither crop nor full
    (the output K is the model's own)."""
    args = (0.55, 0.8, 0.5, 0.52, 0.6, 80, 112)
    for mode in ("crop", "none"):
        ref = JUndistorter(JAtan(*args), mode, 72, 96)
        port = Undistorter(AtanModel(*args), mode, 72, 96, device="cpu")
        np.testing.assert_allclose(port.K, ref.K, rtol=1e-6)
        _compare_tables(port, ref, nudged=4)
    from types import SimpleNamespace

    with pytest.raises(TypeError):
        Undistorter(SimpleNamespace(in_rows=8, in_cols=8), device="cpu")


def _case_zero_distortion():
    """s = 0: the map is a pure scaling, equal on both sides, and an image
    comes back unchanged in the interior."""
    args = (0.5, 0.5, 0.5, 0.5, 0.0, 64, 64)
    ref = JUndistorter(JAtan(*args), "crop", 64, 64)
    port = Undistorter(AtanModel(*args), "crop", 64, 64, device="cpu")
    np.testing.assert_allclose(port.K, ref.K, rtol=1e-6)
    _compare_tables(port, ref)
    img = checkerboard(64, 64).astype(np.float32)
    out = port(img).numpy()
    np.testing.assert_allclose(out[8:-8, 8:-8], img[8:-8, 8:-8], atol=1e-2)
    r = torch.tensor([0.0, 0.5])
    assert torch.equal(AtanModel(*args).distort_radius_factor(r),
                       torch.ones(2))
    fac = AtanModel(*args[:4], 0.7, 64, 64).distort_radius_factor(r)
    ref_fac = np.asarray(JAtan(*args[:4], 0.7, 64, 64).distort_radius_factor(
        jnp.asarray(r.numpy())))
    np.testing.assert_allclose(fac.numpy(), ref_fac, rtol=1e-6)


def _case_radtan_table():
    """Radial-tangential: both sides call cv2 on the host, so K and the
    table are equal; relative and absolute calibrations."""
    for cal in ((300.0, 300.0, 160.0, 120.0), (0.9, 1.2, 0.5, 0.5)):
        args = (*cal, -0.2, 0.05, 0.001, -0.001, 240, 320)
        for mode in ("crop", "full"):
            ref = JUndistorter(JRadTan(*args), mode, 240, 320)
            port = Undistorter(RadTanModel(*args), mode, 240, 320,
                               device="cpu")
            np.testing.assert_array_equal(port.K, ref.K)
            np.testing.assert_array_equal(port.remap.numpy(),
                                          np.asarray(ref.remap))
    x, y = np.float32(0.3), np.float32(-0.2)
    assert RadTanModel(*args).distort_normalized(x, y) \
        == JRadTan(*args).distort_normalized(x, y)


def _case_undistort_frames():
    """Undistorter.__call__ on a u8 colour batch: each side through its own
    table, within 1 grey level on >= 99.9 % of the bytes (the tables differ
    by 1e-4 px, which flips a rounding here and there); through the
    reference's table, carried over by convert, equal bytes."""
    rng = np.random.default_rng(8)
    args = (0.55, 0.8, 0.5, 0.52, 0.6, 80, 112)
    ref = JUndistorter(JAtan(*args), "crop", 72, 96)
    port = Undistorter(AtanModel(*args), "crop", 72, 96, device="cpu")
    smooth = np.add.outer(np.arange(80) * 2.0, np.arange(112) * 1.5)
    img = np.stack([smooth % 256, rng.uniform(0, 255, (80, 112))], 0)
    img = np.stack([img, img[:, ::-1], img[:, :, ::-1]], -1).astype(np.uint8)
    want = np.asarray(ref(jnp.asarray(img)))
    got = port(img).numpy()
    assert got.shape == want.shape == (2, 72, 96, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff <= 1).mean() >= 0.999 and diff.max() <= 3
    carried = convert.undistorter_from_reference(ref, device="cpu")
    np.testing.assert_array_equal(carried(img).numpy(), want)


def _case_file_sniffing(tmp_path):
    """8 floats on line 1: the OpenCV model; else ATAN. Same K and table
    sizes as the reference's factory."""
    atan = tmp_path / "atan.txt"
    atan.write_text("0.5 0.5 0.5 0.5 0.7\n64 48\ncrop\n64 48\n")
    ocv = tmp_path / "ocv.txt"
    ocv.write_text("300 300 160 120 -0.2 0.05 0 0\n320 240\ncrop\n320 240\n")
    for path, cls in ((atan, AtanModel), (ocv, RadTanModel)):
        port = undistorter_from_file(str(path), device="cpu")
        ref = j_from_file(str(path))
        assert isinstance(port.model, cls)
        assert (port.in_rows, port.in_cols, port.out_rows, port.out_cols,
                port.mode) == (ref.in_rows, ref.in_cols, ref.out_rows,
                               ref.out_cols, ref.mode)
        np.testing.assert_allclose(port.K, ref.K, rtol=1e-6)
        assert port.remap.shape == np.asarray(ref.remap).shape


def _case_convert_round_trip(tmp_path):
    """convert.undistorter_from_reference keeps the model, mode, sizes, K
    and the reference's own table; undistorter_to_numpy gives them back."""
    for ref in (JUndistorter(JAtan(0.55, 0.8, 0.5, 0.52, 0.6, 80, 112),
                             "full", 72, 96),
                JUndistorter(JRadTan(300.0, 300.0, 160.0, 120.0, -0.2, 0.05,
                                     0.001, -0.001, 240, 320), "crop")):
        port = convert.undistorter_from_reference(ref, device="cpu")
        assert type(port.model).__name__ == type(ref.model).__name__
        assert port.remap.device.type == "cpu"
        back = convert.undistorter_to_numpy(port)
        np.testing.assert_array_equal(back["remap"], np.asarray(ref.remap))
        np.testing.assert_array_equal(back["K"], ref.K)
        assert (back["mode"], back["out_rows"], back["out_cols"]) \
            == (ref.mode, ref.out_rows, ref.out_cols)
        assert back["model"] == {k: getattr(ref.model, k)
                                 for k in back["model"]}
        again = convert.undistorter_from_reference(back, device="cpu")
        assert torch.equal(again.remap, port.remap)


def _case_wants_the_card(tmp_path):
    """Without device= the undistorter resolves to CUDA and raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        corvis_undistorter()
    with pytest.raises(RuntimeError, match="CUDA"):
        Undistorter(AtanModel(0.5, 0.5, 0.5, 0.5, 0.0, 8, 8))


UNDISTORT_CASES = [_case_corvis_K_and_table, _case_full_mode,
                   _case_crop_small_and_no_mode, _case_zero_distortion,
                   _case_radtan_table, _case_undistort_frames]
UNDISTORT_FILE_CASES = [_case_file_sniffing, _case_convert_round_trip,
                        _case_wants_the_card]


@pytest.mark.parametrize("case", UNDISTORT_CASES,
                         ids=[c.__name__[6:] for c in UNDISTORT_CASES])
def test_undistorter(case):
    case()


@pytest.mark.parametrize("case", UNDISTORT_FILE_CASES,
                         ids=[c.__name__[6:] for c in UNDISTORT_FILE_CASES])
def test_undistorter_files(case, tmp_path):
    case(tmp_path)
