"""The remap kernel's per-tile choice on the CPU, through its plain twin
`visma_tpu_torch.image.remap.remap_footprint_plain`: each output tile's
source box and whether the kernel stages that box in shared memory or
gathers from device memory (csrc/bilinear_remap.cu). The kernel's own
branches are held against this twin on the card (tests/test_torch_kernels.py).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from visma_tpu_torch.image import remap as trm
from visma_tpu_torch.image.undistort import corvis_undistorter


@pytest.fixture(scope="module")
def corvis():
    return corvis_undistorter(device="cpu").remap


def _box_dims(boxes):
    return boxes[..., 3] - boxes[..., 1] + 1, boxes[..., 2] - boxes[..., 0] + 1


@pytest.mark.parametrize("dtype,C", [(torch.uint8, 1), (torch.uint8, 3),
                                     (torch.float32, 1)])
def test_corvis_slice_is_staged(corvis, dtype, C):
    """The ingest path's table (rows 50-549): every tile of a batch staged,
    every tile of a single frame gathered directly; at the 32x64 tile the
    boxes reach 36 rows and 75 columns, the footprint measured for the
    design."""
    tile, budget = trm.remap_tiling(dtype, C)
    assert tile == (32, 64)
    for frames, want in ((240, trm.STAGED), (1, trm.DIRECT)):
        boxes, branches = trm.remap_footprint_plain(
            corvis[50:550], 600, 960, tile, budget, C=C,
            itemsize=1 if dtype == torch.uint8 else 4, frames=frames)
        assert tuple(branches.shape) == (16, 15)
        assert bool((branches == want).all())
    rows, cols = _box_dims(boxes)
    assert (int(rows.max()), int(cols.max())) == (36, 75)
    assert int(rows.min()) > 1 and int(cols.min()) > 1


def _smooth(oh, ow, H, W, a, b, k, shift):
    y, x = np.mgrid[0:oh, 0:ow].astype(np.float64)
    u = (x - ow / 2) * a[0] + b[0] * (y - oh / 2)
    v = (y - oh / 2) * a[1] + b[1] * (x - ow / 2)
    r2 = u * u + v * v
    return np.stack([u * (1 + k * r2) + W / 2 + shift[0],
                     v * (1 + k * r2) + H / 2 + shift[1]],
                    -1).astype(np.float32)


@settings(max_examples=40, deadline=None)
@given(oh=st.integers(1, 90), ow=st.integers(1, 150),
       H=st.integers(2, 120), W=st.integers(2, 160),
       a=st.tuples(st.floats(0.5, 2.0), st.floats(0.5, 2.0)),
       b=st.tuples(st.floats(-0.2, 0.2), st.floats(-0.2, 0.2)),
       k=st.floats(-1e-4, 1e-4), shift=st.tuples(st.floats(-40, 40),
                                                 st.floats(-40, 40)),
       invalid_row=st.integers(-1, 89), nan_at=st.integers(-1, 500),
       dtype=st.sampled_from([torch.uint8, torch.float32]),
       C=st.integers(1, 4))
def test_valid_taps_lie_in_their_tile_box(oh, ow, H, W, a, b, k, shift,
                                          invalid_row, nan_at, dtype, C):
    """For smooth warps (affine plus radial, some with an invalid row and a
    NaN entry, some reaching outside the frame), every clamped tap of every
    valid entry lies in its tile's box, and a tile without a valid entry
    has the empty box."""
    table = _smooth(oh, ow, H, W, a, b, k, shift)
    if 0 <= invalid_row < oh:
        table[invalid_row, :, 0] = -1.0
    if 0 <= nan_at < oh * ow:
        table.reshape(-1, 2)[nan_at] = np.nan
    tile, budget = trm.remap_tiling(dtype, C)
    boxes, branches = trm.remap_footprint_plain(
        torch.as_tensor(table), H, W, tile, budget, C=C,
        itemsize=1 if dtype == torch.uint8 else 4)
    x0f, y0f, valid, _, _ = trm._taps(torch.as_tensor(table), H, W)
    th, tw = tile
    ty, tx = np.mgrid[0:oh, 0:ow]
    box = boxes.numpy()[ty // th, tx // tw]
    x0, y0, v = x0f.numpy(), y0f.numpy(), valid.numpy()
    assert (x0[v] >= box[v, 0]).all() and (x0[v] + 1 <= box[v, 2]).all()
    assert (y0[v] >= box[v, 1]).all() and (y0[v] + 1 <= box[v, 3]).all()
    assert ((x0[v] + 1 < W) & (y0[v] + 1 < H)).all()
    empty = ~np.add.reduceat(np.add.reduceat(
        v.astype(int), np.arange(0, oh, th), 0), np.arange(0, ow, tw), 1
    ).astype(bool)
    assert (boxes.numpy()[empty] == [0, 0, -1, -1]).all()
    assert set(branches.unique().tolist()) <= {trm.STAGED, trm.DIRECT}


@pytest.mark.parametrize("shape,table_shape,dtype,aligned,branch", [
    ((600, 960), (37, 53), torch.float32, True, trm.DIRECT),   # tests' table
    ((600, 960), (96, 128), torch.float32, True, trm.DIRECT),  # chip_smoke's
    ((5, 131, 77), (64, 40), torch.uint8, True, trm.DIRECT),   # 77-byte rows
    ((3, 131, 77), (37, 53), torch.float32, True, trm.DIRECT),  # 308-byte rows
    ((2, 50, 60, 3), (37, 53), torch.float32, True, trm.STAGED),  # fits
    ((2, 50, 60, 3), (37, 53), torch.float32, False, trm.DIRECT),
    ((2, 40, 64), (37, 53), torch.uint8, False, trm.DIRECT),
])
def test_random_tables_branch(shape, table_shape, dtype, aligned, branch):
    """The tests' random tables (with an invalid row and a NaN entry), in a
    batch: the box of a tile is the whole frame, so a 600x960 frame and an
    unaligned row pitch go direct; a frame small enough to fit a stage is
    staged, unless the image's base is not 16-byte aligned."""
    rng = np.random.default_rng(0)
    chan = len(shape) == 4
    H, W = shape[-3:-1] if chan else shape[-2:]
    C = shape[-1] if chan else 1
    oh, ow = table_shape
    t = np.stack([rng.uniform(1, W - 2, (oh, ow)),
                  rng.uniform(1, H - 2, (oh, ow))], -1).astype(np.float32)
    t[3, :, 0] = -1.0
    t[5, 7] = np.nan
    tile, budget = trm.remap_tiling(dtype, C)
    _, branches = trm.remap_footprint_plain(
        torch.as_tensor(t), H, W, tile, budget, C=C,
        itemsize=1 if dtype == torch.uint8 else 4, aligned=aligned, frames=2)
    assert bool((branches == branch).all())


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_tile_without_valid_entry_is_staged_empty(dtype):
    """A tile whose entries are all invalid (sx < 0 or NaN) has the empty
    box, nothing to copy, and is staged; its neighbour with valid entries
    keeps its own box."""
    t = np.zeros((32, 128, 2), np.float32)
    t[:, :64, 0] = -1.0
    t[:16, :64] = np.nan
    t[:, 64:, 0] = 5.5
    t[:, 64:, 1] = 7.25
    tile, budget = trm.remap_tiling(dtype, 1)
    boxes, branches = trm.remap_footprint_plain(
        torch.as_tensor(t), 20, 32, tile, budget,
        itemsize=1 if dtype == torch.uint8 else 4)
    assert boxes.tolist() == [[[0, 0, -1, -1], [5, 7, 6, 8]]]
    assert branches.tolist() == [[trm.STAGED, trm.STAGED]]


def test_cpu_wrapper_takes_plain_and_refuses_branches(corvis):
    """On a CPU tensor the wrapper is the plain version and counts no
    launch; the kernel's branches exist only on the card (their CPU twin
    is remap_footprint_plain), so asking for them on the CPU raises."""
    rng = np.random.default_rng(1)
    img = torch.as_tensor(rng.integers(0, 256, (2, 600, 960),
                                       dtype=np.uint8))
    table = corvis[50:550]
    n0 = trm.bilinear_remap.launches
    assert torch.equal(trm.bilinear_remap(img, table),
                       trm.bilinear_remap_plain(img, table))
    assert trm.bilinear_remap.launches == n0
    with pytest.raises(ValueError, match="remap_footprint_plain"):
        trm.bilinear_remap(img, table, return_branches=True)


def test_u8_rounding_identity():
    """The kernel's uint8 store: the low byte of (clip(v, 0, 255) + 2^23)
    in float32 round-to-nearest-even equals clip(rint(v), 0, 255), ties
    and NaN included, and the 2^23 trick reads every byte exactly."""
    v = np.concatenate([np.arange(-2.0, 258.0, 0.25),
                        np.arange(-2.0, 258.0) + 0.5,
                        np.random.default_rng(2).uniform(-1e3, 1e3, 10000),
                        [np.nan, np.inf, -np.inf, -0.0]]).astype(np.float32)
    with np.errstate(invalid="ignore"):
        c = np.fmin(np.fmax(v, np.float32(0)), np.float32(255))
        want = np.clip(np.nan_to_num(np.rint(v), nan=0.0), 0, 255)
    got = ((c + np.float32(8388608.0)).view(np.uint32) & 0xFF)
    np.testing.assert_array_equal(got, want.astype(np.uint32))
    b = np.arange(256, dtype=np.uint32)
    back = (b | np.uint32(0x4B000000)).view(np.float32) - np.float32(8388608)
    np.testing.assert_array_equal(back, b.astype(np.float32))
