"""The raster kernels' coarse test, through its plain version on the CPU.

`subtile_cull_plain` is what stage 1 of csrc/chunk_raster.cu computes: per
(pose, subtile, chunk, triangle), whether the triangle can touch the
subtile. The cull must be exact: no pixel that the plain per-pixel test
accepts may belong to a culled triangle, so the image over the survivors
is the image over all triangles, bit for bit. Small sizes: meshes of
300-320 faces, windows of 48x64 and a ragged 45x70, 4 poses.

The port's triangle-major (B, nc, 128, 12) table is also held against the
reference's lane-major (B, nc, 16, 128) table, transposed: 1e-4 relative
plus 1e-5 absolute (float32 products summed in another order) on the
triangles where float32 can promise it, and a float64 table within a bound
derived from each triangle's conditioning on the rest
(test_torch_render.py's `assert_planes_match`), with the same coverage and
the hitting chunks of every subtile equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from hypothesis.extra import numpy as hnp

from visma_tpu.render import camera as JC, raster as JR
from visma_tpu_torch.render import camera as TC, raster as TR

from test_torch_render import assert_planes_match, mesh_db, poses

KW = dict(fx=100.0, fy=110.0, cx=63.5, cy=47.5, z_near=0.05, z_far=8.0)
ORG = np.array([[30, 20], [40, 30], [0, 0], [64, 40]], np.float32)
MESH = np.array([0, 1, 1, 0])


def intrinsics(rows, cols, cls=TC.Intrinsics):
    return cls(rows=rows, cols=cols, **KW)


@pytest.fixture(scope="module")
def renderer():
    r = TR.MultiMeshRenderer(intrinsics(96, 128), device="cpu")
    r.set_meshes(mesh_db())
    return r


def window_tables(renderer, roi, sub_px, seed=1):
    """Kernel inputs of 4 poses rendered into `roi` windows."""
    intr = intrinsics(*roi)
    return TR._prep_chunks_all(
        renderer.Cs[torch.as_tensor(MESH)], torch.as_tensor(poses(4, seed)),
        intr, origins=torch.as_tensor(ORG), sub_px=sub_px), intr


def pixel_test(planes, intr):
    """The plain per-pixel test on every (pixel, triangle) pair, with
    chunk_raster_plain's own expression: accepted (B, H*W, T) bool and the
    inverse depth (B, H*W, T)."""
    B = planes.shape[0]
    H, W = intr.rows, intr.cols
    p = planes.reshape(B, 1, -1, 12)
    px = torch.arange(W, dtype=torch.float32).repeat(H)[None, :, None]
    py = torch.arange(H, dtype=torch.float32).repeat_interleave(W)[
        None, :, None]

    def plane(k):
        return px * p[..., 3 * k] + py * p[..., 3 * k + 1] + p[..., 3 * k + 2]

    iz = plane(3)
    ok = ((plane(0) >= 0) & (plane(1) >= 0) & (plane(2) >= 0)
          & (iz > 1.0 / intr.z_far) & (iz < 1.0 / intr.z_near))
    return ok, iz


def survivors_per_pixel(planes, intr, sub_px):
    """subtile_cull_plain, gathered to (B, H*W, T): whether the triangle
    survived the cull of the subtile the pixel lies in. sub_px: the edge of
    square subtiles, or (rows, cols) of rectangular ones."""
    B = planes.shape[0]
    H, W = intr.rows, intr.cols
    sy, sx = (sub_px, sub_px) if isinstance(sub_px, int) else sub_px
    surv = TR.subtile_cull_plain(planes, intr, sub_px)
    nsy, nsx = -(-H // sy), -(-W // sx)
    assert surv.shape == (B, nsy * nsx, *planes.shape[1:3])
    st_of = ((torch.arange(H) // sy)[:, None] * nsx
             + (torch.arange(W) // sx)[None, :]).reshape(-1)
    return surv.reshape(B, nsy * nsx, -1)[:, st_of]


SHAPES = [((48, 64), 16), ((48, 64), 32), ((45, 70), 16), ((45, 70), 32)]
# the rectangles one warp owns inside a 16-px and a 32-px subtile
FOOTPRINTS = [TR.warp_footprint(16), TR.warp_footprint(32)]


@pytest.mark.parametrize("roi,sub_px", SHAPES)
def test_no_accepted_pixel_belongs_to_a_culled_triangle(renderer, roi,
                                                        sub_px):
    """Rendered poses, whole and ragged subtile grids: the cull drops no
    pair that the pixel test accepts, and it does drop most of the rest."""
    (planes, ids, counts), intr = window_tables(renderer, roi, sub_px)
    ok, _ = pixel_test(planes, intr)
    surv = survivors_per_pixel(planes, intr, sub_px)
    assert int(ok.sum()) > 1000
    assert not bool((ok & ~surv).any())
    share = float(surv.float().mean())
    assert 0.0 < share < 0.5, share


@pytest.mark.parametrize("roi", [(48, 64), (45, 70)])
@pytest.mark.parametrize("footprint", FOOTPRINTS)
def test_warp_footprint_cull_drops_no_accepted_pixel(renderer, roi,
                                                     footprint):
    """The same test on the rectangle a warp owns (4x8 px of a 16-px
    subtile, 8x16 of a 32-px one): exact as well, and finer."""
    assert FOOTPRINTS == [(4, 8), (8, 16)]
    (planes, _, _), intr = window_tables(renderer, roi, 16)
    ok, _ = pixel_test(planes, intr)
    fine = survivors_per_pixel(planes, intr, footprint)
    assert not bool((ok & ~fine).any())
    coarse = survivors_per_pixel(planes, intr, 4 * footprint[0])
    assert float(fine.float().mean()) < float(coarse.float().mean())


@pytest.mark.parametrize("roi,sub_px", SHAPES)
def test_raster_over_survivors_is_bit_equal(renderer, roi, sub_px):
    """chunk_raster_plain restricted to each subtile's survivors gives the
    image of chunk_raster_plain, bit for bit."""
    (planes, _, _), intr = window_tables(renderer, roi, sub_px, seed=2)
    ok, iz = pixel_test(planes, intr)
    surv = survivors_per_pixel(planes, intr, sub_px)
    best = torch.where(ok & surv, iz, torch.zeros_like(iz)).amax(-1)
    got = TR._inv_to_depth(best).reshape(-1, intr.rows, intr.cols)
    ref = TR.chunk_raster_plain(planes, intr)
    assert int(torch.isfinite(ref).sum()) > 500
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("roi,sub_px", SHAPES)
def test_kernel_schedule_is_bit_equal(renderer, roi, sub_px):
    """The kernels' schedule in full: per subtile, only the chunks on its
    list of hitting chunks, of those only the survivors of the subtile's
    cull, and of those only the survivors of the warp footprint's cull,
    against every pixel x every triangle. (The corner test is conservative, so survivors
    also occur in chunks that are not listed; the kernel never sees them.)"""
    (planes, ids, counts), intr = window_tables(renderer, roi, sub_px, seed=3)
    B, nc, chunk = planes.shape[:3]
    listed = torch.zeros((B, ids.shape[1], nc), dtype=torch.bool)
    listed.scatter_(2, ids.long(),
                    torch.arange(nc)[None, None] < counts[..., None])
    nsx = TR._subtile_grid(intr, sub_px)[1]
    st_of = ((torch.arange(intr.rows) // sub_px)[:, None] * nsx
             + (torch.arange(intr.cols) // sub_px)[None, :]).reshape(-1)
    listed_px = listed[:, st_of].repeat_interleave(chunk, dim=-1)
    ok, iz = pixel_test(planes, intr)
    surv = survivors_per_pixel(planes, intr, sub_px) \
        & survivors_per_pixel(planes, intr, TR.warp_footprint(sub_px))
    assert 0.0 < float((surv & listed_px).float().mean()) \
        < float(listed_px.float().mean())
    best = torch.where(ok & surv & listed_px, iz,
                       torch.zeros_like(iz)).amax(-1)
    got = TR._inv_to_depth(best).reshape(-1, intr.rows, intr.cols)
    np.testing.assert_array_equal(
        got.numpy(), TR.chunk_raster_plain(planes, intr).numpy())


SPECIAL = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-38, 1.0, -1.0, 0.5, -0.37,
                    15.0, -47.0, 63.0, 1e30, -1e30, 3e38, -3e38, np.inf,
                    -np.inf, np.nan, 0.2, 2.5], np.float32)


def assert_cull_exact(table, roi=(20, 37), sub_px=16, need_accepted=False):
    planes = torch.as_tensor(table).reshape(1, 1, -1, 12)
    intr = intrinsics(*roi)
    ok, _ = pixel_test(planes, intr)
    surv = survivors_per_pixel(planes, intr, sub_px) \
        & survivors_per_pixel(planes, intr, TR.warp_footprint(sub_px))
    lost = ok & ~surv
    assert not bool(lost.any()), table[np.nonzero(lost.any(1)[0].numpy())[0]]
    if need_accepted:
        assert int(ok.sum()) > 0


@given(hnp.arrays(np.float32, (6, 12), elements=st.one_of(
    st.floats(width=32, allow_nan=True, allow_infinity=True),
    st.sampled_from(SPECIAL.tolist()))))
@settings(max_examples=150, deadline=None, derandomize=True)
def test_cull_is_exact_on_any_coefficients(table):
    """Any float32 coefficients: huge, denormal, -0.0, infinite, NaN."""
    assert_cull_exact(table)


@given(hnp.arrays(np.float32, (6, 4, 3), elements=st.floats(
    -1.0, 1.0, width=32)), st.floats(0.5, 60.0))
@settings(max_examples=100, deadline=None, derandomize=True)
def test_cull_is_exact_on_moderate_planes(abc, spread):
    """Planes of the size the setup makes (slopes up to 1 a pixel, offsets
    up to `spread`), where many pixels are accepted and many planes change
    sign inside a subtile."""
    table = abc.copy()
    table[:, :, 2] *= spread
    table[:, 3, :] = np.abs(table[:, 3, :]) * 0.01 + 0.2   # 1/z in range
    assert_cull_exact(table.reshape(6, 12))


def test_cull_on_a_table_of_special_values():
    """4,000 triangles drawn from a list of special values; the draw has
    accepted pairs, so the property is not vacuous."""
    rng = np.random.default_rng(0)
    table = SPECIAL[rng.integers(0, len(SPECIAL), (4000, 12))]
    table[::2, 9:] = [0.0, 0.0, 0.5]            # half with 1/z in range
    assert_cull_exact(table, need_accepted=True)


def test_dead_nan_huge_and_clipped_triangles():
    """The dead-triangle plane and a NaN triangle are culled everywhere; a
    triangle larger than the window survives in every subtile; near and far
    clipping inside the window culls the subtiles wholly beyond the clip."""
    intr = intrinsics(48, 64)
    dead = [0, 0, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0]
    nan = [0, 0, 1, 0, 0, 1, 0, 0, 1, np.nan, 0, 0.5]
    huge = [0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 0.5]
    # 1/z = 0.02 + 0.5 x: beyond far (1/8) left of x = 0.21, nearer than
    # near (1/0.05 = 20) right of x = 39.96
    ramp = [0, 0, 1, 0, 0, 1, 0, 0, 1, 0.5, 0, 0.02]
    planes = torch.tensor([dead, nan, huge, ramp],
                          dtype=torch.float32).reshape(1, 1, 4, 12)
    surv = TR.subtile_cull_plain(planes, intr, 16)[0, :, 0]   # (nsub, 4)
    assert not bool(surv[:, 0].any()) and not bool(surv[:, 1].any())
    assert bool(surv[:, 2].all())
    cols = surv[:, 3].reshape(3, 4)
    assert cols[:, :3].all() and not cols[:, 3].any()   # x >= 48: too near
    ok, _ = pixel_test(planes, intr)
    assert not bool(ok[0, :, :2].any()) and bool(ok[0, :, 2].all())
    assert not bool((ok & ~survivors_per_pixel(planes, intr, 16)).any())


def test_empty_window_has_no_survivors(renderer):
    """A window the object does not reach: no hitting chunk, no survivor,
    an image of +inf."""
    intr = intrinsics(48, 64)
    pose = torch.as_tensor(poses(1, 1))
    far_off = torch.tensor([[2000.0, 1500.0]])
    planes, ids, counts = TR._prep_chunks_all(
        renderer.Cs[:1], pose, intr, origins=far_off, sub_px=16)
    assert int(counts.sum()) == 0
    assert not bool(TR.subtile_cull_plain(planes, intr, 16).any())
    assert bool(torch.isinf(TR.chunk_raster_batched(planes, ids, counts,
                                                    intr)).all())


def test_pack_chunks_makes_no_copy():
    """With a whole number of chunks the packed table is the triangle
    setup's own memory, reshaped."""
    rng = np.random.default_rng(5)
    intr = intrinsics(48, 64)
    C = torch.as_tensor(rng.uniform(-0.5, 0.5, (3, 256, 3, 3))
                        .astype(np.float32))
    pose = torch.as_tensor(poses(3, 6))
    tri, _, x0, x1, y0, y1 = TR._planes_batched(C, pose, intr)
    planes, ids, counts = TR._pack_chunks(tri, x0, x1, y0, y1, intr, 128, 16)
    assert planes.shape == (3, 2, 128, 12) and planes.is_contiguous()
    assert planes.data_ptr() == tri.data_ptr()
    assert ids.dtype == torch.int32 and counts.dtype == torch.int32


@pytest.mark.parametrize("sub_px", [16, 32])
def test_table_equals_reference_transposed(renderer, sub_px):
    """The port's (B, nc, 128, 12) table against the reference's
    `_prep_chunks_all` table, transposed (`assert_planes_match`: 1e-4
    relative where float32 can promise it, the float64 table elsewhere,
    the same coverage); counts equal and the same hitting chunks per
    subtile."""
    roi = (48, 64)
    (tpl, tids, tcnt), ti = window_tables(renderer, roi, sub_px)
    jr = JR.MultiMeshRenderer(intrinsics(96, 128, JC.Intrinsics),
                              use_pallas=False)
    jr.set_meshes(mesh_db())
    jpl, jids, jcnt = JR._prep_chunks_all(
        jr.Cs[jnp.asarray(MESH)], jnp.asarray(poses(4, 1)),
        intrinsics(*roi, JC.Intrinsics), 32, 128, origins=jnp.asarray(ORG),
        sub_px=sub_px)
    jpl, jids, jcnt = np.asarray(jpl), np.asarray(jids), np.asarray(jcnt)
    assert_planes_match(tpl, jpl, renderer.Cs[torch.as_tensor(MESH)],
                        poses(4, 1), ti, ORG)
    # the reference bins over a grid padded to (32, 128)-px blocks; the
    # port's grid is its top-left part
    nsy, nsx = TR._subtile_grid(ti, sub_px)
    jsx = -(-ti.cols // 128) * (128 // sub_px)
    jgrid = np.arange(jcnt.shape[1]).reshape(-1, jsx)[:nsy, :nsx].reshape(-1)
    np.testing.assert_array_equal(tcnt.numpy(), jcnt[:, jgrid])
    assert int(tcnt.sum()) > 0
    for b in range(tpl.shape[0]):
        for s in range(nsy * nsx):
            n = int(tcnt[b, s])
            assert set(tids[b, s, :n].tolist()) \
                == set(jids[b, :n, jgrid[s]].tolist())


# ---------------------------------------------------------------------------
# triangle_setup: the setup's wrapper; on the CPU its plain twin
# ---------------------------------------------------------------------------

def setup_args(renderer, B=4):
    return (renderer.Cs, torch.as_tensor(MESH[:B]),
            torch.as_tensor(poses(B, 1)), torch.as_tensor(ORG[:B]))


def _bad_setup_args(renderer, case):
    Cs, mi, p, org = setup_args(renderer)
    if case == "device":
        p = p.to("meta")
    elif case == "stack_dtype":
        Cs = Cs.double()
    elif case == "pose_dtype":
        p = p.double()
    elif case == "origin_dtype":
        org = org.long()
    elif case == "index_dtype":
        mi = mi.to(torch.int16)
    elif case == "stack_shape":
        Cs = Cs.reshape(Cs.shape[0], -1, 9)
    elif case == "pose_shape":
        p = torch.cat([p, p[:, :1]], dim=1)            # (B,4,4) rows
    elif case == "index_shape":
        mi = mi[:3]
    elif case == "origin_shape":
        org = org[:, :1]
    elif case == "stack_contiguity":
        Cs = Cs.transpose(2, 3)
    return Cs, mi, p, org


@pytest.mark.parametrize("case", [
    "device", "stack_dtype", "pose_dtype", "origin_dtype", "index_dtype",
    "stack_shape", "pose_shape", "index_shape", "origin_shape",
    "stack_contiguity"])
def test_triangle_setup_refuses_bad_arguments(renderer, case):
    """Wrong device, dtype, shape or contiguity raises on either path, before
    any work (a CUDA tensor would hand the kernel raw pointers)."""
    Cs, mi, p, org = _bad_setup_args(renderer, case)
    with pytest.raises(ValueError):
        TR.triangle_setup(Cs, mi, p, intrinsics(48, 64), origins=org,
                          sub_px=16)


def test_triangle_setup_plain_path_is_prep_chunks_all(renderer):
    """On the CPU the wrapper is `_prep_chunks_all` on the gathered corners
    (an int32 index too), and mesh_idx None renders mesh 0 at every pose."""
    Cs, mi, p, org = setup_args(renderer)
    intr = intrinsics(48, 64)
    got = TR.triangle_setup(Cs, mi.to(torch.int32), p, intr, origins=org,
                            sub_px=16)
    ref = TR._prep_chunks_all(Cs[mi], p, intr, origins=org, sub_px=16)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    got = TR.triangle_setup(Cs[:1], None, p, intr, sub_px=32)
    ref = TR._prep_chunks_all(Cs[:1].expand(4, -1, -1, -1), p, intr,
                              sub_px=32)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_pack_chunks_id_order_is_pinned():
    """Four chunks with hand-made bboxes on a 2x3 grid of 16-px subtiles:
    each list holds the hitting chunks ascending, then the rest ascending,
    the order the kernel writes."""
    intr = intrinsics(32, 48)
    chunk = 2
    # chunk bboxes (x0, x1, y0, y1): 0 in subtile (0, 2) only, 1 over the
    # whole window, 2 dead, 3 over subtiles (0..1, 0..1)
    boxes = [(40.0, 44.0, 2.0, 9.0), (-5.0, 60.0, -5.0, 40.0),
             (1e9, -1e9, 1e9, -1e9), (3.0, 20.0, 15.0, 16.0)]
    x0, x1, y0, y1 = (torch.tensor([[b[k] for b in boxes for _ in range(chunk)]])
                      for k in range(4))
    tri = torch.zeros((1, 4 * chunk, 12))
    _, ids, counts = TR._pack_chunks(tri, x0, x1, y0, y1, intr, chunk, 16)
    assert counts.tolist() == [[2, 2, 2, 2, 2, 1]]
    assert ids[0].tolist() == [[1, 3, 0, 2], [1, 3, 0, 2], [0, 1, 2, 3],
                               [1, 3, 0, 2], [1, 3, 0, 2], [1, 0, 2, 3]]


@pytest.mark.parametrize("sub_px", [16, 32])
def test_triangle_setup_lists_against_a_loop(renderer, sub_px):
    """The setup's lists on rendered poses against a loop over the chunk
    bboxes with `_pack_chunks`' comparisons: per subtile the hitting chunk
    ids ascending, then the rest ascending, and the count."""
    Cs, mi, p, org = setup_args(renderer)
    intr = intrinsics(45, 70)
    _, ids, counts = TR.triangle_setup(Cs, mi, p, intr, origins=org,
                                       sub_px=sub_px)
    _, _, x0, x1, y0, y1 = TR._planes_batched(Cs[mi], p, intr, origins=org)
    B, nc = ids.shape[0], ids.shape[2]
    pad = nc * 128 - x0.shape[1]

    def chunks(a, value, reduce):
        a = torch.nn.functional.pad(a, (0, pad), value=value)
        return reduce(a.reshape(B, nc, 128), -1).values

    cx0, cx1 = chunks(x0, 1e9, torch.min), chunks(x1, -1e9, torch.max)
    cy0, cy1 = chunks(y0, 1e9, torch.min), chunks(y1, -1e9, torch.max)
    nsy, nsx = TR._subtile_grid(intr, sub_px)
    assert int(counts.sum()) > 0 and int((counts == 0).sum()) > 0
    for b in range(B):
        for s in range(nsy * nsx):
            tx, ty = (s % nsx) * sub_px, (s // nsx) * sub_px
            hit = [c for c in range(nc)
                   if cx0[b, c] <= tx + sub_px - 1 and cx1[b, c] >= tx
                   and cy0[b, c] <= ty + sub_px - 1 and cy1[b, c] >= ty]
            rest = [c for c in range(nc) if c not in hit]
            assert ids[b, s].tolist() == hit + rest
            assert int(counts[b, s]) == len(hit)
