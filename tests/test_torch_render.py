"""The port's rasterizer and depth-edge stencil against the JAX reference
on the CPU. The same seeded numpy inputs go through both; the reference's
Pallas kernels run in interpret mode, the port's wrappers take their plain
versions (the tensors lie on the CPU).

Tolerances, as tests/test_render.py holds the reference to its oracle:
coverage masks equal on >= 99.9 % of pixels and depth within 1e-3 m where
both cover. Plane tables agree to 1e-4 relative (float32 products summed
in another order) on the triangles where float32 can promise that, and to
a float64 table within a bound derived from each triangle's conditioning
on the rest (`assert_planes_match`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visma_tpu.image import edges as JE
from visma_tpu.render import camera as JC, raster as JR
from visma_tpu_torch.image import edges as TE
from visma_tpu_torch.io.procedural import box_mesh, cylinder_mesh, merge_meshes
from visma_tpu_torch.render import camera as TC, raster as TR

KW = dict(fx=100.0, fy=110.0, cx=63.5, cy=47.5, rows=96, cols=128,
          z_near=0.05, z_far=8.0)
TI, JI = TC.Intrinsics(**KW), JC.Intrinsics(**KW)
ROI = (32, 64)


def icosphere(subdiv=2, r=0.5):
    """Icosphere of 20 * 4^subdiv faces."""
    t = (1 + 5 ** 0.5) / 2
    V = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float32)
    F = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int32)
    for _ in range(subdiv):
        newF, mid, verts = [], {}, V.tolist()

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                verts.append(((np.asarray(verts[a]) + np.asarray(verts[b]))
                              / 2).tolist())
                mid[key] = len(verts) - 1
            return mid[key]

        for a, b, c in F.tolist():
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            newF += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        V, F = np.asarray(verts, np.float32), np.asarray(newF, np.int32)
    return V / np.linalg.norm(V, axis=1, keepdims=True) * r, F


def mesh_db():
    """A 320-face sphere and a 300-face table (box on a cylinder)."""
    table = merge_meshes([box_mesh(0.9, 0.08, 0.5, subdiv=4,
                                   center=(0.0, 0.3, 0.0)),
                          cylinder_mesh(0.06, 0.6, segments=12, stacks=3)])
    return {"ball": icosphere(2, 0.4), "table": table}


def poses(n, seed):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    out = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        out[i, :, :3] = Rotation.from_euler(
            "yx", [rng.uniform(-3, 3), rng.uniform(-0.3, 0.3)]).as_matrix()
        out[i, :, 3] = [rng.uniform(-0.4, 0.4), rng.uniform(-0.2, 0.2),
                        rng.uniform(1.6, 2.6)]
    return out


@pytest.fixture(scope="module")
def stack():
    db = mesh_db()
    tr = TR.MultiMeshRenderer(TI, device="cpu")
    tr.set_meshes(db)
    jr = JR.MultiMeshRenderer(JI, use_pallas=False)
    jr.set_meshes(db)
    return db, tr, jr


def assert_depth_close(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    fg, fr = np.isfinite(got), np.isfinite(ref)
    assert (fg == fr).mean() >= 0.999, what
    both = fg & fr
    assert both.sum() > 200, what
    np.testing.assert_allclose(got[both], ref[both], atol=1e-3, err_msg=what)


# the float32 roundings that carry a corner coordinate's error, in ulps
PLANE_ULPS = 2


def _planes64(u, v, z, z_near, z_far):
    """The triangle setup of render/raster.py's module comment in float64:
    corners (..., T, 3) -> planes (..., T, 12), live triangles (..., T)."""
    x0, y0, z0 = u[..., 0], v[..., 0], z[..., 0]
    x1, y1, z1 = u[..., 1], v[..., 1], z[..., 1]
    x2, y2, z2 = u[..., 2], v[..., 2], z[..., 2]
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    zmin = torch.minimum(torch.minimum(z0, z1), z2)
    ok = (zmin > z_near) & (zmin < z_far) & (area.abs() > 1e-12)
    inv = torch.where(ok, 1.0 / torch.where(ok, area, torch.ones_like(area)),
                      torch.zeros_like(area))

    def edge(xa, ya, xb, yb):
        return (-(yb - ya) * inv, (xb - xa) * inv,
                ((yb - ya) * xa - (xb - xa) * ya) * inv)

    e = [edge(x1, y1, x2, y2), edge(x2, y2, x0, y0), edge(x0, y0, x1, y1)]
    iz = [torch.where(ok, 1.0 / zz.clamp(min=1e-9), torch.zeros_like(zz))
          for zz in (z0, z1, z2)]
    zp = [sum(e[k][j] * iz[k] for k in range(3)) for j in range(3)]
    c0 = torch.where(ok, e[0][2], -torch.ones_like(area))
    return torch.stack([e[0][0], e[0][1], c0, *e[1], *e[2], *zp], -1), ok


def planes_oracle(C, poses, intr, origins=None):
    """The float64 plane table (B, T, 12) of face corners C (B, T, 3, 3)
    under poses (B, 3, 4), its live triangles (B, T), and the float32
    error a coefficient can carry (B, T, 12).

    The bound is first order. float32 rounds each projected corner
    coordinate w (u, v, z of three corners) with an error of at most
    PLANE_ULPS ulps of the terms it sums: for z, |R_2j C_j| summed with
    |t_2| (the einsum: products, two sums, the translation); for u,
    fx / |z| times the same sum for x, plus |u - cx| times the sum for z
    over |z| (the division), plus |cx| and the window origin; v likewise.
    A coefficient's error is then at most PLANE_ULPS ulps of the sum over
    the nine w of |d coefficient / d w| times that magnitude, plus its own
    magnitude for its last rounding. The cancelling terms of c,
    (yb - ya) xa - (xb - xa) ya, and of the area, scaled by 1/area, enter
    through the derivatives: on a sliver triangle they are large."""
    C = torch.as_tensor(np.asarray(C), dtype=torch.float64)
    P = torch.as_tensor(np.asarray(poses), dtype=torch.float64)
    R, t = P[:, :, :3], P[:, :, 3]
    Vc = torch.einsum("bij,btkj->btki", R, C) + t[:, None, None, :]
    A = torch.einsum("bij,btkj->btki", R.abs(), C.abs()) \
        + t.abs()[:, None, None, :]
    z = Vc[..., 2]
    o = (torch.zeros((C.shape[0], 2), dtype=torch.float64) if origins is None
         else torch.as_tensor(np.asarray(origins), dtype=torch.float64))
    u = intr.fx * Vc[..., 0] / z + intr.cx - o[:, 0, None, None]
    v = intr.fy * Vc[..., 1] / z + intr.cy - o[:, 1, None, None]
    corners = (u, v, z)
    scale = (
        abs(intr.fx) * (A[..., 0] + (Vc[..., 0] / z).abs() * A[..., 2])
        / z.abs() + abs(intr.cx) + o[:, 0, None, None].abs(),
        abs(intr.fy) * (A[..., 1] + (Vc[..., 1] / z).abs() * A[..., 2])
        / z.abs() + abs(intr.cy) + o[:, 1, None, None].abs(),
        A[..., 2])

    def planes_of(*uvz):
        return _planes64(*uvz, intr.z_near, intr.z_far)[0]

    planes, ok = _planes64(u, v, z, intr.z_near, intr.z_far)
    spread = planes.abs()
    for w in range(3):
        for k in range(3):
            tangent = [torch.zeros_like(c) for c in corners]
            tangent[w][..., k] = scale[w][..., k]
            spread = spread + torch.func.jvp(planes_of, corners,
                                             tuple(tangent))[1].abs()
    eps = float(np.finfo(np.float32).eps)
    return planes.numpy(), ok.numpy(), PLANE_ULPS * eps * spread.numpy()


def assert_planes_match(tpl, jpl, C, poses, intr, origins=None):
    """The port's plane table tpl (B, nc, 128, 12) against the reference's
    jpl (B, nc, 16, 128) of the same corners C (B, T, 3, 3), poses and
    window origins.

    Where the float32 bound of `planes_oracle` lies within 1e-4 relative +
    1e-5 absolute of every coefficient of a triangle, the two tables are
    held to each other at that tolerance. Elsewhere (sliver triangles:
    1/area scales rounding that cancels in c) each table is held to the
    float64 table within that bound: the port's einsum sums its products in
    order, the reference's XLA may fuse them, and a corner one ulp apart
    moves such a triangle's coefficients by up to 1.8e-4 relative. The
    depth images both tables give through the plain pixel test cover the
    same pixels."""
    B, nc = tpl.shape[:2]
    T = np.asarray(C).shape[1]
    got = tpl.numpy().reshape(B, -1, 12)
    ref = np.ascontiguousarray(
        jpl[:, :, :12].transpose(0, 1, 3, 2)).reshape(B, -1, 12)
    p64, ok, bound = planes_oracle(C, poses, intr, origins)
    assert ok.any()
    tight = 1e-4 * np.abs(ref) + 1e-5
    well = np.ones(got.shape[:2], bool)      # the padding: fail planes
    well[:, :T] = (bound <= tight[:, :T]).all(-1)
    np.testing.assert_allclose(got[well], ref[well], rtol=1e-4, atol=1e-5)
    ill = ~well[:, :T]
    for side in (got, ref):
        assert (np.abs(side[:, :T] - p64) <= bound)[ill].all()
    cover = [np.isfinite(TR.chunk_raster_plain(
        torch.as_tensor(x.reshape(B, nc, 128, 12)), intr).numpy())
        for x in (got, ref)]
    np.testing.assert_array_equal(cover[0], cover[1])
    assert cover[0].any()


def test_mesh_stack_equals_reference(stack):
    db, tr, jr = stack
    np.testing.assert_array_equal(tr.Vs.numpy(), np.asarray(jr.Vs))
    np.testing.assert_array_equal(tr.Fs.numpy(), np.asarray(jr.Fs))
    np.testing.assert_array_equal(tr.Cs.numpy(), np.asarray(jr.Cs))
    V, F = db["table"]
    np.testing.assert_array_equal(TR.sort_faces_morton(V, F),
                                  JR.sort_faces_morton(V, F))
    assert tr.names == jr.names and tr.index("table") == 1


@pytest.mark.parametrize("sub_px,roi", [(32, None), (16, ROI)])
def test_prep_chunks_planes_and_hits(stack, sub_px, roi):
    """Plane tables to 1e-4 relative (plus 1e-5 absolute) where float32
    can promise it, to the float64 table within its bound elsewhere
    (`assert_planes_match`), the same coverage, and the per-subtile sets of
    hitting chunks equal."""
    _, tr, jr = stack
    p = poses(5, 1)
    mi = np.array([0, 1, 1, 0, 1])
    org = None if roi is None else np.array(
        [[10, 20], [40, 30], [0, 0], [64, 64], [30, 10]], np.float32)
    ti = TI if roi is None else TR._roi_intr(TI, roi)
    ji = JI if roi is None else JR._roi_intr(JI, roi)
    tpl, tids, tcnt = TR._prep_chunks_all(
        tr.Cs[torch.as_tensor(mi)], torch.as_tensor(p), ti,
        origins=None if org is None else torch.as_tensor(org), sub_px=sub_px)
    jpl, jids, jcnt = JR._prep_chunks_all(
        jr.Cs[jnp.asarray(mi)], jnp.asarray(p), ji, 32, 128,
        origins=None if org is None else jnp.asarray(org), sub_px=sub_px)
    jpl, jids, jcnt = np.asarray(jpl), np.asarray(jids), np.asarray(jcnt)
    B, nc = tpl.shape[:2]
    # the port's table is triangle-major: transpose the reference's
    assert tpl.shape == (B, nc, 128, 12) and jpl.shape == (B, nc, 16, 128)
    assert_planes_match(tpl, jpl, tr.Cs[torch.as_tensor(mi)], p, ti, org)
    # the reference bins over a grid padded to (32, 128)-px blocks; the
    # port's grid is its top-left part
    nsy, nsx = TR._subtile_grid(ti, sub_px)
    jsx = -(-ti.cols // 128) * (128 // sub_px)
    jgrid = np.arange(jcnt.shape[1]).reshape(-1, jsx)[:nsy, :nsx].reshape(-1)
    np.testing.assert_array_equal(tcnt.numpy(), jcnt[:, jgrid])
    assert int(tcnt.sum()) > 0
    for b in range(B):
        for st in range(nsy * nsx):
            n = int(tcnt[b, st])
            assert set(tids[b, st, :n].tolist()) \
                == set(jids[b, :n, jgrid[st]].tolist())


def test_project_and_triangle_planes_match(stack):
    """One pose through _project + _triangle_planes: screen coordinates to
    1e-4 px, planes to 1e-4 relative, the same live triangles."""
    db, _, _ = stack
    V, F = db["table"]
    p = poses(1, 9)[0]
    txy, tz = TR._project(torch.as_tensor(V), torch.as_tensor(p), TI)
    jxy, jz = JR._project(jnp.asarray(V), jnp.asarray(p), JI)
    np.testing.assert_allclose(txy.numpy(), np.asarray(jxy), atol=1e-4)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-6)
    tpl, tok = TR._triangle_planes(txy, tz, torch.as_tensor(F), TI)
    jpl, jok = JR._triangle_planes(jxy, jz, jnp.asarray(F), JI)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tpl.numpy(), np.asarray(jpl), rtol=1e-4,
                               atol=1e-5)
    assert tpl.shape == (len(F), 12) and bool(tok.any())


def test_frame_raster_matches_interpret_and_brute(stack):
    """rasterize_depth_chunked (plain pair evaluation on the CPU) against
    the reference's K3 in interpret mode, its own plain entry point and
    the barycentric oracle."""
    db, tr, _ = stack
    V, F = db["table"]
    Fm = TR.sort_faces_morton(V, F)
    p = poses(3, 2)
    got = TR.rasterize_depth_chunked(torch.as_tensor(V), torch.as_tensor(Fm),
                                     torch.as_tensor(p), TI)
    ref = JR.rasterize_depth_chunked(jnp.asarray(V), jnp.asarray(Fm),
                                     jnp.asarray(p), JI, interpret=True)
    assert_depth_close(got, ref, "interpret")
    plain = TR.rasterize_depth_chunked_plain(
        torch.as_tensor(V), torch.as_tensor(Fm), torch.as_tensor(p), TI)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    for b in range(2):
        brute = TR.rasterize_depth_brute(torch.as_tensor(V),
                                         torch.as_tensor(Fm),
                                         torch.as_tensor(p[b]), TI)
        jbrute = JR.rasterize_depth_brute(jnp.asarray(V), jnp.asarray(Fm),
                                          jnp.asarray(p[b]), JI)
        assert_depth_close(brute, jbrute, "oracles")
        assert_depth_close(got[b], brute, "against the oracle")


def test_multi_raster_matches_interpret(stack):
    _, tr, jr = stack
    p = poses(4, 3)
    mi = np.array([1, 0, 0, 1])
    got = TR.rasterize_depth_chunked_multi(tr.Cs, torch.as_tensor(p),
                                           torch.as_tensor(mi), TI)
    ref = JR.rasterize_depth_chunked_multi(jr.Vs, jr.Fs, jnp.asarray(p),
                                           jnp.asarray(mi), JI, 32,
                                           interpret=True)
    assert_depth_close(got, ref)
    plain = TR.rasterize_depth_chunked_multi_plain(
        tr.Cs, torch.as_tensor(p), torch.as_tensor(mi), TI)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_roi_raster_matches_interpret_batched_and_crop(stack):
    """rasterize_depth_chunked_multi_roi against the reference's (K3 per
    pose, 32-px subtiles), against its pose-batched K4 call (G = 5,
    sub_px = 16) in interpret mode, and against the crop of the port's
    own full frame."""
    _, tr, jr = stack
    p = poses(5, 4)
    mi = np.array([1, 0, 1, 1, 0])
    org = np.array([[0, 0], [8, 16], [16, 8], [64, 64], [33, 41]], np.float32)
    got = TR.rasterize_depth_chunked_multi_roi(
        tr.Cs, torch.as_tensor(p), torch.as_tensor(mi), torch.as_tensor(org),
        TI, ROI)
    assert got.shape == (5, *ROI)
    ref = JR.rasterize_depth_chunked_multi_roi(
        jr.Vs, jr.Fs, jnp.asarray(p), jnp.asarray(mi), jnp.asarray(org), JI,
        ROI, 32, interpret=True)
    assert_depth_close(got, ref, "K3 per pose")

    roi_ji = JR._roi_intr(JI, ROI)
    planes, ids, counts = JR._prep_chunks_all(
        jr.Cs[jnp.asarray(mi)], jnp.asarray(p), roi_ji, 32, 128,
        origins=jnp.asarray(org), sub_px=16)
    inv = np.asarray(JR._chunk_raster_call_batched(
        roi_ji, jr.Fs.shape[1], 32, 128, True, 5, sub_px=16)(
            counts, ids, planes))[:, :ROI[0], :ROI[1]]
    batched = np.where(inv > 0, 1.0 / np.maximum(inv, 1e-12), np.inf)
    assert_depth_close(got, batched, "K4 batched call")

    plain = TR.rasterize_depth_chunked_multi_roi_plain(
        tr.Cs, torch.as_tensor(p), torch.as_tensor(mi), torch.as_tensor(org),
        TI, ROI)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    full = TR.rasterize_depth_chunked_multi(tr.Cs, torch.as_tensor(p),
                                            torch.as_tensor(mi), TI).numpy()
    for b in range(5):
        x0, y0 = int(org[b, 0]), int(org[b, 1])
        crop = full[b, y0:y0 + ROI[0], x0:x0 + ROI[1]]
        w = got[b].numpy()
        assert (np.isfinite(w) == np.isfinite(crop)).mean() >= 0.999
        both = np.isfinite(w) & np.isfinite(crop)
        np.testing.assert_allclose(w[both], crop[both], atol=1e-3)


def test_renderers_match_reference(stack):
    """Renderer and MultiMeshRenderer entry points: depth as above, masks
    and edges on >= 99.9 % of pixels (an edge pixel follows its depth)."""
    db, tr, jr = stack
    p = poses(3, 5)
    mi = np.array([0, 1, 0])
    d = tr.render_depth(p, mi)
    assert d.shape == (3, 96, 128)
    jd = JR.rasterize_depth_chunked_multi(jr.Vs, jr.Fs, jnp.asarray(p),
                                          jnp.asarray(mi), JI, 32,
                                          interpret=True)
    assert_depth_close(d, jd)
    mask = tr.render_mask(p, mi)
    assert mask.dtype == torch.uint8
    assert ((mask.numpy() == 255) == np.isfinite(np.asarray(jd))).mean() \
        >= 0.999
    e = tr.render_edge(p, mi).numpy()
    je = np.asarray(JE.depth_edge(jd))
    assert (np.abs(e - je) < 1e-3).mean() >= 0.999 and e.sum() > 50
    assert tr.render_depth(p[0], mi[:1]).shape == (96, 128)
    p4 = np.concatenate([p, np.tile([[[0, 0, 0, 1.0]]], (3, 1, 1))], 1)
    np.testing.assert_array_equal(tr.render_depth(p4, mi).numpy(), d.numpy())

    r = TR.Renderer(TI, device="cpu")
    r.set_mesh(*db["ball"])
    np.testing.assert_array_equal(r.render_depth(p[0]).numpy(), d[0].numpy())
    assert r.render_depth(p[None]).shape == (1, 3, 96, 128)
    assert r.render_edge(p).shape == (3, 96, 128)
    assert int(r.render_mask(p[0]).max()) == 255


def _depth_images(seed, shape):
    rng = np.random.default_rng(seed)
    H, W = shape[-2:]
    yy, xx = np.mgrid[0:H, 0:W]
    n = int(np.prod(shape[:-2]))
    d = (1.5 + 0.004 * xx + 0.002 * yy)[None] + rng.uniform(0, 2, (n, 1, 1))
    d = d + 0.3 * (rng.uniform(size=d.shape) < 0.05)
    d = np.where(rng.uniform(size=d.shape) < 0.05, np.inf, d)
    d[:, H // 2:, : W // 3] = np.inf
    d[:, : H // 4, W // 2:] = -1.0
    d[:, :3] = 2.0                       # foreground inside the border mask
    return d.reshape(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(4, 40, 56), (33, 47), (2, 3, 24, 31)])
def test_depth_edge_matches_reference(shape):
    """depth_edge_plain against the reference's Pallas kernel in interpret
    mode and its XLA form (which shifts with a wrapping roll; the 5-px
    border mask hides the difference): 1e-6."""
    d = _depth_images(6, shape)
    got = TE.depth_edge_plain(torch.as_tensor(d)).numpy()
    np.testing.assert_array_equal(TE.depth_edge(torch.as_tensor(d)).numpy(),
                                  got)
    xla = np.asarray(JE.depth_edge(jnp.asarray(d)))
    np.testing.assert_allclose(got, xla, atol=1e-6)
    if d.ndim <= 3:
        pallas = np.asarray(JE.depth_edge_pallas(jnp.asarray(d),
                                                 interpret=True))
        np.testing.assert_allclose(got, pallas, atol=1e-6)
    assert got.shape == d.shape and got.max() == 1.0
    assert (got[..., :5, :] == 0).all() and (got[..., :, -5:] == 0).all()


def test_depth_conventions_match():
    d = _depth_images(7, (20, 30))
    gl = TC.to_gl_depth(torch.as_tensor(d), 0.05, 8.0)
    np.testing.assert_allclose(
        gl.numpy(), np.asarray(JC.to_gl_depth(jnp.asarray(d), 0.05, 8.0)),
        atol=1e-6)
    lin = TE.linearize_gl_depth(gl, 0.05, 8.0)
    np.testing.assert_allclose(
        lin.numpy(), np.asarray(JE.linearize_gl_depth(jnp.asarray(gl.numpy()),
                                                      0.05, 8.0)), rtol=1e-5)
    v = np.linspace(0, 0.2, 41, dtype=np.float32)
    np.testing.assert_allclose(TE.soft_threshold(torch.as_tensor(v)).numpy(),
                               np.asarray(JE.soft_threshold(jnp.asarray(v))),
                               atol=1e-6)
    assert TC.Intrinsics.from_K([[100, 0, 5], [0, 110, 6], [0, 0, 1]], 8, 9) \
        == TC.Intrinsics(100.0, 110.0, 5.0, 6.0, 8, 9)


def test_wrappers_raise_on_cuda_without_a_card():
    """A wrapper takes its plain version only because its tensor lies on
    the CPU; entry points without device= want the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        TR.MultiMeshRenderer(TI)
    with pytest.raises(RuntimeError):
        TR.Renderer(TI)
