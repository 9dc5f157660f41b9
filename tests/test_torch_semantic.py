"""The port's CEM and semantic mapper against the JAX reference on the
CPU, at small sizes (96x128 frames, 32x64 or 64x64 windows, meshes of
about a hundred faces, 2-3 objects, 8-16 samples). The same seeded numpy
inputs go through both; the reference runs its XLA rasterizer (its CPU
path, with a tile capacity that holds every triangle), the port its plain
pair evaluation.

Random numbers: the fused CEM of the reference draws from a jax.random key
chain; the tests make the same draws and hand them to the port, through
`noise` or by standing in for `cem._draw`. The host-refit oracle draws
from numpy on both sides.

Tolerances: scores of one render 2e-3 (two rasterizers that may differ on
a silhouette pixel, over float32 sums); poses after a whole CEM 2e-3 (the
same draws and the same elites, rounding apart)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from visma_tpu.image.edges import depth_edge as jdepth_edge
from visma_tpu.proto import BoundingBox as JBox, BoundingBoxList as JBoxes
from visma_tpu.render.camera import Intrinsics as JIntr
from visma_tpu.render.likelihood import \
    edge_distance_transform as jedt
from visma_tpu.render.raster import MultiMeshRenderer as JMulti
from visma_tpu.semantic import cem as JCEM
from visma_tpu.semantic.mapper import SemanticMapper as JMapper
from visma_tpu_torch.image.edges import depth_edge
from visma_tpu_torch.io.procedural import box_mesh, cylinder_mesh, merge_meshes
from visma_tpu_torch.proto import BoundingBox, BoundingBoxList
from visma_tpu_torch.render.camera import Intrinsics
from visma_tpu_torch.render.likelihood import edge_distance_transform
from visma_tpu_torch.render.raster import MultiMeshRenderer
from visma_tpu_torch.semantic import cem as TCEM
from visma_tpu_torch.semantic.mapper import (ObjectTrack, SemanticMapper,
                                             _compose_dg,
                                             _exclusive_min_depths)

KW = dict(fx=100.0, fy=110.0, cx=63.5, cy=47.5, rows=96, cols=128,
          z_near=0.05, z_far=8.0)
TI, JI = Intrinsics(**KW), JIntr(**KW)
CAP = 512        # reference tile capacity: holds every triangle of a mesh
POSE_TOL = 2e-3
SCORE_TOL = 2e-3


def mesh_db():
    """A 108-face chair (box seat on a cylinder, with a back) and a
    108-face L-shaped cabinet: neither has a yaw symmetry."""
    stool = merge_meshes([box_mesh(0.5, 0.08, 0.4, subdiv=2,
                                   center=(0.0, 0.25, 0.0)),
                          box_mesh(0.5, 0.35, 0.06, subdiv=1,
                                   center=(0.0, 0.46, -0.17)),
                          cylinder_mesh(0.07, 0.5, segments=8, stacks=2)])
    cabinet = merge_meshes([box_mesh(0.8, 0.5, 0.35, subdiv=2),
                            box_mesh(0.25, 0.3, 0.3, subdiv=2,
                                     center=(0.25, 0.4, 0.0)),
                            box_mesh(0.1, 0.1, 0.1, subdiv=1,
                                     center=(-0.3, 0.3, 0.1))])
    return {"stool": stool, "cabinet": cabinet}


def scene_poses():
    """Three objects in view, the middle one partly behind its neighbour."""
    out = []
    for k, (x, z, yaw) in enumerate([(-0.45, 2.1, 0.4), (0.05, 2.6, -0.3),
                                     (0.55, 2.2, 0.2)]):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("y", yaw).as_matrix()
        T[:3, 3] = [x, 0.02 * k, z]
        out.append(T)
    return out


@pytest.fixture(scope="module")
def scene():
    db = mesh_db()
    tr = MultiMeshRenderer(TI, device="cpu")
    tr.set_meshes(db)
    jr = JMulti(JI, capacity=CAP, use_pallas=False)
    jr.set_meshes(db)
    T = scene_poses()
    mi = np.array([0, 1, 0], np.int32)
    poses = np.stack([t[:3, :4] for t in T]).astype(np.float32)
    obs = depth_edge(tr.render_depth(poses, mi).amin(dim=0)).numpy()
    assert obs.sum() > 100
    return dict(db=db, tr=tr, jr=jr, T=T, mi=mi, poses=poses, obs=obs)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def jax_draws(seed, iters, shape):
    """The standard-normal draws of the reference's fused CEM from
    PRNGKey(seed): split, draw, repeat."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(iters):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


def test_small_helpers_match():
    xi = np.random.default_rng(0).standard_normal((3, 4, 6)) * 0.3
    np.testing.assert_allclose(TCEM._se3_exp_np(xi), JCEM._se3_exp_np(xi),
                               atol=1e-12)
    assert [TCEM.cem_n_elite(s) for s in (4, 8, 24, 48)] \
        == [JCEM.cem_n_elite(s) for s in (4, 8, 24, 48)]
    assert TCEM.CEM_TAU == JCEM.CEM_TAU
    # centres chosen so that u - Wr/2 lands on .5: round half to even
    t_cm = np.array([[0.0, 0.0, 2.0], [-0.31, 0.1, 2.0], [0.5, -0.3, 1.0],
                     [-3.0, 2.0, 2.0], [(32.5 - 63.5 + 32) / 100 * 2.0,
                                        (16.5 - 47.5 + 16) / 110 * 2.0, 2.0]],
                    np.float32)
    got = TCEM._roi_origins(_t(t_cm), TI, (32, 64))
    ref = JCEM._roi_origins(jnp.asarray(t_cm), JI, (32, 64))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    img = np.arange(96 * 128, dtype=np.float32).reshape(96, 128)
    crop = TCEM._crop(_t(img), got, (32, 64))
    for i in range(len(t_cm)):
        np.testing.assert_array_equal(
            crop[i].numpy(), np.asarray(JCEM._crop(jnp.asarray(img), ref[i],
                                                   (32, 64))))
    stack = np.stack([img + k for k in range(len(t_cm))])
    crops = TCEM._crop(_t(stack), got, (32, 64))
    np.testing.assert_array_equal(crops[2].numpy(), crop[2].numpy() + 2)


@pytest.mark.parametrize("mode", ["full", "roi_crop", "roi_occ_poses",
                                  "roi_none"])
def test_render_score_nS_matches(scene, mode):
    """Full frame with occluder depths; ROI with cropped occluder depths;
    ROI with occluders rendered in the window from poses; ROI without
    occluders. The same xi through both."""
    s = scene
    n, S = 3, 6
    rng = np.random.default_rng(1)
    xi = (rng.standard_normal((n, S, 6))
          * np.array([0.03] * 3 + [0.06] * 3)).astype(np.float32)
    xi[:, 0] = 0
    mean_R, mean_t = s["poses"][:, :, :3], s["poses"][:, :, 3]
    roi = None if mode == "full" else (48, 64)
    dt_j = jedt(jnp.asarray(s["obs"]), iters=16)
    dt_t = edge_distance_transform(_t(s["obs"]), iters=16)
    occ_t = _exclusive_min_depths(s["tr"].Cs, _t(s["poses"]), _t(s["mi"]), TI)
    occ_j = jnp.asarray(occ_t.numpy())
    org_t = org_j = None
    if roi is not None:
        org_t = TCEM._roi_origins(_t(mean_t), TI, roi)
        org_j = jnp.asarray(org_t.numpy())
    use_depths = mode in ("full", "roi_crop")
    inf_j = jnp.full((n, 96, 128), jnp.inf, jnp.float32)
    tp, ts = TCEM._render_score_nS(
        s["tr"].Cs, _t(s["mi"]).long(), _t(mean_R), _t(mean_t), _t(xi),
        occ_t if use_depths else None, dt_t, _t(s["obs"]), TI, 10.0, roi=roi,
        origins=org_t,
        occ_poses=_t(s["poses"]) if mode == "roi_occ_poses" else None,
        radius=1)
    jp, js = JCEM._render_score_nS(
        s["jr"].Vs, s["jr"].Fs, jnp.asarray(s["mi"]), jnp.asarray(mean_R),
        jnp.asarray(mean_t), jnp.asarray(xi),
        occ_j if use_depths else inf_j, dt_j, jnp.asarray(s["obs"]), JI, 32,
        CAP, False, 10.0, roi=roi, origins=org_j, Cs=s["jr"].Cs,
        occ_poses=jnp.asarray(s["poses"]) if mode == "roi_occ_poses"
        else None, radius=1)
    assert ts.shape == (n, S)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=SCORE_TOL)
    # the unperturbed truth explains the evidence better than the median
    assert (ts[:, 0] <= ts.median(dim=1).values).all()


def test_roi_scores_equal_full_frame_scores(scene):
    """Within the port: a window that holds the footprint, and the 5-px
    border in which the edge stencil is masked, scores as the full frame
    does (the coverage denominator stays global)."""
    s = scene
    xi = np.zeros((3, 2, 6), np.float32)
    xi[:, 1, 0] = 0.02
    args = (s["tr"].Cs, _t(s["mi"]).long(), _t(s["poses"][:, :, :3]),
            _t(s["poses"][:, :, 3]), _t(xi))
    dt = edge_distance_transform(_t(s["obs"]), iters=16)
    occ = _exclusive_min_depths(s["tr"].Cs, _t(s["poses"]), _t(s["mi"]), TI)
    full = TCEM._render_score_nS(*args, occ, dt, _t(s["obs"]), TI, 10.0)[1]
    # footprints more than 5 px (the edge stencil's border) inside
    org = TCEM._roi_origins(_t(s["poses"][:, :, 3]), TI, (88, 120))
    win = TCEM._render_score_nS(*args, occ, dt, _t(s["obs"]), TI, 10.0,
                                roi=(88, 120), origins=org)[1]
    np.testing.assert_allclose(win.numpy(), full.numpy(), atol=1e-4)


@pytest.mark.parametrize("mode", ["poses", "none"])
def test_fused_cem_matches_with_the_same_draws(scene, mode):
    """`_cem_fused_body` fed the draws JAX makes from PRNGKey(5) against
    the reference's jitted fused CEM, ROI windows recentred each
    iteration."""
    s = scene
    n, iters, S, roi = 3, 3, 8, (48, 64)
    rng = np.random.default_rng(2)
    init = s["poses"].copy()
    init[:, :, 3] += rng.uniform(-0.04, 0.04, (n, 3)).astype(np.float32)
    sig0 = TCEM._sigma6((0.08, 0.04), n)
    noise = jax_draws(5, iters, (n, S, 6))
    n_elite = TCEM.cem_n_elite(S)
    occ_poses = init if mode == "poses" else None
    tp, ts = TCEM._cem_fused_body(
        s["tr"].Cs, _t(s["mi"]).long(), _t(init[:, :, :3]).contiguous(),
        _t(init[:, :, 3]).contiguous(), _t(sig0), None, _t(s["obs"]), None,
        TI, 10.0, iters, S, n_elite, roi=roi,
        occ_poses=None if occ_poses is None else _t(occ_poses), radius=2,
        noise=_t(noise))
    jp, js = JCEM._cem_fused(
        s["jr"].Vs, s["jr"].Fs, jnp.asarray(s["mi"]),
        jnp.asarray(init[:, :, :3]), jnp.asarray(init[:, :, 3]),
        jnp.asarray(sig0),
        jnp.full((n, 96, 128), jnp.inf, jnp.float32), jnp.asarray(s["obs"]),
        jax.random.PRNGKey(5), JI, 32, CAP, False, 10.0, iters, S, n_elite,
        roi, s["jr"].Cs,
        None if occ_poses is None else jnp.asarray(occ_poses), 2)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=POSE_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=SCORE_TOL)
    assert np.isfinite(tp.numpy()).all() and (ts.numpy() < 10.0).all()


@pytest.mark.parametrize("roi", [None, (48, 64)])
def test_host_oracle_matches_draw_for_draw(scene, roi):
    """refine_pose_cem_batched(device_loop=False): numpy draws from the
    same seed on both sides, numpy refit."""
    s = scene
    init = s["poses"].copy()
    init[:, 0, 3] += 0.03
    kw = dict(iters=2, samples=8, init_sigma=(0.08, 0.04), seed=11,
              device_loop=False, roi=roi, radius=2)
    occ = None if roi is not None else _exclusive_min_depths(
        s["tr"].Cs, _t(init), _t(s["mi"]), TI)
    tp, ts = TCEM.refine_pose_cem_batched(
        s["tr"], s["obs"], init, s["mi"], occluder_depths=occ,
        occluder_poses=init if roi is not None else None, device="cpu", **kw)
    jp, js = JCEM.refine_pose_cem_batched(
        s["jr"], jnp.asarray(s["obs"]), init, s["mi"],
        occluder_depths=None if occ is None else jnp.asarray(occ.numpy()),
        occluder_poses=init if roi is not None else None, **kw)
    np.testing.assert_allclose(tp, jp, atol=POSE_TOL)
    np.testing.assert_allclose(ts, js, atol=SCORE_TOL)


def test_single_object_cem_matches(scene):
    """refine_pose_cem with a single-mesh Renderer: numpy draws on both
    sides."""
    from visma_tpu.render.raster import Renderer as JRenderer
    from visma_tpu_torch.render.raster import Renderer

    s = scene
    V, F = s["db"]["cabinet"]
    tr, jr = Renderer(TI, device="cpu"), JRenderer(JI, capacity=CAP,
                                                   use_pallas=False)
    tr.set_mesh(V, F)
    jr.set_mesh(V, F)
    truth = s["poses"][1]
    obs = tr.render_edge(truth)
    init = truth.copy()
    init[0, 3] += 0.04
    kw = dict(iters=2, samples=8, init_sigma=(0.06, 0.04), seed=4)
    tp, tsc = TCEM.refine_pose_cem(tr, obs, init, **kw)
    jp, jsc = JCEM.refine_pose_cem(jr, jnp.asarray(obs.numpy()), init, **kw)
    np.testing.assert_allclose(tp, jp, atol=POSE_TOL)
    assert abs(tsc - jsc) < SCORE_TOL


def test_bench_scene_module():
    """io.synthetic_semantic: the scene of bench.py:170-255 (slots, the
    1.5 cm strafe, seeded yaws) and its detections."""
    from visma_tpu_torch.io.synthetic_semantic import (BENCH_INTRINSICS,
                                                       bench_scene,
                                                       gt_detections)

    names, T_gt, yaw, gwc_at, poses = bench_scene(5, 4)
    assert names == ["chair", "desk", "chair", "desk"]
    assert poses.shape == (5, 4, 3, 4) and poses.dtype == np.float32
    rng = np.random.default_rng(3)          # bench.py:175-190
    for k, (x, z) in enumerate([(-1.5, 2.75), (-0.65, 3.1), (0.65, 3.1),
                                (1.5, 2.75)]):
        assert yaw[k] == rng.uniform(-0.6, 0.6)
        np.testing.assert_array_equal(T_gt[k][:3, 3],
                                      [x, rng.uniform(-0.1, 0.1), z])
    np.testing.assert_allclose(gwc_at(4)[:, 3], [0.06, 0, 0])
    np.testing.assert_allclose(poses[4, 0, :, 3],
                               T_gt[0][:3, 3] - [0.06, 0, 0], atol=1e-6)
    again = bench_scene(5, 4)
    np.testing.assert_array_equal(again[4], poses)
    intr = Intrinsics(**BENCH_INTRINSICS)
    aabbs = {"chair": (np.full(3, -0.4), np.full(3, 0.4)),
             "desk": (np.array([-0.6, -0.37, -0.3]),
                      np.array([0.6, 0.37, 0.3]))}
    boxes = gt_detections(aabbs, intr, names, yaw, poses[0]).bounding_boxes
    assert len(boxes) == 4
    for b in boxes:
        assert b.class_name == "furniture" and b.shape_id == ""
        assert 0 <= b.top_left_x < b.bottom_right_x <= intr.cols
        assert 0 <= b.top_left_y < b.bottom_right_y <= intr.rows
        assert b.azimuth_prob.shape == (12,)
        np.testing.assert_allclose(b.azimuth_prob.sum(), 0.98, atol=1e-6)


# ---------------------------------------------------------------------------
# The mapper
# ---------------------------------------------------------------------------

MAPPER_KW = dict(cem_iters=3, cem_samples=12, roi=(64, 64), retrieval_yaws=8,
                 settle_age=2, settled_iters=2, settled_samples=8,
                 settled_sigma=(0.05, 0.03), roi_spawn=True)
N_STEPS = 6


def gwc_at(i):
    return np.hstack([np.eye(3), np.array([[0.01 * i], [0.0], [0.0]])])


def _boxes(aabbs, names, poses, cls_box, cls_list):
    boxes = []
    for k, name in enumerate(names):
        lo, hi = aabbs[name]
        c = np.array([[x, y, z] for x in (lo[0], hi[0])
                      for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
        pc = c @ poses[k, :3, :3].T + poses[k, :3, 3]
        u = KW["fx"] * pc[:, 0] / pc[:, 2] + KW["cx"]
        v = KW["fy"] * pc[:, 1] / pc[:, 2] + KW["cy"]
        boxes.append(cls_box(
            top_left_x=float(u.min()), top_left_y=float(v.min()),
            bottom_right_x=float(u.max()), bottom_right_y=float(v.max()),
            scores=np.array([0.9], np.float32), class_name="thing",
            azimuth_prob=np.zeros(0, np.float32)))
    return cls_list(bounding_boxes=boxes)


class JaxDraws:
    """Stands in for cem._draw: the draws the reference makes from
    PRNGKey(generator.initial_seed()), one split per call. A generator
    seeded anew (`manual_seed`, as the mapper's async steps do each frame)
    starts its key chain anew: each call also draws once from the
    generator itself, so that its state shows whether it was reseeded
    since the last call."""

    def __init__(self):
        self.keys = []          # [generator, key, state], by identity

    def __call__(self, generator, shape, device):
        for slot in self.keys:
            if slot[0] is generator:
                break
        else:
            slot = [generator, None, None]
            self.keys.append(slot)
        if slot[2] is None or not torch.equal(generator.get_state(),
                                              slot[2]):
            slot[1] = jax.random.PRNGKey(generator.initial_seed())
        slot[1], sub = jax.random.split(slot[1])
        torch.randn(1, generator=generator)
        slot[2] = generator.get_state()
        return torch.as_tensor(np.asarray(
            jax.random.normal(sub, shape, jnp.float32)), device=device)


def _scene_frames(mr, names, T):
    mi = np.array([mr.index(n) for n in names])
    frames, poses0 = [], None
    for i in range(N_STEPS):
        G = np.eye(4)
        G[:3, :4] = gwc_at(i)
        poses = np.stack([(np.linalg.inv(G) @ t)[:3, :4]
                          for t in T]).astype(np.float32)
        poses0 = poses if i == 0 else poses0
        frames.append(depth_edge(mr.render_depth(poses, mi).amin(dim=0)))
    return frames, poses0


def run_port(async_frames, names, T, db, graph=None):
    mapper = SemanticMapper(TI, db, async_frames=async_frames, device="cpu",
                            graph=graph, **MAPPER_KW)
    frames, poses0 = _scene_frames(mapper.mrenderer, names, T)
    for i in range(N_STEPS):
        mapper.step(gwc_at(i), frames[i],
                    bboxes=_boxes(mapper._mesh_aabb, names, poses0,
                                  BoundingBox, BoundingBoxList)
                    if i == 0 else None)
    return mapper, frames


def test_mapper_host_logic_matches(scene):
    """_init_pose_cm, _covered, _footprints_may_overlap, retrieve_shape
    (full frame and windowed) on the same detections."""
    names = ["stool", "cabinet"]
    poses = scene["poses"][[0, 1]]
    kw = dict(retrieval_yaws=8)
    for roi in (None, (64, 64)):
        tm = SemanticMapper(TI, scene["db"], roi=roi, device="cpu", **kw)
        jm = JMapper(JI, scene["db"], roi=roi, **kw)
        jm.mrenderer.capacity = CAP
        tb = _boxes(tm._mesh_aabb, names, poses, BoundingBox,
                    BoundingBoxList).bounding_boxes
        jb = _boxes(jm._mesh_aabb, names, poses, JBox, JBoxes).bounding_boxes
        for k in range(2):
            np.testing.assert_allclose(tm._init_pose_cm(tb[k], names[k]),
                                       jm._init_pose_cm(jb[k], names[k]),
                                       atol=1e-9)
            tname, tT, tsc = tm.retrieve_shape(tb[k], scene["obs"])
            jname, jT, jsc = jm.retrieve_shape(jb[k], scene["obs"])
            assert tname == jname == names[k]
            np.testing.assert_allclose(tT, jT, atol=1e-9)
            assert abs(tsc - jsc) < 5e-3
        assert not tm._covered(tb[0], gwc_at(0))
        tm.tracks[0] = ObjectTrack(0, "stool", scene["T"][0])
        jm.tracks[0] = ObjectTrack(0, "stool", scene["T"][0])
        assert tm._covered(tb[0], gwc_at(0)) and jm._covered(jb[0], gwc_at(0))
        assert not tm._covered(tb[1], gwc_at(0))
        for sig in (None, (0.5, 0.3), (0.001, 0.001)):
            assert tm._footprints_may_overlap(scene["poses"],
                                              ["stool", "cabinet", "stool"],
                                              sig) \
                == jm._footprints_may_overlap(scene["poses"],
                                              ["stool", "cabinet", "stool"],
                                              sig)


def test_mapper_small_pieces(scene):
    dG = np.eye(3, 4, dtype=np.float32)
    dG[0, 3] = -0.02
    out = _compose_dg(_t(dG), _t(scene["poses"]))
    ref = scene["poses"].copy()
    ref[:, 0, 3] -= 0.02
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-7)
    occ = _exclusive_min_depths(scene["tr"].Cs, _t(scene["poses"]),
                                _t(scene["mi"]), TI)
    d = scene["tr"].render_depth(scene["poses"], scene["mi"])
    np.testing.assert_array_equal(occ[0].numpy(),
                                  torch.minimum(d[1], d[2]).numpy())
    m = SemanticMapper(TI, scene["db"], roi=(64, 64), settled_iters=2,
                       settled_samples=8, cem_iters=2, cem_samples=8,
                       device="cpu")
    assert m.warmup(2) > 0 and not m.tracks and not m.history
    m.step(gwc_at(0), np.zeros((48, 64), np.float32))    # resampled, no tracks
    assert m.history == [[]]
