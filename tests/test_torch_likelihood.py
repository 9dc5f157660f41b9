"""The port's edge likelihood against the JAX reference on the CPU: the
same seeded numpy inputs through both.

Tolerances: the distance transform is exact (the same sums of the same two
constants along the same paths); the scores are float32 sums over a frame
taken in another order, 1e-5 relative plus 1e-5 absolute."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visma_tpu.render import likelihood as JL
from visma_tpu.render.camera import Intrinsics as JIntr
from visma_tpu.render.raster import Renderer as JRenderer
from visma_tpu_torch.io.procedural import box_mesh
from visma_tpu_torch.render import likelihood as TL
from visma_tpu_torch.render.camera import Intrinsics
from visma_tpu_torch.render.raster import Renderer

TOL = dict(rtol=1e-5, atol=1e-5)


def _edges(seed, shape, density=0.03):
    rng = np.random.default_rng(seed)
    e = (rng.uniform(size=shape) < density) * rng.uniform(0.3, 1.0, shape)
    return e.astype(np.float32)


def _depths(seed, shape):
    """Random rectangles at random depths on an inf background."""
    rng = np.random.default_rng(seed)
    d = np.full(shape, np.inf, np.float32).reshape(-1, *shape[-2:])
    H, W = shape[-2:]
    for img in d:
        for _ in range(3):
            y, x = rng.integers(6, H - 16), rng.integers(6, W - 16)
            h, w = rng.integers(6, 14), rng.integers(6, 14)
            img[y:y + h, x:x + w] = rng.uniform(1.0, 3.0)
    return d.reshape(shape)


@pytest.mark.parametrize("shape,iters", [((40, 56), 16), ((33, 47), None),
                                         ((24, 24), 3)])
def test_distance_transform_exact(shape, iters):
    e = _edges(1, shape)
    got = TL.edge_distance_transform(torch.as_tensor(e), iters=iters)
    ref = JL.edge_distance_transform(jnp.asarray(e), iters=iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.min() == 0.0 and got.max() > 1.0
    empty = TL.edge_distance_transform(torch.zeros(shape), iters=4)
    assert float(empty.min()) == float(sum(shape))


def test_chamfer_score_matches():
    r, obs = _edges(2, (5, 40, 56), 0.05), _edges(3, (40, 56))
    r[4] = 0.0                                # renders nothing -> tau
    dt = JL.edge_distance_transform(jnp.asarray(obs), iters=16)
    got = TL.chamfer_score(torch.as_tensor(r), torch.as_tensor(np.asarray(dt)),
                           tau=7.0)
    ref = JL.chamfer_score(jnp.asarray(r), dt, tau=7.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert float(got[4]) == 7.0
    one = TL.chamfer_score(torch.as_tensor(r[0]),
                           torch.as_tensor(np.asarray(dt)), tau=7.0)
    np.testing.assert_allclose(float(one), float(ref[0]), **TOL)


@pytest.mark.parametrize("radius,obs_mass", [(2, None), (1, 321.5), (0, None)])
def test_symmetric_edge_score_matches(radius, obs_mass):
    r, obs = _edges(4, (6, 40, 56), 0.05), _edges(5, (40, 56))
    dt = np.asarray(JL.edge_distance_transform(jnp.asarray(obs), iters=16))
    got = TL.symmetric_edge_score(
        torch.as_tensor(r), torch.as_tensor(dt), torch.as_tensor(obs),
        radius=radius,
        obs_mass=None if obs_mass is None else torch.tensor(obs_mass))
    ref = JL.symmetric_edge_score(
        jnp.asarray(r), jnp.asarray(dt), jnp.asarray(obs), radius=radius,
        obs_mass=None if obs_mass is None else jnp.float32(obs_mass))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    one = TL.symmetric_edge_score(torch.as_tensor(r[1]), torch.as_tensor(dt),
                                  torch.as_tensor(obs), radius=radius)
    ref1 = JL.symmetric_edge_score(jnp.asarray(r[1]), jnp.asarray(dt),
                                   jnp.asarray(obs), radius=radius)
    np.testing.assert_allclose(float(one), float(ref1), **TOL)


def test_occlusion_aware_edge_score_matches():
    d, occ = _depths(6, (5, 40, 56)), _depths(7, (40, 56))
    obs = _edges(8, (40, 56), 0.06)
    dt = np.asarray(JL.edge_distance_transform(jnp.asarray(obs), iters=16))
    args = (torch.as_tensor(dt), torch.as_tensor(obs))
    got = TL.occlusion_aware_edge_score(torch.as_tensor(d),
                                        torch.as_tensor(occ), *args)
    ref = JL.occlusion_aware_edge_score(jnp.asarray(d), jnp.asarray(occ),
                                        jnp.asarray(dt), jnp.asarray(obs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # no occluders: None scores as an all-inf buffer does
    none = TL.occlusion_aware_edge_score(torch.as_tensor(d), None, *args)
    inf = JL.occlusion_aware_edge_score(
        jnp.asarray(d), jnp.full((40, 56), jnp.inf), jnp.asarray(dt),
        jnp.asarray(obs))
    np.testing.assert_allclose(none.numpy(), np.asarray(inf), **TOL)


def test_occlusion_aware_score_batched_over_objects():
    """Leading object dimensions: (n, S, H, W) renders against per-object
    occluders, dt and evidence equal n separate reference calls."""
    n, S = 3, 4
    d, occ = _depths(9, (n, S, 40, 56)), _depths(10, (n, 40, 56))
    obs = np.stack([_edges(11 + i, (40, 56), 0.06) for i in range(n)])
    dt = np.stack([np.asarray(JL.edge_distance_transform(
        jnp.asarray(o), iters=16)) for o in obs])
    mass = 777.0
    got = TL.occlusion_aware_edge_score(
        torch.as_tensor(d), torch.as_tensor(occ), torch.as_tensor(dt),
        torch.as_tensor(obs), radius=1, obs_mass=torch.tensor(mass))
    assert got.shape == (n, S)
    for i in range(n):
        ref = JL.occlusion_aware_edge_score(
            jnp.asarray(d[i]), jnp.asarray(occ[i]), jnp.asarray(dt[i]),
            jnp.asarray(obs[i]), radius=1, obs_mass=jnp.float32(mass))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref), **TOL)


def test_scene_depth_and_score_hypotheses_match():
    kw = dict(fx=80.0, fy=80.0, cx=31.5, cy=23.5, rows=48, cols=64,
              z_near=0.05, z_far=8.0)
    V, F = box_mesh(0.5, 0.4, 0.3, subdiv=2)
    poses = np.tile(np.eye(3, 4, dtype=np.float32), (4, 1, 1))
    poses[:, 2, 3] = [2.0, 2.1, 2.4, 1.8]
    poses[:, 0, 3] = [0.0, 0.05, -0.1, 0.3]
    tr, jr = Renderer(Intrinsics(**kw), device="cpu"), \
        JRenderer(JIntr(**kw), use_pallas=False)
    tr.set_mesh(V, F)
    jr.set_mesh(V, F)
    joint, ds = TL.scene_depth([tr, tr], [poses[0], poses[3]])
    jjoint, jds = JL.scene_depth([jr, jr], [poses[0], poses[3]])
    assert ds.shape == (2, 48, 64)
    same = np.isfinite(joint.numpy()) == np.isfinite(np.asarray(jjoint))
    assert same.mean() >= 0.999
    both = np.isfinite(joint.numpy()) & np.isfinite(np.asarray(jjoint))
    np.testing.assert_allclose(joint.numpy()[both], np.asarray(jjoint)[both],
                               atol=1e-3)
    obs = tr.render_edge(poses[0])
    got = TL.score_hypotheses(tr, poses, obs, dt_iters=12)
    ref = JL.score_hypotheses(jr, jnp.asarray(poses),
                              jnp.asarray(obs.numpy()), dt_iters=12)
    # renders of the two rasterizers differ on silhouette pixels: 0.05 px
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=0.05)
    assert int(torch.argmin(got)) == 0 and float(got[0]) < 0.05
