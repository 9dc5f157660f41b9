"""The port's fused edge score (`render/likelihood.py::edge_score`) on CPU
tensors, where it runs its plain version, against the JAX reference's
`occlusion_aware_edge_score` and `symmetric_edge_score`, one object at a
time: the same seeded numpy inputs through both. 2 objects x 3 hypothesis
windows of 40x56.

Tolerance rtol 1e-5, atol 1e-6: the scores are float32 sums over a window
taken in another order by the two frameworks. The argument checks run
before the dispatch, so they are held here too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visma_tpu.image.edges import depth_edge as j_depth_edge
from visma_tpu.render import likelihood as JL
from visma_tpu_torch.render import likelihood as TL

N, S, H, W = 2, 3, 40, 56
TOL = dict(rtol=1e-5, atol=1e-6)


def _depths(rng, lead, background):
    """Random rectangles at random depths on a `background` of inf, NaN,
    0 or a negative depth, with a few background holes inside them."""
    bg = {"inf": np.inf, "nan": np.nan, "zero": 0.0, "negative": -2.5}
    d = np.full((*lead, H, W), bg[background], np.float32).reshape(-1, H, W)
    for img in d:
        for _ in range(3):
            y, x = rng.integers(4, H - 14), rng.integers(4, W - 14)
            h, w = rng.integers(6, 14), rng.integers(6, 14)
            img[y:y + h, x:x + w] = rng.uniform(1.0, 3.0)
        img[rng.integers(0, H, 4), rng.integers(0, W, 4)] = bg[background]
    return d.reshape(*lead, H, W)


def _scene(seed, background="inf"):
    rng = np.random.default_rng(seed)
    d = _depths(rng, (N, S), background)
    occ = _depths(rng, (N,), background)
    obs = ((rng.uniform(size=(N, H, W)) < 0.06)
           * rng.uniform(0.3, 1.0, (N, H, W))).astype(np.float32)
    dt = np.stack([np.asarray(JL.edge_distance_transform(
        jnp.asarray(o), iters=16)) for o in obs])
    return d, occ, dt, obs


def _reference(d, occ, dt, obs, radius, mass):
    """The JAX reference, object by object."""
    m = None if mass is None else jnp.float32(mass)
    out = []
    for i in range(N):
        if occ is None:
            out.append(JL.symmetric_edge_score(
                j_depth_edge(jnp.asarray(d[i])), jnp.asarray(dt[i]),
                jnp.asarray(obs[i]), radius=radius, obs_mass=m))
        else:
            out.append(JL.occlusion_aware_edge_score(
                jnp.asarray(d[i]), jnp.asarray(occ[i]), jnp.asarray(dt[i]),
                jnp.asarray(obs[i]), radius=radius, obs_mass=m))
    return np.stack([np.asarray(o) for o in out])


@pytest.mark.parametrize("occluded", [True, False])
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("mass", [None, 345.5])
def test_edge_score_matches_jax(occluded, radius, mass):
    d, occ, dt, obs = _scene(1)
    occ = occ if occluded else None
    got = TL.edge_score(
        torch.as_tensor(d), None if occ is None else torch.as_tensor(occ),
        torch.as_tensor(dt), torch.as_tensor(obs), radius=radius,
        obs_mass=None if mass is None else torch.tensor(mass))
    assert got.shape == (N, S)
    np.testing.assert_allclose(got.numpy(),
                               _reference(d, occ, dt, obs, radius, mass),
                               **TOL)


@pytest.mark.parametrize("background", ["nan", "inf", "zero", "negative"])
def test_edge_score_backgrounds_match_jax(background):
    """Every kind of background the stencil reads as -1, in the hypothesis
    and in the occluder windows (NaN propagates through the composite)."""
    d, occ, dt, obs = _scene(2, background)
    got = TL.edge_score(torch.as_tensor(d), torch.as_tensor(occ),
                        torch.as_tensor(dt), torch.as_tensor(obs))
    ref = _reference(d, occ, dt, obs, 2, None)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_routing_and_shared_evidence():
    """occlusion_aware_edge_score goes through edge_score; evidence given
    once as (H, W) for all objects scores as the per-object copies do;
    edge_score_plain is what a CPU tensor runs."""
    d, occ, dt, obs = _scene(3)
    args = (torch.as_tensor(d), torch.as_tensor(occ))
    one_dt, one_obs = torch.as_tensor(dt[0]), torch.as_tensor(obs[0])
    mass = torch.tensor(222.0)
    shared = TL.edge_score(*args, one_dt, one_obs, obs_mass=mass)
    copies = TL.edge_score(*args, one_dt.expand(N, H, W),
                           one_obs.expand(N, H, W), obs_mass=mass)
    routed = TL.occlusion_aware_edge_score(*args, one_dt, one_obs,
                                           obs_mass=mass)
    plain = TL.edge_score_plain(*args, one_dt, one_obs, obs_mass=mass)
    np.testing.assert_array_equal(shared.numpy(), copies.numpy())
    np.testing.assert_array_equal(shared.numpy(), routed.numpy())
    np.testing.assert_array_equal(shared.numpy(), plain.numpy())


@pytest.mark.parametrize("bad", ["radius", "negative radius", "occluders",
                                 "dt", "evidence", "rank"])
def test_argument_checks(bad):
    """Checked before the dispatch, so a CPU call raises as a CUDA call
    does."""
    d, occ, dt, obs = (torch.as_tensor(a) for a in _scene(4))
    kw = dict(radius=2)
    if bad == "radius":
        kw["radius"] = 3
    elif bad == "negative radius":
        kw["radius"] = -1
    elif bad == "occluders":
        occ = occ[:1]
    elif bad == "dt":
        dt = dt[:, :, :-1]
    elif bad == "evidence":
        obs = obs[:1].expand(3, H, W)
    else:
        d = d[0]
    with pytest.raises(ValueError):
        TL.edge_score(d, occ, dt, obs, **kw)
