"""The port's SO(3)/SE(3) types against the JAX reference on the CPU: the
same seeded numpy inputs through both, float32, tolerance 1e-6 (the same
closed forms; only the order of the 3-term sums differs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visma_tpu.geom import SE3 as JSE3, SO3 as JSO3
from visma_tpu_torch.geom import SE3, SO3, invrodrigues, rodrigues

TOL = 1e-6


def _xi(seed, shape=(7,), scale=0.6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((*shape, 6)) * scale).astype(np.float32)


def _t(x):
    return torch.as_tensor(x)


@pytest.mark.parametrize("scale", [0.6, 1e-3, 0.0])
def test_se3_exp_matches(scale):
    xi = _xi(1, scale=scale)
    j, t = JSE3.exp(jnp.asarray(xi)), SE3.exp(_t(xi))
    np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=TOL)
    np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=TOL)
    np.testing.assert_allclose(t.matrix3x4().numpy(),
                               np.asarray(j.matrix3x4()), atol=TOL)
    np.testing.assert_allclose(t.matrix().numpy(), np.asarray(j.matrix()),
                               atol=TOL)


@pytest.mark.parametrize("scale", [0.6, 1e-3])
def test_se3_log_matches_and_inverts_exp(scale):
    xi = _xi(2, scale=scale)
    j, t = JSE3.exp(jnp.asarray(xi)), SE3.exp(_t(xi))
    np.testing.assert_allclose(t.log().numpy(), np.asarray(j.log()),
                               atol=1e-5)   # acos near 1 amplifies 1 ulp
    np.testing.assert_allclose(t.log().numpy(), xi, atol=2e-4)


def test_se3_compose_inv_act_broadcast():
    a, b = _xi(3, (4, 1)), _xi(4, (1, 5))
    v = np.random.default_rng(5).standard_normal((4, 5, 3)).astype(np.float32)
    ja, jb = JSE3.exp(jnp.asarray(a)), JSE3.exp(jnp.asarray(b))
    ta, tb = SE3.exp(_t(a)), SE3.exp(_t(b))
    jc, tc = ja @ jb, ta @ tb
    assert tc.shape == (4, 5)
    np.testing.assert_allclose(tc.matrix3x4().numpy(),
                               np.asarray(jc.matrix3x4()), atol=TOL)
    np.testing.assert_allclose((tc.inv() @ tc).matrix3x4().numpy(),
                               np.broadcast_to(np.eye(3, 4), (4, 5, 3, 4)),
                               atol=5e-6)
    np.testing.assert_allclose(tc.inv().matrix3x4().numpy(),
                               np.asarray(jc.inv().matrix3x4()), atol=TOL)
    np.testing.assert_allclose((tc @ _t(v)).numpy(),
                               np.asarray(jc @ jnp.asarray(v)), atol=5e-6)


def test_from_matrix_round_trips():
    G = SE3.exp(_t(_xi(6))).matrix3x4()
    np.testing.assert_array_equal(SE3.from_matrix3x4(G).matrix3x4().numpy(),
                                  G.numpy())
    G4 = SE3.from_matrix3x4(G).matrix()
    np.testing.assert_array_equal(SE3.from_matrix(G4).t.numpy(),
                                  G[..., 3].numpy())
    assert SE3.identity((2,)).matrix3x4().shape == (2, 3, 4)


def test_so3_matches():
    w = _xi(7)[..., 3:]
    j, t = JSO3.exp(jnp.asarray(w)), SO3.exp(_t(w))
    np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=TOL)
    np.testing.assert_allclose(t.log().numpy(), np.asarray(j.log()),
                               atol=1e-5)
    np.testing.assert_allclose((t @ t.inv()).R.numpy(),
                               np.broadcast_to(np.eye(3), (7, 3, 3)),
                               atol=5e-6)
    np.testing.assert_allclose(invrodrigues(rodrigues(_t(w))).numpy(), w,
                               atol=2e-4)
    assert SO3.identity((3,)).shape == (3,)
