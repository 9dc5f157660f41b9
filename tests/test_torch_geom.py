"""The rest of the port's geometry (visma_tpu_torch.geom: the constant
Jacobians, the product derivatives, Rodrigues and its log with analytic
Jacobians, the SO(3) projection, SO3.fit, SE3.from_Rt / translation)
against the JAX reference on the CPU: the same seeded numpy inputs through
both, float32. Tolerances: 0 for the constant matrices and the Kronecker
products (the same entries), 1e-6 for the closed forms, 1e-5 where an
arccos near 1 or a forward-mode derivative (`torch.func.jacfwd`) meets
them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from visma_tpu import geom as J
from visma_tpu_torch import geom as T

TOL = 1e-6
SMALL = 0.3 * T.rotations.SMALL_ANGLE   # below the small-angle branch


def _t(x):
    return torch.as_tensor(np.array(x))


def _rng(seed):
    return np.random.default_rng(seed)


def _axis_angles(seed, n=6):
    """Seeded axis-angles: n of norm 0.1-2.5, one below SMALL_ANGLE, one
    zero."""
    rng = _rng(seed)
    w = rng.normal(size=(n, 3))
    w *= rng.uniform(0.1, 2.5, (n, 1)) / np.linalg.norm(w, axis=1,
                                                        keepdims=True)
    tiny = rng.normal(size=(1, 3))
    tiny *= SMALL / np.linalg.norm(tiny)
    return np.concatenate([w, tiny, np.zeros((1, 3))]).astype(np.float32)


def test_constant_jacobians_equal_reference():
    np.testing.assert_array_equal(T.dhat().numpy(), np.asarray(J.dhat()))
    np.testing.assert_array_equal(T.dvee().numpy(), np.asarray(J.dvee()))
    for n, m in ((3, 3), (2, 4), (4, 1)):
        np.testing.assert_array_equal(T.dAt_dA(n, m).numpy(),
                                      np.asarray(J.dAt_dA(n, m)))


def test_constant_jacobians_against_jacfwd():
    w = _t(_axis_angles(0)[0])
    np.testing.assert_allclose(
        T.dhat().numpy(),
        jacfwd(lambda x: T.hat(x).reshape(9))(w).numpy(), atol=0)
    R = _t(_rng(1).normal(size=(3, 3)).astype(np.float32))
    np.testing.assert_allclose(
        T.dvee().numpy(),
        jacfwd(lambda x: T.vee(x.reshape(3, 3)))(R.reshape(9)).numpy(),
        atol=0)
    A = _t(_rng(2).normal(size=(2, 4)).astype(np.float32))
    np.testing.assert_allclose(
        T.dAt_dA(2, 4).numpy(),
        jacfwd(lambda x: x.reshape(2, 4).T.reshape(8))(A.reshape(8)).numpy(),
        atol=0)


@pytest.mark.parametrize("shapes", [((3, 3), (3, 3)), ((2, 3), (3, 4))])
def test_product_jacobians(shapes):
    rng = _rng(3)
    A = rng.normal(size=shapes[0]).astype(np.float32)
    B = rng.normal(size=shapes[1]).astype(np.float32)
    for name in ("dAB_dA", "dAB_dB"):
        np.testing.assert_array_equal(
            getattr(T, name)(_t(A), _t(B)).numpy(),
            np.asarray(getattr(J, name)(jnp.asarray(A), jnp.asarray(B))))
    N, M = shapes[0]
    P = shapes[1][1]
    tA, tB = _t(A), _t(B)
    np.testing.assert_allclose(
        T.dAB_dA(tA, tB).numpy(),
        jacfwd(lambda x: (x.reshape(N, M) @ tB).reshape(-1))(
            tA.reshape(-1)).numpy(), atol=TOL)
    np.testing.assert_allclose(
        T.dAB_dB(tA, tB).numpy(),
        jacfwd(lambda x: (tA @ x.reshape(M, P)).reshape(-1))(
            tB.reshape(-1)).numpy(), atol=TOL)


@pytest.mark.parametrize("i", range(8))
def test_rodrigues_jac_matches_reference_and_jacfwd(i):
    """Each seeded axis-angle, the one below SMALL_ANGLE (R = I + hat(w),
    J = dhat) and zero included."""
    w = _axis_angles(4)[i]
    R, Jw = T.rodrigues_jac(_t(w))
    Rj, Jj = J.rodrigues_jac(jnp.asarray(w))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=TOL)
    np.testing.assert_allclose(Jw.numpy(), np.asarray(Jj), atol=TOL)
    np.testing.assert_allclose(R.numpy(), T.rodrigues(_t(w)).numpy(),
                               atol=TOL)
    auto = jacfwd(lambda x: T.rodrigues(x).reshape(9))(_t(w))
    np.testing.assert_allclose(Jw.numpy(), auto.numpy(), atol=1e-5)
    if i >= 6:
        np.testing.assert_array_equal(Jw.numpy(), T.dhat().numpy())


@pytest.mark.parametrize("i", range(8))
def test_invrodrigues_jac_matches_reference_and_jacfwd(i):
    """The log map with its analytic 3x9 Jacobian, at the rotations of the
    seeded axis-angles (angles up to 2.5 rad, one below SMALL_ANGLE, zero)."""
    w = _axis_angles(5)[i]
    R = np.asarray(J.rodrigues(jnp.asarray(w)))
    wt, Jt = T.invrodrigues_jac(_t(R))
    wj, Jj = J.invrodrigues_jac(jnp.asarray(R))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-5)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), atol=1e-5)
    np.testing.assert_allclose(wt.numpy(), T.invrodrigues(_t(R)).numpy(),
                               atol=TOL)
    if i < 6:
        # away from the identity: the analytic form against forward mode
        # (on the small branch both are the first-order vee(R)/2 limit,
        # which jacfwd sees through the clamp as zero)
        auto = jacfwd(lambda x: T.invrodrigues(x.reshape(3, 3)))(
            _t(R).reshape(9))
        np.testing.assert_allclose(Jt.numpy(), auto.numpy(), atol=1e-5)
    else:
        # at the identity the Jacobian is the first-order dvee / 2 (the
        # float32 trace of I + hat(w) is 3, so tmp = 1 is not above
        # 1 - SMALL_TRACE = 1: the big branch's limit, in both packages)
        np.testing.assert_allclose(Jt.numpy(), 0.5 * T.dvee().numpy(),
                                   atol=TOL)


def test_jacobians_vmap_over_a_batch():
    w = _axis_angles(6)
    R, Jw = vmap(T.rodrigues_jac)(_t(w))
    for k in range(len(w)):
        Rk, Jk = T.rodrigues_jac(_t(w[k]))
        np.testing.assert_allclose(Jw[k].numpy(), Jk.numpy(), atol=TOL)
    _, Jl = vmap(T.invrodrigues_jac)(R)
    assert Jl.shape == (len(w), 3, 9) and torch.isfinite(Jl).all()


def test_project_so3_and_fit():
    """Noisy rotations, a reflection (negative determinant) and a batch:
    the same proper rotations as the reference's SVD projection."""
    rng = _rng(7)
    R = np.asarray(J.rodrigues(jnp.asarray(_axis_angles(7))))
    noisy = (R + 0.05 * rng.normal(size=R.shape)).astype(np.float32)
    refl = noisy.copy()
    refl[2, :, 0] *= -1.0                       # det < 0
    assert np.linalg.det(refl[2]) < 0
    for M in (noisy, refl):
        got = T.project_so3(_t(M)).numpy()
        ref = np.asarray(J.project_so3(jnp.asarray(M)))
        np.testing.assert_allclose(got, ref, atol=1e-5)
        np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)
        np.testing.assert_allclose(got @ got.transpose(0, 2, 1),
                                   np.broadcast_to(np.eye(3), got.shape),
                                   atol=1e-5)
    np.testing.assert_allclose(T.SO3.fit(_t(refl)).R.numpy(),
                               np.asarray(J.SO3.fit(jnp.asarray(refl)).R),
                               atol=1e-5)


def test_se3_from_rt_and_translation():
    rng = _rng(8)
    R = np.asarray(J.rodrigues(jnp.asarray(_axis_angles(8)[:3])))
    t = rng.normal(size=(3, 3)).astype(np.float32)
    for rot in (_t(R), T.SO3(_t(R))):
        g = T.SE3.from_Rt(rot, _t(t))
        j = J.SE3.from_Rt(jnp.asarray(R), jnp.asarray(t))
        np.testing.assert_array_equal(g.matrix3x4().numpy(),
                                      np.asarray(j.matrix3x4()))
        np.testing.assert_array_equal(g.translation.numpy(),
                                      np.asarray(j.translation))
