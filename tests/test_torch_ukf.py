"""The port's manifold UKF and JUKF against the JAX package's, on the CPU,
float64: ``sigma_weights`` (exact), the filters on the linear systems of
``tests/test_ukf.py`` and ``tests/test_jukf.py`` and on a noisy
floating-base flight (states and covariances rtol 1e-9; the flight's
covariance entries that cancel to 1e-19 against a floor of 1e-12 of its
largest entry), and the four
tests of those files mirrored.

The JAX filters ``vmap`` their callbacks over the sigma points; the
port's callbacks take the sigma points as a leading batch dimension, so
the linear systems' ``f`` here multiplies by ``A`` on the right.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dair_pll_tpu import jukf as jjukf
from dair_pll_tpu import ukf as jukf_mod
from dair_pll_tpu.state_space import FloatingBaseSpace as JFloatingBaseSpace
from dair_pll_tpu_torch.jukf import JUKF
from dair_pll_tpu_torch.state_space import FloatingBaseSpace
from dair_pll_tpu_torch.ukf import (ManifoldUKF, sigma_weights,
                                    state_space_retractions)

RTOL = 1e-9


def close(got, want, atol=1e-15):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=atol)


@pytest.mark.parametrize("dim,alpha", [(2, 1.0), (12, 0.1), (18, 0.1),
                                       (3, 0.5)])
def test_sigma_weights_match_jax(dim, alpha):
    assert tuple(sigma_weights(dim, alpha)) == \
        tuple(jukf_mod.sigma_weights(dim, alpha))


def linear_system(d=3):
    A = np.diag([1.0, 0.95, 1.05])[:d, :d] + \
        0.1 * np.triu(np.ones((d, d)), 1)
    return A, 0.01 * np.eye(d), 0.1 * np.eye(d)


def port_linear(A, Q, R, d):
    At = torch.as_tensor(A)

    def f(state, omega, w, dt):
        return state @ At.T + w

    def add(x, xi):
        return x + xi

    def sub(x1, x2):
        return x2 - x1

    ukf = ManifoldUKF(f=f, h=lambda x: x, phi=add, phi_inv=sub,
                      Q=torch.as_tensor(Q), R=torch.as_tensor(R),
                      alpha=(1.0, 1.0, 1.0), d=d)
    jukf = JUKF(f=f, h=lambda x: x, phi=add, Q=torch.as_tensor(Q),
                alpha=(1.0,) * 5, d=d, red_idxs=tuple(range(d)),
                red_phi=add, red_phi_inv=sub, up_idxs=tuple(range(d)),
                up_phi=add)
    return ukf, jukf


def jax_linear(A, Q, R, d):
    Aj = jnp.asarray(A)

    def f(state, omega, w, dt):
        return Aj @ state + w

    def add(x, xi):
        return x + xi

    def sub(x1, x2):
        return x2 - x1

    ukf = jukf_mod.ManifoldUKF(f=f, h=lambda x: x, phi=add, phi_inv=sub,
                               Q=jnp.asarray(Q), R=jnp.asarray(R),
                               alpha=(1.0, 1.0, 1.0), d=d)
    jukf = jjukf.JUKF(f=f, h=lambda x: x, phi=add, Q=jnp.asarray(Q),
                      alpha=(1.0,) * 5, d=d, red_idxs=tuple(range(d)),
                      red_phi=add, red_phi_inv=sub, up_idxs=tuple(range(d)),
                      up_phi=add)
    return ukf, jukf


def test_filters_match_jax_on_the_linear_system(rng):
    d = 3
    A, Q, R = linear_system(d)
    ukf, jukf = port_linear(A, Q, R, d)
    j_ukf, j_jukf = jax_linear(A, Q, R, d)
    start = np.array([1.0, -0.5, 0.2])
    s_u = s_j = torch.as_tensor(start)
    P_u = P_j = torch.eye(d, dtype=torch.float64)
    js_u = js_j = jnp.asarray(start)
    jP_u = jP_j = jnp.eye(d)
    for _ in range(5):
        y = rng.standard_normal(d)
        s_u, P_u = ukf.step(s_u, P_u, None, torch.as_tensor(y), 0.1)
        s_j, P_j = jukf.step(s_j, P_j, None, torch.as_tensor(y),
                             torch.as_tensor(R), 0.1)
        js_u, jP_u = j_ukf.step(js_u, jP_u, None, jnp.asarray(y), 0.1)
        js_j, jP_j = j_jukf.step(js_j, jP_j, None, jnp.asarray(y),
                                 jnp.asarray(R), 0.1)
        close(s_u, js_u)
        close(P_u, jP_u)
        close(s_j, js_j)
        close(P_j, jP_j)


def flight(space_cls, rng, steps=30, dt=0.01):
    """A constant-velocity floating-base flight and its noisy copy, as
    numpy arrays (made with the port's maps)."""
    space = space_cls(0)
    v_true = torch.tensor([0.5, -0.3, 0.2, 1.0, 0.5, -0.2],
                          dtype=torch.float64)
    zero = space.zero_state(torch.float64)
    truth = [space.x(space.q(zero), v_true)]
    for _ in range(steps):
        q_next = space.euler_step(space.q(truth[-1]), v_true, dt)
        truth.append(space.x(q_next, v_true))
    truth = torch.stack(truth)
    noise = torch.as_tensor(0.05 * rng.standard_normal((steps + 1, 12)))
    return truth, space.shift_state(truth, noise)


def manifold_filters(dt=0.01):
    """The UKF of ``test_manifold_filtering_reduces_noise`` in both
    packages."""
    space, jspace = FloatingBaseSpace(0), JFloatingBaseSpace(0)
    d = 12
    Q, R = 1e-8 * np.eye(d), 1e-2 * np.eye(d)

    def make(sp, zero, batched):
        phi, phi_inv = state_space_retractions(sp)

        def f(state, omega, w, dt_inner):
            q, v = sp.q_v(state)
            return phi(sp.x(sp.euler_step(q, v, dt_inner), v), w)

        def h(state):
            # The port's maps take equal leading dimensions.
            return sp.state_difference(
                zero.expand_as(state) if batched else zero, state)
        return f, h, phi, phi_inv

    f, h, phi, phi_inv = make(space, space.zero_state(torch.float64), True)
    port = ManifoldUKF(f=f, h=h, phi=phi, phi_inv=phi_inv,
                       Q=torch.as_tensor(Q), R=torch.as_tensor(R),
                       alpha=(0.1, 0.1, 0.1), d=d)
    jf, jh, jphi, jphi_inv = make(jspace, jspace.zero_state(jnp.float64),
                                  False)
    ref = jukf_mod.ManifoldUKF(f=jf, h=jh, phi=jphi, phi_inv=jphi_inv,
                               Q=jnp.asarray(Q), R=jnp.asarray(R),
                               alpha=(0.1, 0.1, 0.1), d=d)
    return space, port, ref


def test_manifold_filter_matches_jax(rng):
    """``filter_trajectory`` over a noisy flight on SE(3): the loop
    against JAX's ``lax.scan``."""
    space, port, ref = manifold_filters()
    _, noisy = flight(FloatingBaseSpace, rng, steps=12)
    zero = space.zero_state(torch.float64).expand_as(noisy[1:])
    ys = space.state_difference(zero, noisy[1:])
    P0 = 0.01 * np.eye(12)
    states, Ps = port.filter_trajectory(noisy[0], torch.as_tensor(P0),
                                        torch.zeros((12, 1)), ys, 0.01)
    j_states, j_Ps = ref.filter_trajectory(
        jnp.asarray(noisy[0].numpy()), jnp.asarray(P0), jnp.zeros((12, 1)),
        jnp.asarray(ys.numpy()), 0.01)
    close(states, j_states, atol=1e-14)
    # Off-diagonal entries near 1e-19 are cancellations of 5e-3 terms: the
    # floor is 1e-12 of the covariance's scale.
    close(Ps, j_Ps, atol=1e-12 * float(np.abs(np.asarray(j_Ps)).max()))


# -- tests/test_ukf.py and tests/test_jukf.py, mirrored ---------------------------

def test_linear_system_matches_kalman(rng):
    """On a Euclidean linear system the UKF matches the exact KF."""
    d = 2
    A = np.array([[1.0, 0.1], [0.0, 1.0]])
    Q, R = 0.01 * np.eye(d), 0.1 * np.eye(d)
    At = torch.as_tensor(A)
    ukf = ManifoldUKF(
        f=lambda state, omega, w, dt: state @ At.T + w, h=lambda x: x,
        phi=lambda x, xi: x + xi, phi_inv=lambda x1, x2: x2 - x1,
        Q=torch.as_tensor(Q), R=torch.as_tensor(R), alpha=(1.0, 1.0, 1.0),
        d=d)
    state = torch.tensor([1.0, 0.0], dtype=torch.float64)
    P = torch.eye(d, dtype=torch.float64)
    kf_x, kf_P = np.array([1.0, 0.0]), np.eye(d)
    for _ in range(5):
        y = rng.standard_normal(d)
        state, P = ukf.step(state, P, None, torch.as_tensor(y), 0.1)
        kf_x = A @ kf_x
        kf_P = A @ kf_P @ A.T + Q
        S = kf_P + R
        K = kf_P @ np.linalg.inv(S)
        kf_x = kf_x + K @ (y - kf_x)
        kf_P = kf_P - K @ S @ K.T
        np.testing.assert_allclose(state.numpy(), kf_x, atol=1e-6)
        np.testing.assert_allclose(P.numpy(), kf_P, atol=1e-5)


def test_manifold_filtering_reduces_noise(rng):
    """Filtering a noisy constant-velocity floating-base flight gets
    closer to the truth than the raw measurements."""
    space, port, _ = manifold_filters()
    truth, noisy = flight(FloatingBaseSpace, rng)
    zero = space.zero_state(torch.float64).expand_as(noisy[1:])
    states, _ = port.filter_trajectory(
        noisy[0], 0.01 * torch.eye(12, dtype=torch.float64),
        torch.zeros((30, 1)), space.state_difference(zero, noisy[1:]), 0.01)
    err_filtered = float(torch.mean(space.state_square_error(
        states[10:], truth[1:][10:])))
    err_raw = float(torch.mean(space.state_square_error(
        noisy[1:][10:], truth[1:][10:])))
    assert err_filtered < err_raw


def test_jukf_matches_ukf_linear(rng):
    d = 3
    A, Q, R = linear_system(d)
    ukf, jukf = port_linear(A, Q, R, d)
    state_u = state_j = torch.tensor([1.0, -0.5, 0.2], dtype=torch.float64)
    P_u = P_j = torch.eye(d, dtype=torch.float64)
    for _ in range(5):
        y = torch.as_tensor(rng.standard_normal(d))
        state_u, P_u = ukf.step(state_u, P_u, None, y, 0.1)
        state_j, P_j = jukf.step(state_j, P_j, None, y, torch.as_tensor(R),
                                 0.1)
        np.testing.assert_allclose(state_j.numpy(), state_u.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(P_j.numpy(), P_u.numpy(), atol=1e-5)


def test_jukf_reduced_propagation():
    """With ``red_idxs`` a subset, F is the identity elsewhere; the
    propagated mean is the full dynamics; it matches JAX's."""
    A, Q, R = linear_system(3)
    _, jukf = port_linear(A, Q, R, 3)
    _, j_jukf = jax_linear(A, Q, R, 3)

    def red_phi(x, xi):
        out = x.clone()
        out[..., :2] = out[..., :2] + xi
        return out

    reduced = JUKF(f=jukf.f, h=jukf.h, phi=jukf.phi, Q=jukf.Q,
                   alpha=jukf.alpha, d=3, red_idxs=(0, 1), red_phi=red_phi,
                   red_phi_inv=lambda x1, x2: (x2 - x1)[..., :2],
                   up_idxs=(0, 1, 2), up_phi=jukf.up_phi)
    j_reduced = jjukf.JUKF(
        f=j_jukf.f, h=j_jukf.h, phi=j_jukf.phi, Q=j_jukf.Q,
        alpha=j_jukf.alpha, d=3, red_idxs=(0, 1),
        red_phi=lambda x, xi: x.at[:2].add(xi),
        red_phi_inv=lambda x1, x2: (x2 - x1)[:2], up_idxs=(0, 1, 2),
        up_phi=j_jukf.up_phi)
    state = torch.tensor([1.0, -0.5, 0.2], dtype=torch.float64)
    P = torch.eye(3, dtype=torch.float64)
    new_state, new_P = reduced.propagation(state, P, None, 0.1)
    assert torch.isfinite(new_P).all()
    np.testing.assert_allclose(
        new_state.numpy(),
        jukf.f(state, None, torch.zeros(3, dtype=torch.float64), 0.1).numpy(),
        atol=1e-12)
    want_state, want_P = j_reduced.propagation(jnp.asarray(state.numpy()),
                                               jnp.eye(3), None, 0.1)
    close(new_state, want_state)
    close(new_P, want_P)
