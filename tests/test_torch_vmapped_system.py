"""The port's vmapped system (``integrator.py``, ``system.py``,
``MultibodyLearnableSystem``'s vmapped path) against the JAX package's in
float64 on the cube: the vmapped ContactNets loss on its three routes
(the hybrid solve, ``solver="apgd"``, and the APGD kernel K6's route,
whose plain version runs on the CPU) with every leaf's gradient, three
Adam steps against ``optax.adam``, rollouts with and without
``warm_start``, the implicit-function-theorem gradient of an 8-step
rollout loss against ``jax.grad``, ``remat=True``, and the route rules.

The JAX package's K6 route cannot run on the CPU (its
``contactnets_loss_batch(use_pallas=True)`` calls the TPU kernel without
``interpret``), so its reference is put together here from the same
three pieces: ``jax.vmap(system._contactnets_qp)``, the kernel's wrapper
in interpret mode on the detached QPs, and
``jax.vmap(system._contactnets_loss_given_force)``.

Bars: loss rtol 1e-9 (``tests/test_fused_kernel.py``),
gradients rtol 1e-6 (``tests/test_fused_kernel.py``), rollouts atol 1e-7
(``tests/test_multibody.py``), rollout gradients rtol 1e-6, parameters
after each Adam step atol 1e-8.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dair_pll_tpu.ops.pallas_cone_solver import solve_contact_impulse_pallas
from dair_pll_tpu_torch.multibody import learnable_system
from dair_pll_tpu_torch.multibody.learnable_system import (
    FUSED_LOSS_MIN_BATCH, LOSS_EPSILON, SOLVER_ITERATIONS)
from dair_pll_tpu_torch.multibody.model import params_from_numpy
from dair_pll_tpu_torch.ops import cone_kernels
from torch_parity import (cube_transitions, jax_params, model_pair,
                          params_numpy, perturbed_params, random_states)

LOSS_RTOL, LOSS_ATOL = 1e-9, 1e-13
GRAD_RTOL = 1e-6
ROLLOUT_ATOL = 1e-7
PARAM_ATOL = 1e-8
LR = 1e-3
ROUTES = ("hybrid", "apgd", "apgd_kernel")
STEPS = 8


@functools.lru_cache(maxsize=None)
def _systems(solver="hybrid", warm_start=False):
    return model_pair("cube", solver=solver, warm_start=warm_start)


@functools.lru_cache(maxsize=None)
def _inputs():
    """Perturbed parameters (numpy) and 8 transitions, half in contact."""
    jsystem, _ = _systems()
    rng = np.random.default_rng(31)
    numpy_params = perturbed_params(
        rng, *params_numpy(jsystem.model.initial_params(jnp.float64)))
    x, x_plus = cube_transitions(rng, 4)
    return numpy_params, x, x_plus


@functools.lru_cache(maxsize=None)
def _jax_loss_fn(route):
    """The JAX package's mean vmapped loss of ``route``, jitted with its
    gradient."""
    jsystem, _ = _systems("apgd" if route == "apgd" else "hybrid")

    def loss(params, x, x_plus):
        u = jnp.zeros((x.shape[0], 0))
        if route != "apgd_kernel":
            return jnp.mean(jsystem.contactnets_loss_batch(
                params, x, u, x_plus, use_fused=False))
        D, q_vec, M, _, phi, dv = jax.vmap(
            lambda a, b, c: jsystem._contactnets_qp(params, a, b, c))(
                x, u, x_plus)
        force, valid = solve_contact_impulse_pallas(
            jax.lax.stop_gradient(D), jax.lax.stop_gradient(q_vec),
            LOSS_EPSILON, SOLVER_ITERATIONS, True)
        return jnp.mean(jax.vmap(jsystem._contactnets_loss_given_force)(
            D, q_vec, M, phi, dv, jax.lax.stop_gradient(force), valid))
    return jax.jit(jax.value_and_grad(loss))


@functools.lru_cache(maxsize=None)
def _jax_loss(route):
    numpy_params, x, x_plus = _inputs()
    value, grads = _jax_loss_fn(route)(jax_params(numpy_params),
                                       jnp.asarray(x), jnp.asarray(x_plus))
    return float(value), [np.asarray(g) for g in
                          jax.tree_util.tree_leaves(grads)]


def _port_loss(system, params, x, x_plus, **kwargs):
    leaves = params.parameters()
    for leaf in leaves:
        leaf.requires_grad_(True)
        leaf.grad = None
    loss = torch.mean(system.contactnets_loss_batch(
        params, torch.tensor(x), torch.zeros(x.shape[0], 0),
        torch.tensor(x_plus), **kwargs))
    loss.backward()
    return loss.item(), [leaf.grad.numpy().copy() for leaf in leaves]


@pytest.mark.parametrize("route", ROUTES)
def test_vmapped_loss_matches_jax(route):
    """The mean vmapped loss and every leaf's gradient on each route; K6's
    route runs its plain version here and counts no launch."""
    numpy_params, x, x_plus = _inputs()
    _, tsystem = _systems("apgd" if route == "apgd" else "hybrid")
    params = params_from_numpy(tsystem.model, *numpy_params)
    kwargs = {"use_apgd_kernel": True} if route == "apgd_kernel" else {}
    before = cone_kernels.solve_cone_qp_cuda.launches
    value, grads = _port_loss(tsystem, params, x, x_plus, **kwargs)
    assert cone_kernels.solve_cone_qp_cuda.launches == before
    want_value, want_grads = _jax_loss(route)
    np.testing.assert_allclose(value, want_value, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    assert len(grads) == len(want_grads) == 3
    for got, want in zip(grads, want_grads):
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.max(np.abs(want)))
    assert want_value > 0.0


def test_adam_steps_match_optax():
    """Three Adam steps on the vmapped (hybrid) loss: the loss, every
    leaf's gradient and every leaf after each step."""
    numpy_params, x, x_plus = _inputs()
    value_and_grad = _jax_loss_fn("hybrid")
    jparams = jax_params(numpy_params)
    optimizer = optax.adam(LR)
    state = optimizer.init(jparams)
    _, tsystem = _systems()
    params = params_from_numpy(tsystem.model, *numpy_params)
    leaves = params.parameters()
    torch_adam = torch.optim.Adam(leaves, lr=LR)
    for _ in range(3):
        value, grads = value_and_grad(jparams, jnp.asarray(x),
                                      jnp.asarray(x_plus))
        updates, state = optimizer.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        got_value, got_grads = _port_loss(tsystem, params, x, x_plus)
        torch_adam.step()
        np.testing.assert_allclose(got_value, float(value), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
        for got, want, after, want_after in zip(
                got_grads, jax.tree_util.tree_leaves(grads), leaves,
                jax.tree_util.tree_leaves(jparams)):
            want = np.asarray(want)
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                       atol=GRAD_RTOL * np.max(np.abs(want)))
            np.testing.assert_allclose(after.detach().numpy(),
                                       np.asarray(want_after), rtol=0,
                                       atol=PARAM_ATOL)


@functools.lru_cache(maxsize=None)
def _rollout_inputs():
    jsystem, _ = _systems()
    rng = np.random.default_rng(32)
    return random_states("cube", jsystem.model, rng, 4)


@functools.lru_cache(maxsize=None)
def _jax_rollout(warm_start=False):
    """The JAX package's vmapped rollout of STEPS steps, jitted."""
    jsystem, _ = _systems(warm_start=warm_start)
    return jax.jit(lambda p, x: jsystem.simulate_batch(p, x, STEPS,
                                                       use_fused=False))


@pytest.mark.parametrize("warm_start", [False, True])
def test_vmapped_rollout_matches_jax(warm_start):
    """``simulate_batch(use_fused=False)``, 4 trajectories x 8 steps from
    states near the ground, at perturbed parameters."""
    numpy_params, _, _ = _inputs()
    x0 = _rollout_inputs()
    _, tsystem = _systems(warm_start=warm_start)
    want = np.asarray(_jax_rollout(warm_start)(jax_params(numpy_params),
                                               jnp.asarray(x0)))
    params = params_from_numpy(tsystem.model, *numpy_params)
    with torch.no_grad():
        got = tsystem.simulate_batch(params, torch.tensor(x0), STEPS,
                                     use_fused=False)
    assert got.shape == want.shape == (4, STEPS + 1, 13)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ROLLOUT_ATOL)
    # The trajectories reach contact.
    assert np.min(want[:, :, 6]) < 0.06


def _velocity_mse(trajectory, target):
    return ((trajectory[:, 1:, 7:] - target[:, 1:, 7:]) ** 2).mean()


def test_rollout_gradient_matches_jax():
    """The gradient of a velocity-MSE prediction loss over an 8-step
    vmapped rollout (the IFT backward of every step's hybrid solve) for
    every leaf, against ``jax.grad`` through the JAX custom VJPs; the
    target is the rollout at the initial parameters."""
    numpy_params, _, _ = _inputs()
    x0 = _rollout_inputs()
    jsystem, tsystem = _systems()
    target = np.asarray(_jax_rollout()(
        jsystem.model.initial_params(jnp.float64), jnp.asarray(x0)))
    want = jax.tree_util.tree_leaves(jax.jit(jax.grad(
        lambda p: _velocity_mse(jsystem.simulate_batch(
            p, jnp.asarray(x0), STEPS, use_fused=False), target)))(
                jax_params(numpy_params)))
    params = params_from_numpy(tsystem.model, *numpy_params)
    leaves = params.parameters()
    for leaf in leaves:
        leaf.requires_grad_(True)
    _velocity_mse(tsystem.simulate_batch(params, torch.tensor(x0), STEPS),
                  torch.tensor(target)).backward()
    for leaf, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.max(np.abs(w)))
        assert np.any(w != 0.0)


def test_remat_gives_the_same_gradient():
    """``System.simulate(remat=True)`` recomputes each step in the
    backward pass: the same trajectory and gradient."""
    numpy_params, _, _ = _inputs()
    x0 = torch.tensor(_rollout_inputs()[:2])
    _, tsystem = _systems()
    results = []
    for remat in (False, True):
        params = params_from_numpy(tsystem.model, *numpy_params)
        leaves = params.parameters()
        for leaf in leaves:
            leaf.requires_grad_(True)
        trajectory = tsystem.simulate(params, x0, 4, remat=remat)
        (trajectory[:, 1:, 7:] ** 2).sum().backward()
        results.append([trajectory.detach()] + [leaf.grad for leaf in leaves])
    for plain, remat in zip(*results):
        assert torch.equal(plain, remat)


class _Reached(Exception):
    """Raised by a stand-in to show a route reached it."""


def _stand_in(name, seen):
    def stand_in(*args, **kwargs):
        seen.append((name, args, kwargs))
        raise _Reached(name)
    return stand_in


@pytest.mark.parametrize("solver", ["hybrid", "apgd"])
def test_loss_route_rules(monkeypatch, solver):
    """The routes of ``contactnets_loss_batch``, as the JAX package's:
    from ``FUSED_LOSS_MIN_BATCH`` transitions the fused path for the
    hybrid solver unless ``use_apgd_kernel`` is given; any explicit
    ``use_apgd_kernel`` keeps the vmapped path; ``use_fused=True`` ignores
    it; the K6 route solves detached inputs at ``solver_iterations``,
    whatever the solver; ``solver="apgd"`` has no fused path, and the warm
    loss is fused only."""
    seen = []
    monkeypatch.setattr(learnable_system, "soa_contactnets_loss",
                        _stand_in("fused", seen))
    for name in ("solve_contact_impulse_cuda",
                 "solve_contact_impulse_hybrid", "solve_contact_impulse"):
        monkeypatch.setattr(learnable_system, name, _stand_in(name, seen))
    _, system = _systems(solver)
    system = type(system)(system.model, system.dt, solver=solver,
                          solver_iterations=37, device="cpu")
    params = system.initial_params(torch.float64)
    for leaf in params.parameters():
        leaf.requires_grad_(True)
    x = torch.tensor(random_states("cube", system.model,
                                   np.random.default_rng(33),
                                   FUSED_LOSS_MIN_BATCH))
    u = x.new_zeros((x.shape[0], 0))
    vmapped = ("solve_contact_impulse_hybrid" if solver == "hybrid"
               else "solve_contact_impulse")
    cases = [({}, "fused" if solver == "hybrid" else vmapped),
             ({"use_apgd_kernel": False}, vmapped),
             ({"use_apgd_kernel": True}, "solve_contact_impulse_cuda"),
             ({"use_fused": False}, vmapped)]
    if solver == "hybrid":
        cases.append(({"use_fused": True, "use_apgd_kernel": True}, "fused"))
    for kwargs, route in cases:
        seen.clear()
        with pytest.raises(_Reached, match=route):
            system.contactnets_loss_batch(params, x, u, x, **kwargs)
        name, args, call_kwargs = seen[0]
        if name == "solve_contact_impulse_cuda":
            assert args[2] == LOSS_EPSILON and args[3] == 37
        if name != "fused":
            assert not any(isinstance(a, torch.Tensor) and a.requires_grad
                           for a in args)
    if solver == "apgd":
        with pytest.raises(ValueError, match="fused"):
            system.contactnets_loss_batch(params, x, u, x, use_fused=True)
        with pytest.raises(ValueError, match="fused"):
            system.contactnets_loss_batch_warm(
                params, x, u, x, x.new_zeros((3, 4, x.shape[0])))
