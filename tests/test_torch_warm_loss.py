"""The port's epoch-warm ContactNets loss and its training step against the
JAX package's, float64, on the cube, as ``bench.py`` trains: a cold step
(the (10, 10) solve) at parameters perturbed by
``torch_parity.perturbed_params``; the seed of the impulse cache, the warm
call from zeros at the cold budget (10, 10); then two epoch-warm steps at
(4, 10) from the cache. Each step is followed by Adam at lr 1e-3
(``torch.optim.Adam`` against ``optax.adam``).

The seeded cache matches JAX to 1e-8. The first warm step is the
warm-loss parity check: its per-sample loss
(rtol 1e-8, atol 1e-12), its refreshed cache (1e-8) and its gradients with
respect to the parameters, ``x`` and ``x_plus`` (rtol 1e-6, atol 1e-9)
match JAX. Every step's parameter gradient matches to rtol 1e-6, atol
1e-9, and the parameters after every step to atol 1e-8.

The JAX side runs eagerly (``jax.disable_jit``), as in
``test_torch_loss.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from dair_pll_tpu import assets as jassets
from dair_pll_tpu.multibody.learnable_system import (
    MultibodyLearnableSystem as JSystem)
from dair_pll_tpu.urdf import build_multibody_model as jbuild
from dair_pll_tpu_torch import assets as tassets
from dair_pll_tpu_torch.multibody.learnable_system import (
    DEFAULT_LOSS_IPM_ITERATIONS, DEFAULT_LOSS_NEWTON_ITERATIONS,
    DEFAULT_LOSS_WARM_BUDGET, MultibodyLearnableSystem as TSystem)
from dair_pll_tpu_torch.multibody.model import params_from_numpy
from torch_parity import (DT, cube_transitions, jax_params, params_numpy,
                          perturbed_params)

LOSS_RTOL, LOSS_ATOL = 1e-8, 1e-12
FORCE_TOL = 1e-8
GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-9
PARAM_ATOL = 1e-8
LR = 1e-3
COLD_BUDGET = (DEFAULT_LOSS_IPM_ITERATIONS, DEFAULT_LOSS_NEWTON_ITERATIONS)


def _leaves(params):
    """JAX parameters -> ``(theta, friction, half_lengths)`` numpy, the
    order of the port's ``MultibodyParams.parameters()``."""
    return [np.asarray(params.theta), np.asarray(params.friction),
            np.asarray(params.geometry[1]["half_lengths"])]


@functools.lru_cache(maxsize=None)
def _reference():
    """The JAX training run: per step the loss, the gradients and the
    parameters after Adam; for the first warm step also the per-sample
    loss, the refreshed cache and the state gradients."""
    jmodel = jbuild({"cube": jassets.get_asset("cube")})
    system = JSystem(jmodel, DT)
    rng = np.random.default_rng(31)
    x, x_plus = (jnp.asarray(t) for t in cube_transitions(rng))
    u = jnp.zeros((x.shape[0], 0))
    numpy_params = perturbed_params(
        rng, *params_numpy(jmodel.initial_params(jnp.float64)))
    params = jax_params(numpy_params)

    def cold(p):
        return jnp.mean(system.contactnets_loss_batch(p, x, u, x_plus,
                                                      use_fused=True))

    def warm(p, xx, xxp, cache):
        loss, new_cache = system.contactnets_loss_batch_warm(
            p, xx, u, xxp, cache)
        return jnp.mean(loss), (loss, new_cache)

    optimizer = optax.adam(LR)
    state = optimizer.init(params)
    steps = []
    with jax.disable_jit():
        for step in range(3):
            if step == 0:
                loss, grads = jax.value_and_grad(cold)(params)
            elif step == 1:
                (loss, (per_sample, cache)), (grads, gx, gxp) = \
                    jax.value_and_grad(warm, argnums=(0, 1, 2),
                                       has_aux=True)(params, x, x_plus,
                                                     cache)
                record.update(loss=np.asarray(per_sample),
                              cache=np.asarray(cache), gx=np.asarray(gx),
                              gxp=np.asarray(gxp))
            else:
                (loss, (_, cache)), grads = jax.value_and_grad(
                    warm, has_aux=True)(params, x, x_plus, cache)
            updates, state = optimizer.update(grads, state, params)
            params = optax.apply_updates(params, updates)
            steps.append({"loss": float(loss), "grads": _leaves(grads),
                          "params": _leaves(params)})
            if step == 0:
                # The seed, as bench.py takes it: the warm call from zeros
                # at the cold budget, at the parameters the cold step left.
                _, cache = system.contactnets_loss_batch_warm(
                    params, x, u, x_plus,
                    jnp.zeros((3, jmodel.n_contacts, x.shape[0])),
                    budget=COLD_BUDGET)
                record = {"seed": np.asarray(cache)}
    return np.asarray(x), np.asarray(x_plus), numpy_params, steps, record


def _port_run():
    """The port's three training steps on the CPU: ``(steps, record)``
    as in :func:`_reference`, plus the cache check's tensors."""
    x, x_plus, numpy_params, _, _ = _reference()
    system = TSystem.from_urdfs({"cube": tassets.get_asset("cube")}, DT,
                                device="cpu")
    params = params_from_numpy(system.model, *numpy_params)
    leaves = params.parameters()
    for leaf in leaves:
        leaf.requires_grad_(True)
    optimizer = torch.optim.Adam(leaves, lr=LR)
    u = torch.zeros(x.shape[0], 0, dtype=torch.float64)
    steps, record = [], {}
    cache = None
    for step in range(3):
        xt = torch.tensor(x, requires_grad=True)
        xpt = torch.tensor(x_plus, requires_grad=True)
        optimizer.zero_grad()
        if step == 0:
            loss = system.contactnets_loss_batch(params, xt, u, xpt,
                                                 use_fused=True)
        else:
            cache_in = cache.clone().requires_grad_(True)
            loss, cache = system.contactnets_loss_batch_warm(
                params, xt, u, xpt, cache_in)
        torch.mean(loss).backward()
        if step == 1:
            record.update(loss=loss.detach().numpy(), cache=cache.numpy(),
                          gx=xt.grad.numpy(), gxp=xpt.grad.numpy(),
                          cache_requires_grad=cache.requires_grad,
                          cache_in_grad=cache_in.grad)
        grads = [leaf.grad.numpy().copy() for leaf in leaves]
        optimizer.step()
        steps.append({"loss": float(torch.mean(loss.detach())),
                      "grads": grads,
                      "params": [leaf.detach().numpy().copy()
                                 for leaf in leaves]})
        if step == 0:
            with torch.no_grad():
                _, cache = system.contactnets_loss_batch_warm(
                    params, torch.tensor(x), u, torch.tensor(x_plus),
                    torch.zeros(3, system.model.n_contacts, x.shape[0],
                                dtype=torch.float64),
                    budget=COLD_BUDGET)
            record = {"seed": cache.numpy()}
    return steps, record


@functools.lru_cache(maxsize=None)
def _port():
    return _port_run()


def test_warm_budget():
    assert DEFAULT_LOSS_WARM_BUDGET == (4, 10)


def test_warm_loss_matches_jax():
    """The first warm step: (4, 10) from the cache the cold solve filled
    at the perturbed parameters, evaluated one Adam step later."""
    _, _, _, _, ref = _reference()
    _, got = _port()
    np.testing.assert_allclose(got["seed"], ref["seed"], rtol=FORCE_TOL,
                               atol=FORCE_TOL)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(got["cache"], ref["cache"], rtol=FORCE_TOL,
                               atol=FORCE_TOL)
    np.testing.assert_allclose(got["gx"], ref["gx"], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(got["gxp"], ref["gxp"], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    # The warm samples did move off the cold impulses.
    assert np.max(np.abs(ref["cache"])) > 1e-6


def test_cache_gets_no_gradient():
    _, got = _port()
    assert not got["cache_requires_grad"]
    assert got["cache_in_grad"] is None


def test_training_steps_match_optax():
    _, _, _, ref_steps, _ = _reference()
    steps, _ = _port()
    assert len(steps) == len(ref_steps) == 3
    for got, ref in zip(steps, ref_steps):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
        for g, r in zip(got["grads"], ref["grads"]):
            np.testing.assert_allclose(g, r, rtol=GRAD_RTOL, atol=GRAD_ATOL)
        for g, r in zip(got["params"], ref["params"]):
            np.testing.assert_allclose(g, r, rtol=0, atol=PARAM_ATOL)
    # Adam moved every parameter on the first step.
    _, _, numpy_params, _, _ = _reference()
    start = [numpy_params[0], numpy_params[1],
             numpy_params[2][1]["half_lengths"]]
    for after, before in zip(steps[0]["params"], start):
        assert np.all(after != before)
