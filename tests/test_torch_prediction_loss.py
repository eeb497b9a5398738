"""The prediction-loss hazards of the port's structured cube, on the CPU,
float64 (the residual and the deep baselines train through this loss):
``tests/test_resting_contact_gradients.py`` (finite gradients at rest and
under pure normal motion; training on noiseless resting data stays finite)
and ``tests/test_long_horizon.py::
test_multistep_prediction_training_decreases_loss`` mirrored. The remat
tests of that file are held in ``tests/test_torch_vmapped_system.py``.
"""
import numpy as np
import pytest
import torch

from dair_pll_tpu_torch.assets import get_asset
from dair_pll_tpu_torch.multibody.learnable_system import (
    MultibodyLearnableSystem)


def cube(dt, solver_iterations):
    system = MultibodyLearnableSystem.from_urdfs(
        {"cube": get_asset("cube")}, dt, solver_iterations=solver_iterations,
        mesh_representation="polygon", device="cpu")
    return system, system.initial_params(torch.float64)


def trainable(params):
    params = params.map(lambda leaf: leaf.detach().clone())
    for leaf in params.parameters():
        leaf.requires_grad_(True)
    return params


def assert_finite_gradients(params):
    for leaf in params.parameters():
        if leaf.grad is not None:
            assert torch.isfinite(leaf.grad).all(), "NaN gradient"


@pytest.fixture(scope="module")
def resting_cube():
    return cube(0.0068, 80)


def test_gradient_finite_at_rest(resting_cube):
    """An exactly resting transition (all velocities zero, on the
    plane)."""
    system, params = resting_cube
    params = trainable(params)
    x_rest = torch.tensor([1.0, 0, 0, 0, 0, 0, 0.0524] + [0.0] * 6,
                          dtype=torch.float64)
    loss = system.contactnets_loss(params, x_rest, x_rest.new_zeros(0),
                                   x_rest)
    assert torch.isfinite(loss)
    loss.backward()
    assert_finite_gradients(params)


def test_gradient_finite_pure_normal_motion(resting_cube):
    """Zero tangential but nonzero normal velocity."""
    system, params = resting_cube
    params = trainable(params)
    x = torch.tensor([1.0, 0, 0, 0, 0, 0, 0.06, 0, 0, 0, 0, 0, -0.3],
                     dtype=torch.float64)
    x_plus = torch.tensor([1.0, 0, 0, 0, 0, 0, 0.058, 0, 0, 0, 0, 0, -0.28],
                          dtype=torch.float64)
    system.contactnets_loss(params, x, x.new_zeros(0), x_plus).backward()
    assert_finite_gradients(params)


def test_training_on_noiseless_resting_data_stays_finite(resting_cube):
    """Adam on self-consistent data with a long resting tail keeps the
    parameters finite (the failure that found the resting hazard)."""
    system, params = resting_cube
    x0 = torch.tensor([1.0, 0, 0, 0, 0, 0, 0.08, 0.5, 0.2, 0, 0.2, 0, -0.1],
                      dtype=torch.float64)
    with torch.no_grad():
        trajectory = system.simulate(params, x0, 60)   # settles to rest
    xs, xps = trajectory[:-1], trajectory[1:]
    us = xs.new_zeros((xs.shape[0], 0))
    params = trainable(params)
    optimizer = torch.optim.Adam(params.parameters(), lr=1e-3)
    for _ in range(25):
        optimizer.zero_grad()
        loss = torch.mean(system.contactnets_loss_batch(params, xs, us, xps))
        loss.backward()
        optimizer.step()
    for leaf in params.parameters():
        assert torch.isfinite(leaf).all(), "training diverged on rest"
    assert torch.isfinite(loss)


def test_multistep_prediction_training_decreases_loss():
    """An 8-step prediction loss through the rollout learns a perturbed
    friction back: Adam at 2e-2 takes the loss under half its start
    within 30 steps (the JAX package's recipe; both packages stall for 13
    steps with the friction too high to slide, then fall). The loop stops
    at the first loss under half, to bound the test's time; without remat
    (its gradients equal remat's, ``tests/test_torch_vmapped_system.py``)."""
    system, params = cube(0.005, 60)
    space = system.space
    x0s = torch.tensor(np.stack([
        [1.0, 0, 0, 0, 0, 0, 0.0524, 0, 0, 0, 1.0, 0.3, 0.0],
        [1.0, 0, 0, 0, 0, 0, 0.0524, 0, 0, 0, -0.8, 0.5, 0.0]]))
    with torch.no_grad():
        target = system.simulate(params, x0s, 8)
    wrong = params.map(lambda leaf: leaf.detach().clone())
    wrong.friction.mul_(2.5)
    wrong = trainable(wrong)
    optimizer = torch.optim.Adam(wrong.parameters(), lr=2e-2)

    def loss_fn():
        predicted = system.simulate(wrong, x0s, 8)
        return torch.mean((space.v(predicted) - space.v(target)) ** 2)

    losses = []
    for _ in range(30):
        optimizer.zero_grad()
        loss = loss_fn()
        losses.append(float(loss.detach()))
        if losses[-1] < 0.5 * losses[0]:
            break
        loss.backward()
        optimizer.step()
    assert losses[-1] < 0.5 * losses[0], losses
