"""The port's fused cube rollout (``MultibodyLearnableSystem.
simulate_batch(use_fused=True)`` of ``dair_pll_tpu_torch``) against the
JAX package's, at float64, at initial and perturbed parameters carried
across, to atol 1e-7 (the bar of the JAX package's own fused-vs-vmapped
rollout test); an float32 run against the float64 run; and the port's
import isolation from JAX."""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dair_pll_tpu import assets as jassets
from dair_pll_tpu.multibody.learnable_system import (
    MultibodyLearnableSystem as JSystem)
from dair_pll_tpu.multibody.model import MultibodyParams as JParams
from dair_pll_tpu.urdf import build_multibody_model as jbuild
from dair_pll_tpu_torch import assets as tassets
from dair_pll_tpu_torch.multibody import learnable_system
from dair_pll_tpu_torch.multibody.learnable_system import (
    MultibodyLearnableSystem as TSystem)
from dair_pll_tpu_torch.assets import cube_states_near_ground
from dair_pll_tpu_torch.multibody.model import params_from_numpy
from torch_parity import DT, params_numpy, perturbed_params

B = 16
STEPS = 10
ATOL = 1e-7
#: float32 against float64, one step at a time. Whole float32 rollouts
#: part from float64 ones within a few steps near contact, in the JAX
#: package as in the port (contact solves at eps = 1e-4 amplify float32
#: rounding by the inverse regularization, and impacts make the
#: trajectories chaotic), so the check is on one-step errors from the
#: float64 trajectory's states. On these states the JAX package's own
#: float32 step errs by 8.2e-4 at the median and 2.9e-2 at the 90th
#: percentile (max-norm over the state); the bounds give a factor of
#: about two.
F32_MEDIAN_ATOL = 2e-3
F32_P90_ATOL = 6e-2


@functools.lru_cache(maxsize=None)
def _reference():
    """Initial states, both parameter sets and the JAX rollouts, computed
    once and jitted."""
    jmodel = jbuild({"cube": jassets.get_asset("cube")})
    system = JSystem(jmodel, DT)
    rng = np.random.default_rng(5)
    x0 = cube_states_near_ground(rng, B)
    initial = params_numpy(jmodel.initial_params(jnp.float64))
    perturbed = perturbed_params(rng, *initial)
    roll = jax.jit(lambda p, x: system.simulate_batch(p, x, STEPS,
                                                      use_fused=True))
    results = {}
    for name, (theta, friction, geometry) in (("initial", initial),
                                              ("perturbed", perturbed)):
        jparams = JParams(
            theta=jnp.asarray(theta), friction=jnp.asarray(friction),
            geometry=tuple(None if g is None else
                           {k: jnp.asarray(v) for k, v in g.items()}
                           for g in geometry))
        results[name] = ((theta, friction, geometry),
                         np.asarray(roll(jparams, jnp.asarray(x0))))
    return x0, results


def _port(dtype, which="initial"):
    x0, results = _reference()
    system = TSystem.from_urdfs({"cube": tassets.get_asset("cube")}, DT,
                                device="cpu")
    params = params_from_numpy(system.model, *results[which][0],
                               dtype=dtype, device="cpu")
    traj = system.simulate_batch(params, torch.tensor(x0, dtype=dtype),
                                 STEPS, use_fused=True)
    return traj.numpy(), results[which][1]


@pytest.mark.parametrize("which", ["initial", "perturbed"])
def test_fused_rollout_matches_jax(which):
    got, ref = _port(torch.float64, which)
    assert got.shape == ref.shape == (B, STEPS + 1, 13)
    # The rollout must reach contact: some corner at or below the ground.
    assert np.min(ref[:, :, 6]) < 0.09
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=ATOL)


def test_float32_step_tracks_float64():
    got32, _ = _port(torch.float32)
    assert np.all(np.isfinite(got32))
    got64, _ = _port(torch.float64)
    states = got64[:, :-1].reshape(-1, 13)
    system = TSystem.from_urdfs({"cube": tassets.get_asset("cube")}, DT,
                                device="cpu")
    steps = {}
    for dtype in (torch.float32, torch.float64):
        steps[dtype] = system.simulate_batch(
            system.initial_params(dtype), torch.tensor(states, dtype=dtype),
            1, use_fused=True)[:, 1].double().numpy()
    err = np.max(np.abs(steps[torch.float32] - steps[torch.float64]),
                 axis=-1)
    assert np.all(np.isfinite(err))
    assert np.median(err) <= F32_MEDIAN_ATOL, np.median(err)
    assert np.quantile(err, 0.9) <= F32_P90_ATOL, np.quantile(err, 0.9)


def test_small_batch_default_path_runs_vmapped(monkeypatch):
    """Below ``FUSED_ROLLOUT_MIN_BATCH`` the default, like
    ``use_fused=False``, is the vmapped integrator (the fused step is never
    reached), and it matches the JAX package's vmapped rollout (jitted) at
    the rollout bar."""
    n, steps = 4, 4
    x0 = _reference()[0][:n]
    jmodel = jbuild({"cube": jassets.get_asset("cube")})
    jsystem = JSystem(jmodel, DT)
    want = np.asarray(jax.jit(lambda p, x: jsystem.simulate_batch(
        p, x, steps, use_fused=False))(jmodel.initial_params(jnp.float64),
                                       jnp.asarray(x0)))

    def fused(*args, **kwargs):
        raise AssertionError("the fused rollout step was called")

    monkeypatch.setattr(learnable_system, "soa_forward_dynamics_batch", fused)
    system = TSystem.from_urdfs({"cube": tassets.get_asset("cube")}, DT,
                                device="cpu")
    params = system.initial_params(torch.float64)
    with torch.no_grad():
        for got in (system.simulate_batch(params, torch.tensor(x0), steps),
                    system.simulate_batch(params, torch.tensor(x0), steps,
                                          use_fused=False)):
            np.testing.assert_allclose(got.numpy(), want, rtol=0.0,
                                       atol=ATOL)


def test_port_imports_no_jax():
    """Importing every module of the port leaves ``jax``,
    ``dair_pll_tpu``, ``click`` and ``mujoco`` out of ``sys.modules``
    (the MuJoCo systems import ``mujoco`` when one is built)."""
    code = (
        "import pkgutil, importlib, sys, dair_pll_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    dair_pll_tpu_torch.__path__, 'dair_pll_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) >= 62, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith('jax.') or m == 'dair_pll_tpu' or\n"
        "             m.startswith('dair_pll_tpu.') or m == 'click' or\n"
        "             m == 'mujoco' or m.startswith('mujoco.'))\n"
        "print('LEAKED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
