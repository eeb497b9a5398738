"""The elbow's fused rollout and its solve kernels' wrappers at the elbow's
``(n_v, k) = (7, 8)``, against the JAX package, float64.

``simulate_batch(use_fused=True)`` of the elbow (a free base, a revolute
hinge, two boxes against the ground: 15 states, 8 contacts) matches JAX's
at initial and perturbed parameters carried across with
``params_from_numpy``, to atol 1e-7 (the bar of the JAX package's own
fused-vs-vmapped rollout test). The warm (K5) and cold (K4) solve
kernels' wrappers, on CPU tensors, run their plain versions, which match
the TPU kernels ``solve_warm_hybrid_soa_pallas`` and
``solve_contact_impulse_soa_pallas`` run in interpret mode on 32 of the
elbow's rollout QPs (impulses and primals atol 1e-8, as
``test_torch_soa_solver.py``). On a device other than the CPU the default
rollout from 1,024 trajectories reaches K5 with the elbow's shape.

One slow test (``-m slow``, some 5 minutes) witnesses the float32
divergence that ``chip_smoke.py`` allows the elbow's rollout
(``ELBOW_DIVERGED_SHARE``): over the first 512 of its initial states, 120
steps in float32, the port's plain rollout on the CPU leaves the finite
numbers on no larger a share than JAX's does, and each such trajectory
stays finite in float64.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dair_pll_tpu import assets as jassets
from dair_pll_tpu.multibody.learnable_system import (
    MultibodyLearnableSystem as JSystem)
from dair_pll_tpu.ops.soa_pallas import (solve_contact_impulse_soa_pallas,
                                         solve_warm_hybrid_soa_pallas)
from dair_pll_tpu.urdf import build_multibody_model as jbuild
from dair_pll_tpu_torch import assets as tassets
from dair_pll_tpu_torch.multibody.learnable_system import (
    DYNAMICS_EPSILON, FUSED_ROLLOUT_MIN_BATCH, MultibodyLearnableSystem as
    TSystem)
from dair_pll_tpu_torch.multibody import soa_terms as tterms
from dair_pll_tpu_torch.multibody.model import params_from_numpy
from dair_pll_tpu_torch.multibody.soa_terms import soa_rollout_qp
from dair_pll_tpu_torch.ops import soa_kernels
from torch_parity import (DT, jax_params, params_numpy, perturbed_params,
                          random_states)

B = 16
STEPS = 10
ATOL = 1e-7
SOLVE_TOL = 1e-8
QP_B = 32


@functools.lru_cache(maxsize=None)
def _reference():
    """Initial states near the ground, both parameter sets and JAX's
    rollouts, jitted once."""
    jmodel = jbuild({"elbow": jassets.get_asset("elbow")})
    system = JSystem(jmodel, DT)
    rng = np.random.default_rng(11)
    x0 = random_states("elbow", jmodel, rng, B)
    initial = params_numpy(jmodel.initial_params(jnp.float64))
    perturbed = perturbed_params(rng, *initial)
    roll = jax.jit(lambda p, x: system.simulate_batch(p, x, STEPS,
                                                      use_fused=True))
    return x0, {name: (numpy_params,
                       np.asarray(roll(jax_params(numpy_params),
                                       jnp.asarray(x0))))
                for name, numpy_params in (("initial", initial),
                                           ("perturbed", perturbed))}


def _port_system():
    return TSystem.from_urdfs({"elbow": tassets.get_asset("elbow")}, DT,
                              device="cpu")


@pytest.mark.parametrize("which", ["initial", "perturbed"])
def test_fused_elbow_rollout_matches_jax(which):
    x0, results = _reference()
    numpy_params, ref = results[which]
    system = _port_system()
    params = params_from_numpy(system.model, *numpy_params)
    got = system.simulate_batch(params, torch.tensor(x0), STEPS,
                                use_fused=True).numpy()
    assert got.shape == ref.shape == (B, STEPS + 1, 15)
    # The rollout reaches contact: a body centre within a box's reach of
    # the ground.
    assert np.min(ref[:, :, 6]) < 0.06
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=ATOL)


@functools.lru_cache(maxsize=None)
def _elbow_qps():
    """Packed rollout QPs of the elbow, ``(m, jc, qc, w0)``, float64: the
    solve of step 3 from states near the ground, with the primal carried
    from step 2; ``(n_v, k) = (7, 8)``."""
    system = _port_system()
    params = system.initial_params(torch.float64)
    x0 = torch.tensor(random_states("elbow", system.model,
                                    np.random.default_rng(12), QP_B))
    traj = system.simulate_batch(params, x0, 3, use_fused=True)
    with torch.no_grad():
        m, jc, qc, _, _ = soa_rollout_qp(system.model, params,
                                         traj[:, 2].contiguous(), DT)
        w0 = torch.tensor(np.random.default_rng(13).normal(
            0.0, 0.05, (system.model.n_v, QP_B)))
    return m, jc, qc, w0


def _jax_qp(m, jc, qc):
    n_v = jc.shape[1]
    M = [[jnp.asarray(m[i * n_v + j].numpy()) for j in range(n_v)]
         for i in range(n_v)]
    Jc = [[jnp.asarray(jc[i, v].numpy()) for v in range(n_v)]
          for i in range(3)]
    return M, Jc, [jnp.asarray(qc[i].numpy()) for i in range(3)]


@pytest.mark.parametrize("kernel", ["K5", "K4"])
def test_solve_wrappers_at_7_8_match_tpu_kernels(kernel):
    """K5 (warm, the rollout budget (14, 6) at eps 1e-4) and K4 (cold,
    (10, 10) at eps 1e-3) at the elbow's ``(7, 8)``: the wrappers on CPU
    tensors (their plain versions) against the TPU kernels in interpret
    mode; no launch is counted."""
    m, jc, qc, w0 = _elbow_qps()
    assert tuple(jc.shape) == (3, 7, 8, QP_B)
    M, Jc, q = _jax_qp(m, jc, qc)
    counter = (soa_kernels.solve_warm_hybrid_soa_cuda if kernel == "K5"
               else soa_kernels.solve_contact_impulse_soa_cuda)
    soa_kernels.reset_launches(counter)
    if kernel == "K5":
        force, w, valid = soa_kernels.solve_warm_hybrid_soa_cuda_packed(
            m, jc, qc, w0, DYNAMICS_EPSILON, 14, 6)
        j_force, j_w, j_valid = solve_warm_hybrid_soa_pallas(
            M, Jc, q, [jnp.asarray(row.numpy()) for row in w0],
            DYNAMICS_EPSILON, 14, 6, block=QP_B, interpret=True)
        np.testing.assert_allclose(w.numpy(), np.stack(
            [np.asarray(row).reshape(-1) for row in j_w]), rtol=0,
            atol=SOLVE_TOL)
    else:
        force, valid = soa_kernels.solve_contact_impulse_soa_cuda_packed(
            m, jc, qc, 1e-3, 10, 10)
        j_force, j_valid = solve_contact_impulse_soa_pallas(
            M, Jc, q, 1e-3, 10, 10, block=QP_B, interpret=True)
    j_force = np.stack([np.asarray(f) for f in j_force])
    np.testing.assert_allclose(force.numpy(), j_force, rtol=0, atol=SOLVE_TOL)
    np.testing.assert_array_equal(valid.numpy(),
                                  np.asarray(j_valid).reshape(-1))
    assert np.all(np.asarray(j_valid))
    assert np.max(j_force[0]) > 1e-3
    assert counter.launches == 0


class _Reached(Exception):
    pass


def test_default_rollout_route_reaches_k5_at_7_8(monkeypatch):
    """On a device other than the CPU (the meta device stands in for the
    card), ``simulate_batch`` from ``FUSED_ROLLOUT_MIN_BATCH``
    trajectories takes the fused path, whose solve is K5's wrapper at
    ``(n_v, k) = (7, 8)``, whose shape check takes it."""
    shapes = []

    def stand_in(m, jc, qc, w0, *args):
        soa_kernels._check_qp(m, jc, qc)
        shapes.append(tuple(jc.shape))
        raise _Reached()

    monkeypatch.setattr(soa_kernels, "solve_warm_hybrid_soa_cuda_packed",
                        stand_in)
    monkeypatch.setattr(tterms, "solve_warm_hybrid_soa_cuda_packed",
                        stand_in)
    system = TSystem.from_urdfs({"elbow": tassets.get_asset("elbow")}, DT,
                                device="meta")
    params = system.initial_params(torch.float32)
    x0 = torch.empty((FUSED_ROLLOUT_MIN_BATCH, 15), device="meta")
    with pytest.raises(_Reached):
        system.simulate_batch(params, x0, 2)
    assert shapes == [(3, 7, 8, FUSED_ROLLOUT_MIN_BATCH)]


DIVERGENCE_STATES = 512


@pytest.mark.slow
def test_float32_elbow_divergence_is_the_references():
    """The elbow's fused float32 rollout, 120 steps (its trajectory length)
    from the first DIVERGENCE_STATES of ``chip_smoke.py``'s elbow states
    (``tree_states_near_ground``, seed 4, 8,192 drawn), in JAX and in the
    port on the CPU: the trajectories that leave the finite numbers are
    no larger a share in the port than in JAX, and every trajectory that
    does so in either stays finite in float64 in the port. Prints both
    shares (``-s``)."""
    steps = 120
    system = _port_system()
    x0 = tassets.tree_states_near_ground(np.random.default_rng(4), 8192,
                                         system.model)[:DIVERGENCE_STATES]
    port = system.simulate_batch(system.initial_params(torch.float32),
                                 torch.tensor(x0, dtype=torch.float32),
                                 steps, use_fused=True).numpy()
    jsystem = JSystem(jbuild({"elbow": jassets.get_asset("elbow")}), DT)
    ref = np.asarray(jax.jit(
        lambda p, x: jsystem.simulate_batch(p, x, steps, use_fused=True))(
            jsystem.model.initial_params(jnp.float32),
            jnp.asarray(x0, dtype=jnp.float32)))
    assert port.dtype == ref.dtype == np.float32
    port_out = np.nonzero(~np.isfinite(port).all(axis=(1, 2)))[0]
    ref_out = np.nonzero(~np.isfinite(ref).all(axis=(1, 2)))[0]
    print(f"float32 elbow trajectories not finite over {steps} steps, of "
          f"{DIVERGENCE_STATES}: port {port_out.tolist()}, JAX "
          f"{ref_out.tolist()}")
    assert len(port_out) <= len(ref_out), (port_out, ref_out)
    either = np.union1d(port_out, ref_out)
    if len(either):
        referee = system.simulate_batch(system.initial_params(torch.float64),
                                        torch.tensor(x0[either]), steps,
                                        use_fused=True)
        assert bool(torch.isfinite(referee).all())
