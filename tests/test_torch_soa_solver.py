"""Parity of the port's plain warm hybrid solve
(``dair_pll_tpu_torch.ops.soa_solver.solve_warm_hybrid_soa``, the plain
version of the CUDA kernel) with the JAX package's TPU kernel
``solve_warm_hybrid_soa_pallas`` run in interpret mode, on cone QPs that
the JAX package's own terms build at seeded cube states near contact.
Float64; force and w to rtol/atol 1e-8, valid mask equal."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dair_pll_tpu import assets as jassets
from dair_pll_tpu.multibody import soa_terms as jterms
from dair_pll_tpu.ops.soa_pallas import solve_warm_hybrid_soa_pallas
from dair_pll_tpu.ops.soa_solver import j_dot as jj_dot
from dair_pll_tpu.urdf import build_multibody_model as jbuild
from dair_pll_tpu_torch.assets import cube_states_near_ground
from dair_pll_tpu_torch.ops import soa_kernels
from dair_pll_tpu_torch.ops.soa_solver import (solve_contact_impulse_soa,
                                               solve_warm_hybrid_soa)
from torch_parity import DT

TOL = 1e-8
B = 64
#: (ipm, newton, eps): the rollout budget and a loss-family budget.
BUDGETS = {"rollout": (14, 6, 1e-4), "loss": (10, 6, 1e-3)}


@functools.lru_cache(maxsize=None)
def _cube_qps():
    """``(M (6, 6, B), Jc (3, 6, 4, B), qc (3, 4, B), w0 (6, B))`` numpy
    QPs of the fused rollout step at cube states near the ground."""
    model = jbuild({"cube": jassets.get_asset("cube")})
    params = model.initial_params(jnp.float64)
    rng = np.random.default_rng(11)
    x = cube_states_near_ground(rng, B)

    @jax.jit
    def build(x):
        q, v = list(x.T[:7]), list(x.T[7:])
        M, Jc, phi, a_nc = jterms.soa_multibody_terms(model, params, q, v,
                                                      [])
        v_minus = [v[i] + DT * a_nc[i] for i in range(6)]
        jv = jj_dot(Jc, v_minus)
        return M, Jc, [jv[0] + phi / DT, jv[1], jv[2]], phi

    M, Jc, qc, phi = jax.tree_util.tree_map(np.asarray, build(x))
    assert np.mean(np.min(phi, axis=0) < 0.01) > 0.5, "QPs not in contact"
    # Half the samples carry a nearby primal, half start cold.
    w0 = 0.05 * rng.standard_normal((6, B))
    w0[:, ::2] = 0.0
    return (np.stack([np.stack(r) for r in M]),
            np.stack([np.stack(r) for r in Jc]), np.stack(qc), w0)


def _random_spd_qps():
    """Random SPD QPs as in the JAX package's ``test_soa_ops``."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((6, 6, B))
    M = np.einsum("ilb,jlb->ijb", A, A) + 2.0 * np.eye(6)[..., None]
    return (M, rng.standard_normal((3, 6, 4, B)),
            rng.standard_normal((3, 4, B)), rng.standard_normal((6, B)))


def _jax_kernel(qps, budget):
    M, Jc, qc, w0 = qps
    ipm, newton, eps = BUDGETS[budget]
    force, w, valid = solve_warm_hybrid_soa_pallas(
        [[jnp.asarray(M[i, j]) for j in range(6)] for i in range(6)],
        [[jnp.asarray(Jc[i, v]) for v in range(6)] for i in range(3)],
        [jnp.asarray(c) for c in qc],
        [jnp.asarray(w0[v])[None, :] for v in range(6)],
        eps, ipm, newton, block=32, interpret=True)
    return (np.stack([np.asarray(f) for f in force]),
            np.concatenate([np.asarray(x) for x in w], axis=0),
            np.asarray(valid).reshape(-1))


def _torch_inputs(qps):
    M, Jc, qc, w0 = (torch.from_numpy(np.ascontiguousarray(a)) for a in qps)
    return ([[M[i, j] for j in range(6)] for i in range(6)],
            [[Jc[i, v] for v in range(6)] for i in range(3)],
            [qc[i] for i in range(3)], [w0[v] for v in range(6)])


@pytest.mark.parametrize("budget", sorted(BUDGETS))
@pytest.mark.parametrize("qps", ["cube", "random_spd"])
def test_plain_warm_solve_matches_jax_kernel(qps, budget):
    qps = _cube_qps() if qps == "cube" else _random_spd_qps()
    f_ref, w_ref, v_ref = _jax_kernel(qps, budget)
    ipm, newton, eps = BUDGETS[budget]
    force, w, valid = solve_warm_hybrid_soa(*_torch_inputs(qps), eps, ipm,
                                            newton)
    np.testing.assert_allclose(torch.stack(force).numpy(), f_ref,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(torch.stack(w).numpy(), w_ref, rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(valid.numpy(), v_ref)


def test_cuda_wrapper_routes_cpu_tensors_to_plain_version():
    """On CPU tensors the kernel wrapper is the plain version and no
    kernel is launched; both entries agree."""
    qps = _cube_qps()
    M, Jc, qc, w0 = _torch_inputs(qps)
    ipm, newton, eps = BUDGETS["rollout"]
    before = soa_kernels.solve_warm_hybrid_soa_cuda.launches
    ref = solve_warm_hybrid_soa(M, Jc, qc, w0, eps, ipm, newton)
    got = soa_kernels.solve_warm_hybrid_soa_cuda(M, Jc, qc, w0, eps, ipm,
                                                 newton)
    packed = soa_kernels.solve_warm_hybrid_soa_cuda_packed(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in
          (qps[0].reshape(36, B), qps[1], qps[2], qps[3])),
        eps, ipm, newton)
    assert soa_kernels.solve_warm_hybrid_soa_cuda.launches == before == 0
    for r, g, p in zip(ref[:2], got[:2], packed[:2]):
        np.testing.assert_array_equal(torch.stack(g).numpy(),
                                      torch.stack(r).numpy())
        np.testing.assert_array_equal(p.numpy(), torch.stack(r).numpy())
    np.testing.assert_array_equal(got[2].numpy(), ref[2].numpy())
    np.testing.assert_array_equal(packed[2].numpy(), ref[2].numpy())


def test_cold_solve_matches_warm_solve_from_ipm_start():
    """The cold hybrid solve equals the warm one whose carried primal
    loses the primal-cost choice (a huge carry)."""
    M, Jc, qc, w0 = _torch_inputs(_cube_qps())
    ipm, newton, eps = BUDGETS["loss"]
    force, valid = solve_contact_impulse_soa(M, Jc, qc, eps, ipm, newton)
    w_far = [torch.full_like(w, 1e6) for w in w0]
    warm_force, _, warm_valid = solve_warm_hybrid_soa(M, Jc, qc, w_far, eps,
                                                      ipm, newton)
    np.testing.assert_array_equal(torch.stack(force).numpy(),
                                  torch.stack(warm_force).numpy())
    np.testing.assert_array_equal(valid.numpy(), warm_valid.numpy())
