"""The port's batched cone-QP solvers against the JAX package's in float64:
the cone algebra, the interior-point methods, SAP-Newton, the hybrid and
warm hybrid solves, the lax APGD, the implicit-function-theorem
cotangents of both ``autograd.Function``s, the plain version of the APGD
kernel K6 against the TPU kernel run in Pallas's interpreter, the failure
masking, and the K6 wrapper's routes.

The QPs are the cube's own (harvested from the port's float64 terms: the
rollout's at eps 1e-4 and the ContactNets loss's at eps 1e-3) and random
contact-like QPs (the JAX package's ``tests/test_socp_solver.py``
recipe), fed to both packages as the same numpy arrays; the JAX side is
``jax.vmap`` of its unbatched solvers (jitted).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dair_pll_tpu.ops import cone_solver as jcone
from dair_pll_tpu.ops import cones as jcones
from dair_pll_tpu.ops import sap_solver as jsap
from dair_pll_tpu.ops import socp_solver as jsocp
from dair_pll_tpu.ops.pallas_cone_solver import (solve_cone_qp_pallas,
                                                 solve_contact_impulse_pallas)
from dair_pll_tpu_torch.ops import cone_kernels
from dair_pll_tpu_torch.ops import cone_solver as tcone
from dair_pll_tpu_torch.ops import cones as tcones
from dair_pll_tpu_torch.ops import sap_solver as tsap
from dair_pll_tpu_torch.ops import socp_solver as tsocp
from torch_parity import cube_qps, random_qps

#: Converged solves (SAP, hybrid, APGD-200) agree to rounding, amplified
#: by the QP's conditioning (1/eps up to 1e4).
SOLVE_ATOL = 1e-9
#: The IFT cotangents: the solve's residual is at rounding, so the
#: cotangents agree to a few digits short of it.
IFT_RTOL = 1e-8
#: K6's plain version against the TPU kernel in interpret mode: the TPU
#: kernel sums its matvecs and reductions in its blocked row order, the
#: plain version in the CUDA kernel's, and 200 iterations carry the
#: rounding; measured 1.2e-14 at |x| ~ 8.
K6_RTOL = 1e-11
#: Float32 APGD-200 against float64 on random PSD problems: float32
#: rounding carried through 200 iterations. On the test's problems
#: (condition numbers up to 7e2, |x| up to 8) the gap is at most 1.3e-5;
#: the bar leaves room for rounding and still catches a stalled or
#: diverging solve.
F32_TOL = 1e-3


@functools.lru_cache(maxsize=None)
def _qps(family: str):
    if family == "random":
        return random_qps(np.random.default_rng(11), 8, 1e-3)
    return cube_qps(np.random.default_rng(12), 8)[family]


def _t(*arrays):
    return tuple(torch.tensor(a) for a in arrays)


def _close(got, want, atol=SOLVE_ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_cone_ops_match_jax():
    rng = np.random.default_rng(0)
    u = rng.standard_normal((5, 4, 3))
    u[..., 0] = np.abs(u[..., 0]) + 2.0                # interior points
    z = u + 0.3 * np.abs(rng.standard_normal((5, 4, 3)))
    z[..., 0] += 1.0
    du = rng.standard_normal((5, 4, 3))
    w = rng.standard_normal((5, 4, 3))
    w[:, 0] = [2.0, 0.3, 0.1]                          # inside
    w[:, 1] = [-2.0, 0.3, 0.1]                         # polar
    tu, tz, tdu, tw = _t(u, z, du, w)
    vm = jax.vmap
    _close(tcones.project(tw), vm(jcones.project)(w), atol=1e-15)
    _close(tcones.projection_jacobian_apply(tw, tdu),
           vm(jcones.projection_jacobian_apply)(w, du), atol=1e-14)
    _close(tcones.projection_jacobian_matrix(tw),
           vm(jcones.projection_jacobian_matrix)(w), atol=1e-14)
    _close(tcones.jordan_product(tu, tdu),
           vm(jcones.jordan_product)(u, du), atol=1e-14)
    _close(tcones.arrow_solve(tu, tdu), vm(jcones.arrow_solve)(u, du),
           atol=1e-13)
    scaling, lam = tcones.nt_scaling(tu, tz)
    j_scaling, j_lam = vm(jcones.nt_scaling)(u, z)
    _close(lam, j_lam, atol=1e-13)
    _close(scaling.apply_inverse(tdu),
           vm(lambda s, a: s.apply_inverse(a))(j_scaling, du), atol=1e-13)
    _close(tcones.nt_w2_inverse_matrix(scaling, 1e-3),
           vm(lambda s: jcones.nt_w2_inverse_matrix(s, 1e-3))(j_scaling),
           atol=1e-12)
    _close(tcones.step_to_boundary(tu, tdu),
           vm(jcones.step_to_boundary)(u, du), atol=1e-14)
    rows = rng.standard_normal((5, 12, 6))
    _close(tcones.rows_to_cone_major(torch.tensor(rows)),
           vm(jcones.rows_to_cone_major)(rows), atol=0.0)
    stacked = rng.standard_normal((5, 12))
    _close(tcones.stacked_to_cone_major(torch.tensor(stacked)),
           vm(jcones.stacked_to_cone_major)(stacked), atol=0.0)
    _close(tcones.cone_major_to_stacked(torch.tensor(u)),
           vm(jcones.cone_major_to_stacked)(u), atol=0.0)
    A = rng.standard_normal((5, 4, 3, 3))
    A = A + np.swapaxes(A, -1, -2) + 6.0 * np.eye(3)
    _close(tcones.sym3_inverse(torch.tensor(A)), vm(jcones.sym3_inverse)(A),
           atol=1e-14)


# The JAX side, jitted once for all QP families (same shapes; eps is an
# argument).
_vm = jax.vmap
_static = functools.partial(functools.partial, jax.jit)


@_static(static_argnums=(2,))
def _j_ipm(Q, q, iterations):
    return _vm(lambda a, b: jsocp.solve_cone_qp_ipm(a, b, iterations))(Q, q)


@_static(static_argnums=(4, 5))
def _j_ipm_mj(M, J, q, eps, iterations, correctors):
    return _vm(lambda a, b, c: jsocp.solve_cone_qp_ipm_mj(
        a, b, c, eps, iterations, correctors))(M, J, q)


@_static(static_argnums=(5,))
def _j_sap(M, J, q, eps, w0, iterations):
    return _vm(lambda a, b, c, d: jsap.solve_contact_impulse_sap(
        a, b, c, eps, iterations, d))(M, J, q, w0)


@_static(static_argnums=(5, 6))
def _j_hybrid(D, M, J, q, eps, ipm, newton):
    return _vm(lambda a, b, c, d: jsap.solve_contact_impulse_hybrid(
        a, b, c, d, eps, ipm, newton))(D, M, J, q)


@_static(static_argnums=(5, 6))
def _j_hybrid_qp(Q, q, M, J, eps, ipm, newton):
    return _vm(lambda a, b, c, d: jsap.solve_cone_qp_hybrid(
        a, b, c, d, eps, ipm, newton))(Q, q, M, J)


@_static(static_argnums=(5, 6))
def _j_warm(M, J, q, eps, w0, ipm, newton):
    return _vm(lambda a, b, c, d: jsap.solve_cone_qp_hybrid_warm(
        a, b, c, eps, d, ipm, newton))(M, J, q, w0)


@_static(static_argnums=(3,))
def _j_apgd(D, q, eps, iterations):
    return _vm(lambda a, b: jcone.solve_contact_impulse(
        a, b, eps, iterations))(D, q)


@jax.jit
def _j_ift(Q, q, M, J, eps, g):
    """Cotangents of (Q, q) through the hybrid (10, 10) and APGD-200
    solves."""
    def hybrid(a, b):
        return jnp.sum(_vm(lambda aa, bb, mm, jj: jsap.solve_cone_qp_hybrid(
            aa, bb, mm, jj, eps, 10, 10))(a, b, M, J) * g)

    def apgd(a, b):
        return jnp.sum(_vm(lambda aa, bb: jcone.solve_cone_qp(aa, bb, 200))(
            a, b) * g)
    return (jax.grad(hybrid, argnums=(0, 1))(Q, q),
            jax.grad(apgd, argnums=(0, 1))(Q, q))


@pytest.mark.parametrize("family", ["rollout", "loss", "random"])
def test_ipm_path_matches_jax(family):
    """The first four interior-point iterations, dense and
    Delassus-structured (with and without two Gondzio correctors), to
    1e-9 (1 + |x|). Later iterates part: the central path's late
    iterations amplify the last bit of the input, in the JAX package
    itself (its own iterate moves by up to 4e-3 when ``q`` moves by
    1e-15 relative), so the full budget is checked by its cost."""
    D, M, J, q, eps = _qps(family)
    Q = D + eps * np.eye(12)
    pairs = [(tsocp.solve_cone_qp_ipm(*_t(Q, q), 4), _j_ipm(Q, q, 4))]
    for correctors in (0, 2):
        pairs.append((
            tsocp.solve_cone_qp_ipm_mj(*_t(M, J, q), eps, 4, correctors),
            _j_ipm_mj(M, J, q, eps, 4, correctors)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                                   atol=1e-9)


def _cost(Q, q, x):
    x = np.asarray(x)
    return 0.5 * np.einsum("bi,bij,bj->b", x, Q, x) + np.sum(q * x, -1)


@pytest.mark.parametrize("family", ["rollout", "loss", "random"])
def test_ipm_converges_as_jax(family):
    """At the full budgets (dense 18; structured 14 for rollout QPs, 10
    otherwise) each sample's suboptimality, relative to ``|f*| + q.q`` with
    ``f*`` from a long hybrid solve, is within a factor of two of the JAX
    package's (plus 1e-10); the masked contact solve flags the samples
    JAX's solution would. The solutions lie in the cones."""
    D, M, J, q, eps = _qps(family)
    Q = D + eps * np.eye(12)
    optimum = _j_hybrid_qp(Q, q, M, J, eps, 18, 24)
    scale = np.abs(_cost(Q, q, optimum)) + np.sum(q * q, -1)
    ipm = 14 if family == "rollout" else 10
    dense = _j_ipm(Q, q, 18)
    for got, want in (
            (tsocp.solve_cone_qp_ipm(*_t(Q, q), 18), dense),
            (tsocp.solve_cone_qp_ipm_mj(*_t(M, J, q), eps, ipm),
             _j_ipm_mj(M, J, q, eps, ipm, 0))):
        sub_t = (_cost(Q, q, got.numpy()) - _cost(Q, q, optimum)) / scale
        sub_j = (_cost(Q, q, want) - _cost(Q, q, optimum)) / scale
        assert np.all(sub_t <= 2.0 * sub_j + 1e-10), (sub_t, sub_j)
        assert np.all(sub_j <= 2.0 * sub_t + 1e-10), (sub_t, sub_j)
        cones = tcones.stacked_to_cone_major(got)
        assert bool((cones[..., 0] >= torch.linalg.norm(
            cones[..., 1:], dim=-1) - 1e-9).all())
    _, valid = tsocp.solve_contact_impulse_ipm(*_t(D, q), eps, 18)
    dense = np.asarray(dense)
    assert np.array_equal(valid.numpy(), np.isfinite(dense).all(-1) &
                          (np.abs(dense) <= 1e3).all(-1))


@pytest.mark.parametrize("family", ["rollout", "loss", "random"])
def test_sap_and_hybrid_match_jax(family):
    """SAP-Newton from zero and from a random primal, the hybrid solve
    (with its masking) and the warm hybrid from a random carried primal.
    SAP-Newton alone is compared converged, at 24 iterations: short of
    that it can stall in active-set discovery (up to 16 iterations on
    these QPs) at points that move with the last bit of the input, as the
    line search's bracket flips."""
    D, M, J, q, eps = _qps(family)
    Q = D + eps * np.eye(12)
    w0 = 0.1 * np.random.default_rng(14).standard_normal((8, 6))
    tQ, tq, tM, tJ, tD, tw0 = _t(Q, q, M, J, D, w0)
    _close(tsap.solve_contact_impulse_sap(tM, tJ, tq, eps, 24)[0],
           _j_sap(M, J, q, eps, np.zeros((8, 6)), 24)[0])
    got, valid = tsap.solve_contact_impulse_sap(tM, tJ, tq, eps, 24, tw0)
    want, j_valid = _j_sap(M, J, q, eps, w0, 24)
    _close(got, want)
    assert np.array_equal(valid.numpy(), np.asarray(j_valid))
    _close(tsap.solve_cone_qp_hybrid(tQ, tq, tM, tJ, eps, 10, 10),
           _j_hybrid_qp(Q, q, M, J, eps, 10, 10))
    got, valid = tsap.solve_contact_impulse_hybrid(tD, tM, tJ, tq, eps, 14, 6)
    want, j_valid = _j_hybrid(D, M, J, q, eps, 14, 6)
    _close(got, want)
    assert np.array_equal(valid.numpy(), np.asarray(j_valid))
    got_x, got_w = tsap.solve_cone_qp_hybrid_warm(tM, tJ, tq, eps, tw0, 14, 6)
    want_x, want_w = _j_warm(M, J, q, eps, w0, 14, 6)
    _close(got_x, want_x)
    _close(got_w, want_w)


@pytest.mark.parametrize("family", ["loss", "random"])
def test_apgd_matches_jax(family):
    D, _, _, q, eps = _qps(family)
    got, valid = tcone.solve_contact_impulse(*_t(D, q), eps, 200)
    want, j_valid = _j_apgd(D, q, eps, 200)
    _close(got, want)
    assert np.array_equal(valid.numpy(), np.asarray(j_valid))


@pytest.mark.parametrize("solver", ["hybrid", "apgd"])
@pytest.mark.parametrize("family", ["loss", "random"])
def test_ift_cotangents_match_jax(solver, family):
    """The backward of each ``autograd.Function`` against ``jax.grad``
    through the JAX custom VJPs, for a random cotangent."""
    D, M, J, q, eps = _qps(family)
    Q = D + eps * np.eye(12)
    g = np.random.default_rng(15).standard_normal(q.shape)
    want = _j_ift(Q, q, M, J, eps, g)[solver == "apgd"]
    tQ, tq = (t.requires_grad_(True) for t in _t(Q, q))
    if solver == "hybrid":
        x = tsap.solve_cone_qp_hybrid(tQ, tq, *_t(M, J), eps, 10, 10)
    else:
        x = tcone.solve_cone_qp(tQ, tq, 200)
    (x * torch.tensor(g)).sum().backward()
    for got, w in zip((tQ.grad, tq.grad), want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=IFT_RTOL,
                                   atol=IFT_RTOL * np.max(np.abs(w)))
    # M and J are the solve's geometry: no gradient reaches them.
    tM, tJ = (t.requires_grad_(True) for t in _t(M, J))
    tsap.solve_cone_qp_hybrid(*_t(Q, q), tM, tJ, eps, 4, 2).sum().backward()
    assert tM.grad is None and tJ.grad is None


@pytest.mark.parametrize("k", [1, 4, 9])
def test_k6_plain_version_matches_the_tpu_kernel(k):
    """K6's plain version against ``solve_cone_qp_pallas(Q, q, 200,
    True)`` on random PSD problems of the JAX package's
    ``tests/test_pallas_cone_solver.py`` recipe."""
    rng = np.random.default_rng(k)
    n = 3 * k
    A = rng.standard_normal((8, n, n))
    Q = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(n)
    q = rng.standard_normal((8, n)) * 2
    want = np.asarray(solve_cone_qp_pallas(jnp.asarray(Q), jnp.asarray(q),
                                           200, True))
    got = cone_kernels.plain_apgd(*_t(Q, q), 200).numpy()
    np.testing.assert_allclose(got, want, rtol=K6_RTOL, atol=K6_RTOL)
    assert np.max(np.abs(want)) > 0.5


def test_float32_apgd_converges_on_random_problems():
    """In float32, K6's plain version, the port's lax APGD and the JAX
    package's lax APGD all solve 512 random PSD problems at k = 4 (the
    recipe and seed of ``chip_smoke.random_psd_qps``): every solution is
    valid (finite, at most 1e3) and within F32_TOL (1 + |x|) of K6's
    plain version in float64."""
    k, n = 4, 12
    rng = np.random.default_rng(40 + k)
    A = rng.standard_normal((512, n, n))
    Q = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(n)
    q = 2.0 * rng.standard_normal((512, n))
    want = cone_kernels.plain_apgd(*_t(Q, q), 200).numpy()
    Q32, q32 = (torch.tensor(a, dtype=torch.float32) for a in (Q, q))
    solves = {
        "k6_plain": cone_kernels.plain_apgd(Q32, q32, 200).numpy(),
        "lax": tcone._apgd(Q32, q32, torch.zeros_like(q32), 200).numpy(),
        "jax_lax": np.asarray(_vm(lambda a, b: jcone.solve_cone_qp(
            a, b, 200))(jnp.asarray(Q32.numpy()), jnp.asarray(q32.numpy())))}
    for name, got in solves.items():
        assert got.dtype == np.float32, name
        _, valid = tsocp.mask_failures(torch.tensor(got))
        assert bool(valid.all()), f"{name}: {int((~valid).sum())} diverged"
        gap = np.max(np.abs(got - want) / (1 + np.abs(want)))
        assert gap <= F32_TOL, f"{name}: {gap:.3e}"


def test_failure_masking_matches_jax():
    """Samples with a non-finite or an above-1e3 impulse are zeroed and
    flagged invalid, by the K6 wrapper and the lax and hybrid solves, as
    by the JAX package's."""
    D, M, J, q, eps = _qps("loss")
    q = q.copy()
    q[1, 0] = np.nan                                   # non-finite
    q[2] *= 1e7                                        # unbounded impulse
    tD, tM, tJ, tq = _t(D, M, J, q)
    before = cone_kernels.solve_cone_qp_cuda.launches
    for (got, valid), (want, j_valid) in (
            (cone_kernels.solve_contact_impulse_cuda(tD, tq, eps, 200),
             solve_contact_impulse_pallas(D, q, eps, 200, True)),
            (tcone.solve_contact_impulse(tD, tq, eps, 200),
             _j_apgd(D, q, eps, 200)),
            (tsap.solve_contact_impulse_hybrid(tD, tM, tJ, tq, eps, 10, 10),
             _j_hybrid(D, M, J, q, eps, 10, 10))):
        assert np.array_equal(valid.numpy(), np.asarray(j_valid))
        assert not valid[1] and not valid[2] and valid[0]
        assert torch.all(got[~valid] == 0.0)
        _close(got, want, atol=1e-8)
    assert cone_kernels.solve_cone_qp_cuda.launches == before


def test_k6_wrapper_routes():
    """CPU tensors run the plain version and count no launch; a mix of
    devices, another device (the meta device stands in for one the port
    does not run on), no cones or another dtype raise; more than ten
    cones (any k builds at first use) pass the check."""
    D, _, _, q, _ = _qps("loss")
    Q, tq = _t(D + 1e-3 * np.eye(12), q)
    before = cone_kernels.solve_cone_qp_cuda.launches
    got = cone_kernels.solve_cone_qp_cuda(Q, tq, 50)
    assert torch.equal(got, cone_kernels.plain_apgd(Q, tq, 50))
    assert cone_kernels.solve_cone_qp_cuda.launches == before
    with pytest.raises(ValueError, match="several devices"):
        cone_kernels.solve_cone_qp_cuda(Q, tq.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        cone_kernels.solve_cone_qp_cuda(Q.to("meta"), tq.to("meta"))
    assert cone_kernels._check(torch.zeros(2, 33, 33),
                               torch.zeros(2, 33)) == (2, 11)
    with pytest.raises(ValueError, match="k = 0"):
        cone_kernels._check(torch.zeros(2, 0, 0), torch.zeros(2, 0))
    with pytest.raises(TypeError, match="dtype"):
        cone_kernels._check(torch.zeros(2, 3, 3, dtype=torch.int32),
                            torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        cone_kernels._check(torch.zeros(2, 3, 4), torch.zeros(2, 3))
    assert cone_kernels._check(Q, tq) == (8, 4)
