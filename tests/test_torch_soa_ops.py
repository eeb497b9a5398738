"""Parity of the port's batch-minor primitives (``dair_pll_tpu_torch.ops.
soa`` and ``ops.soa_cones``) with the JAX package's, at float64 on the
same seeded numpy inputs, to rtol 1e-12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dair_pll_tpu.ops import soa as jsoa
from dair_pll_tpu.ops import soa_cones as jcones
from dair_pll_tpu.ops.soa_solver import _step_to_boundary as j_stb
from dair_pll_tpu_torch.ops import soa as tsoa
from dair_pll_tpu_torch.ops import soa_cones as tcones
from dair_pll_tpu_torch.ops.soa_solver import _step_to_boundary as t_stb

RTOL = 1e-12
ATOL = 1e-12
B = 64
K = 4


def _j(tree):
    """numpy leaves -> jnp (nested lists kept)."""
    if isinstance(tree, (list, tuple)):
        return [_j(t) for t in tree]
    return jnp.asarray(tree)


def _t(tree):
    if isinstance(tree, (list, tuple)):
        return [_t(t) for t in tree]
    return torch.from_numpy(np.ascontiguousarray(tree))


def _np(tree):
    if isinstance(tree, (list, tuple)):
        return np.stack([_np(t) for t in tree])
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def _close(got, ref, rtol=RTOL, atol=ATOL):
    got, ref = _np(got), _np(ref)
    np.testing.assert_allclose(got.reshape(ref.shape), ref, rtol=rtol,
                               atol=atol)


def _spd(rng, n, batch):
    A = rng.standard_normal((n, n, batch))
    return [[sum(A[i, l] * A[j, l] for l in range(n)) +
             (2.0 if i == j else 0.0) for j in range(n)] for i in range(n)]


def _interior_cones(rng, shape):
    """Cone field strictly inside the second-order cone."""
    t = rng.standard_normal((2,) + shape)
    n = np.sqrt(t[0] ** 2 + t[1] ** 2) + rng.uniform(0.1, 1.0, shape)
    return [n, t[0], t[1]]


def test_ldlt_and_spd_solve():
    rng = np.random.default_rng(0)
    M = _spd(rng, 6, B)
    rhs = list(rng.standard_normal((6, B)))
    L_j, d_j = jsoa.ldlt(_j(M))
    L_t, d_t = tsoa.ldlt(_t(M))
    _close(d_t, d_j)
    for i in range(6):
        for j in range(i):
            _close(L_t[i][j], L_j[i][j])
    _close(tsoa.spd_solve(_t(M), _t(rhs)), jsoa.spd_solve(_j(M), _j(rhs)))
    _close(tsoa.cho_solve(tsoa.cholesky(_t(M)), _t(rhs)),
           jsoa.cho_solve(jsoa.cholesky(_j(M)), _j(rhs)))


@pytest.mark.parametrize("descending", [False, True])
def test_sort_with_payload_with_ties(descending):
    """Same insertion network: equal keys keep their input order, which
    decides which box vertices become witnesses."""
    rng = np.random.default_rng(1)
    # Keys drawn from a few values, so most columns hold ties.
    keys = list(rng.integers(0, 3, size=(8, B)).astype(np.float64))
    payloads = [list(rng.standard_normal((8, B))) for _ in range(3)]
    k_j, p_j = jsoa.sort_with_payload(_j(keys), _j(payloads), descending)
    k_t, p_t = tsoa.sort_with_payload(_t(keys), _t(payloads), descending)
    np.testing.assert_array_equal(_np(k_t), _np(k_j))
    np.testing.assert_array_equal(_np(p_t), _np(p_j))


def test_sym3_inverse():
    rng = np.random.default_rng(2)
    A = _spd(rng, 3, B)
    _close(tsoa.sym3_inverse(_t(A)), jsoa.sym3_inverse(_j(A)))


def test_project_and_jacobians():
    """Points in the cone, in the polar cone and outside both."""
    rng = np.random.default_rng(3)
    z = list(rng.standard_normal((3, K, B)))
    u = list(rng.standard_normal((3, K, B)))
    _close(tcones.project(_t(z)), jcones.project(_j(z)))
    g_t, D_t = tcones.project_and_jacobian_matrix(_t(z))
    g_j, D_j = jcones.project_and_jacobian_matrix(_j(z))
    _close(g_t, g_j)
    _close(D_t, D_j)
    g_t, du_t = tcones.project_and_jacobian_apply(_t(z), _t(u))
    g_j, du_j = jcones.project_and_jacobian_apply(_j(z), _j(u))
    _close(g_t, g_j)
    _close(du_t, du_j)
    _close(tcones.projection_jacobian_apply(_t(z), _t(u)),
           jcones.projection_jacobian_apply(_j(z), _j(u)))


def test_nt_scaling_and_arrow_solve():
    rng = np.random.default_rng(4)
    x = _interior_cones(rng, (K, B))
    z = _interior_cones(rng, (K, B))
    b = list(rng.standard_normal((3, K, B)))
    s_t, lam_t = tcones.nt_scaling(_t(x), _t(z))
    s_j, lam_j = jcones.nt_scaling(_j(x), _j(z))
    _close(lam_t, lam_j)
    _close(s_t.eta, s_j.eta)
    _close(s_t.apply(_t(b)), s_j.apply(_j(b)))
    _close(s_t.apply_inverse(_t(b)), s_j.apply_inverse(_j(b)))
    _close(tcones.nt_w2_inverse(s_t, 1e-4), jcones.nt_w2_inverse(s_j, 1e-4))
    _close(tcones.arrow_solve(_t(x), _t(b)), jcones.arrow_solve(_j(x), _j(b)))


def test_step_to_boundary():
    rng = np.random.default_rng(5)
    u = _interior_cones(rng, (K, B))
    du = list(3.0 * rng.standard_normal((3, K, B)))
    _close(tcones.step_to_boundary_one(_t(u), _t(du)),
           jcones.step_to_boundary_one(_j(u), _j(du)))
    _close(t_stb(_t(u), _t(du)), j_stb(_j(u), _j(du)))
    cones_u = [[u[i][c] for i in range(3)] for c in range(K)]
    cones_du = [[du[i][c] for i in range(3)] for c in range(K)]
    _close(tcones.step_to_boundary(_t(cones_u), _t(cones_du)),
           jcones.step_to_boundary(_j(cones_u), _j(cones_du)))
