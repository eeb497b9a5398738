"""The port's per-sample (vmapped) stack, modules below the solvers,
against the JAX package's in float64: tensor ops, the unrolled linear
solves, the state spaces, kinematics and the mass matrix, the support
queries of every geometry type (ties included), convex-vs-convex
collision, and ``multibody_terms`` for the cube, the ICNN cube, the elbow
and two mesh cubes.

The port writes the batch out as leading dimensions; the JAX side is
``jax.vmap`` of its unbatched functions (jitted where a model's terms
are compiled once). Inputs come from seeded numpy. Bars: rtol 1e-10 on
the terms (the two frameworks differ here only in the
order of a few sums), 1e-12 on the elementary functions.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dair_pll_tpu import geometry as jgeom
from dair_pll_tpu import state_space as jspace
from dair_pll_tpu.multibody import dynamics as jdyn
from dair_pll_tpu.multibody import kinematics as jkin
from dair_pll_tpu.multibody.terms import multibody_terms as jterms
from dair_pll_tpu.ops import linear as jlinear
from dair_pll_tpu.ops import tensor as jtensor
from dair_pll_tpu_torch import geometry as tgeom
from dair_pll_tpu_torch import state_space as tspace
from dair_pll_tpu_torch.multibody import dynamics as tdyn
from dair_pll_tpu_torch.multibody import kinematics as tkin
from dair_pll_tpu_torch.multibody.model import params_from_numpy
from dair_pll_tpu_torch.multibody.terms import multibody_terms as tterms
from dair_pll_tpu_torch.ops import linear as tlinear
from dair_pll_tpu_torch.ops import tensor as ttensor
from torch_parity import (MODELS, jax_params, map_tree, model_pair,
                          params_numpy, perturbed_params, random_states)

TERMS_RTOL = 1e-10
RTOL = 1e-12


def _close(got, want, rtol=RTOL, atol=1e-14):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=atol)


def test_tensor_ops_match_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 3, 4))
    b = rng.standard_normal((5, 4, 2))
    v = rng.standard_normal((5, 4))
    p = rng.standard_normal((5, 3))
    s = rng.standard_normal((5, 12))
    s[:, :4] = np.array([2.0, -2.0, 0.1, 0.0])      # inside, polar, boundary
    t = {k: torch.tensor(x) for k, x in dict(a=a, b=b, v=v, p=p, s=s).items()}
    _close(ttensor.small_matmul(t["a"], t["b"]), jtensor.small_matmul(a, b))
    _close(ttensor.pbmm(t["a"], t["b"]), jtensor.pbmm(a, b))
    _close(ttensor.small_matvec(t["a"], t["v"]), jtensor.small_matvec(a, v))
    _close(ttensor.spatial_to_point_jacobian(t["p"]),
           jtensor.spatial_to_point_jacobian(p))
    _close(ttensor.broadcast_lorentz(t["p"]), jtensor.broadcast_lorentz(p))
    _close(ttensor.project_lorentz(t["s"]), jtensor.project_lorentz(s))


@pytest.mark.parametrize("n", [6, 24])
def test_linear_solves_match_jax(n):
    """The unrolled Cholesky and substitutions (``n = 6``) and the
    library fallback past ``MAX_UNROLL_DIM`` (``n = 24``)."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((3, n, n))
    M = A @ A.transpose(0, 2, 1) + n * np.eye(n)
    rhs_v = rng.standard_normal((3, n))
    rhs_m = rng.standard_normal((3, n, 2))
    L = tlinear.cholesky_unrolled(torch.tensor(M))
    _close(L, jlinear.cholesky_unrolled(jnp.asarray(M)), rtol=1e-11)
    for rhs in (rhs_v, rhs_m):
        _close(tlinear.cho_solve_unrolled(L, torch.tensor(rhs)),
               jlinear.cho_solve_unrolled(jnp.asarray(np.asarray(L)),
                                          jnp.asarray(rhs)), rtol=1e-11)
        _close(tlinear.spd_solve(torch.tensor(M), torch.tensor(rhs)),
               jlinear.spd_solve(jnp.asarray(M), jnp.asarray(rhs)),
               rtol=1e-11)


def _spaces():
    return {
        "floating": (jspace.FloatingBaseSpace(1), tspace.FloatingBaseSpace(1)),
        "fixed": (jspace.FixedBaseSpace(2), tspace.FixedBaseSpace(2)),
        "product": (jspace.ProductSpace([jspace.FloatingBaseSpace(0),
                                         jspace.FixedBaseSpace(2)]),
                    tspace.ProductSpace([tspace.FloatingBaseSpace(0),
                                         tspace.FixedBaseSpace(2)])),
    }


def _space_states(space, rng, shape):
    x = rng.standard_normal(shape + (space.n_x,))
    offset = 0
    for sub in getattr(space, "spaces", (space,)):
        if isinstance(sub, jspace.FloatingBaseSpace):
            quat = x[..., offset:offset + 4]
            x[..., offset:offset + 4] = quat / np.linalg.norm(
                quat, axis=-1, keepdims=True)
        offset += sub.n_q
    return x


@pytest.mark.parametrize("name", ["floating", "fixed", "product"])
def test_state_space_methods_match_jax(name):
    jsp, tsp = _spaces()[name]
    rng = np.random.default_rng(1)
    x1 = _space_states(jsp, rng, (4,))
    x2 = _space_states(jsp, rng, (4,))
    traj = _space_states(jsp, rng, (2, 5))
    dx = 0.1 * rng.standard_normal((4, 2 * jsp.n_v))
    raw_q = 1.3 * x1[:, :jsp.n_q]
    t1, t2, tt, tdx = (torch.tensor(a) for a in (x1, x2, traj, dx))
    q1, q2 = x1[:, :jsp.n_q], x2[:, :jsp.n_q]
    tq1, tq2 = t1[:, :tsp.n_q], t2[:, :tsp.n_q]
    _close(tsp.configuration_difference(tq1, tq2),
           jsp.configuration_difference(q1, q2))
    _close(tsp.project_configuration(torch.tensor(raw_q)),
           jsp.project_configuration(raw_q))
    _close(tsp.finite_difference(tq1, tq2, 0.01),
           jsp.finite_difference(q1, q2, 0.01), rtol=1e-11)
    _close(tsp.state_difference(t1, t2), jsp.state_difference(x1, x2))
    _close(tsp.shift_state(t1, tdx), jsp.shift_state(x1, dx))
    raw_x = np.concatenate((raw_q, x1[:, jsp.n_q:]), axis=-1)
    _close(tsp.project_state(torch.tensor(raw_x)), jsp.project_state(raw_x))
    _close(tsp.project_derivative(tt, 0.01), jsp.project_derivative(traj,
                                                                    0.01),
           rtol=1e-11)
    _close(tsp.config_square_error(tq1, tq2),
           jsp.config_square_error(q1, q2))
    _close(tsp.velocity_square_error(t1[:, tsp.n_q:], t2[:, tsp.n_q:]),
           jsp.velocity_square_error(x1[:, jsp.n_q:], x2[:, jsp.n_q:]))
    _close(tsp.state_square_error(t1, t2), jsp.state_square_error(x1, x2))
    for kind in ("auxiliary_comparisons", "auxiliary_pointwise_comparisons"):
        got, want = getattr(tsp, kind)(), getattr(jsp, kind)()
        assert sorted(got) == sorted(want)
        for key in want:
            _close(got[key](t1, t2), want[key](x1, x2))


@functools.lru_cache(maxsize=None)
def _models(name):
    """The JAX and port systems of a model, perturbed parameters carried
    across, and float64 states of it near contact."""
    jsystem, tsystem = model_pair(name)
    rng = np.random.default_rng(sorted(MODELS).index(name))
    numpy_params = perturbed_params(
        rng, *params_numpy(jsystem.model.initial_params(jnp.float64)))
    return (jsystem.model, tsystem.model, jax_params(numpy_params),
            params_from_numpy(tsystem.model, *numpy_params),
            random_states(name, jsystem.model, rng, 5))


@pytest.mark.parametrize("name", ["cube", "elbow"])
def test_kinematics_and_mass_matrix_match_jax(name):
    jmodel, tmodel, jparams, tparams, x = _models(name)
    q, v = x[:, :jmodel.n_q], x[:, jmodel.n_q:]
    tq, tv = torch.tensor(q), torch.tensor(v)
    u = np.zeros((q.shape[0], jmodel.n_u))
    jkin_b = jax.vmap(lambda a: jkin.body_kinematics(jmodel, a))(q)
    tkin_b = tkin.body_kinematics(tmodel, tq)
    for got, want in zip(tkin_b, jkin_b):
        _close(got, want)
    _close(tkin.configuration_rate(tmodel, tq, tv),
           jax.vmap(lambda a, b: jkin.configuration_rate(jmodel, a, b))(q, v))
    for got, want in zip(
            tkin.geometry_kinematics(tmodel, tkin_b, tq),
            jax.vmap(lambda a: jkin.geometry_kinematics(
                jmodel, jkin.body_kinematics(jmodel, a), a))(q)):
        _close(got, want)
    pi_j, pi_t = jparams.pi_cm(), tparams.pi_cm()
    _close(tdyn.mass_matrix(tmodel, pi_t, tq),
           jax.vmap(lambda a: jdyn.mass_matrix(jmodel, pi_j, a))(q),
           rtol=TERMS_RTOL)
    for fn_t, fn_j in ((tdyn.lagrangian_terms, jdyn.lagrangian_terms),
                       (tdyn.non_contact_acceleration,
                        jdyn.non_contact_acceleration)):
        got = fn_t(tmodel, pi_t, tq, tv, torch.tensor(u))
        want = jax.vmap(lambda a, b, c: fn_j(jmodel, pi_j, a, b, c))(q, v, u)
        for g, w in zip(got, want):
            _close(g, w, rtol=TERMS_RTOL, atol=1e-12)


_CUBE = tuple((sx, sy, sz) for sx in (-0.05, 0.05) for sy in (-0.05, 0.05)
              for sz in (-0.05, 0.05))
_SPECS = {
    "box": dict(half_lengths_init=(0.05, 0.04, 0.03)),
    "polygon": dict(vertices_init=_CUBE),
    "sphere": dict(radius_init=0.1),
    "cylinder": dict(radius_init=0.1, half_length_init=0.2),
    "cylinder6": dict(radius_init=0.1, half_length_init=0.2, n_query=6),
    "deep_support_convex": dict(vertices_init=_CUBE, icnn_width=16),
}


def _geometry(kind):
    """The same geometry spec in both packages, with JAX's initial
    parameters carried across."""
    fields = dict(geom_type=kind.rstrip("6"), body=0,
                  R_BG=((1.0, 0, 0), (0, 1.0, 0), (0, 0, 1.0)),
                  p_BG=(0.0, 0.0, 0.0), mu=0.5, name=kind, **_SPECS[kind])
    jspec = jgeom.CollisionGeometrySpec(**fields)
    tspec = tgeom.CollisionGeometrySpec(**fields)
    jparams = jgeom.default_geometry_params(jspec, jnp.float64)
    tparams = map_tree(lambda a: torch.tensor(np.asarray(a)), jparams)
    return jspec, tspec, jparams, tparams


def _directions(rng):
    """Random unit directions and the tie cases: the axes (an axis-aligned
    box has four tied vertices along each) and a face diagonal."""
    d = rng.standard_normal((4, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ties = np.array([[0, 0, -1.0], [1.0, 0, 0], [0, 0, 1.0],
                     [0.0, 2 ** -0.5, 2 ** -0.5]])
    return np.concatenate((d, ties))


@pytest.mark.parametrize("kind", list(_SPECS))
def test_support_queries_match_jax(kind):
    """Support points, the single support point and the support function
    with its gradients (to the direction and the parameters), ties
    included: witnesses in JAX's ``top_k`` order, the first vertex of
    largest support value, the gradient of a tied maximum split evenly."""
    jspec, tspec, jparams, tparams = _geometry(kind)
    d = _directions(np.random.default_rng(3))
    td = torch.tensor(d, requires_grad=True)
    _close(tgeom.support_points(tspec, tparams, td),
           jax.vmap(lambda a: jgeom.support_points(jspec, jparams, a))(d))
    _close(tgeom.icnn_or_support_point(tspec, tparams, td),
           jax.vmap(lambda a: jgeom.icnn_or_support_point(jspec, jparams,
                                                          a))(d))
    leaves = [leaf.requires_grad_(True) for leaf in
              jax.tree_util.tree_leaves(map_tree(lambda t: t, tparams))]
    h = tgeom.support_function(tspec, tparams, td)
    _close(h, jax.vmap(lambda a: jgeom.support_function(jspec, jparams,
                                                        a))(d))
    inputs = [td] + leaves
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        inputs, torch.autograd.grad(h.sum(), inputs, allow_unused=True))]
    want_d, want_p = jax.grad(lambda dd, pp: jnp.sum(jax.vmap(
        lambda a: jgeom.support_function(jspec, pp, a))(dd)),
        argnums=(0, 1))(d, jparams)
    want_d = np.asarray(want_d)
    # At an axial direction the cylinder's |d_xy| has no gradient: JAX's
    # norm gives NaN there, torch's its subgradient 0.
    axial = np.isnan(want_d).any(axis=-1)
    assert kind.startswith("cylinder") or not axial.any()
    assert torch.isfinite(grads[0]).all()
    _close(grads[0][~axial], want_d[~axial])
    for got, want in zip(grads[1:], jax.tree_util.tree_leaves(want_p)):
        if kind.startswith("cylinder"):
            # Sum without the NaN rows of JAX's parameter gradient.
            want = jax.grad(lambda pp: jnp.sum(jax.vmap(
                lambda a: jgeom.support_function(jspec, pp, a))(
                    d[~axial])))(jparams)
            got = torch.autograd.grad(tgeom.support_function(
                tspec, tparams, td[~axial]).sum(), leaves)
            for g, w in zip(got, jax.tree_util.tree_leaves(want)):
                _close(g, w)
            break
        _close(got, want)
    if kind in ("box", "polygon"):
        _close(tgeom.get_vertices(tspec, tparams),
               jgeom.get_vertices(jspec, jparams))
    assert tgeom.pair_contact_count(tspec, tspec) == 1
    assert tgeom.support_points(tspec, tparams, td).shape[-2] == \
        tspec.n_contacts


def test_box_witness_ties_follow_vertex_order():
    """Straight down, an axis-aligned box has four tied bottom vertices:
    the witnesses are they, in vertex order, as ``jax.lax.top_k`` returns
    them."""
    _, tspec, _, tparams = _geometry("box")
    got = tgeom.support_points(tspec, tparams,
                               torch.tensor([[0.0, 0.0, -1.0]], dtype=torch.float64))[0]
    vertices = tgeom.get_vertices(tspec, tparams)
    bottom = [i for i in range(8) if vertices[i, 2] < 0]
    assert torch.equal(got, vertices[bottom])


@pytest.mark.parametrize("pair", [("box", "sphere"), ("deep_support_convex",
                                                     "deep_support_convex")])
def test_collide_convex_convex_matches_jax(pair):
    """Convex-vs-convex collision (the direction search and the one
    contact) at random relative poses, and its gradient to B's origin."""
    jspec_a, tspec_a, jparams_a, tparams_a = _geometry(pair[0])
    jspec_b, tspec_b, jparams_b, tparams_b = _geometry(pair[1])
    rng = np.random.default_rng(4)
    quat = rng.standard_normal((4, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    from dair_pll_tpu.ops import quaternion as jquat
    R = np.asarray(jquat.to_rotation_matrix(jnp.asarray(quat)))
    p = rng.standard_normal((4, 3))
    p = 0.6 * p / np.linalg.norm(p, axis=-1, keepdims=True)
    tp = torch.tensor(p, requires_grad=True)
    got = tgeom.collide(tspec_a, tparams_a, tspec_b, tparams_b,
                        torch.tensor(R), tp)
    want = jax.vmap(lambda r, o: jgeom.collide(
        jspec_a, jparams_a, jspec_b, jparams_b, r, o))(R, p)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-10, atol=1e-12)
    (grad,) = torch.autograd.grad(got[0].sum(), tp)
    _close(grad, jax.grad(lambda o: jnp.sum(jax.vmap(
        lambda r, oo: jgeom.collide(jspec_a, jparams_a, jspec_b, jparams_b,
                                    r, oo)[0])(R, o)))(p),
           rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", ["cube", "cube_mesh", "elbow",
                                  "two_mesh_cubes"])
def test_multibody_terms_match_jax(name):
    """``(D, M, J, phi, a_nc)`` at perturbed parameters, states near
    contact, against the JAX package's (jitted, vmapped)."""
    jmodel, tmodel, jparams, tparams, x = _models(name)
    q, v = x[:, :jmodel.n_q], x[:, jmodel.n_q:]
    u = np.zeros((q.shape[0], jmodel.n_u))
    want = jax.jit(jax.vmap(lambda a, b, c: jterms(jmodel, jparams, a, b,
                                                   c)))(q, v, u)
    got = tterms(tmodel, tparams, torch.tensor(q), torch.tensor(v),
                 torch.tensor(u))
    k = jmodel.n_contacts
    shapes = [(3 * k, 3 * k), (jmodel.n_v, jmodel.n_v), (3 * k, jmodel.n_v),
              (k,), (jmodel.n_v,)]
    for g, w, shape in zip(got, want, shapes):
        assert tuple(g.shape) == (q.shape[0],) + shape
        scale = np.max(np.abs(np.asarray(w)))
        _close(g, w, rtol=TERMS_RTOL, atol=TERMS_RTOL * scale)
    # Some contact is within reach in every model.
    assert np.min(np.asarray(want[3])) < 0.1
