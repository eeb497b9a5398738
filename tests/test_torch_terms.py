"""Parity of the port's batch-minor multibody terms
(``dair_pll_tpu_torch.multibody.soa_terms``) with the JAX package's, for
the cube (free body) and the elbow (free body + revolute joint), at
random states and at initial and perturbed parameters carried across
with ``params_from_numpy``; float64, rtol 1e-11."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dair_pll_tpu import assets as jassets
from dair_pll_tpu.multibody import soa_terms as jterms
from dair_pll_tpu.multibody.model import MultibodyParams as JParams
from dair_pll_tpu.urdf import build_multibody_model as jbuild
from dair_pll_tpu_torch import assets as tassets
from dair_pll_tpu_torch.multibody import soa_terms as tterms
from dair_pll_tpu_torch.multibody.model import params_from_numpy
from dair_pll_tpu_torch.urdf import build_multibody_model as tbuild
from torch_parity import params_numpy, perturbed_params

RTOL = 1e-11
ATOL = 1e-13   # for entries that are exactly zero
B = 32


def _random_states(rng, model):
    q_parts, v_parts = [], []
    for spec in model.models:
        if spec.floating:
            quat = rng.standard_normal((B, 4))
            quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
            pos = np.concatenate([0.05 * rng.standard_normal((B, 2)),
                                  0.1 * rng.random((B, 1))], axis=-1)
            q_parts += [quat, pos]
            v_parts.append(rng.standard_normal((B, 6)))
        q_parts.append(rng.standard_normal((B, spec.n_joints)))
        v_parts.append(rng.standard_normal((B, spec.n_joints)))
    return (np.concatenate(q_parts, axis=-1),
            np.concatenate(v_parts, axis=-1))


@functools.lru_cache(maxsize=None)
def _case(system: str):
    """Both models, the JAX terms at initial and perturbed parameters,
    computed once per system and jitted."""
    jmodel = jbuild({system: jassets.get_asset(system)})
    tmodel = tbuild({system: tassets.get_asset(system)})
    rng = np.random.default_rng(7 if system == "cube" else 8)
    q, v = _random_states(rng, jmodel)
    initial = params_numpy(jmodel.initial_params(jnp.float64))
    perturbed = perturbed_params(rng, *initial)

    @jax.jit
    def terms(params, q, v):
        M, Jc, phi, a_nc = jterms.soa_multibody_terms(
            jmodel, params, list(q.T), list(v.T), [])
        derived = jterms.derive_scalar_params(jmodel, params)
        return M, Jc, phi, a_nc, derived

    results = {}
    for name, (theta, friction, geometry) in (("initial", initial),
                                              ("perturbed", perturbed)):
        jparams = JParams(
            theta=jnp.asarray(theta), friction=jnp.asarray(friction),
            geometry=tuple(None if g is None else
                           {k: jnp.asarray(val) for k, val in g.items()}
                           for g in geometry))
        out = jax.tree_util.tree_map(np.asarray, terms(jparams, q, v))
        results[name] = ((theta, friction, geometry), out)
    return jmodel, tmodel, q, v, results


@pytest.mark.parametrize("system", ["cube", "elbow"])
def test_model_structure(system):
    jmodel, tmodel, _, _, _ = _case(system)
    assert (tmodel.n_q, tmodel.n_v, tmodel.n_u, tmodel.n_contacts) == \
        (jmodel.n_q, jmodel.n_v, jmodel.n_u, jmodel.n_contacts)
    assert tmodel.collision_candidates == jmodel.collision_candidates
    assert tterms.supports_fused(tmodel)
    if system == "cube":
        assert (tmodel.n_q, tmodel.n_v, tmodel.n_contacts) == (7, 6, 4)


@pytest.mark.parametrize("system", ["cube", "elbow"])
@pytest.mark.parametrize("which", ["initial", "perturbed"])
def test_derived_params_and_terms(system, which):
    _, tmodel, q, v, results = _case(system)
    (theta, friction, geometry), (M, Jc, phi, a_nc, derived) = \
        results[which]
    params = params_from_numpy(tmodel, theta, friction, geometry)

    t_derived = tterms.derive_scalar_params(tmodel, params)
    np.testing.assert_allclose(t_derived["pi"].numpy(), derived["pi"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_derived["mu"].numpy(), derived["mu"],
                               rtol=RTOL, atol=ATOL)
    for t_g, j_g in zip(t_derived["geom"], derived["geom"]):
        assert set(t_g) == set(j_g)
        for key in t_g:
            np.testing.assert_allclose(t_g[key].numpy(), j_g[key],
                                       rtol=RTOL, atol=ATOL)
    # The cube's 15 derived scalars: pi (10), mu (plane + box), halves (3).
    if system == "cube":
        n_derived = sum(t.numel() for t in
                        [t_derived["pi"], t_derived["mu"]] +
                        [x for g in t_derived["geom"] for x in g.values()])
        assert n_derived == 15

    tM, tJc, tphi, ta_nc = tterms.soa_multibody_terms(
        tmodel, params, list(torch.from_numpy(q.T.copy())),
        list(torch.from_numpy(v.T.copy())), [])
    np.testing.assert_allclose(
        np.stack([np.stack([x.numpy() for x in row]) for row in tM]),
        np.stack([np.stack(row) for row in M]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        np.stack([np.stack([x.numpy() for x in row]) for row in tJc]),
        np.stack([np.stack(row) for row in Jc]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tphi.numpy(), phi, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.stack([x.numpy() for x in ta_nc]),
                               np.stack(a_nc), rtol=RTOL, atol=ATOL)


def test_mesh_geometry_needs_icnn_or_polygon():
    """A mesh collision shape builds as a deep-support (ICNN) convex by
    default, whose initial parameters have the JAX package's leaf shapes,
    order and initial bounds (the values differ: the generators differ),
    or as a polygon."""
    path = tassets.get_asset("cube_mesh")
    polygon = tbuild({"cube": path}, mesh_representation="polygon")
    assert tterms.supports_fused(polygon)
    assert polygon.initial_params(torch.float64).geometry[1]["vertices"] \
        .shape == (8, 3)

    model = tbuild({"cube": path})
    spec = model.geometries[1]
    assert spec.geom_type == "deep_support_convex"
    assert (spec.icnn_depth, spec.icnn_width, spec.n_query,
            spec.icnn_negative_slope) == (2, 256, 4, 0.5)
    assert tterms.supports_fused(model)
    jparams = jbuild({"cube": jassets.get_asset("cube_mesh")}).initial_params(
        jnp.float64)
    params = model.initial_params(torch.float64)
    got = params.parameters()
    want = jax.tree_util.tree_leaves(jparams)
    assert [tuple(t.shape) for t in got] == [np.shape(a) for a in want]
    # Leaves: theta, friction, hidden (256, 256), input (3, 256) twice,
    # output (256,), perturbations (4, 3); their initial bounds.
    width, slope = 256, 0.5
    corners = np.asarray(spec.vertices_init)
    scale = np.linalg.norm(corners.max(axis=0) - corners.min(axis=0)) / 2
    bounds = [2 * np.sqrt(2 / (1 + slope**2)) / width, np.sqrt(2.0), 1.0,
              scale * 2 * np.sqrt(2 / (width * (1 + slope**2))), 0.2]
    for t, a, bound in zip(got[2:], want[2:], bounds):
        for leaf in (t.numpy(), np.asarray(a)):
            assert np.max(np.abs(leaf)) <= bound * (1 + 1e-12)
        assert np.max(np.abs(t.numpy())) > 0.5 * bound
    for perturbations in (got[-1].numpy(), np.asarray(want[-1])):
        np.testing.assert_array_equal(perturbations[0], 0.0)
    # The port's initialization is reproducible.
    again = model.initial_params(torch.float64).parameters()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("system", ["cube", "elbow"])
def test_weight_carry_round_trip(system):
    """JAX parameters -> port -> numpy returns them unchanged, and
    malformed fields are refused."""
    _, tmodel, _, _, results = _case(system)
    theta, friction, geometry = results["perturbed"][0]
    params = params_from_numpy(tmodel, theta, friction, geometry,
                               dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(params.theta.numpy(), theta)
    np.testing.assert_array_equal(params.friction.numpy(), friction)
    for t_g, j_g in zip(params.geometry, geometry):
        assert (t_g is None) == (j_g is None)
        for key in (j_g or {}):
            np.testing.assert_array_equal(t_g[key].numpy(), j_g[key])
    with pytest.raises(ValueError):
        params_from_numpy(tmodel, theta[:, :9], friction, geometry)
    with pytest.raises(ValueError):
        params_from_numpy(tmodel, theta, friction, geometry[:-1])
