"""The port's deep-support (ICNN) geometry against the JAX package's,
float64: the network's value and support points (the closed-form input
gradient, ``dair_pll_tpu_torch.ops.icnn``) and their Jacobian with respect
to every weight, at exact ties of the LeakyReLU; convexity, homogeneity
and the plane collision; mesh extraction and URDF export of the learned
shape; the cold hybrid solve's wrapper on CPU tensors against the TPU
kernel in interpret mode; and rollouts of the ICNN cube.

Weights and inputs are made by JAX or seeded numpy and carried across.
Tolerances: values and support points rtol 1e-12 (the same float64
arithmetic, the sums over the width in another order); their Jacobians
rtol 1e-10, atol 1e-12; mesh vertices and hyperplanes 1e-9 (2e-7 for the
float32 points of the JAX package's URDF export); the solve
rtol 1e-10, atol 1e-10 (``tests/test_fused_loss.py``'s bar for the
kernel); rollouts atol 1e-7 (``tests/test_multibody.py``'s bar).
"""
import functools
import os
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dair_pll_tpu import assets as jassets
from dair_pll_tpu import mesh_extraction as jmesh
from dair_pll_tpu import urdf_export as jexport
from dair_pll_tpu.multibody.learnable_system import (
    MultibodyLearnableSystem as JSystem)
from dair_pll_tpu.ops import icnn as jicnn
from dair_pll_tpu.ops.soa_pallas import solve_contact_impulse_soa_pallas
from dair_pll_tpu.urdf import build_multibody_model as jbuild
from dair_pll_tpu_torch import assets as tassets
from dair_pll_tpu_torch import mesh_extraction as tmesh
from dair_pll_tpu_torch import urdf_export as texport
from dair_pll_tpu_torch.geometry import (CollisionGeometrySpec,
                                         default_geometry_params)
from dair_pll_tpu_torch.multibody import soa_terms as tterms
from dair_pll_tpu_torch.multibody.learnable_system import (
    MultibodyLearnableSystem as TSystem)
from dair_pll_tpu_torch.multibody.model import params_from_numpy
from dair_pll_tpu_torch.ops import icnn as ticnn
from dair_pll_tpu_torch.ops import soa_kernels
from dair_pll_tpu_torch.urdf import build_multibody_model as tbuild
from torch_parity import DT, jax_params, map_tree, params_numpy

SLOPE = 0.5
VALUE_RTOL = 1e-12
JAC_RTOL, JAC_ATOL = 1e-10, 1e-12
MESH_TOL = 1e-9
#: The JAX package's URDF export returns the support points in float32:
#: it rounds each layer's contribution to float32 and sums them in float32
#: (1.5 float32 ulps at most, 9e-8 at the ICNN cube's extent below 1 m),
#: where the port keeps float64.
OBJ_TOL = 2e-7
SOLVE_TOL = 1e-10
ROLLOUT_ATOL = 1e-7


def _jax_net(depth, width, seed=0):
    return jicnn.init_homogeneous_icnn(jax.random.PRNGKey(seed), depth,
                                       width, scale=0.1, dtype=jnp.float64)


def _torch_net(net, requires_grad=False):
    return map_tree(lambda a: torch.tensor(np.asarray(a),
                                           requires_grad=requires_grad), net)


def _directions(rng, n):
    d = rng.standard_normal((n, 3))
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _jax_points(net, directions):
    return np.asarray(jax.vmap(lambda d: jicnn.icnn_support_point(
        net, d, SLOPE))(jnp.asarray(directions)))


@pytest.mark.parametrize("depth,width", [(2, 16), (2, 256), (3, 16)])
def test_value_and_support_points_match_jax(rng, depth, width):
    net = _jax_net(depth, width)
    d = _directions(rng, 64)
    values = np.asarray(jax.vmap(lambda x: jicnn.icnn_value(net, x, SLOPE))(
        jnp.asarray(d)))
    tnet = _torch_net(net)
    np.testing.assert_allclose(
        ticnn.icnn_value(tnet, torch.tensor(d), SLOPE).numpy(), values,
        rtol=VALUE_RTOL)
    np.testing.assert_allclose(
        ticnn.icnn_support_points(tnet, torch.tensor(d), SLOPE).numpy(),
        _jax_points(net, d), rtol=VALUE_RTOL, atol=1e-15)


@pytest.mark.parametrize("depth", [2, 3])
def test_support_point_jacobian_matches_jax(rng, depth):
    """d(support points)/d(every weight): the torch closed form under
    autograd against ``jax.jacrev`` of ``vmap(grad(value))``."""
    net = _jax_net(depth, 16, seed=depth)
    d = _directions(rng, 4)
    ref = jax.jacrev(lambda p: jax.vmap(
        lambda x: jicnn.icnn_support_point(p, x, SLOPE))(jnp.asarray(d)))(net)
    ref_leaves = jax.tree_util.tree_leaves(ref)
    tnet = _torch_net(net, requires_grad=True)
    leaves = [tnet[key][i] for key in ("hidden_weights", "input_weights")
              for i in range(len(tnet[key]))] + [tnet["output_weight"]]
    assert len(leaves) == len(ref_leaves) == 2 * depth
    points = ticnn.icnn_support_points(tnet, torch.tensor(d), SLOPE)
    jac = [torch.zeros(points.shape + leaf.shape, dtype=torch.float64)
           for leaf in leaves]
    for n in range(points.shape[0]):
        for i in range(3):
            grads = torch.autograd.grad(points[n, i], leaves,
                                        retain_graph=True, allow_unused=True)
            for out, g in zip(jac, grads):
                if g is not None:
                    out[n, i] = g
    for got, want in zip(jac, ref_leaves):
        assert np.max(np.abs(np.asarray(want))) > 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=JAC_RTOL, atol=JAC_ATOL)


def _points_with_slopes(net, d, at_zero):
    """Depth-2 support points written out, the slope at a pre-activation
    of exactly 0 being ``at_zero``; also the pre-activations."""
    def slope(z):
        return torch.where(z > 0, 1.0, torch.where(z == 0, at_zero, SLOPE))
    u0, u1 = net["input_weights"]
    h0 = torch.abs(net["hidden_weights"][0])
    z1 = d @ u0
    z2 = (slope(z1) * z1) @ h0 + d @ u1
    g2 = slope(z2) * torch.abs(net["output_weight"])
    g1 = slope(z1) * (g2 @ h0.T)
    return g2 @ u1.T + g1 @ u0.T, z1, z2


def test_support_point_at_exact_ties():
    """Directions that put a pre-activation of each layer at exactly 0:
    the slope there is 1 (``x >= 0``), as in JAX; with the other slope
    the support point would differ."""
    net = map_tree(np.array, _jax_net(2, 16, seed=5))
    net["input_weights"][0][:, 0] = [1.0, 0.0, 0.0]
    net["input_weights"][1][:, 1] = [1.0, 0.0, 0.0]
    net["hidden_weights"][0][:, 1] = 0.0
    d = np.array([[0.0, 0.6, 0.8], [0.0, -0.8, 0.6]])
    tnet = _torch_net(net)
    want = _jax_points(map_tree(jnp.asarray, net), d)
    ones, z1, z2 = _points_with_slopes(tnet, torch.tensor(d), 1.0)
    slopes, _, _ = _points_with_slopes(tnet, torch.tensor(d), SLOPE)
    assert torch.all(z1[:, 0] == 0) and torch.all(z2[:, 1] == 0)
    got = ticnn.icnn_support_points(tnet, torch.tensor(d), SLOPE).numpy()
    np.testing.assert_allclose(got, want, rtol=VALUE_RTOL, atol=1e-15)
    np.testing.assert_allclose(ones.numpy(), want, rtol=VALUE_RTOL,
                               atol=1e-15)
    assert np.all(np.abs(slopes.numpy()[:, 0] - want[:, 0]) > 1e-6)


def _spec(width=32):
    corners = [(sx * 0.05, sy * 0.05, sz * 0.05)
               for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    return CollisionGeometrySpec(
        geom_type="deep_support_convex", body=0,
        R_BG=((1.0, 0, 0), (0, 1.0, 0), (0, 0, 1.0)), p_BG=(0.0, 0.0, 0.0),
        mu=0.5, n_query=4, vertices_init=tuple(corners), icnn_width=width,
        name="deep")


def test_icnn_convex_homogeneous_and_euler(rng):
    """The port's own initialization: positive homogeneity, convexity
    along segments, and Euler's identity ``s(d) . d = f(d)``."""
    net = default_geometry_params(_spec(), torch.float64)["icnn"]
    d = torch.tensor(rng.standard_normal((2, 3)))
    f = lambda x: float(ticnn.icnn_value(net, x, SLOPE))
    np.testing.assert_allclose(f(2.5 * d[0]), 2.5 * f(d[0]), rtol=1e-9)
    for t in (0.25, 0.5, 0.75):
        assert f(t * d[0] + (1 - t) * d[1]) <= \
            t * f(d[0]) + (1 - t) * f(d[1]) + 1e-9
    units = torch.tensor(_directions(rng, 5))
    points = ticnn.icnn_support_points(net, units, SLOPE)
    np.testing.assert_allclose(torch.sum(points * units, dim=-1).numpy(),
                               ticnn.icnn_value(net, units, SLOPE).numpy(),
                               rtol=1e-8)


def test_deep_support_collide_plane():
    """The SoA plane collision of an ICNN above the plane: finite signed
    distances, witnesses below the body origin for the downward
    direction."""
    spec = _spec()
    params = default_geometry_params(spec, torch.float64)
    one = torch.ones(1, dtype=torch.float64)
    zero = torch.zeros(1, dtype=torch.float64)
    eye = [[one if i == j else zero for j in range(3)] for i in range(3)]
    phi, _, witnesses = tterms._soa_collide_plane_convex(
        spec, {"icnn": params}, eye, [zero, zero, 0.3 * one])
    assert len(phi) == 4
    assert all(bool(torch.isfinite(p).all()) for p in phi)
    assert all(float(w[2]) <= 1e-6 for w in witnesses)


@functools.lru_cache(maxsize=None)
def _mesh_case():
    """The ICNN cube's JAX initial parameters, perturbed, and the port's
    model with them carried across."""
    jmodel = jbuild({"cube": jassets.get_asset("cube_mesh")})
    theta, friction, geometry = params_numpy(
        jmodel.initial_params(jnp.float64))
    rng = np.random.default_rng(13)
    geometry = [map_tree(lambda a: a * rng.uniform(0.9, 1.1, a.shape), g)
                for g in geometry]
    tmodel = tbuild({"cube": tassets.get_asset("cube_mesh")})
    return jmodel, tmodel, (theta, friction, geometry)


def test_extract_mesh_matches_jax():
    jmodel, tmodel, numpy_params = _mesh_case()
    net = map_tree(jnp.asarray, numpy_params[2][1]["icnn"])
    want = jmesh.extract_mesh(lambda d: _jax_points(net, d))
    tparams = params_from_numpy(tmodel, *numpy_params)
    tnet = tparams.geometry[1]["icnn"]
    got = tmesh.extract_mesh(lambda d: ticnn.icnn_support_points(
        tnet, torch.tensor(d), SLOPE).numpy())
    assert got.vertices.shape == want.vertices.shape
    assert len(want.vertices) > 8
    np.testing.assert_allclose(got.vertices, want.vertices, atol=MESH_TOL)
    np.testing.assert_array_equal(got.faces, want.faces)
    for g, w in zip(
            tmesh.extract_outward_normal_hyperplanes(got.vertices, got.faces),
            jmesh.extract_outward_normal_hyperplanes(want.vertices,
                                                     want.faces)):
        np.testing.assert_allclose(g, w, atol=MESH_TOL)
    assert tmesh.mesh_to_obj(got).count("\nf ") == len(got.faces)


def _assert_same_xml(got, want):
    assert got.tag == want.tag and got.attrib.keys() == want.attrib.keys()
    for key, value in want.attrib.items():
        try:
            np.testing.assert_allclose(
                np.array(got.attrib[key].split(), dtype=np.float64),
                np.array(value.split(), dtype=np.float64), rtol=1e-12,
                atol=0)
        except ValueError:
            assert got.attrib[key] == value
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same_xml(g, w)


def _obj_counts(path):
    """An ``.obj`` file's vertices and its number of faces."""
    with open(path, encoding="utf-8") as handle:
        lines = handle.read().splitlines()
    vertices = [line.split()[1:] for line in lines if line.startswith("v ")]
    return (np.array(vertices, dtype=np.float64),
            sum(line.startswith("f ") for line in lines))


@pytest.mark.parametrize("asset", ["cube_mesh", "cube"])
def test_urdf_export_matches_jax(tmp_path, asset):
    """The exported URDFs have the same elements and attributes, the
    numbers equal to rtol 1e-12 (``theta -> pi_cm`` rounds the last ulps
    differently in the two frameworks, so the printed masses and inertias
    may differ in their last digits), and the ICNN's extracted ``.obj``
    files have as many vertices and faces, the vertices within OBJ_TOL."""
    if asset == "cube_mesh":
        jmodel, tmodel, numpy_params = _mesh_case()
    else:
        jmodel = jbuild({"cube": jassets.get_asset(asset)})
        tmodel = tbuild({"cube": tassets.get_asset(asset)})
        numpy_params = params_numpy(jmodel.initial_params(jnp.float64))
    want = jexport.represent_multibody_terms_as_urdfs(
        jmodel, jax_params(numpy_params), str(tmp_path / "jax"))
    got = texport.represent_multibody_terms_as_urdfs(
        tmodel, params_from_numpy(tmodel, *numpy_params),
        str(tmp_path / "port"))
    assert got.keys() == want.keys()
    for name in want:
        _assert_same_xml(ET.fromstring(got[name]), ET.fromstring(want[name]))
    jax_files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == jax_files
    for name in jax_files:
        got_v, got_f = _obj_counts(tmp_path / "port" / name)
        want_v, want_f = _obj_counts(tmp_path / "jax" / name)
        assert (len(got_v), got_f) == (len(want_v), want_f)
        np.testing.assert_allclose(got_v, want_v, rtol=0, atol=OBJ_TOL)


def _fused_loss_test_qps():
    """The QPs of ``tests/test_fused_loss.py``'s kernel check: 48 random
    SPD mass matrices, Jacobians and cone fields, ``n_v = 6``, ``k = 4``."""
    B, k, n_v = 48, 4, 6
    kM, kJ, kq = jax.random.split(jax.random.PRNGKey(0), 3)
    A = jax.random.normal(kM, (n_v, n_v, B), jnp.float64)
    M = [[sum(A[i][l] * A[j][l] for l in range(n_v)) +
          (2.0 if i == j else 0.0) for j in range(n_v)] for i in range(n_v)]
    J = jax.random.normal(kJ, (3, n_v, k, B), jnp.float64)
    q = jax.random.normal(kq, (3, k, B), jnp.float64)
    return M, [[J[i, v] for v in range(n_v)] for i in range(3)], \
        [q[i] for i in range(3)]


@pytest.mark.parametrize("budget", [(10, 6), (10, 10)])
def test_cold_solve_wrapper_on_cpu_matches_tpu_kernel(budget):
    """K4's wrapper on CPU tensors runs the plain version, which matches
    the TPU kernel run in interpret mode; no launch is counted."""
    M, Jc, qc = _fused_loss_test_qps()
    f_pal, v_pal = solve_contact_impulse_soa_pallas(
        M, Jc, qc, 1e-3, *budget, block=32, interpret=True)

    def t(a):
        return torch.tensor(np.asarray(a))
    before = soa_kernels.solve_contact_impulse_soa_cuda.launches
    force, valid = soa_kernels.solve_contact_impulse_soa_cuda(
        [[t(x) for x in row] for row in M],
        [[t(x) for x in row] for row in Jc],
        [t(x) for x in qc], 1e-3, *budget)
    assert soa_kernels.solve_contact_impulse_soa_cuda.launches == before
    np.testing.assert_allclose(torch.stack(force).numpy(),
                               np.asarray(jnp.stack(f_pal)),
                               rtol=SOLVE_TOL, atol=SOLVE_TOL)
    np.testing.assert_array_equal(valid.numpy(),
                                  np.asarray(v_pal).reshape(-1))
    assert valid.shape == (48,)


def test_icnn_rollout_matches_jax():
    """8 trajectories x 10 steps of the ICNN cube from states near the
    ground, float64, at the JAX initial parameters carried across."""
    jmodel = jbuild({"cube": jassets.get_asset("cube_mesh")})
    numpy_params = params_numpy(jmodel.initial_params(jnp.float64))
    system = TSystem.from_urdfs({"cube": tassets.get_asset("cube_mesh")}, DT,
                                device="cpu")
    params = params_from_numpy(system.model, *numpy_params)
    x0 = tassets.icnn_states_near_ground(np.random.default_rng(17), 8,
                                         params.geometry[1]["icnn"])
    want = np.asarray(jax.jit(lambda p, x: JSystem(jmodel, DT).simulate_batch(
        p, x, 10, use_fused=True))(jax_params(numpy_params),
                                   jnp.asarray(x0)))
    before = soa_kernels.solve_warm_hybrid_soa_cuda.launches
    got = system.simulate_batch(params, torch.tensor(x0), 10,
                                use_fused=True).numpy()
    assert soa_kernels.solve_warm_hybrid_soa_cuda.launches == before
    np.testing.assert_allclose(got, want, rtol=0, atol=ROLLOUT_ATOL)
    # The contacts were active: the bodies did not fall freely.
    free_fall = x0[:, 6] + 10 * DT * x0[:, 12] - 0.5 * 9.81 * (10 * DT)**2
    assert np.max(np.abs(got[:, -1, 6] - free_fall)) > 1e-3
