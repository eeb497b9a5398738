"""The URDF front end's features in the PyTorch port, mirroring the rest
of ``tests/test_urdf_features.py`` (rotated inertial frames, fixed-base
models, links with several collision geometries and their export round
trips) and ``tests/test_mesh_mesh.py`` (two ICNN bodies in contact with
each other), each held against the JAX package in float64: the parsed
models' fields, the kinematics' Jacobians against the time derivative of
the forward kinematics, the exported URDFs, and the two-mesh terms at the
same parameters."""
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dair_pll_tpu.assets import get_asset as jasset
from dair_pll_tpu.multibody.terms import (contact_terms as jcontact_terms,
                                          multibody_terms as jterms)
from dair_pll_tpu.urdf import build_multibody_model as jbuild
from dair_pll_tpu_torch import assets as tassets
from dair_pll_tpu_torch.multibody.kinematics import (body_kinematics,
                                                     configuration_rate)
from dair_pll_tpu_torch.multibody.learnable_system import (
    MultibodyLearnableSystem)
from dair_pll_tpu_torch.multibody.model import params_from_numpy
from dair_pll_tpu_torch.multibody.terms import contact_terms, multibody_terms
from dair_pll_tpu_torch.state_space import FixedBaseSpace
from dair_pll_tpu_torch.urdf import build_multibody_model
from dair_pll_tpu_torch.urdf_export import represent_multibody_terms_as_urdfs
from torch_parity import jax_params, params_numpy

_BOX_INERTIAL = """
      <inertial>
        <origin xyz="0 0 0" rpy="0 0 0"/>
        <mass value="0.5"/>
        <inertia ixx="0.002" iyy="0.003" izz="0.004"
                 ixy="0" ixz="0" iyz="0"/>
      </inertial>
"""
_BOX_COLLISION = """
      <collision>
        <origin xyz="0 0 0" rpy="0 0 0"/>
        <geometry><box size="0.1 0.1 0.1"/></geometry>
      </collision>
"""
ARM = f"""\
<robot name="arm">
  <link name="world"/>
  <link name="upper">{_BOX_INERTIAL}{_BOX_COLLISION}
  </link>
  <link name="lower">{_BOX_INERTIAL}{_BOX_COLLISION}
  </link>
  <joint name="shoulder" type="revolute">
    <parent link="world"/>
    <child link="upper"/>
    <origin xyz="0 0 0.5" rpy="0 0 0"/>
    <axis xyz="0 1 0"/>
  </joint>
  <joint name="elbow" type="revolute">
    <parent link="upper"/>
    <child link="lower"/>
    <origin xyz="0.3 0 0" rpy="0 0 0"/>
    <axis xyz="0 1 0"/>
  </joint>
</robot>
"""
MULTI = f"""\
<robot name="multi">
  <link name="body">{_BOX_INERTIAL}
    <collision>
      <origin xyz="0.1 0 0" rpy="0 0 0"/>
      <geometry><box size="0.1 0.2 0.3"/></geometry>
    </collision>
    <collision>
      <origin xyz="-0.1 0 0" rpy="0 0 0"/>
      <geometry><sphere radius="0.05"/></geometry>
    </collision>
  </link>
</robot>
"""
ROTATED = """\
<robot name="rot">
  <link name="body">
    <inertial>
      <origin xyz="0.01 0 0" rpy="0 0 1.5707963267948966"/>
      <mass value="2.0"/>
      <inertia ixx="0.010" iyy="0.020" izz="0.030"
               ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision>
      <geometry><box size="0.1 0.1 0.1"/></geometry>
    </collision>
  </link>
</robot>
"""


def _write(tmp_path, name, body):
    path = os.path.join(str(tmp_path), name)
    with open(path, "w", encoding="utf-8") as handle:
        handle.write(textwrap.dedent(body))
    return path


def _same_models(tmodel, jmodel):
    """The port's parsed model has the JAX package's fields."""
    assert (tmodel.n_q, tmodel.n_v, tmodel.n_bodies) == \
        (jmodel.n_q, jmodel.n_v, jmodel.n_bodies)
    for tb, jb in zip(tmodel.bodies, jmodel.bodies):
        np.testing.assert_allclose(np.asarray(tb.pi_cm_init),
                                   np.asarray(jb.pi_cm_init), atol=1e-15)
        assert tb.joint.joint_type == jb.joint.joint_type
        assert tb.joint.parent == jb.joint.parent
    assert [g.geom_type for g in tmodel.geometries] == \
        [g.geom_type for g in jmodel.geometries]
    assert tmodel.collision_candidates == tuple(
        tuple(c) for c in jmodel.collision_candidates)


def test_rotated_inertial_frame(tmp_path):
    """A diagonal inertia stated in a frame rotated 90 degrees about z
    parses to the link-frame tensor with Ixx and Iyy swapped, as the JAX
    package parses it."""
    path = _write(tmp_path, "rot.urdf", ROTATED)
    model = build_multibody_model({"rot": path})
    pi = np.asarray(model.bodies[0].pi_cm_init)
    assert pi[0] == 2.0
    np.testing.assert_allclose(pi[1:4], [0.02, 0.0, 0.0], atol=1e-12)
    np.testing.assert_allclose(pi[4:7], [0.020, 0.010, 0.030], atol=1e-12)
    np.testing.assert_allclose(pi[7:], 0.0, atol=1e-12)
    _same_models(model, jbuild({"rot": path}))


def _jacobian_consistency(model, q, v):
    """Jv and Jw against the time derivative of the forward kinematics:
    d/dt p_WB = Jv v and d/dt R_WB = skew(Jw v) R_WB."""
    qdot = configuration_rate(model, q, v)
    kin, kin_dot = torch.func.jvp(lambda qq: body_kinematics(model, qq),
                                  (q,), (qdot,))
    for b in range(model.n_bodies):
        np.testing.assert_allclose(kin_dot.p_WB[b].numpy(),
                                   (kin.Jv[b] @ v).numpy(), rtol=1e-9,
                                   atol=1e-12)
        omega = (kin.Jw[b] @ v).numpy()
        skew = np.array([[0, -omega[2], omega[1]],
                         [omega[2], 0, -omega[0]],
                         [-omega[1], omega[0], 0]])
        np.testing.assert_allclose(kin_dot.R_WB[b].numpy(),
                                   skew @ kin.R_WB[b].numpy(), rtol=1e-9,
                                   atol=1e-12)
    return kin


def test_fixed_base_model(tmp_path):
    """A world-rooted URDF builds a fixed-base model (no floating
    coordinates, ``FixedBaseSpace``, joints hanging off the world) whose
    Jacobians are the forward kinematics' derivative, and whose mass
    matrix and terms equal the JAX package's."""
    path = _write(tmp_path, "fixed.urdf", ARM)
    model = build_multibody_model({"arm": path})
    assert not model.models[0].floating
    assert model.n_q == 2 and model.n_v == 2 and model.n_bodies == 2
    assert model.bodies[0].joint.parent == -1
    assert isinstance(model.state_space(), FixedBaseSpace)
    jmodel = jbuild({"arm": path})
    _same_models(model, jmodel)
    rng = np.random.default_rng(1)
    q, v = rng.standard_normal(2), rng.standard_normal(2)
    kin = _jacobian_consistency(model, torch.tensor(q), torch.tensor(v))
    from dair_pll_tpu.multibody.kinematics import body_kinematics as jkin
    want = jkin(jmodel, jnp.asarray(q))
    np.testing.assert_allclose(kin.p_WB.numpy(), np.asarray(want.p_WB),
                               atol=1e-14)
    params = model.initial_params(torch.float64)
    got = multibody_terms(model, params, torch.tensor(q), torch.tensor(v),
                          torch.zeros(0, dtype=torch.float64))
    ref = jterms(jmodel, jmodel.initial_params(jnp.float64),
                 jnp.asarray(q), jnp.asarray(v), jnp.zeros((0,)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)
    assert np.linalg.eigvalsh(got[1].numpy()).min() > 0


def _perturbed_export(model, params_tree, tmp_path, name):
    out_dir = str(tmp_path / f"export_{name}")
    urdfs = represent_multibody_terms_as_urdfs(model, params_tree, out_dir)
    exported = os.path.join(out_dir, f"{name}.urdf")
    with open(exported, "w", encoding="utf-8") as handle:
        handle.write(urdfs[name])
    return exported


def test_multi_collision_link_parse_and_export(tmp_path):
    """Two collision geometries on one link (a box and a sphere) parse
    into two geometries and export back into the same two ``<collision>``
    elements with the learned values and their origins; the JAX
    package's export of the same parameters reparses to the same
    geometry."""
    path = _write(tmp_path, "multi.urdf", MULTI)
    model = build_multibody_model({"multi": path})
    body_geoms = [g for g in model.geometries if g.body == 0]
    assert [g.geom_type for g in body_geoms] == ["box", "sphere"]
    jmodel = jbuild({"multi": path})
    _same_models(model, jmodel)
    theta, friction, geometry = params_numpy(jmodel.initial_params(
        jnp.float64))
    geometry = list(geometry)
    for i, spec in enumerate(model.geometries):
        if spec.geom_type == "box":
            geometry[i] = {"half_lengths": geometry[i]["half_lengths"] * 1.5}
        elif spec.geom_type == "sphere":
            geometry[i] = {"radius": geometry[i]["radius"] * 2.0}
    exported = _perturbed_export(
        model, params_from_numpy(model, theta, friction, geometry),
        tmp_path, "multi")
    reparsed = build_multibody_model({"multi": exported})
    new_geoms = [g for g in reparsed.geometries if g.body == 0]
    assert [g.geom_type for g in new_geoms] == ["box", "sphere"]
    np.testing.assert_allclose(new_geoms[0].half_lengths_init,
                               np.asarray([0.05, 0.1, 0.15]) * 1.5,
                               rtol=1e-6)
    np.testing.assert_allclose(new_geoms[1].radius_init, 0.1, rtol=1e-6)
    np.testing.assert_allclose(new_geoms[0].p_BG, (0.1, 0.0, 0.0))
    np.testing.assert_allclose(new_geoms[1].p_BG, (-0.1, 0.0, 0.0))
    from dair_pll_tpu.urdf_export import (
        represent_multibody_terms_as_urdfs as jexport)
    want = jexport(jmodel, jax_params((theta, friction, geometry)),
                   str(tmp_path / "jax_export"))["multi"]
    want_path = _write(tmp_path, "jax_multi.urdf", want)
    _same_models(reparsed, jbuild({"multi": want_path}))


@pytest.mark.parametrize("asset", ["cube", "elbow"])
def test_export_round_trip(tmp_path, asset):
    """The cube's and the elbow's export at perturbed parameters reparses
    to a model whose initial parameters are those (the bodies' friction
    and geometry; the ground plane is not exported), and equals the JAX
    package's export reparsed."""
    name = asset
    model = build_multibody_model({name: tassets.get_asset(asset)})
    jmodel = jbuild({name: jasset(asset)})
    theta, friction, geometry = params_numpy(jmodel.initial_params(
        jnp.float64))
    rng = np.random.default_rng(7)
    theta = theta + 0.01 * rng.standard_normal(theta.shape) * np.abs(theta)
    friction = friction * 1.2
    geometry = [None if g is None else
                {key: value * 1.1 for key, value in g.items()}
                for g in geometry]
    params = params_from_numpy(model, theta, friction, geometry)
    exported = _perturbed_export(model, params, tmp_path, name)
    reparsed = build_multibody_model({name: exported})
    back = reparsed.initial_params(torch.float64)
    bodies = [i for i, g in enumerate(model.geometries) if g.body >= 0]
    np.testing.assert_allclose(back.friction.numpy()[bodies],
                               params.friction.detach().numpy()[bodies],
                               rtol=1e-6)
    for got, want in zip(back.geometry, params.geometry):
        if want is not None:
            for key in want:
                np.testing.assert_allclose(got[key].numpy(),
                                           want[key].detach().numpy(),
                                           rtol=1e-6)
    from dair_pll_tpu.urdf_export import (
        represent_multibody_terms_as_urdfs as jexport)
    want = jexport(jmodel, jax_params((theta, friction, geometry)),
                   str(tmp_path / "jax_export"))[name]
    jback = jbuild({name: _write(tmp_path, f"jax_{name}.urdf", want)})
    _same_models(reparsed, jback)


@pytest.fixture(scope="module")
def two_cubes():
    """Two ICNN cubes (``cube_mesh`` twice) in the port and in the JAX
    package, at the JAX package's initial parameters."""
    path = tassets.get_asset("cube_mesh")
    model = build_multibody_model({"cube_a": path, "cube_b": path},
                                  mesh_representation="deep_support_convex")
    jmodel = jbuild({"cube_a": jasset("cube_mesh"),
                     "cube_b": jasset("cube_mesh")},
                    mesh_representation="deep_support_convex")
    numpy_params = params_numpy(jmodel.initial_params(jnp.float64))
    return (model, params_from_numpy(model, *numpy_params), jmodel,
            jax_params(numpy_params))


def test_two_mesh_model_structure(two_cubes):
    """Ground against each cube (4 contacts each) and the cubes against
    each other (1): 9 contacts, 14 coordinates, as in the JAX package."""
    model, _, jmodel, _ = two_cubes
    assert model.n_q == 14 and model.n_v == 12 and model.n_contacts == 9
    kinds = [(model.geometries[a].geom_type, model.geometries[b].geom_type)
             for a, b in model.collision_candidates]
    assert ("plane", "deep_support_convex") in kinds
    assert ("deep_support_convex", "deep_support_convex") in kinds
    _same_models(model, jmodel)


def test_two_mesh_terms_finite(two_cubes):
    """The terms of two separated ICNN bodies are finite, the mesh-mesh
    distance lies between 1 and 3 m and falls as they approach, and the
    terms equal the JAX package's."""
    model, params, jmodel, jparams = two_cubes
    q = np.concatenate(([1.0, 0, 0, 0, -1.5, 0.0, 2.0],
                        [1.0, 0, 0, 0, 1.5, 0.0, 2.0]))
    v = 0.1 * np.random.default_rng(2).standard_normal(12)
    with torch.no_grad():
        got = multibody_terms(model, params, torch.tensor(q),
                              torch.tensor(v),
                              torch.zeros(0, dtype=torch.float64))
    D, M, J, phi, a_nc = got
    assert phi.shape == (9,) and J.shape == (27, 12)
    for arr in got:
        assert bool(torch.isfinite(arr).all())
    assert 1.0 < float(phi[-1]) < 3.0
    q_close = q.copy()
    q_close[4], q_close[11] = -0.5, 0.5
    with torch.no_grad():
        phi_close, _ = contact_terms(model, params, torch.tensor(q_close))
    assert float(phi_close[-1]) < float(phi[-1])
    ref = jterms(jmodel, jparams, jnp.asarray(q), jnp.asarray(v),
                 jnp.zeros((0,)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-11)


def test_two_mesh_gradients(two_cubes):
    """The gradient of the contact terms of two touching ICNN bodies is
    finite for every leaf, and the friction's equals the JAX package's."""
    model, params, jmodel, jparams = two_cubes
    q = np.concatenate(([1.0, 0, 0, 0, -0.06, 0.0, 0.06],
                        [1.0, 0, 0, 0, 0.06, 0.0, 0.06]))
    leaves = params.parameters()
    for leaf in leaves:
        leaf.requires_grad_(True)
    phi, J = contact_terms(model, params, torch.tensor(q))
    grads = torch.autograd.grad(torch.sum(phi ** 2) + torch.sum(J ** 2),
                                leaves, allow_unused=True)
    for grad in grads:
        assert grad is None or bool(torch.isfinite(grad).all())

    def loss(p):
        jphi, jJ = jcontact_terms(jmodel, p, jnp.asarray(q))
        return jnp.sum(jphi ** 2) + jnp.sum(jJ ** 2)

    want = jax.grad(loss)(jparams)
    assert grads[1] is not None
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(want.friction),
                               rtol=1e-8, atol=1e-12)


def test_two_mesh_simulation_step(two_cubes):
    """Ten steps of two ICNN bodies falling beside each other stay
    finite."""
    model, params, _, _ = two_cubes
    system = MultibodyLearnableSystem(model, 0.005, solver_iterations=80,
                                      device="cpu")
    x0 = torch.tensor(np.concatenate((
        [1.0, 0, 0, 0, -0.06, 0.0, 0.2], [1.0, 0, 0, 0, 0.06, 0.0, 0.2],
        np.zeros(12))))
    with torch.no_grad():
        trajectory = system.simulate(params, x0, 10)
    assert bool(torch.isfinite(trajectory).all())
