"""Shared inputs for the ``test_torch_*`` parity tests: seeded numpy
states and parameters that feed the JAX package and its PyTorch port
alike (the two frameworks' generators differ, so inputs come from
numpy). Cube states near the ground come from the port's
``assets.cube_states_near_ground``, which ``chip_smoke.py`` uses too."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dair_pll_tpu.multibody.model import MultibodyParams as JParams

DT = 0.0068


def cube_transitions(rng: np.random.Generator, n: int = 8):
    """``(x, x_plus)``, each ``(2 n, 13)``: ``n`` transitions of the JAX
    package's ``tests/test_fused_kernel.py`` recipe (random states at
    heights straddling contact, ``x_plus`` a small random perturbation)
    and ``n`` cube states near the ground with their next state from one
    step of the port's float64 rollout (active contacts)."""
    from dair_pll_tpu_torch import assets
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    x = rng.standard_normal((n, 13))
    x[:, :4] /= np.linalg.norm(x[:, :4], axis=-1, keepdims=True)
    x[:, 6] = 0.02 + 0.08 * rng.random(n)
    x_plus = x + 0.005 * rng.standard_normal((n, 13))
    x_plus[:, :4] /= np.linalg.norm(x_plus[:, :4], axis=-1, keepdims=True)

    system = MultibodyLearnableSystem.from_urdfs(
        {"cube": assets.get_asset("cube")}, DT, device="cpu")
    near = assets.cube_states_near_ground(rng, n)
    step = system.simulate_batch(system.initial_params(torch.float64),
                                 torch.tensor(near), 1, use_fused=True)
    return (np.concatenate([x, near]),
            np.concatenate([x_plus, step[:, 1].numpy()]))


def icnn_transitions(rng: np.random.Generator, numpy_params, n: int = 8):
    """``(x, x_plus)``, each ``(n, 13)``: ICNN cube states near the ground
    at the parameters ``numpy_params`` (``(theta, friction, geometry)``,
    carried across) and their next states from one step of the port's
    float64 rollout."""
    from dair_pll_tpu_torch import assets
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    from dair_pll_tpu_torch.multibody.model import params_from_numpy
    system = MultibodyLearnableSystem.from_urdfs(
        {"cube": assets.get_asset("cube_mesh")}, DT, device="cpu")
    params = params_from_numpy(system.model, *numpy_params)
    x = assets.icnn_states_near_ground(rng, n, params.geometry[1]["icnn"])
    step = system.simulate_batch(params, torch.tensor(x), 1, use_fused=True)
    return x, step[:, 1].numpy()


def map_tree(fn, tree):
    """``fn`` on every array leaf of nested dictionaries and lists (a
    geometry entry; ``None`` stays ``None``), keys in insertion order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: map_tree(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, item) for item in tree]
    return fn(tree)


def jax_params(numpy_params) -> JParams:
    """``(theta, friction, geometry)`` numpy -> JAX ``MultibodyParams``."""
    theta, friction, geometry = numpy_params
    return JParams(theta=jnp.asarray(theta), friction=jnp.asarray(friction),
                   geometry=tuple(map_tree(jnp.asarray, g) for g in geometry))


def perturbed_params(rng: np.random.Generator, theta, friction, geometry):
    """Perturbs JAX ``MultibodyParams`` fields given as numpy arrays;
    returns ``(theta, friction, geometry)`` in the same form. Each
    geometry leaf is scaled by a factor in [0.95, 1.05] per entry."""
    theta = np.asarray(theta) + 0.1 * rng.standard_normal(np.shape(theta))
    friction = np.asarray(friction) * rng.uniform(0.8, 1.25,
                                                  np.shape(friction))
    geometry = [map_tree(lambda val: np.asarray(val) * rng.uniform(
        0.95, 1.05, np.shape(val)), g) for g in geometry]
    return theta, friction, geometry


def params_numpy(params):
    """JAX ``MultibodyParams`` -> ``(theta, friction, geometry)`` numpy."""
    return (np.asarray(params.theta), np.asarray(params.friction),
            [map_tree(np.asarray, g) for g in params.geometry])


#: Models of the parity tests by name: URDF assets per model instance.
MODELS = {"cube": {"cube": "cube"}, "cube_mesh": {"cube": "cube_mesh"},
          "elbow": {"elbow": "elbow"},
          "two_mesh_cubes": {"cube_a": "cube_mesh", "cube_b": "cube_mesh"}}


def model_pair(name: str, **kwargs):
    """The JAX package's and the port's (CPU) ``MultibodyLearnableSystem``
    of a model of :data:`MODELS`, with the same constructor arguments."""
    from dair_pll_tpu.assets import get_asset as jasset
    from dair_pll_tpu.multibody.learnable_system import (
        MultibodyLearnableSystem as JSystem)
    from dair_pll_tpu_torch import assets
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem as TSystem)
    urdfs = MODELS[name]
    jsystem = JSystem.from_urdfs(
        {key: jasset(value) for key, value in urdfs.items()}, DT, **kwargs)
    tsystem = TSystem.from_urdfs(
        {key: assets.get_asset(value) for key, value in urdfs.items()}, DT,
        device="cpu", **kwargs)
    return jsystem, tsystem


def random_states(name: str, model, rng: np.random.Generator, n: int):
    """``(n, n_x)`` float64 states of a model of :data:`MODELS` near
    contact: unit quaternions, bodies a few centimetres above the ground
    (the two mesh cubes side by side, 1.2 m apart at 0.3 m, their
    random-init support networks some 0.5 m across), velocities of a few
    tenths."""
    x = rng.standard_normal((n, model.n_q + model.n_v))
    x[:, model.n_q:] *= 0.3
    bases = [(0, (0.0, 0.0, 0.06))] if name != "two_mesh_cubes" else \
        [(0, (-0.6, 0.0, 0.3)), (7, (0.6, 0.0, 0.3))]
    for offset, position in bases:
        quat = x[:, offset:offset + 4]
        x[:, offset:offset + 4] = quat / np.linalg.norm(quat, axis=-1,
                                                        keepdims=True)
        x[:, offset + 4:offset + 7] = np.asarray(position) + \
            0.02 * rng.standard_normal((n, 3))
    return x


def cube_qps(rng: np.random.Generator, n: int):
    """Contact QPs of the cube in float64, from the port's terms at
    initial parameters: ``{"rollout": ..., "loss": ...}``, each a tuple
    ``(delassus, M, J, q, eps)`` of numpy arrays and the regularization.
    Rollout QPs are the dynamics solve's at ``n`` states near the ground
    (eps 1e-4); loss QPs the ContactNets loss's on ``cube_transitions``
    (eps 1e-3)."""
    from dair_pll_tpu_torch import assets
    from dair_pll_tpu_torch.multibody.learnable_system import (
        DYNAMICS_EPSILON, LOSS_EPSILON, MultibodyLearnableSystem)
    system = MultibodyLearnableSystem.from_urdfs(
        {"cube": assets.get_asset("cube")}, DT, device="cpu")
    params = system.initial_params(torch.float64)
    x = torch.tensor(assets.cube_states_near_ground(rng, n))
    q, v = system.space.q_v(x)
    u = x.new_zeros((n, 0))
    with torch.no_grad():
        delassus, M, J, _, _, q_full = system._rollout_qp(params, q, v, u)
        xs, xps = (torch.tensor(t) for t in cube_transitions(rng, n // 2))
        loss_D, loss_q, loss_M, loss_J, _, _ = system._contactnets_qp(
            params, xs, xs.new_zeros((xs.shape[0], 0)), xps)
    return {"rollout": (delassus.numpy(), M.numpy(), J.numpy(),
                        q_full.numpy(), DYNAMICS_EPSILON),
            "loss": (loss_D.numpy(), loss_M.numpy(), loss_J.numpy(),
                     loss_q.numpy(), LOSS_EPSILON)}


def random_qps(rng: np.random.Generator, n: int, eps: float, k: int = 4,
               n_v: int = 6):
    """Random contact-like QPs, the recipe of the JAX package's
    ``tests/test_socp_solver.py``: ``(delassus, M, J, q, eps)``."""
    A = rng.standard_normal((n, n_v, n_v))
    M = A @ A.transpose(0, 2, 1) + n_v * np.eye(n_v)
    J = rng.standard_normal((n, 3 * k, n_v))
    q = rng.standard_normal((n, 3 * k))
    return J @ np.linalg.solve(M, J.transpose(0, 2, 1)), M, J, q, eps


# -- the model-generic loss kernels' models ----------------------------------------
_BOX_INERTIAL = """
      <inertial>
        <origin xyz="0 0 0" rpy="0 0 0"/>
        <mass value="0.5"/>
        <inertia ixx="0.002" iyy="0.003" izz="0.004"
                 ixy="0" ixz="0" iyz="0"/>
      </inertial>"""
_BOX_COLLISION = """
      <collision>
        <origin xyz="0 0 0" rpy="0 0 0"/>
        <geometry><box size="0.1 0.1 0.1"/></geometry>
      </collision>"""
#: ``tests/test_urdf_features.py``'s prismatic ``pris2`` and
#: ``tests/test_fused_loss.py``'s actuated ``paddle``.
FEATURE_URDFS = {
    "pris2": f"""<robot name="pris2">
  <link name="base">{_BOX_INERTIAL}{_BOX_COLLISION}
  </link>
  <link name="slider">{_BOX_INERTIAL}{_BOX_COLLISION}
  </link>
  <joint name="slide" type="prismatic">
    <parent link="base"/>
    <child link="slider"/>
    <origin xyz="0 0 0.15" rpy="0 0 0"/>
    <axis xyz="0 0 1"/>
  </joint>
</robot>
""",
    "paddle": """<robot name="paddle">
  <link name="base">
    <inertial>
      <mass value="0.5"/>
      <inertia ixx="0.002" iyy="0.003" izz="0.004"
               ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision>
      <geometry><box size="0.1 0.1 0.1"/></geometry>
    </collision>
  </link>
  <link name="arm">
    <inertial>
      <mass value="0.2"/>
      <inertia ixx="0.001" iyy="0.001" izz="0.001"
               ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision>
      <geometry><box size="0.08 0.02 0.02"/></geometry>
    </collision>
  </link>
  <joint name="swing" type="revolute">
    <parent link="base"/>
    <child link="arm"/>
    <origin xyz="0 0 0.1" rpy="0 0 0"/>
    <axis xyz="0 1 0"/>
  </joint>
  <transmission name="swing_drive">
    <joint name="swing"/>
  </transmission>
</robot>
"""}
#: The generic loss kernels' parity models: (asset or URDF name, mesh
#: representation); the elbow in boxes and in polygons, the polygon cube,
#: ``pris2`` and the actuated ``paddle``.
KERNEL_MODELS = {"elbow": ("elbow", None),
                 "elbow_polygon": ("elbow_mesh", "polygon"),
                 "cube_polygon": ("cube_mesh", "polygon"),
                 "pris2": ("pris2", None), "paddle": ("paddle", None)}
#: The models of every size the JAX kernels take beyond the five above
#: (``tests/test_torch_size_cover.py``): a ball (one sphere, (n_v, k) =
#: (6, 1)), a box and a sphere on one body (``tests/test_urdf_features.py``'s
#: pattern; witnesses 4 + 1, (6, 5)), a pentagonal prism of 10 vertices as
#: a polygon, and three box cubes (15 contacts; the K6 route).
SIZE_URDFS = {
    "ball": """<robot name="ball"><link name="ball">
  <inertial><mass value="0.3"/><inertia ixx="0.0003" iyy="0.0003"
    izz="0.0003" ixy="0" ixz="0" iyz="0"/></inertial>
  <collision><geometry><sphere radius="0.05"/></geometry></collision>
</link></robot>""",
    "box_sphere": f"""<robot name="box_sphere"><link name="body">{_BOX_INERTIAL}
  <collision><origin xyz="0.1 0 0" rpy="0 0 0"/>
    <geometry><box size="0.1 0.2 0.3"/></geometry></collision>
  <collision><origin xyz="-0.1 0 0" rpy="0 0 0"/>
    <geometry><sphere radius="0.05"/></geometry></collision>
</link></robot>""",
    "prism10": f"""<robot name="prism10"><link name="body">{_BOX_INERTIAL}
  <collision><origin xyz="0 0 0" rpy="0 0 0"/>
    <geometry><mesh filename="prism10.obj"/></geometry></collision>
</link></robot>"""}


def prism_obj(n: int = 5, radius: float = 0.05, half: float = 0.04) -> str:
    """A prism over a regular ``n``-gon: ``2 n`` vertices (an ``.obj``)."""
    import math
    rows = [f"v {radius * math.cos(2 * math.pi * i / n):.9f} "
            f"{radius * math.sin(2 * math.pi * i / n):.9f} {z:.9f}"
            for z in (-half, half) for i in range(n)]
    return "\n".join(rows) + "\n"


def size_model_urdfs(name: str, tmp_dir: str):
    """``({name: URDF path}, mesh_representation)`` of a model of
    :data:`SIZE_URDFS` (written, with the prism's mesh, to ``tmp_dir``),
    or of the three cubes (``"three_cubes"``, the ``cube`` asset three
    times; ``jax_side`` picks whose)."""
    import os
    if name == "three_cubes":
        from dair_pll_tpu_torch import assets
        path = assets.get_asset("cube")
        return {f"cube_{c}": path for c in "abc"}, None
    if name == "prism10":
        with open(os.path.join(str(tmp_dir), "prism10.obj"), "w",
                  encoding="utf-8") as handle:
            handle.write(prism_obj())
    path = os.path.join(str(tmp_dir), f"{name}.urdf")
    with open(path, "w", encoding="utf-8") as handle:
        handle.write(SIZE_URDFS[name])
    return {name: path}, "polygon" if name == "prism10" else None


#: Base heights of the near-ground states by model: the elbow and the
#: cubes rest on their boxes; pris2's and the paddle's second body sits
#: above the base.
_BASE_HEIGHT = {"elbow": 0.03, "elbow_polygon": 0.03, "cube_polygon": 0.05,
                "pris2": 0.05, "paddle": 0.05}


def kernel_model_urdfs(name: str, tmp_dir: str, jax_side: bool):
    """``({model name: URDF path}, mesh_representation)`` of a model of
    :data:`KERNEL_MODELS`; the feature URDFs are written to ``tmp_dir``."""
    import os
    asset, representation = KERNEL_MODELS[name]
    if asset in FEATURE_URDFS:
        path = os.path.join(str(tmp_dir), f"{asset}.urdf")
        with open(path, "w", encoding="utf-8") as handle:
            handle.write(FEATURE_URDFS[asset])
    elif jax_side:
        from dair_pll_tpu.assets import get_asset
        path = get_asset(asset)
    else:
        from dair_pll_tpu_torch import assets
        path = assets.get_asset(asset)
    return {asset: path}, representation


def kernel_model_pair(name: str, tmp_dir: str):
    """The JAX package's and the port's ``MultibodyModel`` of a model of
    :data:`KERNEL_MODELS`."""
    from dair_pll_tpu.urdf import build_multibody_model as jbuild
    from dair_pll_tpu_torch.urdf import build_multibody_model as tbuild
    models = []
    for jax_side, build in ((True, jbuild), (False, tbuild)):
        urdfs, representation = kernel_model_urdfs(name, tmp_dir, jax_side)
        kwargs = ({} if representation is None else
                  {"mesh_representation": representation})
        models.append(build(urdfs, **kwargs))
    return tuple(models)


def kernel_transitions(name: str, tmodel, rng: np.random.Generator,
                       n: int = 8):
    """``(x, x_plus, u)`` of a model of :data:`KERNEL_MODELS`, ``2 n``
    float64 transitions: ``n`` of the JAX package's random recipe (a
    perturbed ``x_plus``) and ``n`` states near the ground with their next
    state from one step of the port's float64 fused rollout (active
    contacts); ``u`` random for actuated models."""
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    n_x = tmodel.n_q + tmodel.n_v

    def states(height, spread):
        x = rng.standard_normal((n, n_x))
        x[:, 7:] *= 0.3
        x[:, :4] /= np.linalg.norm(x[:, :4], axis=-1, keepdims=True)
        x[:, 4:7] = spread * rng.standard_normal((n, 3))
        x[:, 6] += height
        return x

    x = states(_BASE_HEIGHT[name] + 0.03, 0.03)
    x_plus = x + 0.005 * rng.standard_normal((n, n_x))
    x_plus[:, :4] /= np.linalg.norm(x_plus[:, :4], axis=-1, keepdims=True)
    near = states(_BASE_HEIGHT[name], 0.01)
    system = MultibodyLearnableSystem(tmodel, DT, device="cpu")
    step = system.simulate_batch(system.initial_params(torch.float64),
                                 torch.tensor(near), 1, use_fused=True)
    u = 0.1 * rng.standard_normal((2 * n, tmodel.n_u))
    return (np.concatenate([x, near]),
            np.concatenate([x_plus, step[:, 1].numpy()]), u)


# -- JAX references of the generic loss kernels' models ---------------------------
LOSS_EPS = 1e-3
COLD_BUDGET, WARM_BUDGET = (10, 10), (4, 10)
#: Models whose warm loss the parity tests hold against JAX.
WARM_CASES = ("elbow",)


def _jax_loss_parts(jmodel, params, x, u, x_plus):
    """JAX's ``soa_loss_parts`` of numpy transitions."""
    from dair_pll_tpu.multibody import soa_terms as jterms
    sp = jterms.scalarize_derived(
        jmodel, jterms.derive_scalar_params(jmodel, params))
    xT, xpT = jnp.asarray(x).T, jnp.asarray(x_plus).T
    n_q, n_v = jmodel.n_q, jmodel.n_v
    return jterms.soa_loss_parts(
        jmodel, sp, list(xT[n_q:n_q + n_v]), list(xpT[:n_q]),
        list(xpT[n_q:n_q + n_v]), list(jnp.asarray(u).T), DT)


@functools.lru_cache(maxsize=None)
def kernel_case(name: str, urdf_dir: str):
    """Models, transitions, perturbed parameters (numpy) and JAX's cold
    loss, impulses and valid mask (the steps of ``soa_contactnets_loss``:
    its terms, its detached cold solve, its assembly), the warm loss's
    impulses and valid mask from the cold impulses, and the packed derived
    vector."""
    from dair_pll_tpu.multibody import soa_terms as jterms
    from dair_pll_tpu.ops import soa as jsoa
    from dair_pll_tpu.ops import soa_loss_pallas as jpack
    from dair_pll_tpu.ops import soa_solver as jsolver
    jmodel, tmodel = kernel_model_pair(name, urdf_dir)
    rng = np.random.default_rng(sorted(KERNEL_MODELS).index(name) + 31)
    x, x_plus, u = kernel_transitions(name, tmodel, rng)
    numpy_params = perturbed_params(
        rng, *params_numpy(jmodel.initial_params(jnp.float64)))
    params = jax_params(numpy_params)
    eps = jnp.asarray(LOSS_EPS)
    ref = {}
    with jax.disable_jit():
        M, Jc, phi, qc, dv = _jax_loss_parts(jmodel, params, x, u, x_plus)
        force, valid = jsolver.solve_contact_impulse_soa(M, Jc, qc, eps,
                                                         *COLD_BUDGET)
        ref["loss"] = jterms.soa_loss_assemble(M, Jc, phi, qc, dv, force,
                                               valid, eps).reshape(-1)
        ref["force"], ref["valid"] = jnp.stack(force), valid.reshape(-1)
        if name in WARM_CASES:
            w_carry = jsoa.spd_solve(M, jsolver.jt_dot(Jc, force))
            warm, _, warm_valid = jsolver.solve_warm_hybrid_soa(
                M, Jc, qc, w_carry, eps, *WARM_BUDGET)
            ref["warm_force"] = jnp.stack(warm)
            ref["warm_valid"] = warm_valid.reshape(-1)
        ref["pvec"] = jpack.pack_derived(
            jmodel, jterms.derive_scalar_params(jmodel, params))
    return jmodel, tmodel, (x, x_plus, u), numpy_params, \
        jax.tree_util.tree_map(np.asarray, ref)


def size_transitions(tmodel, rng: np.random.Generator, n: int = 8):
    """``(x, x_plus)`` of a single free body, ``2 n`` float64 transitions:
    ``n`` near the ground (``assets.tree_states_near_ground``, the lowest
    witness within (-4, 10) mm of the plane) with their next state from
    one step of the port's float64 fused rollout, and ``n`` of them lifted
    2 cm with a perturbed ``x_plus``."""
    from dair_pll_tpu_torch import assets
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    near = assets.tree_states_near_ground(rng, n, tmodel)
    system = MultibodyLearnableSystem(tmodel, DT, device="cpu")
    step = system.simulate_batch(system.initial_params(torch.float64),
                                 torch.tensor(near), 1, use_fused=True)
    lifted = near.copy()
    lifted[:, 6] += 0.02
    x_plus = lifted + 0.005 * rng.standard_normal(lifted.shape)
    x_plus[:, :4] /= np.linalg.norm(x_plus[:, :4], axis=-1, keepdims=True)
    return (np.concatenate([near, lifted]),
            np.concatenate([step[:, 1].numpy(), x_plus]))


@functools.lru_cache(maxsize=None)
def size_case(name: str, urdf_dir: str):
    """The JAX package's and the port's models of a model of
    :data:`SIZE_URDFS`, transitions (:func:`size_transitions`), perturbed
    parameters and JAX's cold loss, impulses and valid mask (eagerly, as
    :func:`kernel_case`)."""
    from dair_pll_tpu.multibody import soa_terms as jterms
    from dair_pll_tpu.ops import soa_solver as jsolver
    from dair_pll_tpu.urdf import build_multibody_model as jbuild
    from dair_pll_tpu_torch.urdf import build_multibody_model as tbuild
    urdfs, representation = size_model_urdfs(name, urdf_dir)
    kwargs = ({} if representation is None else
              {"mesh_representation": representation})
    jmodel, tmodel = jbuild(urdfs, **kwargs), tbuild(urdfs, **kwargs)
    rng = np.random.default_rng(sorted(SIZE_URDFS).index(name) + 51)
    x, x_plus = size_transitions(tmodel, rng)
    u = np.zeros((x.shape[0], 0))
    numpy_params = perturbed_params(
        rng, *params_numpy(jmodel.initial_params(jnp.float64)))
    eps = jnp.asarray(LOSS_EPS)
    with jax.disable_jit():
        M, Jc, phi, qc, dv = _jax_loss_parts(jmodel, jax_params(numpy_params),
                                             x, u, x_plus)
        force, valid = jsolver.solve_contact_impulse_soa(M, Jc, qc, eps,
                                                         *COLD_BUDGET)
        loss = jterms.soa_loss_assemble(M, Jc, phi, qc, dv, force, valid,
                                        eps).reshape(-1)
    ref = {"loss": np.asarray(loss), "force": np.asarray(jnp.stack(force)),
           "valid": np.asarray(valid).reshape(-1)}
    return jmodel, tmodel, (x, x_plus, u), numpy_params, ref


@functools.lru_cache(maxsize=None)
def kernel_gradients(name: str, kind: str, urdf_dir: str):
    """JAX's per-sample loss and the gradients of the summed loss with
    respect to (params, x, x_plus), at the impulse of the cold or warm
    solve: the gradient ``jax.grad`` takes through ``soa_contactnets_loss``
    and ``_warm``, whose solves are detached (the envelope theorem)."""
    from dair_pll_tpu.multibody import soa_terms as jterms
    jmodel, _, (x, x_plus, u), numpy_params, ref = kernel_case(name,
                                                               urdf_dir)
    key = "force" if kind == "cold" else "warm_force"
    force = list(jnp.asarray(ref[key]))
    valid = jnp.asarray(ref[key.replace("force", "valid")])

    def total(p, xx, xxp):
        M, Jc, phi, qc, dv = _jax_loss_parts(jmodel, p, xx, u, xxp)
        loss = jterms.soa_loss_assemble(M, Jc, phi, qc, dv, force, valid,
                                        jnp.asarray(LOSS_EPS)).reshape(-1)
        return jnp.sum(loss), loss

    with jax.disable_jit():
        (_, loss), grads = jax.value_and_grad(
            total, argnums=(0, 1, 2), has_aux=True)(
                jax_params(numpy_params), jnp.asarray(x), jnp.asarray(x_plus))
    return jax.tree_util.tree_map(np.asarray, (loss, grads))


def kernel_port(name: str, urdf_dir: str):
    """The port's CPU system, the perturbed parameters and the
    transitions ``(x, x_plus, u)`` of :func:`kernel_case`, as tensors."""
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    from dair_pll_tpu_torch.multibody.model import params_from_numpy
    _, tmodel, (x, x_plus, u), numpy_params, _ = kernel_case(name, urdf_dir)
    system = MultibodyLearnableSystem(tmodel, DT, device="cpu")
    params = params_from_numpy(tmodel, *numpy_params)
    return system, params, torch.tensor(x), torch.tensor(x_plus), \
        torch.tensor(u)
