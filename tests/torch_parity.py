"""Shared inputs for the ``test_torch_*`` parity tests: seeded numpy
states and parameters that feed the JAX package and its PyTorch port
alike (the two frameworks' generators differ, so inputs come from
numpy). Cube states near the ground come from the port's
``assets.cube_states_near_ground``, which ``chip_smoke.py`` uses too."""
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
