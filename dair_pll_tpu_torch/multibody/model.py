r"""Static multibody model description and learnable parameters (PyTorch).

Counterpart of ``dair_pll_tpu/multibody/model.py``. A
:class:`MultibodyModel` is static metadata (plain numpy, Python ints and
strings) describing the kinematic tree, collision geometries and initial
parameter values; the learnable values live in a :class:`MultibodyParams`
of tensors on a chosen device.

Conventions (as in the JAX package):

* Bodies are indexed topologically; ``parent == -1`` denotes the world.
* Joint types: ``"free"``, ``"revolute"``, ``"prismatic"``, ``"fixed"``.
* Per URDF model the configuration is ``[quat(4, wxyz), world position(3),
  joint angles]`` and the velocity ``[body-frame angular velocity(3),
  world linear velocity(3), rates]``.
* A ground half-space ``z = 0`` with friction 1.0 is geometry 0.
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from dair_pll_tpu_torch import inertia as inertia_mod
from dair_pll_tpu_torch import state_space as space_mod
from dair_pll_tpu_torch.geometry import (CollisionGeometrySpec,
                                         default_geometry_params)

GROUND_FRICTION = 1.0
GRAVITY = 9.81


@dataclasses.dataclass(frozen=True)
class JointSpec:
    """Inboard joint of a body.

    Attributes:
        joint_type: "free", "revolute", "prismatic" or "fixed".
        parent: parent body index (-1 = world).
        R_PJ: (3, 3) rotation of the joint frame in the parent body frame.
        p_PJ: (3,) joint frame origin in the parent body frame.
        axis: (3,) joint axis in the joint (= child) frame.
        name: joint name (URDF).
        actuated: whether a URDF <transmission> drives this joint.
    """
    joint_type: str
    parent: int
    R_PJ: Tuple[Tuple[float, ...], ...]
    p_PJ: Tuple[float, ...]
    axis: Tuple[float, ...]
    name: str
    actuated: bool = False


@dataclasses.dataclass(frozen=True)
class BodySpec:
    """Rigid body with its inboard joint; ``pi_cm_init`` is the initial
    10-vector ``[m, m*p_com, I_cm(6)]``."""
    name: str
    model_index: int
    joint: JointSpec
    pi_cm_init: Tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One URDF model: its name and body index range in the global list."""
    name: str
    body_indices: Tuple[int, ...]
    floating: bool
    n_joints: int


@dataclasses.dataclass(frozen=True)
class MultibodyModel:
    """Complete static description of a multibody scene.

    Attributes:
        models: per-URDF model specs.
        bodies: all bodies, parents before children.
        geometries: all collision geometries; index 0 is the ground plane.
        collision_candidates: ``(a, b)`` geometry index pairs ordered by
          geometry type rank.
        n_q, n_v, n_u: configuration/velocity/actuation dimensions.
        contacts_per_pair: contact points per candidate pair.
        urdf_paths: original URDF paths by model name.
    """
    models: Tuple[ModelSpec, ...]
    bodies: Tuple[BodySpec, ...]
    geometries: Tuple[CollisionGeometrySpec, ...]
    collision_candidates: Tuple[Tuple[int, int], ...]
    n_q: int
    n_v: int
    n_u: int
    contacts_per_pair: Tuple[int, ...]
    urdf_paths: Tuple[Tuple[str, str], ...] = ()

    @property
    def n_bodies(self) -> int:
        return len(self.bodies)

    @property
    def n_contacts(self) -> int:
        """Total (static) number of contact points."""
        return sum(self.contacts_per_pair)

    def body_q_offset(self, body_index: int) -> int:
        """Configuration offset of the body's joint coordinates."""
        return self._layout()[0][body_index]

    def body_v_offset(self, body_index: int) -> int:
        """Velocity offset of the body's joint coordinates."""
        return self._layout()[1][body_index]

    def _layout(self):
        """Per-body (q_offset, v_offset); cached on first use."""
        if not hasattr(self, "_layout_cache"):
            q_offsets, v_offsets = [], []
            q_off = v_off = 0
            for body in self.bodies:
                q_offsets.append(q_off)
                v_offsets.append(v_off)
                if body.joint.joint_type == "free":
                    q_off += 7
                    v_off += 6
                elif body.joint.joint_type in ("revolute", "prismatic"):
                    q_off += 1
                    v_off += 1
            object.__setattr__(self, "_layout_cache", (q_offsets, v_offsets))
        return self._layout_cache

    def state_space(self) -> space_mod.StateSpace:
        """The state space: a product over per-URDF floating or fixed
        base spaces."""
        spaces = [space_mod.FloatingBaseSpace(model.n_joints)
                  if model.floating else
                  space_mod.FixedBaseSpace(model.n_joints)
                  for model in self.models]
        if len(spaces) == 1:
            return spaces[0]
        return space_mod.ProductSpace(spaces)

    def initial_params(self, dtype=torch.float32,
                       device=None) -> "MultibodyParams":
        """Initial learnable parameters from the URDF values."""
        pi_cm = np.stack([np.asarray(b.pi_cm_init) for b in self.bodies])
        theta = inertia_mod.pi_cm_to_theta(
            torch.as_tensor(pi_cm, dtype=dtype, device=device))
        friction = torch.as_tensor(
            np.array([g.mu for g in self.geometries], dtype=np.float64),
            dtype=dtype, device=device)
        geometry = tuple(default_geometry_params(g, dtype, device)
                         for g in self.geometries)
        return MultibodyParams(theta=theta, friction=friction,
                               geometry=geometry)

    def __hash__(self):
        return hash((self.models, self.bodies, self.geometries,
                     self.collision_candidates))


@dataclasses.dataclass
class MultibodyParams:
    """Learnable parameters.

    Attributes:
        theta: ``(n_bodies, 10)`` unconstrained inertial parameters
          (Rucker-Wensing; see ``dair_pll_tpu_torch.inertia``).
        friction: ``(n_geometries,)``; the coefficient in use is
          ``|friction|``.
        geometry: per-geometry parameter dictionaries of tensors; ``None``
          for parameter-free shapes.
    """
    theta: torch.Tensor
    friction: torch.Tensor
    geometry: Tuple

    def pi_cm(self) -> torch.Tensor:
        """Inertial parameters in ``pi_cm`` format, ``(n_bodies, 10)``."""
        return inertia_mod.theta_to_pi_cm(self.theta)

    def friction_coefficients(self) -> torch.Tensor:
        """Non-negative friction coefficients."""
        return torch.abs(self.friction)

    def map(self, fn) -> "MultibodyParams":
        """The parameters with ``fn`` applied to every leaf tensor, in the
        same structure."""
        return MultibodyParams(theta=fn(self.theta),
                               friction=fn(self.friction),
                               geometry=_tree_map(fn, self.geometry))

    def parameters(self) -> List[torch.Tensor]:
        """The leaf tensors in a fixed order, for a ``torch.optim``
        optimizer: ``theta``, ``friction``, then each geometry's leaves in
        geometry order, in the order of JAX's ``tree_leaves`` (dictionary
        keys sorted, lists in order), so that leaf lists compare one to
        one with the JAX package's."""
        return [self.theta, self.friction, *_tree_leaves(self.geometry)]


def _tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of nested dictionaries, lists and tuples (``None``
    skipped), dictionary keys sorted, as ``jax.tree_util.tree_leaves``
    orders them."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [leaf for key in sorted(tree)
                for leaf in _tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _tree_leaves(item)]
    return [tree]


def _tree_map(fn, tree):
    """``fn`` on the tensors of nested dictionaries, lists and tuples
    (``None`` kept)."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {key: _tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, item) for item in tree)
    return fn(tree)


def params_from_numpy(model: MultibodyModel, theta, friction,
                      geometry: Sequence[Optional[Mapping]],
                      dtype=torch.float64, device=None) -> MultibodyParams:
    """Carries parameters across from the JAX package.

    Takes the fields of a JAX ``MultibodyParams`` as numpy arrays:
    ``theta`` ``(n_bodies, 10)``, ``friction`` ``(n_geom,)`` and, per
    geometry, ``None`` or a mapping such as ``{"half_lengths": ...}``,
    ``{"vertices": ...}``, ``{"radius": ...}`` or the nested ICNN mapping
    ``{"icnn": {"hidden_weights": [...], "input_weights": [...],
    "output_weight": ...}, "perturbations": ...}``. Keys, list lengths and
    every leaf's shape are checked against the spec's initial parameters.
    Returns the port's :class:`MultibodyParams` on ``device`` in
    ``dtype``.
    """
    theta = np.asarray(theta, dtype=np.float64)
    friction = np.asarray(friction, dtype=np.float64)
    if theta.shape != (model.n_bodies, 10):
        raise ValueError(f"theta has shape {theta.shape}, expected "
                         f"{(model.n_bodies, 10)}")
    if friction.shape != (len(model.geometries),):
        raise ValueError(f"friction has shape {friction.shape}, expected "
                         f"{(len(model.geometries),)}")
    if len(geometry) != len(model.geometries):
        raise ValueError(f"{len(geometry)} geometry entries for "
                         f"{len(model.geometries)} geometries")

    def tensor(value):
        # A copy: the caller's arrays may be read-only views of JAX
        # buffers.
        return torch.as_tensor(np.array(value, dtype=np.float64),
                               dtype=dtype, device=device)

    def convert(expected, given, where: str):
        """``given`` in the structure of ``expected``, as tensors."""
        if isinstance(expected, Mapping):
            if not isinstance(given, Mapping) or set(given) != set(expected):
                raise ValueError(f"{where} needs keys {sorted(expected)}")
            return {key: convert(ref, given[key], f"{where} {key}")
                    for key, ref in expected.items()}
        if isinstance(expected, list):
            if not isinstance(given, (list, tuple)) or \
                    len(given) != len(expected):
                raise ValueError(f"{where} needs a list of {len(expected)}")
            return [convert(ref, item, f"{where}[{i}]")
                    for i, (ref, item) in enumerate(zip(expected, given))]
        value = tensor(given)
        if value.shape != expected.shape:
            raise ValueError(f"{where} has shape {tuple(value.shape)}, "
                             f"expected {tuple(expected.shape)}")
        return value

    geometry_out = []
    for spec, entry in zip(model.geometries, geometry):
        expected = default_geometry_params(spec, torch.float64)
        if expected is None:
            if entry:
                raise ValueError(f"geometry {spec.name} takes no parameters")
            geometry_out.append(None)
            continue
        geometry_out.append(convert(expected, entry, f"geometry {spec.name}"))
    return MultibodyParams(theta=tensor(theta), friction=tensor(friction),
                           geometry=tuple(geometry_out))


def params_from_leaves(model: MultibodyModel, leaves: Sequence,
                       dtype=torch.float64, device=None) -> MultibodyParams:
    """The inverse of :meth:`MultibodyParams.parameters`: arrays in that
    order (the order of JAX's ``tree_leaves`` of its parameters, so also a
    JAX run's flattened parameters) back into the model's structure, read
    by :func:`params_from_numpy`, which checks every shape."""
    leaves = list(leaves)
    template = model.initial_params(torch.float64)
    position = iter(range(2, len(leaves)))

    def fill(tree):
        if tree is None:
            return None
        if isinstance(tree, Mapping):
            return {key: fill(tree[key]) for key in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return [fill(item) for item in tree]
        index = next(position, None)
        if index is None:
            raise ValueError(f"{len(leaves)} leaves; the model has more")
        return leaves[index]

    if len(leaves) < 2:
        raise ValueError(f"{len(leaves)} leaves; the model has more")
    geometry = [fill(entry) for entry in template.geometry]
    if next(position, None) is not None:
        raise ValueError(f"{len(leaves)} leaves; the model has fewer")
    return params_from_numpy(model, leaves[0], leaves[1], geometry,
                             dtype=dtype, device=device)
