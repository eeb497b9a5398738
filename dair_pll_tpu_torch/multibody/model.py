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
from dair_pll_tpu_torch.params import tree_from_numpy, tree_leaves, tree_map

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
                               geometry=tree_map(fn, self.geometry))

    def parameters(self) -> List[torch.Tensor]:
        """The leaf tensors in a fixed order, for a ``torch.optim``
        optimizer: ``theta``, ``friction``, then each geometry's leaves in
        geometry order, in the order of JAX's ``tree_leaves`` (dictionary
        keys sorted, lists in order), so that leaf lists compare one to
        one with the JAX package's."""
        return [self.theta, self.friction, *tree_leaves(self.geometry)]


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
    template = model.initial_params(dtype, device)
    return MultibodyParams(
        theta=tree_from_numpy(template.theta, theta, "theta"),
        friction=tree_from_numpy(template.friction, friction, "friction"),
        geometry=tree_from_numpy(template.geometry, tuple(geometry),
                                 "geometry"))
