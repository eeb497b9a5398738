r"""Lie group/algebra state spaces (PyTorch).

Counterpart of the spaces of ``dair_pll_tpu/state_space.py``: each space
models configurations on a Lie group :math:`G` and velocities on its
algebra; operations broadcast over leading batch dims, the state index
last. Ported: what rollouts use (splitting and joining states, the
geodesic Euler step, the zero state). Not ported yet: configuration
differences and projections, noisers and samplers.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from dair_pll_tpu_torch.ops import quaternion

N_QUAT = 4
N_ANG_VEL = 3
N_COM = 3


class StateSpace:
    r"""State space :math:`G \times \mathfrak g`. Subclasses implement
    :meth:`exponential` and :meth:`zero_state`."""

    n_q: int
    n_v: int
    n_x: int

    def __init__(self, n_q: int, n_v: int) -> None:
        if n_q < 0 or n_v < 0:
            raise ValueError("dimensions must be non-negative")
        self.n_q = n_q
        self.n_v = n_v
        self.n_x = n_q + n_v

    def exponential(self, q: Tensor, dq: Tensor) -> Tensor:
        """``q exp(dq)``: ``(*, n_q) x (*, n_v) -> (*, n_q)``."""
        raise NotImplementedError

    def zero_state(self, dtype=torch.float32, device=None) -> Tensor:
        """Identity element of ``G x g`` as an ``(n_x,)`` tensor."""
        raise NotImplementedError

    def q(self, x: Tensor) -> Tensor:
        """Configuration slice of state(s)."""
        return x[..., :self.n_q]

    def v(self, x: Tensor) -> Tensor:
        """Velocity slice of state(s)."""
        return x[..., self.n_q:]

    def q_v(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        """Splits state(s) into configuration and velocity."""
        return self.q(x), self.v(x)

    def x(self, q: Tensor, v: Tensor) -> Tensor:
        """Concatenates configuration and velocity into state(s)."""
        return torch.cat((q, v), dim=-1)

    def euler_step(self, q: Tensor, v: Tensor, dt: float) -> Tensor:
        """Geodesic forward Euler step ``q exp(v dt)``."""
        return self.exponential(q, v * dt)


class FloatingBaseSpace(StateSpace):
    """``SE(3) x R^n_joints``: configuration = unit quaternion (wxyz) +
    world base position + joint angles; velocity = body-frame angular
    velocity + world linear velocity + joint rates."""

    def __init__(self, n_joints: int) -> None:
        super().__init__(7 + n_joints, 6 + n_joints)
        self.n_joints = n_joints

    def __hash__(self):
        return hash(("FloatingBaseSpace", self.n_joints))

    def __eq__(self, other):
        return isinstance(other, FloatingBaseSpace) and \
            other.n_joints == self.n_joints

    def quat(self, q_or_x: Tensor) -> Tensor:
        return q_or_x[..., :N_QUAT]

    def base(self, q_or_x: Tensor) -> Tensor:
        return q_or_x[..., N_QUAT:N_QUAT + N_COM]

    def exponential(self, q: Tensor, dq: Tensor) -> Tensor:
        delta_quat = quaternion.exp(dq[..., :N_ANG_VEL])
        quat_plus = quaternion.multiply(self.quat(q), delta_quat)
        linear_plus = q[..., N_QUAT:] + dq[..., N_ANG_VEL:]
        return torch.cat((quat_plus, linear_plus), dim=-1)

    def zero_state(self, dtype=torch.float32, device=None) -> Tensor:
        zero = torch.zeros((self.n_x,), dtype=dtype, device=device)
        zero[0] = 1.0
        return zero


class FixedBaseSpace(StateSpace):
    """``R^n_joints`` (group = algebra = vector space)."""

    def __init__(self, n_joints: int) -> None:
        super().__init__(n_joints, n_joints)
        self.n_joints = n_joints

    def __hash__(self):
        return hash(("FixedBaseSpace", self.n_joints))

    def __eq__(self, other):
        return isinstance(other, FixedBaseSpace) and \
            other.n_joints == self.n_joints

    def exponential(self, q: Tensor, dq: Tensor) -> Tensor:
        return q + dq

    def zero_state(self, dtype=torch.float32, device=None) -> Tensor:
        return torch.zeros((self.n_x,), dtype=dtype, device=device)


class ProductSpace(StateSpace):
    """Cartesian product of spaces; coordinates concatenate per kind (all
    configurations first, then all velocities)."""

    def __init__(self, spaces) -> None:
        self.spaces = tuple(spaces)
        super().__init__(
            sum(s.n_q for s in self.spaces), sum(s.n_v for s in self.spaces))

    def __hash__(self):
        return hash(("ProductSpace",) + self.spaces)

    def __eq__(self, other):
        return isinstance(other, ProductSpace) and other.spaces == self.spaces

    @staticmethod
    def _split(t: Tensor, sizes):
        return list(torch.split(t, list(sizes), dim=-1))

    def q_split(self, q: Tensor):
        return self._split(q, [s.n_q for s in self.spaces])

    def v_split(self, v: Tensor):
        return self._split(v, [s.n_v for s in self.spaces])

    def exponential(self, q: Tensor, dq: Tensor) -> Tensor:
        return torch.cat([
            s.exponential(qi, dqi) for s, qi, dqi in
            zip(self.spaces, self.q_split(q), self.v_split(dq))], dim=-1)

    def zero_state(self, dtype=torch.float32, device=None) -> Tensor:
        zeros = [s.zero_state(dtype, device) for s in self.spaces]
        q = torch.cat([s.q(z) for s, z in zip(self.spaces, zeros)], dim=-1)
        v = torch.cat([s.v(z) for s, z in zip(self.spaces, zeros)], dim=-1)
        return torch.cat((q, v), dim=-1)
