r"""Lie group/algebra state spaces (PyTorch).

Counterpart of the spaces of ``dair_pll_tpu/state_space.py``: each space
models configurations on a Lie group :math:`G` and velocities on its
algebra; operations broadcast over leading batch dims, the state index
last. The white noiser and the samplers draw from an explicit
``torch.Generator`` where the JAX package takes a PRNG key.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import Tensor

from dair_pll_tpu_torch.ops import quaternion

N_QUAT = 4
N_ANG_VEL = 3
N_COM = 3

ComparisonCallable = Callable[[Tensor, Tensor], Tensor]


class StateSpace:
    r"""State space :math:`G \times \mathfrak g`. Subclasses implement
    :meth:`configuration_difference`, :meth:`exponential`,
    :meth:`project_configuration` and :meth:`zero_state`; the rest is
    derived."""

    n_q: int
    n_v: int
    n_x: int

    def __init__(self, n_q: int, n_v: int) -> None:
        if n_q < 0 or n_v < 0:
            raise ValueError("dimensions must be non-negative")
        self.n_q = n_q
        self.n_v = n_v
        self.n_x = n_q + n_v

    def configuration_difference(self, q_1: Tensor, q_2: Tensor) -> Tensor:
        """``log(q_1^{-1} q_2)``: ``(*, n_q) x (*, n_q) -> (*, n_v)``."""
        raise NotImplementedError

    def exponential(self, q: Tensor, dq: Tensor) -> Tensor:
        """``q exp(dq)``: ``(*, n_q) x (*, n_v) -> (*, n_q)``."""
        raise NotImplementedError

    def project_configuration(self, q: Tensor) -> Tensor:
        """Projects ``(*, n_q)`` onto the group."""
        raise NotImplementedError

    def zero_state(self, dtype=torch.float32, device=None) -> Tensor:
        """Identity element of ``G x g`` as an ``(n_x,)`` tensor."""
        raise NotImplementedError

    def auxiliary_comparisons(self) -> Dict[str, ComparisonCallable]:
        """Extra named comparisons of state batches (batch means)."""
        return {}

    def auxiliary_pointwise_comparisons(self) -> Dict[str,
                                                      ComparisonCallable]:
        """Per-state variants of :meth:`auxiliary_comparisons`."""
        return {}

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

    def config_square_error(self, q_1: Tensor, q_2: Tensor) -> Tensor:
        """Squared geodesic distance: ``(*, n_q) -> (*)``."""
        diff = self.configuration_difference(q_1, q_2)
        return torch.sum(diff * diff, dim=-1)

    def velocity_square_error(self, v_1: Tensor, v_2: Tensor) -> Tensor:
        """Squared Euclidean distance: ``(*, n_v) -> (*)``."""
        dv = v_2 - v_1
        return torch.sum(dv * dv, dim=-1)

    def state_square_error(self, x_1: Tensor, x_2: Tensor) -> Tensor:
        """Squared geodesic distance between states: ``(*, n_x) -> (*)``."""
        q_1, v_1 = self.q_v(x_1)
        q_2, v_2 = self.q_v(x_2)
        return self.config_square_error(q_1, q_2) + \
            self.velocity_square_error(v_1, v_2)

    def finite_difference(self, q: Tensor, q_plus: Tensor,
                          dt: float) -> Tensor:
        """Rate ``v`` with ``q_plus = q exp(v dt)``."""
        return self.configuration_difference(q, q_plus) / dt

    def euler_step(self, q: Tensor, v: Tensor, dt: float) -> Tensor:
        """Geodesic forward Euler step ``q exp(v dt)``."""
        return self.exponential(q, v * dt)

    def state_difference(self, x_1: Tensor, x_2: Tensor) -> Tensor:
        """Lie-algebra difference on ``G x g``: ``(*, n_x) -> (*, 2 n_v)``."""
        q_1, v_1 = self.q_v(x_1)
        q_2, v_2 = self.q_v(x_2)
        return torch.cat((self.configuration_difference(q_1, q_2),
                          v_2 - v_1), dim=-1)

    def shift_state(self, x: Tensor, dx: Tensor) -> Tensor:
        """Perturbs states by ``dx`` ``(*, 2 n_v)``; the inverse of
        :meth:`state_difference`."""
        q, v = self.q_v(x)
        return self.x(self.exponential(q, dx[..., :self.n_v]),
                      v + dx[..., self.n_v:])

    def project_state(self, x: Tensor) -> Tensor:
        """Projects states onto ``G x g``."""
        return self.x(self.project_configuration(self.q(x)), self.v(x))

    def project_derivative(self, x: Tensor, dt: float) -> Tensor:
        """Replaces the velocities of a trajectory ``(*, T, n_x)`` with
        finite differences of consecutive configurations; drops step 0."""
        q = self.q(x)
        q_plus = q[..., 1:, :]
        return self.x(q_plus, self.finite_difference(q[..., :-1, :], q_plus,
                                                     dt))


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

    def configuration_difference(self, q_1: Tensor, q_2: Tensor) -> Tensor:
        quat_shift = quaternion.multiply(
            quaternion.inverse(self.quat(q_1)), self.quat(q_2))
        rot = quaternion.log(quat_shift)
        return torch.cat((rot, q_2[..., N_QUAT:] - q_1[..., N_QUAT:]),
                         dim=-1)

    def exponential(self, q: Tensor, dq: Tensor) -> Tensor:
        delta_quat = quaternion.exp(dq[..., :N_ANG_VEL])
        quat_plus = quaternion.multiply(self.quat(q), delta_quat)
        linear_plus = q[..., N_QUAT:] + dq[..., N_ANG_VEL:]
        return torch.cat((quat_plus, linear_plus), dim=-1)

    def project_configuration(self, q: Tensor) -> Tensor:
        return torch.cat((quaternion.normalize(self.quat(q)),
                          q[..., N_QUAT:]), dim=-1)

    def zero_state(self, dtype=torch.float32, device=None) -> Tensor:
        zero = torch.zeros((self.n_x,), dtype=dtype, device=device)
        zero[0] = 1.0
        return zero

    def auxiliary_comparisons(self) -> Dict[str, ComparisonCallable]:
        return {"rot_err": self.quaternion_error, "pos_err": self.base_error}

    def auxiliary_pointwise_comparisons(self) -> Dict[str,
                                                      ComparisonCallable]:
        return {"rot_err": self.pointwise_quaternion_error,
                "pos_err": self.pointwise_base_error}

    def pointwise_quaternion_error(self, x_1: Tensor, x_2: Tensor) -> Tensor:
        """Geodesic angle between base orientations, per state."""
        quat_shift = quaternion.multiply(
            quaternion.inverse(self.quat(x_1)), self.quat(x_2))
        return torch.linalg.norm(quaternion.log(quat_shift), dim=-1)

    def pointwise_base_error(self, x_1: Tensor, x_2: Tensor) -> Tensor:
        """Euclidean base-position error, per state."""
        return torch.linalg.norm(self.base(x_1) - self.base(x_2), dim=-1)

    def quaternion_error(self, x_1: Tensor, x_2: Tensor) -> Tensor:
        """Mean geodesic angle between base orientations."""
        return torch.mean(self.pointwise_quaternion_error(x_1, x_2))

    def base_error(self, x_1: Tensor, x_2: Tensor) -> Tensor:
        """Mean Euclidean base-position error."""
        return torch.mean(self.pointwise_base_error(x_1, x_2))


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

    def configuration_difference(self, q_1: Tensor, q_2: Tensor) -> Tensor:
        return q_2 - q_1

    def exponential(self, q: Tensor, dq: Tensor) -> Tensor:
        return q + dq

    def project_configuration(self, q: Tensor) -> Tensor:
        return q

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

    def x_split(self, x: Tensor):
        """Per-subspace states (``q_i ++ v_i``)."""
        return [torch.cat((qi, vi), dim=-1) for qi, vi in
                zip(self.q_split(self.q(x)), self.v_split(self.v(x)))]

    def configuration_difference(self, q_1: Tensor, q_2: Tensor) -> Tensor:
        return torch.cat([
            s.configuration_difference(a, b) for s, a, b in
            zip(self.spaces, self.q_split(q_1), self.q_split(q_2))], dim=-1)

    def exponential(self, q: Tensor, dq: Tensor) -> Tensor:
        return torch.cat([
            s.exponential(qi, dqi) for s, qi, dqi in
            zip(self.spaces, self.q_split(q), self.v_split(dq))], dim=-1)

    def project_configuration(self, q: Tensor) -> Tensor:
        return torch.cat([s.project_configuration(qi) for s, qi in
                          zip(self.spaces, self.q_split(q))], dim=-1)

    def zero_state(self, dtype=torch.float32, device=None) -> Tensor:
        zeros = [s.zero_state(dtype, device) for s in self.spaces]
        q = torch.cat([s.q(z) for s, z in zip(self.spaces, zeros)], dim=-1)
        v = torch.cat([s.v(z) for s, z in zip(self.spaces, zeros)], dim=-1)
        return torch.cat((q, v), dim=-1)

    def _wrap_sub_comparisons(self, per_space) -> Dict[str,
                                                       ComparisonCallable]:
        comparisons: Dict[str, ComparisonCallable] = {}
        for index, space in enumerate(self.spaces):
            prefix = "" if len(self.spaces) == 1 else f"space_{index}_"
            for name, fn in per_space(space).items():
                def compare(x_1, x_2, fn=fn, index=index):
                    return fn(self.x_split(x_1)[index],
                              self.x_split(x_2)[index])
                comparisons[prefix + name] = compare
        return comparisons

    def auxiliary_comparisons(self) -> Dict[str, ComparisonCallable]:
        return self._wrap_sub_comparisons(
            lambda space: space.auxiliary_comparisons())

    def auxiliary_pointwise_comparisons(self) -> Dict[str,
                                                      ComparisonCallable]:
        return self._wrap_sub_comparisons(
            lambda space: space.auxiliary_pointwise_comparisons())


class WhiteNoiser:
    r"""Zero-mean noise on the Lie algebra of a state space, drawn on
    :math:`\mathbb R^{2 n_v}` and applied with :meth:`StateSpace.shift_state`.

    Attributes:
        space: the state space to perturb.
        kind: ``"gaussian"`` (unit standard deviation) or ``"uniform"`` (on
          ``[-1, 1]``).
    """

    def __init__(self, space: StateSpace, kind: str = "gaussian") -> None:
        if kind not in ("gaussian", "uniform"):
            raise ValueError(f"unknown noise kind {kind!r}")
        self.space = space
        self.kind = kind

    @property
    def variance_factor(self) -> float:
        """Per-coordinate variance of the unit-scale noise."""
        return 1.0 / 3.0 if self.kind == "uniform" else 1.0

    def unit_noise(self, generator: torch.Generator, shape, like: Tensor
                    ) -> Tensor:
        # Drawn on the generator's device, then moved next to ``like``.
        device = generator.device
        if self.kind == "uniform":
            noise = 2.0 * torch.rand(shape, generator=generator,
                                     dtype=like.dtype, device=device) - 1.0
        else:
            noise = torch.randn(shape, generator=generator, dtype=like.dtype,
                                device=device)
        return noise.to(like.device)

    def noise(self, generator: torch.Generator, x: Tensor, ranges: Tensor,
              independent: bool = True) -> Tensor:
        """Perturbs the states ``x (*, n_x)`` by noise scaled per coordinate
        by ``ranges (2 n_v,)``; with ``independent=False`` one draw is
        applied to every state."""
        dx_shape = x.shape[:-1] + (2 * self.space.n_v,)
        noise_shape = dx_shape if independent else (2 * self.space.n_v,)
        ranges = torch.as_tensor(ranges, dtype=x.dtype, device=x.device)
        noise = self.unit_noise(generator, noise_shape, x) * ranges
        return self.space.shift_state(x, noise.expand(dx_shape))

    def covariance(self, ranges: Tensor) -> Tensor:
        """Lie-algebra covariance implied by ``ranges``."""
        return torch.diag(self.variance_factor * ranges * ranges)


class StateSpaceSampler:
    """Distribution over a state space; draws from a ``torch.Generator``."""

    def __init__(self, space: StateSpace) -> None:
        self.space = space

    def get_sample(self, generator: torch.Generator,
                   dtype=torch.float32) -> Tensor:
        """One ``(n_x,)`` state."""
        return self.get_samples(generator, 1, dtype)[0]

    def get_samples(self, generator: torch.Generator, n: int,
                    dtype=torch.float32) -> Tensor:
        """``(n, n_x)`` independent states."""
        raise NotImplementedError

    def covariance(self, dtype=torch.float32) -> Tensor:
        """Lie-algebra covariance of the distribution."""
        raise NotImplementedError


class ConstantSampler(StateSpaceSampler):
    """Samples a fixed state; zero covariance."""

    def __init__(self, space: StateSpace, x_0: Tensor) -> None:
        super().__init__(space)
        self.x_0 = torch.as_tensor(x_0)

    def get_samples(self, generator: torch.Generator, n: int,
                    dtype=torch.float32) -> Tensor:
        del generator
        return self.x_0.to(dtype).expand(n, self.space.n_x).clone()

    def covariance(self, dtype=torch.float32) -> Tensor:
        n = 2 * self.space.n_v
        return torch.zeros((n, n), dtype=dtype)


class ZeroSampler(ConstantSampler):
    """Samples the group identity."""

    def __init__(self, space: StateSpace) -> None:
        super().__init__(space, space.zero_state(torch.float64))


class CenteredSampler(StateSpaceSampler):
    """Samples ``x_0`` perturbed by white noise of per-coordinate scale
    ``ranges``; ``kind`` selects gaussian or uniform unit noise."""

    def __init__(self, space: StateSpace, ranges, kind: str = "gaussian",
                 x_0: Optional[Tensor] = None) -> None:
        super().__init__(space)
        if x_0 is None:
            x_0 = space.zero_state(torch.float64)
        self.x_0 = space.project_state(torch.as_tensor(x_0))
        self.ranges = torch.as_tensor(ranges)
        self.noiser = WhiteNoiser(space, kind)

    def get_samples(self, generator: torch.Generator, n: int,
                    dtype=torch.float32) -> Tensor:
        x_0 = self.x_0.to(dtype).expand(n, self.space.n_x)
        return self.noiser.noise(generator, x_0, self.ranges.to(dtype))

    def covariance(self, dtype=torch.float32) -> Tensor:
        return self.noiser.covariance(self.ranges.to(dtype))


class UniformSampler(CenteredSampler):
    """Centered sampler with uniform unit noise."""

    def __init__(self, space: StateSpace, ranges,
                 x_0: Optional[Tensor] = None) -> None:
        super().__init__(space, ranges, "uniform", x_0)


class GaussianSampler(CenteredSampler):
    """Centered sampler with gaussian unit noise."""

    def __init__(self, space: StateSpace, ranges,
                 x_0: Optional[Tensor] = None) -> None:
        super().__init__(space, ranges, "gaussian", x_0)
