r"""Trajectory integrators (PyTorch).

Counterpart of ``dair_pll_tpu/integrator.py``. An :class:`Integrator`
pairs a state space with a partial-step callback ``(params, x, carry) ->
(out, carry)`` on states ``(*, n_x)`` with any leading batch dimensions,
and interprets ``out`` by its kind:

=======================  ==================================================
kind                     meaning of ``out``
=======================  ==================================================
``state``                next state (projected onto the space)
``delta_state``          Lie-algebra state perturbation ``(*, 2 n_v)``
``velocity``             next velocity; configuration by geodesic Euler
``delta_velocity``       velocity increment
``configuration``        next configuration; velocity by finite difference
``delta_configuration``  configuration perturbation; velocity = dq / dt
=======================  ==================================================

A rollout is a Python loop over the steps (the JAX package's
``lax.scan``); ``remat=True`` recomputes each step in the backward pass
(``torch.utils.checkpoint``) instead of keeping its intermediates.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch import Tensor
from torch.utils.checkpoint import checkpoint

from dair_pll_tpu_torch.state_space import StateSpace

PartialStepCallback = Callable[[Any, Tensor, Tensor], Tuple[Tensor, Tensor]]

INTEGRATOR_KINDS = (
    "state", "delta_state", "velocity", "delta_velocity",
    "configuration", "delta_configuration")


class Integrator:
    """Steps states forward with a partial-step callback.

    Attributes:
        space: state space of the integrated system.
        partial_step: ``(params, x, carry) -> (out, carry)``.
        dt: time step in seconds.
        kind: one of :data:`INTEGRATOR_KINDS`.
    """

    def __init__(self, space: StateSpace, partial_step: PartialStepCallback,
                 dt: float, kind: str) -> None:
        if kind not in INTEGRATOR_KINDS:
            raise ValueError(f"unknown integrator kind {kind}")
        self.space = space
        self.partial_step = partial_step
        self.dt = dt
        self.kind = kind

    def out_size(self) -> int:
        """Final dimension of the partial step's output for this kind."""
        space = self.space
        return {
            "state": space.n_x,
            "delta_state": 2 * space.n_v,
            "velocity": space.n_v,
            "delta_velocity": space.n_v,
            "configuration": space.n_q,
            "delta_configuration": space.n_v,
        }[self.kind]

    def step(self, params: Any, x: Tensor, carry: Tensor
             ) -> Tuple[Tensor, Tensor]:
        """One time step of states ``(*, n_x)``."""
        space = self.space
        dt = self.dt
        out, carry = self.partial_step(params, x, carry)
        if self.kind == "state":
            return space.project_state(out), carry
        if self.kind == "delta_state":
            return space.shift_state(x, out), carry
        if self.kind == "velocity":
            return space.x(space.euler_step(space.q(x), out, dt), out), carry
        if self.kind == "delta_velocity":
            v_next = space.v(x) + out
            return space.x(space.euler_step(space.q(x), v_next, dt),
                           v_next), carry
        q = space.q(x)
        if self.kind == "configuration":
            q_next = space.project_configuration(out)
            return space.x(q_next, space.finite_difference(q, q_next, dt)), \
                carry
        return space.x(space.exponential(q, out), out / dt), carry

    def simulate(self, params: Any, x_0: Tensor, carry_0: Tensor,
                 steps: int, remat: bool = False) -> Tuple[Tensor, Tensor]:
        """Rollout of ``steps`` steps from ``x_0 (*, n_x)``.

        Returns the trajectory ``(*, steps + 1, n_x)`` (``x_0`` first) and
        the carries ``(*, steps + 1, ...)``.
        """
        def step(x, carry):
            return self.step(params, x, carry)

        xs, carries = [x_0], [carry_0]
        x, carry = x_0, carry_0
        for _ in range(steps):
            if remat:
                x, carry = checkpoint(step, x, carry, use_reentrant=False)
            else:
                x, carry = step(x, carry)
            xs.append(x)
            carries.append(carry)
        dim = x_0.dim() - 1
        return torch.stack(xs, dim=dim), torch.stack(carries, dim=dim)
