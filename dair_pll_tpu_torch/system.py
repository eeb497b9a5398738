r"""Dynamical-system abstraction over state spaces (PyTorch).

Counterpart of ``dair_pll_tpu/system.py``. A :class:`System` bundles a
state space and an :class:`~dair_pll_tpu_torch.integrator.Integrator`;
parameters are passed in on every call. Rollouts are batched by leading
dimensions written out, where the JAX package ``vmap``-s an unbatched
rollout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from dair_pll_tpu_torch.integrator import Integrator
from dair_pll_tpu_torch.state_space import StateSpace, StateSpaceSampler


@dataclasses.dataclass
class MeshSummary:
    """Triangle mesh for export and visualization: ``vertices (V, 3)``,
    ``faces (F, 3)`` vertex indices, outward by the right-hand rule."""
    vertices: np.ndarray
    faces: np.ndarray


@dataclasses.dataclass
class SystemSummary:
    """Per-evaluation logging payload."""
    scalars: Dict[str, float]
    videos: Dict[str, Tuple[np.ndarray, int]]
    meshes: Dict[str, MeshSummary]


class System:
    """Base dynamical system: a state space and an integrator. Subclasses
    provide the partial step (through the integrator) and may override
    :meth:`initial_carry` and :meth:`preprocess_initial_condition`."""

    space: StateSpace
    integrator: Integrator
    #: Whether the system steps on the host, one trajectory at a time, on
    #: numpy states (the MuJoCo oracle): the experiment then rolls it out
    #: sequentially.
    host_stepped: bool = False

    def __init__(self, space: StateSpace, integrator: Integrator) -> None:
        self.space = space
        self.integrator = integrator

    def initial_carry(self, x_0: Tensor) -> Tensor:
        """Default hidden state: empty, ``(*, 0)``."""
        return x_0.new_zeros(x_0.shape[:-1] + (0,))

    def preprocess_initial_condition(self, params: Any, x_history: Tensor,
                                     carry: Tensor) -> Tuple[Tensor, Tensor]:
        """Maps an initial-condition history ``(*, T_history, n_x)`` to the
        starting state and carry. Default: the last state."""
        return x_history[..., -1, :], carry

    def simulate(self, params: Any, x_0: Tensor, steps: int,
                 carry_0: Optional[Tensor] = None,
                 remat: bool = False) -> Tensor:
        """Rollout ``(*, n_x) -> (*, steps + 1, n_x)``; ``remat=True``
        recomputes each step in the backward pass."""
        if carry_0 is None:
            carry_0 = self.initial_carry(x_0)
        trajectory, _ = self.integrator.simulate(params, x_0, carry_0, steps,
                                                 remat=remat)
        return trajectory

    def simulate_batch(self, params: Any, x_0: Tensor, steps: int) -> Tensor:
        """Batched rollout ``(*, n_x) -> (*, steps + 1, n_x)`` over the
        flattened leading dimensions."""
        flat = x_0.reshape(-1, x_0.shape[-1])
        rollout = self.simulate(params, flat, steps)
        return rollout.reshape(x_0.shape[:-1] + rollout.shape[1:])

    def sample_initial_condition(self, sampler: StateSpaceSampler,
                                 generator: torch.Generator,
                                 dtype=torch.float32) -> Tensor:
        """Draws one initial state from a sampler."""
        return sampler.get_sample(generator, dtype)

    def summary(self, params: Any, statistics: Dict) -> SystemSummary:
        """Evaluation summary; empty by default."""
        del params, statistics
        return SystemSummary(scalars={}, videos={}, meshes={})
