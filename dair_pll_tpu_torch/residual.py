r"""Residual physics: structured contact dynamics plus a learned
correction (PyTorch).

Counterpart of ``dair_pll_tpu/residual.py``. The structured
:class:`~dair_pll_tpu_torch.multibody.learnable_system.MultibodyLearnableSystem`
(Anitescu contact dynamics with learnable inertia, friction and geometry)
gains a small MLP residual on the next-step velocity:

.. math::
    v^+ = v^+_{\text{structured}}(\theta, x) +
          s \cdot \mathrm{MLP}_\phi(\bar x)

Both parameter sets train jointly on the prediction loss. The structured
half steps the batch-leading ``forward_dynamics``, whose hybrid solve
differentiates by the implicit-function theorem (the JAX package runs no
Pallas kernel on this path either); the residual gets its gradient from
autograd. ``residual_scale`` starts training near the structured model.

Parameters are a :class:`~dair_pll_tpu_torch.params.ParamTree`
``{"structured": MultibodyParams, "residual": {"net", "mean", "std"}}``,
the JAX package's pytree; ``mean`` and ``std`` are leaves and move under
the optimizer, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from dair_pll_tpu_torch.deep_learnable import _apply_mlp, _init_mlp
from dair_pll_tpu_torch.integrator import Integrator
from dair_pll_tpu_torch.multibody.learnable_system import (
    MultibodyLearnableSystem)
from dair_pll_tpu_torch.multibody.model import params_from_numpy
from dair_pll_tpu_torch.params import ParamTree, tree_from_numpy
from dair_pll_tpu_torch.system import System, SystemSummary


@dataclasses.dataclass
class ResidualPhysicsConfig:
    """Configuration of the residual head.

    Attributes:
        layers, hidden_size, nonlinearity: the MLP.
        residual_scale: output scale (start near the structured model).
    """
    layers: int = 2
    hidden_size: int = 64
    nonlinearity: str = "tanh"
    residual_scale: float = 0.1


class ResidualPhysicsSystem(System):
    """Structured multibody system with an additive learned velocity
    residual; runs on the structured system's device.

    Args:
        structured: the structured system.
        config: the residual head.
        generator: draws the residual's initial weights.
        training_data: states whose mean and standard deviation start the
          residual's normalization (zeros and ones without).
        dtype: the parameters' dtype.
    """

    def __init__(self, structured: MultibodyLearnableSystem,
                 config: ResidualPhysicsConfig, generator: torch.Generator,
                 training_data: Optional[np.ndarray] = None,
                 dtype=torch.float32) -> None:
        self.structured = structured
        self.config = config
        self.device = structured.device
        space = structured.space
        super().__init__(space, Integrator(space, self._partial_step,
                                           structured.dt, "velocity"))
        self._init_params = self._build_params(generator, training_data,
                                               dtype)

    def _build_params(self, generator, training_data, dtype) -> ParamTree:
        n_x = self.space.n_x
        device = self.device
        if training_data is not None:
            flat = np.asarray(training_data).reshape(-1, n_x)
            mean = torch.as_tensor(flat.mean(axis=0), dtype=dtype,
                                   device=device)
            std = torch.as_tensor(flat.std(axis=0) + 1e-8, dtype=dtype,
                                  device=device)
        else:
            mean = torch.zeros((n_x,), dtype=dtype, device=device)
            std = torch.ones((n_x,), dtype=dtype, device=device)
        net = _init_mlp(generator, n_x, self.config.hidden_size,
                        self.space.n_v, self.config.layers, dtype, device)
        return ParamTree({
            "structured": self.structured.initial_params(dtype),
            "residual": {"net": net, "mean": mean, "std": std},
        })

    def initial_params(self) -> ParamTree:
        return self._init_params

    def residual_velocity(self, params, x: Tensor) -> Tensor:
        """The learned velocity correction of states ``(*, n_x)``."""
        res = params["residual"]
        x_n = (x - res["mean"]) / res["std"]
        return self.config.residual_scale * _apply_mlp(
            res["net"], x_n, self.config.nonlinearity)

    def _partial_step(self, params, x: Tensor,
                      carry: Tensor) -> Tuple[Tensor, Tensor]:
        q, v = self.space.q_v(x)
        u = x.new_zeros(x.shape[:-1] + (self.structured.model.n_u,))
        v_plus = self.structured.forward_dynamics(params["structured"], q,
                                                  v, u)
        return v_plus + self.residual_velocity(params, x), carry

    def summary(self, params, statistics: Dict) -> SystemSummary:
        """The structured half's physical parameters plus the residual's
        size: the sum of its weights' and biases' Frobenius norms."""
        summary = self.structured.summary(params["structured"], statistics)
        net = params["residual"]["net"]
        norms = [float(torch.linalg.norm(layer[key].detach()))
                 for layer in net for key in sorted(layer)]
        summary.scalars["residual_weight_norm"] = float(np.sum(norms))
        return summary


def residual_params_from_numpy(system: ResidualPhysicsSystem,
                               structured: Mapping, residual: Mapping,
                               dtype=torch.float64,
                               device=None) -> ParamTree:
    """Carries a JAX ``ResidualPhysicsSystem``'s parameters across:
    ``structured`` the fields of its ``MultibodyParams`` (``theta``,
    ``friction``, ``geometry``, through ``params_from_numpy``) and
    ``residual`` its ``{"net", "mean", "std"}`` pytree, as numpy arrays."""
    device = device or system.device
    template = system.initial_params().map(
        lambda leaf: torch.empty(leaf.shape, dtype=dtype, device=device))
    return ParamTree({
        "structured": params_from_numpy(
            system.structured.model, structured["theta"],
            structured["friction"], structured["geometry"], dtype=dtype,
            device=device),
        "residual": tree_from_numpy(template["residual"], residual,
                                    "residual"),
    })


class ResidualPhysicsExperiment:
    """Mixin providing a residual-physics ``get_learned_system``; compose
    it before a ``SupervisedLearningExperiment`` subclass, as
    ``DeepLearnableExperiment``. Trains with the prediction loss (the
    default ``loss_callback``)."""

    def get_learned_system(self):
        config = self.config.learnable_config
        assert isinstance(config, ResidualPhysicsLearnableConfig)
        from dair_pll_tpu_torch.urdf import build_multibody_model
        model = build_multibody_model(
            dict(config.urdfs),
            mesh_representation=config.mesh_representation)
        structured = MultibodyLearnableSystem(
            model, self.config.data_config.dt,
            device=getattr(self, "device", None))
        train_states = getattr(self, "train_states", None)
        system = ResidualPhysicsSystem(
            structured, config.residual, torch.Generator().manual_seed(0),
            train_states, dtype=getattr(self, "dtype", torch.float32))
        return system, system.initial_params()


@dataclasses.dataclass
class ResidualPhysicsLearnableConfig:
    """Learnable-config payload of residual-physics experiments."""
    urdfs: Dict[str, str] = dataclasses.field(default_factory=dict)
    mesh_representation: str = "polygon"
    residual: ResidualPhysicsConfig = dataclasses.field(
        default_factory=ResidualPhysicsConfig)
