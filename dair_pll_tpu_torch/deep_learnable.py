r"""Black-box deep learnable dynamics baselines: MLP and GRU (PyTorch).

Counterpart of ``dair_pll_tpu/deep_learnable.py`` (reference
``deep_learnable_model.py:8-107``, ``deep_learnable_system.py:16-67``):
learned dynamics as an MLP on the normalized current state, or an
encoder-GRU-decoder over the state history, driving any integrator kind.

Parameters are a :class:`~dair_pll_tpu_torch.params.ParamTree` laid out as
the JAX package's pytree: ``mean``, ``std`` and ``net`` (a list of
``{"w": (in, out), "b": (out,)}`` layers), or ``encoder``/``gru``/
``decoder`` with the GRU's ``w_i (in, 3H)``, ``w_h (H, 3H)`` and one bias
``b (3H,)`` on the input side, or ``dummy`` for the zero model. So JAX's
weights carry across unchanged (:func:`deep_params_from_numpy`); the
initial weights come from a ``torch.Generator`` and differ from JAX's
threefry draws. ``mean`` and ``std`` are leaves like the weights, and the
optimizer moves them, as in the JAX package.

The products are ``torch.matmul`` (the JAX package computes them outside
any Pallas kernel); a rollout is the integrator's loop with the batch as
leading dimensions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from dair_pll_tpu_torch.integrator import Integrator
from dair_pll_tpu_torch.multibody.learnable_system import resolve_device
from dair_pll_tpu_torch.params import ParamTree, tree_from_numpy
from dair_pll_tpu_torch.system import System

NONLINEARITIES = {"relu": torch.relu, "tanh": torch.tanh,
                  "elu": torch.nn.functional.elu}


def _uniform(generator: torch.Generator, shape, bound: float, dtype,
             device) -> Tensor:
    draw = torch.rand(shape, generator=generator, dtype=torch.float64)
    return (2.0 * bound * draw - bound).to(dtype=dtype, device=device)


def _init_linear(generator, in_size, out_size, dtype, device) -> Dict:
    bound = 1.0 / np.sqrt(in_size)
    return {"w": _uniform(generator, (in_size, out_size), bound, dtype,
                          device),
            "b": _uniform(generator, (out_size,), bound, dtype, device)}


def _apply_linear(params: Dict, x: Tensor) -> Tensor:
    return x @ params["w"] + params["b"]


def _init_mlp(generator, in_size, hidden, out_size, layers, dtype,
              device) -> List[Dict]:
    """MLP layers: ``layers`` hidden layers (reference ``_mlp``,
    ``deep_learnable_model.py:64-75``)."""
    if layers == 0:
        return [_init_linear(generator, in_size, out_size, dtype, device)]
    mats = [_init_linear(generator, in_size, hidden, dtype, device)]
    for _ in range(layers - 1):
        mats.append(_init_linear(generator, hidden, hidden, dtype, device))
    mats.append(_init_linear(generator, hidden, out_size, dtype, device))
    return mats


def _apply_mlp(mats: List[Dict], x: Tensor, nonlinearity: str) -> Tensor:
    act = NONLINEARITIES[nonlinearity]
    for layer in mats[:-1]:
        x = act(_apply_linear(layer, x))
    return _apply_linear(mats[-1], x)


def _init_gru(generator, in_size, hidden, dtype, device) -> Dict:
    bound = 1.0 / np.sqrt(hidden)
    return {"w_i": _uniform(generator, (in_size, 3 * hidden), bound, dtype,
                            device),
            "w_h": _uniform(generator, (hidden, 3 * hidden), bound, dtype,
                            device),
            "b": _uniform(generator, (3 * hidden,), bound, dtype, device)}


def _apply_gru(params: Dict, x: Tensor, h: Tensor) -> Tensor:
    """The JAX package's GRU cell on ``x (*, in)``, ``h (*, H)``: one bias,
    on the input side; gates r, z, n; the reset gate scales ``h @ w_h``
    before the ``tanh`` (not ``torch.nn.GRUCell``, which has two
    biases)."""
    hidden = h.shape[-1]
    gates_x = x @ params["w_i"] + params["b"]
    gates_h = h @ params["w_h"]
    r = torch.sigmoid(gates_x[..., :hidden] + gates_h[..., :hidden])
    z = torch.sigmoid(gates_x[..., hidden:2 * hidden] +
                      gates_h[..., hidden:2 * hidden])
    n = torch.tanh(gates_x[..., 2 * hidden:] + r * gates_h[..., 2 * hidden:])
    return (1.0 - z) * n + z * h


@dataclasses.dataclass
class DeepLearnableSystemConfig:
    """Configuration (reference ``deep_learnable_system.py:16-22``).

    Attributes:
        integrator_kind: interpretation of the model output (see
          ``dair_pll_tpu_torch.integrator``).
        layers: MLP depth.
        nonlinearity: "relu", "tanh" or "elu".
        hidden_size: hidden width (also the GRU state size).
        model_kind: "mlp", "recurrent" or "zero".
    """
    integrator_kind: str = "velocity"
    layers: int = 1
    nonlinearity: str = "relu"
    hidden_size: int = 128
    model_kind: str = "recurrent"


class DeepLearnableSystem(System):
    """Black-box learned dynamics over a base system's state space.

    Args:
        base_system: gives the state space and the time step.
        config: the network.
        generator: draws the initial weights.
        training_data: states ``(..., n_x)`` whose mean and standard
          deviation start the normalization (zeros and ones without).
        dtype: the parameters' dtype.
        device: where the system runs; ``None`` is the CUDA card.
    """

    def __init__(self, base_system: System,
                 config: DeepLearnableSystemConfig,
                 generator: torch.Generator,
                 training_data: Optional[np.ndarray] = None,
                 dtype=torch.float32, device=None) -> None:
        if config.model_kind not in ("mlp", "recurrent", "zero"):
            raise ValueError(config.model_kind)
        self.config = config
        self.device = resolve_device(device)
        space = base_system.space
        integrator = Integrator(space, self._partial_step,
                                base_system.integrator.dt,
                                config.integrator_kind)
        super().__init__(space, integrator)
        self.out_size = integrator.out_size()
        self._init_params = self._build_params(generator, training_data,
                                               dtype)

    def _build_params(self, generator, training_data, dtype) -> ParamTree:
        config = self.config
        n_x = self.space.n_x
        hidden = config.hidden_size
        device = self.device
        params: Dict[str, Any] = {}
        if training_data is not None:
            flat = np.asarray(training_data).reshape(-1, n_x)
            params["mean"] = torch.as_tensor(flat.mean(axis=0), dtype=dtype,
                                             device=device)
            params["std"] = torch.as_tensor(flat.std(axis=0) + 1e-8,
                                            dtype=dtype, device=device)
        else:
            params["mean"] = torch.zeros((n_x,), dtype=dtype, device=device)
            params["std"] = torch.ones((n_x,), dtype=dtype, device=device)

        if config.model_kind == "recurrent":
            params["encoder"] = _init_mlp(generator, n_x, hidden, hidden,
                                          config.layers // 2, dtype, device)
            params["gru"] = _init_gru(generator, hidden, hidden, dtype,
                                      device)
            params["decoder"] = _init_mlp(
                generator, hidden, hidden, self.out_size,
                config.layers - config.layers // 2, dtype, device)
        elif config.model_kind == "mlp":
            params["net"] = _init_mlp(generator, n_x, hidden, self.out_size,
                                      config.layers, dtype, device)
        else:
            params["dummy"] = torch.ones((), dtype=dtype, device=device)
        return ParamTree(params)

    def initial_params(self) -> ParamTree:
        return self._init_params

    def initial_carry(self, x_0: Tensor) -> Tensor:
        """The GRU's hidden state ``(*, hidden_size)``, zeros (every kind
        carries it, as in the JAX package)."""
        return x_0.new_zeros(x_0.shape[:-1] + (self.config.hidden_size,))

    @staticmethod
    def _normalize(params, x: Tensor) -> Tensor:
        return (x - params["mean"]) / params["std"]

    def _partial_step(self, params, x: Tensor,
                      carry: Tensor) -> Tuple[Tensor, Tensor]:
        config = self.config
        x_n = self._normalize(params, x)
        if config.model_kind == "recurrent":
            encoded = _apply_mlp(params["encoder"], x_n, config.nonlinearity)
            carry = _apply_gru(params["gru"], encoded, carry)
            return _apply_mlp(params["decoder"], carry,
                              config.nonlinearity), carry
        if config.model_kind == "mlp":
            return _apply_mlp(params["net"], x_n, config.nonlinearity), carry
        return params["dummy"] * x.new_zeros(x.shape[:-1] +
                                             (self.out_size,)), carry

    def preprocess_initial_condition(self, params, x_history: Tensor,
                                     carry: Tensor) -> Tuple[Tensor, Tensor]:
        """Recurrent warm-up over the history window ``(*, T, n_x)``
        (reference ``deep_learnable_system.py:49-58``): the GRU steps over
        every state but the last, which starts the rollout."""
        if self.config.model_kind != "recurrent" or x_history.shape[-2] <= 1:
            return x_history[..., -1, :], carry
        for t in range(x_history.shape[-2] - 1):
            _, carry = self._partial_step(params, x_history[..., t, :],
                                          carry)
        return x_history[..., -1, :], carry


def deep_params_from_numpy(system: DeepLearnableSystem, tree: Dict,
                           dtype=torch.float64, device=None) -> ParamTree:
    """Carries a JAX ``DeepLearnableSystem``'s parameters across: its
    pytree with numpy leaves (``mean``, ``std``, and ``net``,
    ``encoder``/``gru``/``decoder`` or ``dummy``), checked against the
    system's own structure and shapes."""
    template = system.initial_params().map(
        lambda leaf: torch.empty(leaf.shape, dtype=dtype,
                                 device=device or system.device))
    return tree_from_numpy(template, tree)


class DeepLearnableExperiment:
    """Mixin providing a deep-learnable ``get_learned_system`` (reference
    ``deep_learnable_system.py:61-67``); compose it before a
    ``SupervisedLearningExperiment`` subclass. The weights come from a
    generator seeded 0, on the experiment's device and in its dtype."""

    def get_learned_system(self):
        config = self.config.learnable_config
        assert isinstance(config, DeepLearnableSystemConfig)
        base_system, _ = self.get_base_system()
        train_states = getattr(self, "train_states", None)
        system = DeepLearnableSystem(
            base_system, config, torch.Generator().manual_seed(0),
            train_states, dtype=getattr(self, "dtype", torch.float32),
            device=getattr(self, "device", None))
        return system, system.initial_params()
