r"""Homogeneous input-convex neural network (deep support function), PyTorch.

Counterpart of ``dair_pll_tpu/ops/icnn.py``. A convex shape is represented
by its support function

.. math:: f(d) = \max_{s \in S} s \cdot d,

a positively homogeneous ICNN: bias-free layers, non-negative hidden and
output weights (entered as absolute values) and the convex monotone
LeakyReLU ``where(x >= 0, x, slope x)``. A support *point* is the input
gradient of the value. The JAX package takes it with ``jax.grad`` under
``vmap``; here :func:`icnn_support_points` writes that gradient in closed
form over a batch of directions with ``torch.matmul``, so ordinary
autograd through it gives the parameter gradient that JAX gets from
differentiating ``grad``, without a double backward.

Parameters are a plain dictionary (``input_weights``: list of ``(3, W)``;
``hidden_weights``: list of ``(W, W)``; ``output_weight``: ``(W,)``) so
they slot into ``MultibodyParams.geometry``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import Tensor

DEFAULT_NEGATIVE_SLOPE = 0.5


def init_homogeneous_icnn(generator: torch.Generator, depth: int, width: int,
                          negative_slope: float = DEFAULT_NEGATIVE_SLOPE,
                          scale: float = 1.0, dtype=torch.float32,
                          device=None) -> Dict:
    r"""Initial ICNN parameters, drawn from ``generator`` (a CPU
    ``torch.Generator``).

    The distributions and scales are the JAX package's: hidden weights
    uniform in ``±2 sqrt(2 / (1 + slope^2)) / width``, input weights
    Kaiming-uniform for a fan-in of 3 (damped by :math:`1/\sqrt 2` past
    the first layer), the output weight uniform in ``±scale 2 sqrt(2 /
    (width (1 + slope^2)))``. The values differ from JAX's: the two
    generators differ.

    Args:
        depth: number of hidden layers ``D``.
        width: hidden width ``W``.
        negative_slope: LeakyReLU negative slope, ``0 <= slope < 1``.
        scale: object length scale in meters.
    """
    if not 0.0 <= negative_slope < 1.0:
        raise ValueError(f"negative_slope {negative_slope} is not in [0, 1)")

    def uniform(shape, bound):
        draw = torch.rand(shape, generator=generator, dtype=torch.float64)
        return ((2.0 * draw - 1.0) * bound).to(dtype=dtype, device=device)

    scale_hidden = 2.0 * (2.0 / (1 + negative_slope**2))**0.5 / width
    hidden_weights = [uniform((width, width), scale_hidden)
                      for _ in range(depth - 1)]
    # Kaiming-uniform bound for fan_in = 3: sqrt(6 / fan_in).
    bound = (6.0 / 3.0)**0.5
    input_weights = [uniform((3, width), bound * (1.0 if layer == 0
                                                  else 2**(-0.5)))
                     for layer in range(depth)]
    scale_out = scale * 2.0 * (2.0 / (width * (1 + negative_slope**2)))**0.5
    output_weight = uniform((width,), scale_out)
    return {"input_weights": input_weights,
            "hidden_weights": hidden_weights,
            "output_weight": output_weight}


def _slope(x: Tensor, negative_slope: float) -> Tensor:
    """The LeakyReLU's derivative, ``1`` where ``x >= 0`` (so at 0 too)."""
    return torch.where(x >= 0, x.new_ones(()), x.new_full((), negative_slope))


def _pre_activation_slopes(params: Dict, directions: Tensor,
                           negative_slope: float
                           ) -> Tuple[List[Tensor], Tensor]:
    """The activations' slopes at every layer's pre-activation, and the
    last pre-activation."""
    input_weights = params["input_weights"]
    z = directions @ input_weights[0]
    slopes = [_slope(z, negative_slope)]
    for w_hidden, w_input in zip(params["hidden_weights"], input_weights[1:]):
        # act(z) = slope(z) * z exactly: 1 * z = z, slope * z as JAX's.
        z = (slopes[-1] * z) @ torch.abs(w_hidden) + directions @ w_input
        slopes.append(_slope(z, negative_slope))
    return slopes, z


def icnn_value(params: Dict, directions: Tensor,
               negative_slope: float = DEFAULT_NEGATIVE_SLOPE) -> Tensor:
    """Support function values ``f(d)``: ``(..., 3) -> (...)``."""
    slopes, z = _pre_activation_slopes(params, directions, negative_slope)
    return (slopes[-1] * z) @ torch.abs(params["output_weight"])


def icnn_support_points(params: Dict, directions: Tensor,
                        negative_slope: float = DEFAULT_NEGATIVE_SLOPE
                        ) -> Tensor:
    r"""Support points, the input gradient :math:`\partial_d f(d)`:
    ``(N, 3) -> (N, 3)``.

    Backpropagation written out: with ``s_l`` the activation slopes,
    ``g_D = s_D |w_out|``, ``g_l = s_l (g_{l+1} |H_l|^T)`` and the point
    ``sum_l g_l U_l^T``. The slopes are piecewise constant, so autograd
    through this gives the same parameter gradient as JAX's second
    derivative of the value.
    """
    with torch.no_grad():
        # Only the slopes are needed, and they carry no gradient.
        slopes, _ = _pre_activation_slopes(params, directions,
                                           negative_slope)
    input_weights = params["input_weights"]
    hidden_weights = params["hidden_weights"]
    g = slopes[-1] * torch.abs(params["output_weight"])
    point = g @ input_weights[-1].T
    for layer in range(len(hidden_weights) - 1, -1, -1):
        g = slopes[layer] * (g @ torch.abs(hidden_weights[layer]).T)
        point = point + g @ input_weights[layer].T
    return point
