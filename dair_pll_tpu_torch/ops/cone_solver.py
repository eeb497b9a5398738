r"""Batched differentiable Lorentz-cone QP solver by accelerated projected
gradient (PyTorch).

Counterpart of ``dair_pll_tpu/ops/cone_solver.py``, batched over leading
dimensions: minimise ``0.5 x^T Q x + q^T x`` over ``k`` unit Lorentz cones
in the stacked layout ``[n_1..n_k, t_1x t_1y .. t_kx t_ky]`` by FISTA with
gradient-based adaptive restart, a fixed iteration count and a step from
12 power iterations. :func:`solve_cone_qp` is a ``torch.autograd.Function``
whose backward is the implicit-function theorem on the projection fixed
point ``x = P(x - alpha (Q x + q))`` (:func:`ift_cotangents`, shared with
the hybrid solve of ``sap_solver.py``).

The APGD kernel K6 (``ops/cone_kernels.py``) runs the same algorithm
with its own operation order; this module is the ``solver="apgd"`` route
and does not call it.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from dair_pll_tpu_torch.ops import cones
from dair_pll_tpu_torch.ops.socp_solver import _cone_index, mask_failures
from dair_pll_tpu_torch.ops.tensor import project_lorentz, small_matvec

DEFAULT_ITERATIONS = 200
POWER_ITERATIONS = 12


def _lipschitz_estimate(Q: Tensor, iters: int = POWER_ITERATIONS) -> Tensor:
    """Largest-eigenvalue estimate ``(*)`` of PSD ``Q`` by power iteration,
    inflated 10%."""
    n = Q.shape[-1]
    v = torch.full(Q.shape[:-1], 1.0, dtype=Q.dtype, device=Q.device) / \
        torch.sqrt(torch.tensor(float(n), dtype=Q.dtype))
    for _ in range(iters):
        w = small_matvec(Q, v)
        v = w / torch.clamp(torch.linalg.norm(w, dim=-1, keepdim=True),
                            min=1e-30)
    lam = torch.sum(v * small_matvec(Q, v), dim=-1)
    return 1.1 * torch.clamp(lam, min=1e-12)


def _apgd(Q: Tensor, q: Tensor, x0: Tensor, iterations: int) -> Tensor:
    """FISTA with adaptive restart over the Lorentz-cone product."""
    inv_L = (1.0 / _lipschitz_estimate(Q))[..., None]
    x = y = x0
    t = torch.ones(q.shape[:-1], dtype=q.dtype, device=q.device)
    for _ in range(iterations):
        grad = small_matvec(Q, y) + q
        x_new = project_lorentz(y - inv_L * grad)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        momentum = (t - 1.0) / t_new
        # Gradient-based adaptive restart (O'Donoghue and Candes).
        restart = torch.sum((y - x_new) * (x_new - x), dim=-1) > 0.0
        t_new = torch.where(restart, torch.ones_like(t_new), t_new)
        momentum = torch.where(restart, torch.zeros_like(momentum), momentum)
        y = x_new + momentum[..., None] * (x_new - x)
        x, t = x_new, t_new
    return x


def _projection_jacobian(z: Tensor) -> Tensor:
    """Dense Jacobian ``(*, 3k, 3k)`` of the cone-product projection at
    ``z (*, 3k)``, stacked layout: per cone the identity inside the cone,
    zero inside the polar cone, else the boundary block."""
    k = z.shape[-1] // 3
    blocks = cones.projection_jacobian_matrix(cones.stacked_to_cone_major(z))
    mask = torch.eye(k, dtype=torch.bool, device=z.device)[:, None, :, None]
    batch = z.shape[:-1]
    dense = torch.where(mask, blocks[..., :, :, None, :].expand(
        batch + (k, 3, k, 3)), torch.zeros((), dtype=z.dtype,
                                           device=z.device))
    _, inv = _cone_index(k)
    return dense.reshape(batch + (3 * k, 3 * k))[..., inv, :][..., :, inv]


def ift_cotangents(Q: Tensor, q: Tensor, x: Tensor,
                   g: Tensor) -> Tuple[Tensor, Tensor]:
    """Cotangents ``(bar_Q, bar_q)`` of any solver of the cone QP at its
    solution ``x``, from the fixed point ``F(x) = x - P(x - alpha (Q x +
    q)) = 0``: solve ``(dF/dx)^T w = g`` (regularised by 1e-10 I), then
    ``bar_q = -alpha D^T w`` and ``bar_Q = bar_q x^T``."""
    alpha = 1.0 / _lipschitz_estimate(Q)
    z = x - alpha[..., None] * (small_matvec(Q, x) + q)
    D = _projection_jacobian(z)
    n = Q.shape[-1]
    eye = torch.eye(n, dtype=Q.dtype, device=Q.device)
    dF_dx = eye - D @ (eye - alpha[..., None, None] * Q)
    w = torch.linalg.solve(dF_dx.transpose(-1, -2) + 1e-10 * eye,
                           g[..., None])[..., 0]
    bar_q = -alpha[..., None] * small_matvec(D.transpose(-1, -2), w)
    return bar_q[..., :, None] * x[..., None, :], bar_q


class _ApgdSolve(torch.autograd.Function):
    """APGD from zero with the IFT backward."""

    @staticmethod
    def forward(ctx, Q, q, iterations):
        x = _apgd(Q, q, torch.zeros_like(q), iterations)
        ctx.save_for_backward(Q, q, x)
        return x

    @staticmethod
    def backward(ctx, g):
        Q, q, x = ctx.saved_tensors
        bar_Q, bar_q = ift_cotangents(Q, q, x, g)
        return bar_Q, bar_q, None


def solve_cone_qp(Q: Tensor, q: Tensor,
                  iterations: int = DEFAULT_ITERATIONS) -> Tensor:
    """Solves ``min 0.5 x^T Q x + q^T x`` over the Lorentz-cone product.

    Args:
        Q: ``(*, 3k, 3k)`` PSD cost (Delassus + regularization).
        q: ``(*, 3k)`` cost vector, stacked.

    Returns:
        ``(*, 3k)`` optimal impulse, stacked.
    """
    return _ApgdSolve.apply(Q, q, iterations)


def solve_contact_impulse(delassus: Tensor, q_vec: Tensor, eps,
                          iterations: int = DEFAULT_ITERATIONS
                          ) -> Tuple[Tensor, Tensor]:
    """Contact solve of ``Q = delassus + eps I`` with the standard failure
    masking (non-finite or above 1e3 zeroes the sample): ``(impulse (*,
    3k), valid (*,))``."""
    n = delassus.shape[-1]
    Q = delassus + eps * torch.eye(n, dtype=delassus.dtype,
                                   device=delassus.device)
    return mask_failures(solve_cone_qp(Q, q_vec, iterations))
