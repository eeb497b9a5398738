r"""SAP-style Newton solver for the contact cone QP, and the hybrid
interior-point + Newton solve with its implicit-function-theorem gradient
(PyTorch).

Counterpart of ``dair_pll_tpu/ops/sap_solver.py``, batched over leading
dimensions. The dual QCQP

.. math:: \min_{f \in K} \tfrac12 f^T (J M^{-1} J^T + \epsilon I) f + f^T q

is the smooth, strongly convex primal

.. math::
   \min_{w} \ \ell(w) = \tfrac12 w^T M w +
   \tfrac{\epsilon}{2}\,\lVert P_K(-(J w + q)/\epsilon)\rVert^2,

with :math:`f^* = P_K(-(J w^* + q)/\epsilon)`. Newton steps use the
generalized Hessian :math:`M + J^T \partial P_K J / \epsilon` and an exact
line search: the crease breakpoints of each cone bracket the root of the
nondecreasing :math:`g'(\alpha)` (a broadcast over the candidate steps),
and a safeguarded Newton polish refines it inside the smooth segment.
Every iteration count is fixed; ``eps`` is a Python float or a 0-d
tensor.

:func:`solve_cone_qp_hybrid` (``torch.autograd.Function``) runs a short
interior-point phase (``socp_solver.solve_cone_qp_ipm_mj``), then the
Newton polish from its point. Its backward is the implicit-function
theorem on the projection fixed point (``cone_solver.ift_cotangents``):
gradients go to ``Q`` and ``q``; ``M``, ``J`` and ``eps`` are the solve's
geometry and get none.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from dair_pll_tpu_torch.ops import cones
from dair_pll_tpu_torch.ops.cone_solver import ift_cotangents
from dair_pll_tpu_torch.ops.linear import (cho_solve_unrolled,
                                           cholesky_unrolled, spd_solve)
from dair_pll_tpu_torch.ops.socp_solver import (mask_failures,
                                                solve_cone_qp_ipm_mj)
from dair_pll_tpu_torch.ops.tensor import project_lorentz, small_matvec

DEFAULT_NEWTON_ITERATIONS = 10
#: Polish steps of the line search, equal to the SoA solver's.
_POLISH_STEPS = 6
#: Default (ipm, newton) budget of the hybrid solve.
DEFAULT_HYBRID_IPM_ITERATIONS = 10
DEFAULT_HYBRID_NEWTON_ITERATIONS = 6


def _jt_dot(Jc: Tensor, u: Tensor) -> Tensor:
    """``J^T u``: ``(*, k, 3, n) x (*, k, 3) -> (*, n)``."""
    return torch.sum(Jc * u[..., None], dim=(-3, -2))


def _j_dot(Jc: Tensor, w: Tensor) -> Tensor:
    """``J w`` per cone: ``(*, k, 3, n) x (*, n) -> (*, k, 3)``."""
    return torch.sum(Jc * w[..., None, None, :], dim=-1)


def _jt_block_j(Jc: Tensor, D: Tensor) -> Tensor:
    """``sum_k J_k^T D_k J_k``: ``(*, k, 3, n), (*, k, 3, 3) -> (*, n,
    n)``."""
    DJ = torch.sum(D[..., None] * Jc[..., None, :, :], dim=-2)
    return torch.sum(Jc[..., :, :, :, None] * DJ[..., :, :, None, :],
                     dim=(-4, -3))


def _primal_gamma(Jc, qc, eps, w):
    return cones.project(-(_j_dot(Jc, w) + qc) / eps)


def _crease_breakpoints(z0: Tensor, dz: Tensor) -> Tensor:
    r"""Step lengths in ``(0, 1)`` where ``z0 + alpha dz`` crosses a
    projection crease (:math:`\lVert t \rVert^2 = n^2`) of each cone
    ``(*, k, 3)``; others are 1. Returns ``(*, 2k)``."""
    n0, dn = z0[..., 0], dz[..., 0]
    t0, dt = z0[..., 1:], dz[..., 1:]
    A = torch.sum(dt * dt, dim=-1) - dn * dn
    B = 2.0 * (torch.sum(t0 * dt, dim=-1) - n0 * dn)
    C = torch.sum(t0 * t0, dim=-1) - n0 * n0
    disc = B * B - 4.0 * A * C
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    tiny = torch.full_like(A, 1e-30)
    safe_A = torch.where(torch.abs(A) > tiny, A, tiny)
    safe_B = torch.where(torch.abs(B) > tiny, B, tiny)
    r1 = (-B - torch.sign(safe_B) * sqrt_disc) / (2.0 * safe_A)
    r2 = C / torch.where(torch.abs(safe_A * r1) > tiny, safe_A * r1, tiny)
    lin = -C / safe_B
    is_linear = torch.abs(A) <= 1e-12 * torch.clamp(torch.abs(B), min=1.0)
    one = torch.ones_like(A)
    r1 = torch.where(is_linear, lin, r1)
    r2 = torch.where(is_linear, one, r2)
    no_root = (disc < 0.0) & ~is_linear

    def clip_valid(r):
        return torch.where((r > 1e-12) & (r < 1.0) & ~no_root, r, one)

    return torch.cat((clip_valid(r1), clip_valid(r2)), dim=-1)


def _line_search(M, Jc, qc, eps, w, dw):
    """Exact line search on ``l(w + alpha dw)`` over ``[0, 1]``; returns
    the new ``w``."""
    z0 = -(_j_dot(Jc, w) + qc) / eps
    dz = -_j_dot(Jc, dw) / eps
    a0 = torch.sum(dw * small_matvec(M, w), dim=-1)
    a1 = torch.sum(dw * small_matvec(M, dw), dim=-1)

    def g_prime(alpha):
        """``g'`` at steps ``alpha (*, C)`` or ``(*,)``."""
        extra = alpha.dim() - a0.dim()
        expand = (...,) + (None,) * extra + (slice(None), slice(None))
        point = z0[expand] + alpha[(...,) + (None, None)] * dz[expand]
        gamma = cones.project(point)
        a0_, a1_ = (a0[(...,) + (None,) * extra],
                    a1[(...,) + (None,) * extra])
        return a0_ + a1_ * alpha + eps * torch.sum(dz[expand] * gamma,
                                                   dim=(-2, -1))

    def g_second(alpha):
        a = alpha[..., None, None]
        Ddz = cones.projection_jacobian_apply(z0 + a * dz, dz)
        return a1 + eps * torch.sum(dz * Ddz, dim=(-2, -1))

    candidates, _ = torch.sort(torch.cat((
        torch.zeros_like(a0)[..., None], _crease_breakpoints(z0, dz),
        torch.ones_like(a0)[..., None]), dim=-1), dim=-1)
    gp = g_prime(candidates)
    big = torch.full_like(candidates, 2.0)
    lo = torch.amax(torch.where(gp <= 0.0, candidates, -big), dim=-1)
    hi = torch.amin(torch.where(gp > 0.0, candidates, big), dim=-1)
    take_full = gp[..., -1] <= 0.0
    lo = torch.clamp(lo, min=0.0)
    hi = torch.where(hi > 1.0, torch.ones_like(hi), hi)
    hi = torch.maximum(hi, lo)

    alpha = 0.5 * (lo + hi)
    for _ in range(_POLISH_STEPS):
        gp_a = g_prime(alpha)
        gpp_a = torch.clamp(g_second(alpha), min=1e-30)
        lo = torch.where(gp_a <= 0.0, alpha, lo)
        hi = torch.where(gp_a > 0.0, alpha, hi)
        newton = alpha - gp_a / gpp_a
        inside = (newton > lo) & (newton < hi)
        alpha = torch.where(inside, newton, 0.5 * (lo + hi))
    alpha = torch.where(take_full, torch.ones_like(alpha), alpha)
    return w + alpha[..., None] * dw


def _sap_newton_cone_major(M: Tensor, Jc: Tensor, qc: Tensor, eps,
                           iterations: int, w0: Tensor
                           ) -> Tuple[Tensor, Tensor]:
    """Fixed-count Newton on the velocity-space primal, cone-major;
    returns ``(impulse (*, k, 3), w (*, n_v))``."""
    n_v = M.shape[-1]
    reg = 1e-10 * torch.eye(n_v, dtype=qc.dtype, device=qc.device)
    w = w0
    for _ in range(iterations):
        z = -(_j_dot(Jc, w) + qc) / eps
        grad = small_matvec(M, w) - _jt_dot(Jc, cones.project(z))
        H = M + _jt_block_j(Jc, cones.projection_jacobian_matrix(z)) / eps
        # A Levenberg floor keeps H well posed on projection facets.
        L = cholesky_unrolled(H + reg)
        dw = -cho_solve_unrolled(L, grad)
        w = _line_search(M, Jc, qc, eps, w, dw)
    return _primal_gamma(Jc, qc, eps, w), w


def _sap_newton(M: Tensor, J: Tensor, q: Tensor, eps, iterations: int,
                w0: Tensor) -> Tuple[Tensor, Tensor]:
    """Stacked layout: returns ``(impulse (*, 3k), w)``."""
    gamma, w = _sap_newton_cone_major(
        M, cones.rows_to_cone_major(J), cones.stacked_to_cone_major(q), eps,
        iterations, w0)
    return cones.cone_major_to_stacked(gamma), w


def solve_cone_qp_sap(M: Tensor, J: Tensor, q: Tensor, eps,
                      iterations: int = DEFAULT_NEWTON_ITERATIONS,
                      w0: Optional[Tensor] = None) -> Tensor:
    """Solves ``min_{f in K} 0.5 f'(J M^-1 J' + eps I) f + f'q`` by Newton
    on the velocity-space primal from ``w0`` (zeros by default).

    Args:
        M: ``(*, n_v, n_v)``; J: ``(*, 3k, n_v)``; q: ``(*, 3k)``.

    Returns:
        ``(*, 3k)`` impulse, stacked layout.
    """
    if w0 is None:
        w0 = q.new_zeros(q.shape[:-1] + (M.shape[-1],))
    return _sap_newton(M, J, q, eps, iterations, w0)[0]


def _hybrid_forward(q, M, J, eps, ipm_iterations, newton_iterations):
    x0 = solve_cone_qp_ipm_mj(M, J, q, eps, ipm_iterations)
    w0 = spd_solve(M, small_matvec(J.transpose(-1, -2), x0))
    return _sap_newton(M, J, q, eps, newton_iterations, w0)[0]


class _HybridSolve(torch.autograd.Function):
    """The hybrid solve with the IFT backward."""

    @staticmethod
    def forward(ctx, Q, q, M, J, eps, ipm_iterations, newton_iterations):
        x = _hybrid_forward(q, M, J, eps, ipm_iterations, newton_iterations)
        ctx.save_for_backward(Q, q, x)
        return x

    @staticmethod
    def backward(ctx, g):
        Q, q, x = ctx.saved_tensors
        bar_Q, bar_q = ift_cotangents(Q, q, x, g)
        return bar_Q, bar_q, None, None, None, None, None


def solve_cone_qp_hybrid(Q: Tensor, q: Tensor, M: Tensor, J: Tensor, eps,
                         ipm_iterations: int = DEFAULT_HYBRID_IPM_ITERATIONS,
                         newton_iterations: int =
                         DEFAULT_HYBRID_NEWTON_ITERATIONS) -> Tensor:
    r"""Interior-point warm start + SAP-Newton polish of the cone QP
    ``(Q, q)`` with ``Q = J M^{-1} J^T + eps I``: ``(*, 3k)``.

    Gradients reach ``Q`` and ``q`` by the implicit-function theorem;
    ``M``, ``J`` and ``eps`` get none."""
    return _HybridSolve.apply(Q, q, M, J, eps, ipm_iterations,
                              newton_iterations)


def solve_contact_impulse_hybrid(delassus: Tensor, M: Tensor, J: Tensor,
                                 q_vec: Tensor, eps,
                                 ipm_iterations: int =
                                 DEFAULT_HYBRID_IPM_ITERATIONS,
                                 newton_iterations: int =
                                 DEFAULT_HYBRID_NEWTON_ITERATIONS
                                 ) -> Tuple[Tensor, Tensor]:
    """Hybrid contact solve of ``Q = delassus + eps I`` with the standard
    failure masking: ``(impulse (*, 3k), valid (*,))``. Gradients flow
    through ``delassus`` and ``q_vec``."""
    n = delassus.shape[-1]
    Q = delassus + eps * torch.eye(n, dtype=delassus.dtype,
                                   device=delassus.device)
    return mask_failures(solve_cone_qp_hybrid(Q, q_vec, M, J, eps,
                                              ipm_iterations,
                                              newton_iterations))


def _primal_cost(M, J, q, eps, w):
    """Stacked-layout primal cost ``(*)`` and impulse."""
    gamma = project_lorentz(-(small_matvec(J, w) + q) / eps)
    return (0.5 * torch.sum(w * small_matvec(M, w), dim=-1) +
            0.5 * eps * torch.sum(gamma * gamma, dim=-1), gamma)


def solve_cone_qp_hybrid_warm(M: Tensor, J: Tensor, q: Tensor, eps,
                              w_carry: Tensor, ipm_iterations: int = 10,
                              newton_iterations: int = 6
                              ) -> Tuple[Tensor, Tensor]:
    """Warm-started hybrid solve for rollouts: ``ipm_iterations`` of the
    interior point, then Newton from the better by primal cost of its
    point and the carried primal ``w_carry``. Returns ``(impulse (*, 3k),
    w)``, ``w`` the carry of the next step."""
    x_ipm = solve_cone_qp_ipm_mj(M, J, q, eps, ipm_iterations)
    w_ipm = spd_solve(M, small_matvec(J.transpose(-1, -2), x_ipm))
    cost_ipm, _ = _primal_cost(M, J, q, eps, w_ipm)
    cost_carry, _ = _primal_cost(M, J, q, eps, w_carry)
    w0 = torch.where((cost_carry < cost_ipm)[..., None], w_carry, w_ipm)
    return _sap_newton(M, J, q, eps, newton_iterations, w0)


def solve_contact_impulse_sap(M: Tensor, J: Tensor, q_vec: Tensor, eps,
                              iterations: int = DEFAULT_NEWTON_ITERATIONS,
                              w0: Optional[Tensor] = None
                              ) -> Tuple[Tensor, Tensor]:
    """SAP-Newton contact solve with the standard failure masking."""
    return mask_failures(solve_cone_qp_sap(M, J, q_vec, eps, iterations, w0))
