r"""Primal-dual interior-point solver for small cone QPs (PyTorch).

Counterpart of ``dair_pll_tpu/ops/socp_solver.py``, batched over leading
dimensions. Solves

.. math:: \min_{x \in K} \ \tfrac12 x^T Q x + q^T x,
          \qquad K = \prod_{i=1}^k \mathcal{Q}^3

with a Nesterov-Todd-scaled Mehrotra predictor-corrector method at a
fixed iteration count, branchless: every sample of the batch takes every
iteration, and the convergence freeze and the keep-best safeguard select
per sample with ``torch.where``. ``eps`` is a Python float or a 0-d
tensor.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from dair_pll_tpu_torch.ops import cones
from dair_pll_tpu_torch.ops.linear import cho_solve_unrolled, cholesky_unrolled

DEFAULT_IPM_ITERATIONS = 18
_STEP_BACKOFF = 0.99
_MIN_DET = 1e-30


def _cone_index(k: int) -> Tuple[list, list]:
    """Stacked index of each cone-major coordinate, and its inverse."""
    idx = [i for c in range(k) for i in (c, k + 2 * c, k + 2 * c + 1)]
    inv = [0] * (3 * k)
    for p, s in enumerate(idx):
        inv[s] = p
    return idx, inv


def _arrow_solve(u: Tensor, b: Tensor) -> Tensor:
    """Solves ``Arw(u) y = b`` per cone, the determinant floored at
    ``_MIN_DET``."""
    det = torch.clamp(cones.det(u), min=_MIN_DET)
    u0 = u[..., :1]
    u1 = u[..., 1:]
    y0 = (u0 * b[..., :1] - torch.sum(u1 * b[..., 1:], dim=-1,
                                      keepdim=True)) / det[..., None]
    y1 = (b[..., 1:] - y0 * u1) / u0
    return torch.cat((y0, y1), dim=-1)


def _nt_scaling(x: Tensor, z: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-cone NT scaling matrices ``W``, ``W^{-1}`` ``(*, k, 3, 3)`` and
    the scaled point ``lam = W x``."""
    R_diag = torch.tensor([1.0, -1.0, -1.0], dtype=x.dtype, device=x.device)
    det_x = torch.clamp(cones.det(x), min=_MIN_DET)
    det_z = torch.clamp(cones.det(z), min=_MIN_DET)
    x_bar = x / torch.sqrt(det_x)[..., None]
    z_bar = z / torch.sqrt(det_z)[..., None]
    gamma = torch.sqrt(torch.clamp(
        0.5 * (1.0 + torch.sum(x_bar * z_bar, dim=-1)), min=1e-15))
    w_bar = (z_bar + R_diag * x_bar) / (2.0 * gamma[..., None])
    e = torch.tensor([1.0, 0.0, 0.0], dtype=x.dtype, device=x.device)
    v = (w_bar + e) / torch.sqrt(2.0 * (w_bar[..., :1] + 1.0))
    eta = (det_z / det_x) ** 0.25
    R = torch.diag(R_diag)
    W = eta[..., None, None] * (2.0 * (v[..., :, None] * v[..., None, :]) - R)
    v_inv = R_diag * v
    W_inv = (2.0 * (v_inv[..., :, None] * v_inv[..., None, :]) - R) / \
        eta[..., None, None]
    return W, W_inv, cones.cone_matvec(W, x)


def _violation(u: Tensor) -> Tensor:
    return torch.sum(torch.clamp(torch.linalg.norm(u[..., 1:], dim=-1) -
                                 u[..., 0], min=0.0), dim=-1)


def _frobenius(r: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(r * r, dim=(-2, -1)))


def _merit(x: Tensor, z: Tensor, r: Tensor, k: int) -> Tensor:
    """Complementarity gap + dual residual + a heavy cone-infeasibility
    penalty."""
    return torch.sum(x * z, dim=(-2, -1)) / (2.0 * k) + _frobenius(r) + \
        1e6 * (_violation(x) + _violation(z))


def _select(cond: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """Per-sample ``where`` of ``(*)`` conditions over ``(*, k, 3)``."""
    return torch.where(cond[..., None, None], a, b)


def _start(qc: Tensor, k: int):
    """Identity-scaled interior start sized to the data, and the scale."""
    scale = torch.clamp(_frobenius(qc) / (3.0 * k) ** 0.5, min=1.0)
    e_cone = torch.zeros_like(qc)
    e_cone[..., 0] = 1.0
    start = e_cone * torch.sqrt(scale)[..., None, None]
    return e_cone, scale, start


def solve_cone_qp_ipm(Q: Tensor, q: Tensor,
                      iterations: int = DEFAULT_IPM_ITERATIONS) -> Tensor:
    """Solves ``min 0.5 x'Qx + q'x`` over the product Lorentz cone by a
    fixed-iteration NT predictor-corrector interior-point method.

    Args:
        Q: ``(*, 3k, 3k)`` PSD cost, stacked layout.
        q: ``(*, 3k)`` cost vector, stacked layout.

    Returns:
        ``(*, 3k)`` optimal impulse, stacked layout.
    """
    k = q.shape[-1] // 3
    n = 3 * k
    batch = q.shape[:-1]
    idx, inv = _cone_index(k)
    Qc = Q[..., idx, :][..., :, idx]
    qc = q[..., idx].reshape(batch + (k, 3))
    e_cone, scale, x = _start(qc, k)
    z = x
    block_mask = torch.eye(k, dtype=torch.bool, device=q.device)[
        :, None, :, None].expand(k, 3, k, 3)

    def qc_dot(u: Tensor) -> Tensor:
        return (Qc @ u.reshape(batch + (n, 1))).reshape(batch + (k, 3))

    x_best = x
    merit_best = torch.full(batch, float("inf"), dtype=q.dtype,
                            device=q.device)
    eps_machine = torch.finfo(q.dtype).eps
    for _ in range(iterations):
        r = qc_dot(x) + qc - z
        mu = torch.sum(x * z, dim=(-2, -1)) / (2.0 * k)
        m = mu + _frobenius(r)
        better = torch.isfinite(m) & (m < merit_best)
        x_best = _select(better, x, x_best)
        merit_best = torch.where(better, m, merit_best)

        W, W_inv, lam = _nt_scaling(x, z)
        W2 = W @ W
        blocks = torch.where(block_mask, W2[..., :, :, None, :].expand(
            batch + (k, 3, k, 3)), torch.zeros((), dtype=q.dtype,
                                               device=q.device))
        L = cholesky_unrolled(Qc + blocks.reshape(batch + (n, n)))

        def kkt_solve(d):
            rhs = cones.cone_matvec(W, d).reshape(batch + (n,)) - \
                r.reshape(batch + (n,))
            dx = cho_solve_unrolled(L, rhs).reshape(batch + (k, 3))
            return dx, qc_dot(dx) + r

        lam_sq = cones.jordan_product(lam, lam)
        dx_aff, dz_aff = kkt_solve(_arrow_solve(lam, -lam_sq))
        alpha_aff = torch.minimum(cones.step_to_boundary(x, dx_aff),
                                  cones.step_to_boundary(z, dz_aff))
        a = alpha_aff[..., None, None]
        mu_aff = torch.sum((x + a * dx_aff) * (z + a * dz_aff),
                           dim=(-2, -1)) / (2.0 * k)
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=_MIN_DET)) ** 3,
                            0.0, 1.0)
        corr = cones.jordan_product(cones.cone_matvec(W, dx_aff),
                                    cones.cone_matvec(W_inv, dz_aff))
        rhs_c = (sigma * mu)[..., None, None] * e_cone - lam_sq - corr
        dx, dz = kkt_solve(_arrow_solve(lam, rhs_c))
        alpha = _STEP_BACKOFF * torch.minimum(
            cones.step_to_boundary(x, dx), cones.step_to_boundary(z, dz))
        converged = mu <= 100.0 * eps_machine * scale
        step_ok = torch.isfinite(dx).all(dim=-1).all(dim=-1) & \
            torch.isfinite(dz).all(dim=-1).all(dim=-1)
        move = step_ok & ~converged
        x = _select(move, x + alpha[..., None, None] * dx, x)
        z = _select(move, z + alpha[..., None, None] * dz, z)

    m_final = _merit(x, z, qc_dot(x) + qc - z, k)
    x = _select(torch.isfinite(m_final) & (m_final < merit_best), x, x_best)
    return x.reshape(batch + (n,))[..., inv]


def solve_cone_qp_ipm_mj(M: Tensor, J: Tensor, q: Tensor, eps,
                         iterations: int = DEFAULT_IPM_ITERATIONS,
                         correctors: int = 0) -> Tensor:
    r"""The interior-point method of :func:`solve_cone_qp_ipm` for ``Q = J
    M^{-1} J^T + eps I``: the KKT system ``(Q + W^2) dx = rhs`` is solved
    by the Woodbury identity with ``A = W^2 + eps I`` block-diagonal per
    cone (3x3 analytic inverses) and one ``n_v x n_v`` Cholesky of the
    Schur complement ``M + J^T A^{-1} J``.

    Args:
        M: ``(*, n_v, n_v)`` SPD mass matrix.
        J: ``(*, 3k, n_v)`` contact Jacobian, stacked layout.
        q: ``(*, 3k)`` cost vector, stacked layout.
        eps: regularization.
        correctors: Gondzio centrality correctors per iteration.

    Returns:
        ``(*, 3k)`` optimal impulse, stacked layout.
    """
    k = q.shape[-1] // 3
    Jc = cones.rows_to_cone_major(J)                       # (*, k, 3, n_v)
    qc = cones.stacked_to_cone_major(q)                    # (*, k, 3)
    L_M = cholesky_unrolled(M)

    def j_dot(w):
        return torch.sum(Jc * w[..., None, None, :], dim=-1)

    def jt_dot(u):
        return torch.sum(Jc * u[..., None], dim=(-3, -2))

    def q_dot(x):
        return j_dot(cho_solve_unrolled(L_M, jt_dot(x))) + eps * x

    e_cone, scale, x = _start(qc, k)
    z = x
    x_best = x
    merit_best = torch.full(q.shape[:-1], float("inf"), dtype=q.dtype,
                            device=q.device)
    eps_machine = torch.finfo(q.dtype).eps
    for _ in range(iterations):
        r = q_dot(x) + qc - z
        mu = torch.sum(x * z, dim=(-2, -1)) / (2.0 * k)
        m = _merit(x, z, r, k)
        better = torch.isfinite(m) & (m < merit_best)
        x_best = _select(better, x, x_best)
        merit_best = torch.where(better, m, merit_best)

        scaling, lam = cones.nt_scaling(x, z)
        A_inv = cones.nt_w2_inverse_matrix(scaling, eps)   # (*, k, 3, 3)
        AJ = torch.sum(A_inv[..., None] * Jc[..., None, :, :], dim=-2)
        S = M + torch.sum(Jc[..., :, :, :, None] * AJ[..., :, :, None, :],
                          dim=(-4, -3))
        L_S = cholesky_unrolled(S)

        def kkt_solve(d, with_r=True):
            rhs = scaling.apply(d) - r if with_r else scaling.apply(d)
            u = cones.cone_matvec(A_inv, rhs)
            h = cho_solve_unrolled(L_S, jt_dot(u))
            dx = u - cones.cone_matvec(A_inv, j_dot(h))
            dz = q_dot(dx) + r if with_r else q_dot(dx)
            return dx, dz

        lam_sq = cones.jordan_product(lam, lam)
        dx_aff, dz_aff = kkt_solve(cones.arrow_solve(lam, -lam_sq))
        alpha_aff = torch.minimum(cones.step_to_boundary(x, dx_aff),
                                  cones.step_to_boundary(z, dz_aff))
        a = alpha_aff[..., None, None]
        mu_aff = torch.sum((x + a * dx_aff) * (z + a * dz_aff),
                           dim=(-2, -1)) / (2.0 * k)
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=_MIN_DET)) ** 3,
                            0.0, 1.0)
        corr = cones.jordan_product(scaling.apply(dx_aff),
                                    scaling.apply_inverse(dz_aff))
        rhs_c = (sigma * mu)[..., None, None] * e_cone - lam_sq - corr
        dx, dz = kkt_solve(cones.arrow_solve(lam, rhs_c))
        alpha = torch.minimum(cones.step_to_boundary(x, dx),
                              cones.step_to_boundary(z, dz))

        # Gondzio centrality correctors, each kept only where it widens
        # the step.
        mu_t = torch.clamp(sigma * mu, min=_MIN_DET)[..., None, None]
        for _ in range(correctors):
            alpha_t = torch.clamp(1.08 * alpha + 0.08, max=1.0)[..., None,
                                                                 None]
            vx = lam + alpha_t * scaling.apply(dx)
            vz = lam + alpha_t * scaling.apply_inverse(dz)
            p = cones.jordan_product(vx, vz)
            t0 = torch.minimum(torch.maximum(p[..., :1], 0.1 * mu_t),
                               10.0 * mu_t) - p[..., :1]
            t = torch.cat((t0, -p[..., 1:]), dim=-1)
            dx_c, dz_c = kkt_solve(cones.arrow_solve(lam, t), with_r=False)
            dx_n = dx + dx_c
            dz_n = dz + dz_c
            alpha_n = torch.minimum(cones.step_to_boundary(x, dx_n),
                                    cones.step_to_boundary(z, dz_n))
            ok = (alpha_n > alpha) & \
                torch.isfinite(dx_n).all(dim=-1).all(dim=-1) & \
                torch.isfinite(dz_n).all(dim=-1).all(dim=-1)
            dx = _select(ok, dx_n, dx)
            dz = _select(ok, dz_n, dz)
            alpha = torch.where(ok, alpha_n, alpha)

        alpha = _STEP_BACKOFF * alpha
        converged = mu <= 100.0 * eps_machine * scale
        step_ok = torch.isfinite(dx).all(dim=-1).all(dim=-1) & \
            torch.isfinite(dz).all(dim=-1).all(dim=-1)
        move = step_ok & ~converged
        x = _select(move, x + alpha[..., None, None] * dx, x)
        z = _select(move, z + alpha[..., None, None] * dz, z)

    m_final = _merit(x, z, q_dot(x) + qc - z, k)
    x = _select(torch.isfinite(m_final) & (m_final < merit_best), x, x_best)
    return cones.cone_major_to_stacked(x)


def mask_failures(impulse: Tensor) -> Tuple[Tensor, Tensor]:
    """The standard failure masking: samples with a non-finite entry or
    one above 1e3 in magnitude are zeroed. Returns ``(impulse (*, 3k),
    valid (*,))``."""
    valid = torch.isfinite(impulse).all(dim=-1) & \
        (torch.abs(impulse) <= 1e3).all(dim=-1)
    impulse = torch.where(valid[..., None], impulse,
                          torch.zeros_like(impulse))
    return torch.nan_to_num(impulse), valid


def solve_contact_impulse_ipm(delassus: Tensor, q_vec: Tensor, eps,
                              iterations: int = DEFAULT_IPM_ITERATIONS
                              ) -> Tuple[Tensor, Tensor]:
    """Interior-point contact solve of ``Q = delassus + eps I`` with the
    standard failure masking."""
    n = delassus.shape[-1]
    Q = delassus + eps * torch.eye(n, dtype=delassus.dtype,
                                   device=delassus.device)
    return mask_failures(solve_cone_qp_ipm(Q, q_vec, iterations))
