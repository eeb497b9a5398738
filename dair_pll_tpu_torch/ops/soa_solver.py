r"""Batch-minor (SoA) hybrid cone-QP solver: NT interior point + SAP-Newton.

Counterpart of ``dair_pll_tpu/ops/soa_solver.py`` (see there and
``ops/socp_solver.py``/``ops/sap_solver.py`` of the JAX package for the
derivations). The same algorithm in the same operation order, written on
torch tensors; ``fori_loop`` becomes a Python loop.

Layout ("cone fields"): a product-cone quantity is a 3-list ``[n, t1,
t2]`` of ``(k, B)`` tensors; the cone-major contact Jacobian is a
``(3, n_v)`` nested list of ``(k, B)`` leaves; the mass matrix an
``(n_v, n_v)`` nested list of ``(B,)`` leaves. Reductions over the cone
axis return ``(B,)`` rows, which broadcast against ``(k, B)`` leaves.

:func:`solve_warm_hybrid_soa` is the plain version of the rollout
kernel: ``ops/soa_kernels.py`` holds its CUDA counterpart, and the tests
and ``chip_smoke.py`` hold the two against each other.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import Tensor

from dair_pll_tpu_torch.ops import soa, soa_cones
from dair_pll_tpu_torch.ops.soa import Smat, Svec

ConeField = List[Tensor]      # [n, t1, t2], each (k, B)
ConeMat = List[List[Tensor]]  # 3 x n_v nested list of (k, B) leaves

_STEP_BACKOFF = 0.99
_MIN_DET = 1e-30
# Safeguarded-Newton polish count of the exact line search; the JAX
# package measured 6 as indistinguishable from 8 and 5 as degrading the
# tail (its ``results/polish_accuracy.json``).
_POLISH_STEPS = 6


def j_dot(Jc: ConeMat, w: Svec) -> ConeField:
    """``J w`` per cone: ``(3, n_v)`` of ``(k, B)`` applied to ``(B,)``
    velocities -> cone field."""
    return [sum(Jc[i][v] * w[v] for v in range(len(w))) for i in range(3)]


def jt_dot(Jc: ConeMat, u: ConeField) -> Svec:
    """``J^T u`` accumulated over cones and components -> svec of
    ``(B,)`` leaves."""
    n_v = len(Jc[0])
    return [soa.sum_rows(Jc[0][v] * u[0] + Jc[1][v] * u[1] +
                         Jc[2][v] * u[2]) for v in range(n_v)]


def _field_sqnorm(u: ConeField) -> Tensor:
    return soa.sum_rows(u[0] * u[0] + u[1] * u[1] + u[2] * u[2])


def _field_isfinite(u: ConeField) -> Tensor:
    return torch.all(torch.isfinite(u[0]) & torch.isfinite(u[1]) &
                     torch.isfinite(u[2]), dim=0)


def _where_field(mask: Tensor, a: ConeField, b: ConeField) -> ConeField:
    """Per-batch select; ``mask`` ``(B,)`` broadcasts over the cone axis."""
    return [torch.where(mask, x, y) for x, y in zip(a, b)]


def _gap(x: ConeField, z: ConeField, k: int) -> Tensor:
    return _divide(soa.sum_rows(x[0] * z[0] + x[1] * z[1] + x[2] * z[2]),
                   2.0 * k)


def _divide(t: Tensor, c) -> Tensor:
    """``t / c`` rounded as one IEEE division, on any device: on the card
    torch divides by a Python scalar as a product with its reciprocal,
    which the kernels' division does not repeat to the last bit."""
    if isinstance(c, Tensor):
        return t / c
    return t / torch.full((), c, dtype=t.dtype, device=t.device)


def _violation(u: ConeField) -> Tensor:
    return soa.sum_rows(torch.clamp_min(
        torch.sqrt(u[1] * u[1] + u[2] * u[2]) - u[0], 0.0))


def solve_ipm_mj(M: Smat, Jc: ConeMat, qc: ConeField, eps,
                 iterations: int) -> ConeField:
    """NT predictor-corrector interior point on the cone QP
    ``min 1/2 x'(J M^-1 J' + eps I)x + qc'x`` over the product cone,
    tracking the merit-best iterate. Returns the impulse as a cone
    field."""
    k = Jc[0][0].shape[0]
    n_v = len(M)
    F_M = soa.ldlt(M)

    def q_dot(x: ConeField) -> ConeField:
        h = soa.ldlt_solve(F_M, jt_dot(Jc, x))
        jw = j_dot(Jc, h)
        return [jw[i] + eps * x[i] for i in range(3)]

    def merit(x, z, r):
        return _gap(x, z, k) + torch.sqrt(_field_sqnorm(r)) + \
            1e6 * (_violation(x) + _violation(z))

    scale = torch.clamp_min(
        torch.sqrt(_divide(_field_sqnorm(qc), float(3 * k))), 1.0)
    sqrt_scale = torch.sqrt(scale)
    like = qc[0]
    machine_eps = torch.finfo(like.dtype).eps
    x = [sqrt_scale.expand(like.shape), torch.zeros_like(like),
         torch.zeros_like(like)]
    z = list(x)
    x_best = list(x)
    merit_best = torch.full_like(scale, float("inf"))

    for _ in range(iterations):
        qx = q_dot(x)
        r = [qx[i] + qc[i] - z[i] for i in range(3)]
        mu = _gap(x, z, k)

        m = merit(x, z, r)
        better = torch.isfinite(m) & (m < merit_best)
        x_best = _where_field(better, x, x_best)
        merit_best = torch.where(better, m, merit_best)

        scaling, lam = soa_cones.nt_scaling(x, z)
        A_inv = soa_cones.nt_w2_inverse(scaling, eps)   # 3x3 of (k, B)

        # Schur complement S = M + J^T A^{-1} J (n_v x n_v of (B,)).
        AJ = [[A_inv[i][0] * Jc[0][v] + A_inv[i][1] * Jc[1][v] +
               A_inv[i][2] * Jc[2][v] for v in range(n_v)]
              for i in range(3)]
        S = [row[:] for row in M]
        for v1 in range(n_v):
            for v2 in range(v1 + 1):
                acc = soa.sum_rows(Jc[0][v1] * AJ[0][v2] +
                                   Jc[1][v1] * AJ[1][v2] +
                                   Jc[2][v1] * AJ[2][v2])
                S[v1][v2] = S[v1][v2] + acc
                if v2 < v1:
                    S[v2][v1] = S[v2][v1] + acc
        F_S = soa.ldlt(S)

        def kkt_solve(d: ConeField, r=r, A_inv=A_inv, F_S=F_S,
                      scaling=scaling):
            """Returns ``(dx, W dx, W^{-1} dz)``; ``dz`` comes from the
            scaled complementarity relation ``W^{-1} dz + W dx = d``."""
            wd = scaling.apply(d)
            rhs = [wd[i] - r[i] for i in range(3)]
            u = soa.matvec(A_inv, rhs)
            h = soa.ldlt_solve(F_S, jt_dot(Jc, u))
            jh = j_dot(Jc, h)
            ajh = soa.matvec(A_inv, jh)
            dx = [u[i] - ajh[i] for i in range(3)]
            wdx = scaling.apply(dx)
            wizd = [d[i] - wdx[i] for i in range(3)]
            return dx, wdx, wizd

        # Affine (predictor) step, bookkept in NT-scaled coordinates.
        ll = soa_cones.jordan_product(lam, lam)
        d_aff = soa_cones.arrow_solve(lam, [-c for c in ll])
        _, wdx_aff, wizd_aff = kkt_solve(d_aff)
        alpha_aff = torch.minimum(_step_to_boundary(lam, wdx_aff),
                                  _step_to_boundary(lam, wizd_aff))
        la_x = [lam[i] + alpha_aff * wdx_aff[i] for i in range(3)]
        la_z = [lam[i] + alpha_aff * wizd_aff[i] for i in range(3)]
        mu_aff = _gap(la_x, la_z, k)
        sigma = torch.clamp((mu_aff / torch.clamp_min(mu, _MIN_DET)) ** 3,
                            0.0, 1.0)

        # Corrector step (same Schur factorization).
        corr = soa_cones.jordan_product(wdx_aff, wizd_aff)
        rhs_c = [sigma * mu - ll[0] - corr[0],
                 -ll[1] - corr[1],
                 -ll[2] - corr[2]]
        d = soa_cones.arrow_solve(lam, rhs_c)
        dx, wdx, wizd = kkt_solve(d)
        dz = scaling.apply(wizd)

        alpha = _STEP_BACKOFF * torch.minimum(
            _step_to_boundary(lam, wdx), _step_to_boundary(lam, wizd))
        converged = mu <= 100.0 * machine_eps * scale
        step_ok = _field_isfinite(dx) & _field_isfinite(dz)
        move = step_ok & ~converged
        x = _where_field(move, [x[i] + alpha * dx[i] for i in range(3)], x)
        z = _where_field(move, [z[i] + alpha * dz[i] for i in range(3)], z)

    qx = q_dot(x)
    r_final = [qx[i] + qc[i] - z[i] for i in range(3)]
    m_final = merit(x, z, r_final)
    return _where_field(torch.isfinite(m_final) & (m_final < merit_best),
                        x, x_best)


def _step_to_boundary(u: ConeField, du: ConeField) -> Tensor:
    """Min over cones of the per-cone step-to-boundary, capped at 1."""
    alpha = soa_cones.step_to_boundary_one(u, du)     # (k, B)
    return torch.clamp_max(torch.amin(alpha, dim=0), 1.0)


# -- SAP-Newton polish -----------------------------------------------------------
def _crease_breakpoints(z0: ConeField, dz: ConeField) -> List[Tensor]:
    """Step lengths in ``(0, 1)`` where a cone argument crosses a
    projection crease; returns ``2k`` candidate ``(B,)`` tensors, invalid
    ones clipped to 1."""
    n0, dn = z0[0], dz[0]
    A = dz[1] * dz[1] + dz[2] * dz[2] - dn * dn
    B = 2.0 * (z0[1] * dz[1] + z0[2] * dz[2] - n0 * dn)
    C = z0[1] * z0[1] + z0[2] * z0[2] - n0 * n0

    disc = B * B - 4.0 * A * C
    sqrt_disc = torch.sqrt(torch.clamp_min(disc, 0.0))
    tiny = 1e-30
    safe_A = torch.where(torch.abs(A) > tiny, A, tiny)
    safe_B = torch.where(torch.abs(B) > tiny, B, tiny)

    r1 = (-B - torch.sign(safe_B) * sqrt_disc) / (2.0 * safe_A)
    r2 = C / torch.where(torch.abs(safe_A * r1) > tiny, safe_A * r1, tiny)
    lin = -C / safe_B
    is_linear = torch.abs(A) <= 1e-12 * torch.clamp_min(torch.abs(B), 1.0)
    r1 = torch.where(is_linear, lin, r1)
    r2 = torch.where(is_linear, 1.0, r2)
    no_root = (disc < 0.0) & ~is_linear

    out = []
    k = z0[0].shape[0]
    for r in (r1, r2):
        valid = (r > 1e-12) & (r < 1.0) & ~no_root
        clipped = torch.where(valid, r, 1.0)   # (k, B)
        out.extend(clipped[c] for c in range(k))
    return out


def _line_search(M: Smat, Jc: ConeMat, qc: ConeField, eps, w: Svec,
                 dw: Svec) -> Svec:
    """Exact line search along ``dw``: bracket by the crease breakpoints,
    then ``_POLISH_STEPS`` safeguarded Newton steps on ``g'``."""
    inv_eps = 1.0 / eps
    jw = j_dot(Jc, w)
    jdw = j_dot(Jc, dw)
    z0 = [-(jw[i] + qc[i]) * inv_eps for i in range(3)]
    dz = [-jdw[i] * inv_eps for i in range(3)]
    a0 = soa.dot(dw, soa.matvec(M, w))
    a1 = soa.dot(dw, soa.matvec(M, dw))

    def g_prime(alpha):
        za = [z0[i] + alpha * dz[i] for i in range(3)]
        gamma = soa_cones.project(za)
        return a0 + a1 * alpha + eps * soa.sum_rows(
            dz[0] * gamma[0] + dz[1] * gamma[1] + dz[2] * gamma[2])

    # g' is nondecreasing along the ray (the SAP primal is convex), so the
    # bracket (max candidate with g' <= 0, min with g' > 0) needs no sort.
    # The last candidate is alpha = 1, so gp[-1] is g'(1).
    candidates = ([torch.zeros_like(a0)] + _crease_breakpoints(z0, dz) +
                  [torch.ones_like(a0)])
    gp = [g_prime(c) for c in candidates]

    big = 2.0
    lo = None
    hi = None
    for c, g in zip(candidates, gp):
        lo_c = torch.where(g <= 0.0, c, -big)
        hi_c = torch.where(g > 0.0, c, big)
        lo = lo_c if lo is None else torch.maximum(lo, lo_c)
        hi = hi_c if hi is None else torch.minimum(hi, hi_c)
    take_full = gp[-1] <= 0.0
    lo = torch.clamp_min(lo, 0.0)
    hi = torch.where(hi > 1.0, 1.0, hi)
    hi = torch.maximum(hi, lo)

    alpha = 0.5 * (lo + hi)
    for _ in range(_POLISH_STEPS):
        # Fused g'/g'': one projection pass gives P(za) and D(za) dz.
        za = [z0[i] + alpha * dz[i] for i in range(3)]
        gamma, ddz = soa_cones.project_and_jacobian_apply(za, dz)
        gp_a = a0 + a1 * alpha + eps * soa.sum_rows(
            dz[0] * gamma[0] + dz[1] * gamma[1] + dz[2] * gamma[2])
        gpp_a = torch.clamp_min(
            a1 + eps * soa.sum_rows(
                dz[0] * ddz[0] + dz[1] * ddz[1] + dz[2] * ddz[2]),
            1e-30)
        lo = torch.where(gp_a <= 0.0, alpha, lo)
        hi = torch.where(gp_a > 0.0, alpha, hi)
        newton = alpha - gp_a / gpp_a
        inside = (newton > lo) & (newton < hi)
        alpha = torch.where(inside, newton, 0.5 * (lo + hi))
    alpha = torch.where(take_full, 1.0, alpha)
    return [w[i] + alpha * dw[i] for i in range(len(w))]


def sap_newton(M: Smat, Jc: ConeMat, qc: ConeField, eps, iterations: int,
               w0: Svec) -> Tuple[ConeField, Svec]:
    """Fixed-count Newton on the velocity-space SAP primal with exact line
    search. Returns ``(impulse cone field, w)``."""
    n_v = len(M)
    inv_eps = 1.0 / eps
    w = w0
    for _ in range(iterations):
        jw = j_dot(Jc, w)
        z = [-(jw[i] + qc[i]) * inv_eps for i in range(3)]
        # Gradient and Hessian share one projection pass.
        gamma, D = soa_cones.project_and_jacobian_matrix(z)
        grad = soa.vsub(soa.matvec(M, w), jt_dot(Jc, gamma))
        DJ = [[D[i][0] * Jc[0][v] + D[i][1] * Jc[1][v] +
               D[i][2] * Jc[2][v] for v in range(n_v)]
              for i in range(3)]
        H = [row[:] for row in M]
        for v1 in range(n_v):
            for v2 in range(v1 + 1):
                acc = inv_eps * soa.sum_rows(
                    Jc[0][v1] * DJ[0][v2] + Jc[1][v1] * DJ[1][v2] +
                    Jc[2][v1] * DJ[2][v2])
                H[v1][v2] = H[v1][v2] + acc
                if v2 < v1:
                    H[v2][v1] = H[v2][v1] + acc
        for i in range(n_v):
            H[i][i] = H[i][i] + 1e-10
        dw = [-g for g in soa.spd_solve(H, grad)]
        w = _line_search(M, Jc, qc, eps, w, dw)
    jw = j_dot(Jc, w)
    gamma = soa_cones.project(
        [-(jw[i] + qc[i]) * inv_eps for i in range(3)])
    return gamma, w


def _mask_failures(gamma: ConeField) -> Tuple[ConeField, Tensor]:
    """Per-sample failure mask: non-finite or ``|gamma| > 1e3`` samples
    get a zero impulse."""
    finite = _field_isfinite(gamma)
    bounded = torch.all((torch.abs(gamma[0]) <= 1e3) &
                        (torch.abs(gamma[1]) <= 1e3) &
                        (torch.abs(gamma[2]) <= 1e3), dim=0)
    valid = finite & bounded
    gamma = [torch.where(valid, torch.nan_to_num(comp), 0.0)
             for comp in gamma]
    return gamma, valid


def solve_contact_impulse_soa(M: Smat, Jc: ConeMat, qc: ConeField, eps,
                              ipm_iterations: int, newton_iterations: int
                              ) -> Tuple[ConeField, Tensor]:
    """Hybrid contact solve (IPM warm start + SAP-Newton polish) with the
    per-sample failure mask. Returns ``(impulse cone field, valid (B,))``."""
    x0 = solve_ipm_mj(M, Jc, qc, eps, ipm_iterations)
    w0 = soa.spd_solve(M, jt_dot(Jc, x0))
    gamma, _ = sap_newton(M, Jc, qc, eps, newton_iterations, w0)
    return _mask_failures(gamma)


def primal_cost(M: Smat, Jc: ConeMat, qc: ConeField, eps,
                w: Svec) -> Tensor:
    """Regularized SAP primal objective per sample, ``(B,)``."""
    jw = j_dot(Jc, w)
    gamma = soa_cones.project([_divide(-(jw[i] + qc[i]), eps)
                               for i in range(3)])
    quad = 0.5 * soa.dot(w, soa.matvec(M, w))
    return quad + 0.5 * eps * soa.sum_rows(
        gamma[0] ** 2 + gamma[1] ** 2 + gamma[2] ** 2)


def solve_warm_hybrid_soa(M: Smat, Jc: ConeMat, qc: ConeField,
                          w_carry: Svec, eps, ipm_iterations: int,
                          newton_iterations: int
                          ) -> Tuple[ConeField, Svec, Tensor]:
    """Warm-started hybrid solve for sequential rollouts: a short IPM
    central path, then SAP-Newton from the better (by primal cost) of the
    carried primal ``w_carry`` and the IPM iterate, with the per-sample
    failure mask. Returns ``(impulse cone field, w, valid (B,))``."""
    n_v = len(M)
    x_ipm = solve_ipm_mj(M, Jc, qc, eps, ipm_iterations)
    w_ipm = soa.spd_solve(M, jt_dot(Jc, x_ipm))
    better = primal_cost(M, Jc, qc, eps, w_carry) < \
        primal_cost(M, Jc, qc, eps, w_ipm)
    w_init = [torch.where(better, w_carry[i], w_ipm[i])
              for i in range(n_v)]
    gamma, w = sap_newton(M, Jc, qc, eps, newton_iterations, w_init)

    gamma, valid = _mask_failures(gamma)
    w = [torch.where(valid, torch.nan_to_num(comp), 0.0) for comp in w]
    return gamma, w, valid
