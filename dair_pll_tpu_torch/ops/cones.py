r"""Per-cone (cone-major) Lorentz-cone primitives (PyTorch).

Counterpart of ``dair_pll_tpu/ops/cones.py``. The ``k`` independent
3-dimensional second-order cones of a contact problem are kept in
cone-major form ``u (*, k, 3)``, scalar ("normal") component first, and
every operator (projection, its Jacobian, Jordan algebra,
Nesterov-Todd scaling) acts matrix-free per cone. Leading dimensions
are the batch.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import Tensor

_SAFE_FLOOR = 1e-30


def stacked_to_cone_major(x: Tensor) -> Tensor:
    """``(*, 3k)`` stacked ``[normals; tangents]`` -> ``(*, k, 3)``."""
    k = x.shape[-1] // 3
    return torch.cat((x[..., :k, None],
                      x[..., k:].reshape(x.shape[:-1] + (k, 2))), dim=-1)


def cone_major_to_stacked(u: Tensor) -> Tensor:
    """``(*, k, 3)`` -> ``(*, 3k)`` stacked layout."""
    return torch.cat((u[..., 0], u[..., 1:].reshape(u.shape[:-2] + (-1,))),
                     dim=-1)


def rows_to_cone_major(J: Tensor) -> Tensor:
    """``(*, 3k, n)`` stacked-row operator -> ``(*, k, 3, n)``."""
    k = J.shape[-2] // 3
    n = J.shape[-1]
    normals = J[..., :k, :].reshape(J.shape[:-2] + (k, 1, n))
    tangents = J[..., k:, :].reshape(J.shape[:-2] + (k, 2, n))
    return torch.cat((normals, tangents), dim=-2)


def det(u: Tensor) -> Tensor:
    """Jordan determinant ``u0^2 - ||u1||^2``: ``(*, k, 3) -> (*, k)``."""
    return u[..., 0] ** 2 - torch.sum(u[..., 1:] ** 2, dim=-1)


def _norm_t(t: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp(torch.sum(t * t, dim=-1), min=_SAFE_FLOOR))


def project(u: Tensor) -> Tensor:
    """Euclidean projection onto each cone (branchless)."""
    n = u[..., 0]
    t = u[..., 1:]
    s = _norm_t(t)
    in_cone = s <= n
    in_polar = s <= -n
    zero = torch.zeros_like(n)
    h = 0.5 * (n + s)
    coeff = torch.where(in_cone, torch.ones_like(n),
                        torch.where(in_polar, zero, h / s))
    n_out = torch.where(in_cone, n, torch.where(in_polar, zero, h))
    return torch.cat((n_out[..., None], coeff[..., None] * t), dim=-1)


def projection_jacobian_apply(z: Tensor, u: Tensor) -> Tensor:
    r"""The projection's generalized Jacobian at ``z`` applied to ``u``,
    per cone: identity inside the cone, zero inside the polar, and in the
    boundary region, with ``s = ||t||``, ``hat = t/s``, ``h = (n+s)/2``,
    ``((u_0 + hat.u_t)/2, u_0 hat/2 + (h/s)(u_t - hat(hat.u_t)) +
    hat(hat.u_t)/2)``."""
    n = z[..., 0]
    t = z[..., 1:]
    s = _norm_t(t)
    hat = t / s[..., None]
    in_cone = s <= n
    in_polar = s <= -n
    u0 = u[..., 0]
    ut = u[..., 1:]
    hat_dot = torch.sum(hat * ut, dim=-1)
    h_over_s = 0.5 * (n + s) / s
    b0 = 0.5 * (u0 + hat_dot)
    bt = 0.5 * u0[..., None] * hat + \
        h_over_s[..., None] * (ut - hat * hat_dot[..., None]) + \
        0.5 * hat * hat_dot[..., None]
    out0 = torch.where(in_cone, u0,
                       torch.where(in_polar, torch.zeros_like(u0), b0))
    out_t = torch.where(in_cone[..., None], ut,
                        torch.where(in_polar[..., None],
                                    torch.zeros_like(bt), bt))
    return torch.cat((out0[..., None], out_t), dim=-1)


def projection_jacobian_matrix(z: Tensor) -> Tensor:
    """Dense per-cone projection Jacobian ``(*, k, 3, 3)``."""
    n = z[..., 0]
    t = z[..., 1:]
    s = _norm_t(t)
    hat = t / s[..., None]
    in_cone = s <= n
    in_polar = s <= -n
    h_over_s = (0.5 * (n + s) / s)[..., None, None]
    eye2 = torch.eye(2, dtype=z.dtype, device=z.device)
    hhT = hat[..., :, None] * hat[..., None, :]
    b_nn = torch.full_like(n, 0.5)
    b_nt = 0.5 * hat
    b_tt = h_over_s * (eye2 - hhT) + 0.5 * hhT
    top = torch.cat((b_nn[..., None, None], b_nt[..., None, :]), dim=-1)
    bottom = torch.cat((b_nt[..., :, None], b_tt), dim=-1)
    D_boundary = torch.cat((top, bottom), dim=-2)
    eye3 = torch.eye(3, dtype=z.dtype, device=z.device).expand(
        D_boundary.shape)
    return torch.where(in_cone[..., None, None], eye3,
                       torch.where(in_polar[..., None, None],
                                   torch.zeros_like(D_boundary), D_boundary))


def jordan_product(u: Tensor, v: Tensor) -> Tensor:
    """Per-cone Jordan product ``u o v = (u.v, u0 v1 + v0 u1)``."""
    scalar = torch.sum(u * v, dim=-1, keepdim=True)
    vector = u[..., :1] * v[..., 1:] + v[..., :1] * u[..., 1:]
    return torch.cat((scalar, vector), dim=-1)


def arrow_solve(u: Tensor, b: Tensor) -> Tensor:
    """Solves ``Arw(u) y = b`` per cone analytically."""
    d = det(u)
    d = torch.where(torch.abs(d) > _SAFE_FLOOR, d, torch.full_like(
        d, _SAFE_FLOOR))
    u0 = u[..., :1]
    u1 = u[..., 1:]
    y0 = (u0 * b[..., :1] - torch.sum(u1 * b[..., 1:], dim=-1,
                                      keepdim=True)) / d[..., None]
    y1 = (b[..., 1:] - y0 * u1) / u0
    return torch.cat((y0, y1), dim=-1)


def _reflect(u: Tensor) -> Tensor:
    """``R u`` with ``R = diag(1, -1, -1)``."""
    return torch.cat((u[..., :1], -u[..., 1:]), dim=-1)


class NTScaling(NamedTuple):
    """Matrix-free Nesterov-Todd scaling ``W u = eta (2 v (v.u) - R u)``
    with ``v`` the Jordan square root of the normalised scaling point."""
    v: Tensor        # (*, k, 3), det(v) = 1
    eta: Tensor      # (*, k)

    def apply(self, u: Tensor) -> Tensor:
        """``W u`` per cone."""
        vu = torch.sum(self.v * u, dim=-1, keepdim=True)
        return self.eta[..., None] * (2.0 * self.v * vu - _reflect(u))

    def apply_inverse(self, u: Tensor) -> Tensor:
        """``W^{-1} u`` per cone (``v^{-1} = R v`` for det-1 elements)."""
        v_inv = _reflect(self.v)
        vu = torch.sum(v_inv * u, dim=-1, keepdim=True)
        return (2.0 * v_inv * vu - _reflect(u)) / self.eta[..., None]


def nt_scaling(x: Tensor, z: Tensor) -> Tuple[NTScaling, Tensor]:
    """Per-cone NT scaling and the scaled point ``lam = W x``."""
    det_x = torch.clamp(det(x), min=_SAFE_FLOOR)
    det_z = torch.clamp(det(z), min=_SAFE_FLOOR)
    x_bar = x / torch.sqrt(det_x)[..., None]
    z_bar = z / torch.sqrt(det_z)[..., None]
    gamma = torch.sqrt(torch.clamp(
        0.5 * (1.0 + torch.sum(x_bar * z_bar, dim=-1)), min=1e-15))
    w_bar = (z_bar + _reflect(x_bar)) / (2.0 * gamma[..., None])
    e = torch.zeros_like(w_bar)
    e[..., 0] = 1.0
    v = (w_bar + e) / torch.sqrt(2.0 * (w_bar[..., :1] + 1.0))
    eta = (det_z / det_x) ** 0.25
    scaling = NTScaling(v=v, eta=eta)
    return scaling, scaling.apply(x)


def nt_w2_inverse_matrix(scaling: NTScaling, eps) -> Tensor:
    r"""Dense per-cone inverse of ``W^2 + eps I`` ``(*, k, 3, 3)``, with
    ``W^2 = eta^2 (2 \bar w \bar w^T - R)`` and ``\bar w = v o v``."""
    w_bar = jordan_product(scaling.v, scaling.v)
    eta2 = (scaling.eta ** 2)[..., None, None]
    wwT = w_bar[..., :, None] * w_bar[..., None, :]
    R = torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=w_bar.dtype,
                                device=w_bar.device))
    eye = torch.eye(3, dtype=w_bar.dtype, device=w_bar.device)
    return sym3_inverse(eta2 * (2.0 * wwT - R) + eps * eye)


def sym3_inverse(A: Tensor) -> Tensor:
    """Inverse of symmetric ``(*, 3, 3)`` matrices by the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e = A[..., 1, 1], A[..., 1, 2]
    f = A[..., 2, 2]
    co_a = d * f - e * e
    co_b = c * e - b * f
    co_c = b * e - c * d
    co_d = a * f - c * c
    co_e = b * c - a * e
    co_f = a * d - b * b
    det3 = a * co_a + b * co_b + c * co_c
    det3 = torch.where(torch.abs(det3) > _SAFE_FLOOR, det3,
                       torch.full_like(det3, _SAFE_FLOOR))
    adj = torch.stack((torch.stack((co_a, co_b, co_c), dim=-1),
                       torch.stack((co_b, co_d, co_e), dim=-1),
                       torch.stack((co_c, co_e, co_f), dim=-1)), dim=-2)
    return adj / det3[..., None, None]


def cone_matvec(A: Tensor, u: Tensor) -> Tensor:
    """Per-cone ``(*, k, 3, 3) @ (*, k, 3)``."""
    return torch.sum(A * u[..., None, :], dim=-1)


def step_to_boundary(u: Tensor, du: Tensor) -> Tensor:
    r"""Largest ``alpha`` in ``[0, 1]`` keeping ``u + alpha du`` in every
    cone, ``(*, k, 3) -> (*)``: the smallest nonnegative root of the det
    quadratic (roots at ~0 included: an iterate on the wall whose
    direction exits gets 0) and the scalar component's zero crossing."""
    A = det(du)
    B = 2.0 * torch.sum(u * _reflect(du), dim=-1)
    C = torch.clamp(det(u), min=0.0)
    disc = B * B - 4.0 * A * C
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    tiny = torch.full_like(A, _SAFE_FLOOR)
    two = torch.full_like(A, 2.0)
    safe_A = torch.where(torch.abs(A) > tiny, A, tiny)
    safe_B = torch.where(torch.abs(B) > tiny, B, tiny)
    r1 = (-B - sqrt_disc) / (2.0 * safe_A)
    r2 = (-B + sqrt_disc) / (2.0 * safe_A)
    lin = -C / safe_B
    is_linear = torch.abs(A) <= 1e-14 * torch.clamp(torch.abs(B), min=1.0)
    lin_crossing = is_linear & (B < 0.0)
    roots = torch.stack((
        torch.where(is_linear, torch.where(lin_crossing, lin, two), r1),
        torch.where(is_linear, two, r2)))
    valid = (roots >= -1e-12) & (disc >= 0.0)[None]
    pos = torch.where(valid, torch.clamp(roots, min=0.0), two[None])
    alpha_det = torch.amin(pos, dim=0)
    du0 = du[..., 0]
    alpha_scalar = torch.where(
        du0 < 0.0, torch.clamp(u[..., 0], min=0.0) /
        torch.where(du0 < 0.0, -du0, tiny), two)
    alpha = torch.minimum(alpha_det, alpha_scalar)
    return torch.clamp(torch.amin(alpha, dim=-1), max=1.0)
