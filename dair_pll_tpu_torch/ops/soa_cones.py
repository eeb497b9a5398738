r"""Batch-minor (SoA) Lorentz-cone primitives in PyTorch.

Counterpart of ``dair_pll_tpu/ops/soa_cones.py``: a cone point is a
3-list ``[n, t1, t2]`` of batched leaves (``(B,)`` or ``(k, B)``), and
every operator is the same branchless math in the same order.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import Tensor

from dair_pll_tpu_torch.ops import soa
from dair_pll_tpu_torch.ops.soa import Smat, Svec

Cone = Svec          # [n, t1, t2]
Cones = List[Svec]   # k cones

_SAFE_FLOOR = 1e-30


def det(u: Cone) -> Tensor:
    return u[0] * u[0] - u[1] * u[1] - u[2] * u[2]


def reflect(u: Cone) -> Cone:
    return [u[0], -u[1], -u[2]]


def _norm_and_regions(n: Tensor, t1: Tensor, t2: Tensor):
    """Shared ``(1/|t|, |t|, in_cone, in_polar)`` of a cone argument; one
    rsqrt replaces a sqrt and a divide."""
    sq = torch.clamp_min(t1 * t1 + t2 * t2, _SAFE_FLOOR)
    s_inv = torch.rsqrt(sq)
    s = sq * s_inv
    return s_inv, s, s <= n, s <= -n


def project(u: Cone) -> Cone:
    """Euclidean projection onto one Lorentz cone (branchless)."""
    n, t1, t2 = u
    s_inv, s, in_cone, in_polar = _norm_and_regions(n, t1, t2)
    h = 0.5 * (n + s)
    coeff = torch.where(in_cone, 1.0, torch.where(in_polar, 0.0, h * s_inv))
    n_out = torch.where(in_cone, n, torch.where(in_polar, 0.0, h))
    return [n_out, coeff * t1, coeff * t2]


def project_and_jacobian_apply(z: Cone, u: Cone) -> Tuple[Cone, Cone]:
    """Fused ``(P(z), D(z) u)``: one norm/rsqrt/region-mask computation
    shared between the projection and its Jacobian apply."""
    n, t1, t2 = z
    s_inv, s, in_cone, in_polar = _norm_and_regions(n, t1, t2)
    h = 0.5 * (n + s)
    hos = h * s_inv
    coeff = torch.where(in_cone, 1.0, torch.where(in_polar, 0.0, hos))
    gamma = [torch.where(in_cone, n, torch.where(in_polar, 0.0, h)),
             coeff * t1, coeff * t2]

    h1, h2 = t1 * s_inv, t2 * s_inv
    u0, u1, u2 = u
    hd = h1 * u1 + h2 * u2
    b0 = 0.5 * (u0 + hd)
    b1 = 0.5 * u0 * h1 + hos * (u1 - h1 * hd) + 0.5 * h1 * hd
    b2 = 0.5 * u0 * h2 + hos * (u2 - h2 * hd) + 0.5 * h2 * hd
    du = [torch.where(in_cone, u0, torch.where(in_polar, 0.0, b0)),
          torch.where(in_cone, u1, torch.where(in_polar, 0.0, b1)),
          torch.where(in_cone, u2, torch.where(in_polar, 0.0, b2))]
    return gamma, du


def projection_jacobian_apply(z: Cone, u: Cone) -> Cone:
    """``D(z) u`` matrix-free."""
    return project_and_jacobian_apply(z, u)[1]


def project_and_jacobian_matrix(z: Cone) -> Tuple[Cone, Smat]:
    """Fused ``(P(z), D(z))`` with ``D`` a dense 3x3 ``smat``."""
    n, t1, t2 = z
    s_inv, s, in_cone, in_polar = _norm_and_regions(n, t1, t2)
    h1, h2 = t1 * s_inv, t2 * s_inv
    h = 0.5 * (n + s)
    hos = h * s_inv

    coeff = torch.where(in_cone, 1.0, torch.where(in_polar, 0.0, hos))
    gamma = [torch.where(in_cone, n, torch.where(in_polar, 0.0, h)),
             coeff * t1, coeff * t2]

    half = torch.full_like(n, 0.5)
    # boundary blocks: [[1/2, h/2], [h/2, hos (I - hh^T) + hh^T / 2]]
    b = [[half, 0.5 * h1, 0.5 * h2],
         [0.5 * h1, hos * (1.0 - h1 * h1) + 0.5 * h1 * h1,
          (0.5 - hos) * h1 * h2],
         [0.5 * h2, (0.5 - hos) * h1 * h2,
          hos * (1.0 - h2 * h2) + 0.5 * h2 * h2]]
    out = []
    for i in range(3):
        row = []
        for j in range(3):
            row.append(torch.where(in_cone, 1.0 if i == j else 0.0,
                                   torch.where(in_polar, 0.0, b[i][j])))
        out.append(row)
    return gamma, out


def projection_jacobian_matrix(z: Cone) -> Smat:
    """Dense per-cone projection Jacobian as a 3x3 ``smat``."""
    return project_and_jacobian_matrix(z)[1]


def jordan_product(u: Cone, v: Cone) -> Cone:
    return [u[0] * v[0] + u[1] * v[1] + u[2] * v[2],
            u[0] * v[1] + v[0] * u[1],
            u[0] * v[2] + v[0] * u[2]]


def arrow_solve(u: Cone, b: Cone) -> Cone:
    d = det(u)
    d = torch.where(torch.abs(d) > _SAFE_FLOOR, d, _SAFE_FLOOR)
    u0_inv = 1.0 / u[0]
    y0 = (u[0] * b[0] - u[1] * b[1] - u[2] * b[2]) / d
    y1 = (b[1] - y0 * u[1]) * u0_inv
    y2 = (b[2] - y0 * u[2]) * u0_inv
    return [y0, y1, y2]


class NTScaling:
    """Matrix-free NT scaling: per-cone ``v`` (det-1 Jordan square root),
    ``eta``, and its reciprocal (so the inverse apply is division-free)."""

    __slots__ = ("v", "eta", "eta_inv")

    def __init__(self, v: Cone, eta: Tensor, eta_inv: Tensor = None):
        self.v = v
        self.eta = eta
        self.eta_inv = 1.0 / eta if eta_inv is None else eta_inv

    def apply(self, u: Cone) -> Cone:
        vu = soa.dot(self.v, u)
        ru = reflect(u)
        return [self.eta * (2.0 * self.v[i] * vu - ru[i]) for i in range(3)]

    def apply_inverse(self, u: Cone) -> Cone:
        v_inv = reflect(self.v)
        vu = soa.dot(v_inv, u)
        ru = reflect(u)
        return [(2.0 * v_inv[i] * vu - ru[i]) * self.eta_inv
                for i in range(3)]


def nt_scaling(x: Cone, z: Cone) -> Tuple[NTScaling, Cone]:
    """NT scaling and scaled point ``lam = W x`` in rsqrt form:
    ``eta = (det_z/det_x)^{1/4}`` is ``sqrt(sqrt(det_z) * rsqrt(det_x))``
    with ``sqrt(det_z) = det_z * rsqrt(det_z)``."""
    det_x = torch.clamp_min(det(x), _SAFE_FLOOR)
    det_z = torch.clamp_min(det(z), _SAFE_FLOOR)
    sx = torch.rsqrt(det_x)
    sz = torch.rsqrt(det_z)
    x_bar = [x[i] * sx for i in range(3)]
    z_bar = [z[i] * sz for i in range(3)]
    gamma2 = torch.clamp_min(0.5 * (1.0 + soa.dot(x_bar, z_bar)), 1e-15)
    rx = reflect(x_bar)
    inv_2g = 0.5 * torch.rsqrt(gamma2)
    w_bar = [(z_bar[i] + rx[i]) * inv_2g for i in range(3)]
    denom = torch.rsqrt(2.0 * (w_bar[0] + 1.0))
    v = [(w_bar[0] + 1.0) * denom, w_bar[1] * denom, w_bar[2] * denom]
    eta2 = (det_z * sz) * sx
    eta = torch.sqrt(eta2)
    eta_inv = torch.rsqrt(eta2)
    scaling = NTScaling(v, eta, eta_inv)
    return scaling, scaling.apply(x)


def nt_w2_inverse(scaling: NTScaling, eps) -> Smat:
    """3x3 ``smat`` inverse of ``W^2 + eps I``."""
    w_bar = jordan_product(scaling.v, scaling.v)
    eta2 = scaling.eta * scaling.eta
    # A = eta^2 (2 w w^T - R) + eps I, R = diag(1, -1, -1)
    a01 = eta2 * 2.0 * w_bar[0] * w_bar[1]
    a02 = eta2 * 2.0 * w_bar[0] * w_bar[2]
    a12 = eta2 * 2.0 * w_bar[1] * w_bar[2]
    A = [[eta2 * (2.0 * w_bar[0] * w_bar[0] - 1.0) + eps, a01, a02],
         [a01, eta2 * (2.0 * w_bar[1] * w_bar[1] + 1.0) + eps, a12],
         [a02, a12, eta2 * (2.0 * w_bar[2] * w_bar[2] + 1.0) + eps]]
    return soa.sym3_inverse(A)


def step_to_boundary_one(u: Cone, du: Cone) -> Tensor:
    """Largest step in ``[0, ~]`` keeping ``u + alpha du`` in one cone
    (branchless root selection; values >= 0, capped by the caller)."""
    A = det(du)
    # 2 <u, R du> with R = diag(1, -1, -1)
    B = 2.0 * (u[0] * du[0] - u[1] * du[1] - u[2] * du[2])
    C = torch.clamp_min(det(u), 0.0)

    disc = B * B - 4.0 * A * C
    sqrt_disc = torch.sqrt(torch.clamp_min(disc, 0.0))
    tiny = _SAFE_FLOOR
    safe_A = torch.where(torch.abs(A) > tiny, A, tiny)
    safe_B = torch.where(torch.abs(B) > tiny, B, tiny)
    inv_2a = 0.5 / safe_A
    r1 = (-B - sqrt_disc) * inv_2a
    r2 = (-B + sqrt_disc) * inv_2a
    lin = -C / safe_B
    is_linear = torch.abs(A) <= 1e-14 * torch.clamp_min(torch.abs(B), 1.0)
    lin_crossing = is_linear & (B < 0.0)
    root1 = torch.where(is_linear, torch.where(lin_crossing, lin, 2.0), r1)
    root2 = torch.where(is_linear, 2.0, r2)
    disc_ok = disc >= 0.0
    pos1 = torch.where((root1 >= -1e-12) & disc_ok,
                       torch.clamp_min(root1, 0.0), 2.0)
    pos2 = torch.where((root2 >= -1e-12) & disc_ok,
                       torch.clamp_min(root2, 0.0), 2.0)
    alpha_det = torch.minimum(pos1, pos2)

    du0 = du[0]
    alpha_scalar = torch.where(
        du0 < 0.0,
        torch.clamp_min(u[0], 0.0) / torch.where(du0 < 0.0, -du0, tiny), 2.0)
    return torch.minimum(alpha_det, alpha_scalar)


def step_to_boundary(us: Cones, dus: Cones) -> Tensor:
    """Min over cones, capped at 1."""
    alpha = step_to_boundary_one(us[0], dus[0])
    for u, du in zip(us[1:], dus[1:]):
        alpha = torch.minimum(alpha, step_to_boundary_one(u, du))
    return torch.clamp_max(alpha, 1.0)
