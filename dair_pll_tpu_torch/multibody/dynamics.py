r"""Lagrangian (non-contact) dynamics terms: mass matrix, Coriolis,
gravity (PyTorch).

Counterpart of ``dair_pll_tpu/multibody/dynamics.py``, batched over
leading dimensions of ``q`` and ``v``:

* the mass matrix sums :math:`J_{cm,b}^T m_b J_{cm,b} + J_{\omega,b}^T
  I_{cm,b}^W J_{\omega,b}` over bodies;
* the Coriolis/centrifugal bias :math:`\dot J v` is the forward-mode JVP
  of the kinematics along ``dq/dt`` (``torch.func.jvp``, which also runs
  under ``torch.no_grad`` and inside reverse-mode autograd);
* gravity acts at each body's center of mass.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from dair_pll_tpu_torch import inertia as inertia_mod
from dair_pll_tpu_torch.multibody.kinematics import (body_kinematics,
                                                     configuration_rate)
from dair_pll_tpu_torch.ops.linear import spd_solve
from dair_pll_tpu_torch.ops.tensor import (skew_symmetric, small_matmul,
                                           small_matvec)

GRAVITY_ACCELERATION = 9.81


def _cm_jacobians(model, pi_cm: Tensor, q: Tensor):
    """World-frame angular and center-of-mass Jacobians ``(*, n_b, 3,
    n_v)`` and the body rotations."""
    kin = body_kinematics(model, q)
    c_B = pi_cm[:, 1:4] / pi_cm[:, 0, None]
    c_W = small_matvec(kin.R_WB, c_B)
    J_cm = kin.Jv - small_matmul(skew_symmetric(c_W), kin.Jw)
    return kin.Jw, J_cm, kin.R_WB


def _mass_matrix(mass: Tensor, I_cm_W: Tensor, Jw: Tensor,
                 J_cm: Tensor) -> Tensor:
    return (torch.einsum("b,...bai,...baj->...ij", mass, J_cm, J_cm) +
            torch.einsum("...bxi,...bxy,...byj->...ij", Jw, I_cm_W, Jw))


def _actuation(model, u: Tensor, like: Tensor) -> Tensor:
    """Generalized force of the actuated joints, ``(*, n_v)``."""
    actuation = torch.zeros_like(like)
    if model.n_u > 0:
        u_index = 0
        columns = []
        for body_index, body in enumerate(model.bodies):
            if body.joint.joint_type in ("revolute", "prismatic") and \
                    body.joint.actuated:
                columns.append((model.body_v_offset(body_index), u_index))
                u_index += 1
        for v_off, u_i in columns:
            one_hot = torch.zeros(model.n_v, dtype=like.dtype,
                                  device=like.device)
            one_hot[v_off] = 1.0
            actuation = actuation + u[..., u_i, None] * one_hot
    return actuation


def _gravity_and_bias(mass, I_cm_W, Jw, J_cm, omega, omega_dot_bias,
                      a_cm_bias) -> Tuple[Tensor, Tensor]:
    """Generalized gravity and Coriolis/centrifugal bias forces."""
    I_omega = small_matvec(I_cm_W, omega)
    torque_bias = (small_matvec(I_cm_W, omega_dot_bias) +
                   torch.linalg.cross(omega, I_omega, dim=-1))
    force_bias = mass[:, None] * a_cm_bias
    coriolis = (torch.einsum("...bai,...ba->...i", Jw, torque_bias) +
                torch.einsum("...bai,...ba->...i", J_cm, force_bias))
    g_W = torch.tensor([0.0, 0.0, -GRAVITY_ACCELERATION],
                       dtype=J_cm.dtype, device=J_cm.device)
    gravity = torch.einsum("...bai,b,a->...i", J_cm, mass, g_W)
    return gravity, coriolis


def mass_matrix(model, pi_cm: Tensor, q: Tensor) -> Tensor:
    """Generalized mass matrix ``M(q)``: ``(*, n_v, n_v)``."""
    Jw, J_cm, R_WB = _cm_jacobians(model, pi_cm, q)
    I_cm_B = inertia_mod.inertia_matrix_from_vector(pi_cm[:, 4:])
    I_cm_W = R_WB @ I_cm_B @ R_WB.transpose(-1, -2)
    return _mass_matrix(pi_cm[:, 0], I_cm_W, Jw, J_cm)


def lagrangian_terms(model, pi_cm: Tensor, q: Tensor, v: Tensor,
                     u: Tensor) -> Tuple[Tensor, Tensor]:
    r"""Mass matrix ``(*, n_v, n_v)`` and generalized non-contact force
    ``F`` ``(*, n_v)`` (gravity, actuation and the negated Coriolis bias),
    with ``M dv/dt = F`` off contact."""
    mass = pi_cm[:, 0]
    I_cm_B = inertia_mod.inertia_matrix_from_vector(pi_cm[:, 4:])

    def velocities(q_inner: Tensor):
        Jw, J_cm, R_WB = _cm_jacobians(model, pi_cm, q_inner)
        return (small_matvec(Jw, v[..., None, :]),
                small_matvec(J_cm, v[..., None, :]), Jw, J_cm, R_WB)

    qdot = configuration_rate(model, q, v)
    (omega, _, Jw, J_cm, R_WB), (omega_dot_bias, a_cm_bias, _, _, _) = \
        torch.func.jvp(velocities, (q,), (qdot,))
    I_cm_W = R_WB @ I_cm_B @ R_WB.transpose(-1, -2)
    M = _mass_matrix(mass, I_cm_W, Jw, J_cm)
    gravity, coriolis = _gravity_and_bias(
        mass, I_cm_W, Jw, J_cm, omega, omega_dot_bias, a_cm_bias)
    return M, gravity + _actuation(model, u, v) - coriolis


def lagrangian_terms_from_kinematics(model, pi_cm: Tensor, kin, kin_dot,
                                     v: Tensor, u: Tensor
                                     ) -> Tuple[Tensor, Tensor]:
    """``(M, F)`` as :func:`lagrangian_terms`, from the body kinematics
    and their time derivative along ``dq/dt`` (shared with the contact
    terms by ``terms.multibody_terms``)."""
    mass = pi_cm[:, 0]
    c_B = pi_cm[:, 1:4] / mass[:, None]
    I_cm_B = inertia_mod.inertia_matrix_from_vector(pi_cm[:, 4:])

    c_W = small_matvec(kin.R_WB, c_B)
    c_W_dot = small_matvec(kin_dot.R_WB, c_B)
    Jw, Jw_dot = kin.Jw, kin_dot.Jw
    J_cm = kin.Jv - small_matmul(skew_symmetric(c_W), Jw)
    J_cm_dot = (kin_dot.Jv - small_matmul(skew_symmetric(c_W_dot), Jw) -
                small_matmul(skew_symmetric(c_W), Jw_dot))

    v_b = v[..., None, :]
    omega = small_matvec(Jw, v_b)
    omega_dot_bias = small_matvec(Jw_dot, v_b)
    a_cm_bias = small_matvec(J_cm_dot, v_b)

    I_cm_W = small_matmul(small_matmul(kin.R_WB, I_cm_B),
                          kin.R_WB.transpose(-1, -2))
    M = _mass_matrix(mass, I_cm_W, Jw, J_cm)
    gravity, coriolis = _gravity_and_bias(
        mass, I_cm_W, Jw, J_cm, omega, omega_dot_bias, a_cm_bias)
    return M, gravity + _actuation(model, u, v) - coriolis


def non_contact_acceleration(model, pi_cm: Tensor, q: Tensor, v: Tensor,
                             u: Tensor) -> Tuple[Tensor, Tensor]:
    """Mass matrix and contact-free acceleration ``M^{-1} F``."""
    M, F = lagrangian_terms(model, pi_cm, q, v, u)
    return M, spd_solve(M, F)
