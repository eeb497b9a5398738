r"""Contact terms and combined multibody dynamics terms (PyTorch).

Counterpart of ``dair_pll_tpu/multibody/terms.py``, batched over the
leading dimensions of ``q``: signed distances ``phi(q)``, the contact
Jacobian ``J(q)`` in ``[J_n; mu J_t]`` ordering, the Delassus operator
``D = J M^{-1} J^T`` and the contact-free acceleration.

With ``k`` contact points the stacked impulse is ``[n_1 .. n_k, t_1x t_1y
.. t_kx t_ky]``; the friction coefficient is folded into the tangential
rows, so the feasible set is the product of unit Lorentz cones.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from dair_pll_tpu_torch import geometry as geometry_mod
from dair_pll_tpu_torch.multibody.dynamics import (
    lagrangian_terms_from_kinematics)
from dair_pll_tpu_torch.multibody.kinematics import (body_kinematics,
                                                     configuration_rate,
                                                     geometry_kinematics)
from dair_pll_tpu_torch.ops.linear import (cho_solve_unrolled,
                                           cholesky_unrolled)
from dair_pll_tpu_torch.ops.tensor import (skew_symmetric, small_matmul,
                                           small_matvec)


def contact_terms(model, params, q: Tensor) -> Tuple[Tensor, Tensor]:
    """Signed distances ``phi (*, k)`` and contact Jacobian
    ``J (*, 3k, n_v)`` of every collision candidate at ``q``."""
    kin = body_kinematics(model, q)
    return _assemble_contact_terms(model, params,
                                   *geometry_kinematics(model, kin, q))


def _assemble_contact_terms(model, params, R_WG, p_WG, Jw_G,
                            Jv_G) -> Tuple[Tensor, Tensor]:
    """Collision sweep and Jacobian assembly from geometry kinematics."""
    mu_all = torch.abs(params.friction)
    phi_list, jac_rows, mu_list = [], [], []
    for a, b in model.collision_candidates:
        R_WA, p_WA = R_WG[..., a, :, :], p_WG[..., a, :]
        R_WB, p_WB = R_WG[..., b, :, :], p_WG[..., b, :]
        R_AW = R_WA.transpose(-1, -2)
        R_AB = small_matmul(R_AW, R_WB)
        p_AoBo_A = small_matvec(R_AW, p_WB - p_WA)

        phi_i, R_AC, p_AoAc_A, p_BoBc_B = geometry_mod.collide(
            model.geometries[a], params.geometry[a], model.geometries[b],
            params.geometry[b], R_AB, p_AoBo_A)

        # Contact frames in world coordinates, (*, n_c, 3, 3).
        R_WF = small_matmul(R_WA[..., None, :, :], R_AC)
        # Witness-point velocity Jacobians: body-origin Jacobians shifted
        # to the contact points.
        off_A_W = small_matvec(R_WA[..., None, :, :], p_AoAc_A)
        off_B_W = small_matvec(R_WB[..., None, :, :], p_BoBc_B)
        J_Ac = Jv_G[..., a, None, :, :] - small_matmul(
            skew_symmetric(off_A_W), Jw_G[..., a, None, :, :])
        J_Bc = Jv_G[..., b, None, :, :] - small_matmul(
            skew_symmetric(off_B_W), Jw_G[..., b, None, :, :])
        # Relative contact-point velocity in the contact frame, rows
        # [t_x, t_y, n].
        J_rel_F = small_matmul(R_WF.transpose(-1, -2), J_Bc - J_Ac)

        mu_a, mu_b = mu_all[a], mu_all[b]
        mu_pair = (2.0 * mu_a * mu_b) / (mu_a + mu_b)
        phi_list.append(phi_i)
        jac_rows.append(J_rel_F)
        mu_list.append(mu_pair.expand(phi_i.shape[-1]))

    phi = torch.cat(phi_list, dim=-1)                        # (*, k)
    J_rel = torch.cat(jac_rows, dim=-3)                      # (*, k, 3, n_v)
    mu = torch.cat(mu_list, dim=-1)                          # (k,)
    J_n = J_rel[..., 2, :]
    J_t = (mu[:, None, None] * J_rel[..., :2, :]).reshape(
        J_rel.shape[:-3] + (-1, J_rel.shape[-1]))
    return phi, torch.cat((J_n, J_t), dim=-2)


def multibody_terms(model, params, q: Tensor, v: Tensor, u: Tensor
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """All dynamics terms at a state: ``(D, M, J, phi, a_nc)``.

    Forward kinematics and its time derivative (a forward-mode JVP along
    ``dq/dt``) are computed once and shared by the Lagrangian and the
    contact terms.

    Args:
        q: ``(*, n_q)``; v: ``(*, n_v)``; u: ``(*, n_u)``.

    Returns:
        delassus ``(*, 3k, 3k)``, M ``(*, n_v, n_v)``, J ``(*, 3k, n_v)``,
        phi ``(*, k)``, a_nc ``(*, n_v)``.
    """
    qdot = configuration_rate(model, q, v)
    kin, kin_dot = torch.func.jvp(
        lambda q_inner: body_kinematics(model, q_inner), (q,), (qdot,))
    M, F = lagrangian_terms_from_kinematics(model, params.pi_cm(), kin,
                                            kin_dot, v, u)
    phi, J = _assemble_contact_terms(model, params,
                                     *geometry_kinematics(model, kin, q))
    L = cholesky_unrolled(M)
    Minv_JT = cho_solve_unrolled(L, J.transpose(-1, -2))      # (*, n_v, 3k)
    delassus = small_matmul(J, Minv_JT)
    a_nc = cho_solve_unrolled(L, F)
    return delassus, M, J, phi, a_nc
