r"""Rigid-body inertial reparameterizations (PyTorch).

Counterpart of the ``theta <-> pi_cm`` part of ``dair_pll_tpu/inertia.py``
and of its URDF strings (:func:`pi_cm_to_urdf`):
the smooth, unconstrained 10-DoF ``theta`` parameterization of Rucker &
Wensing ("Smooth Parameterization of Rigid-Body Inertia", RA-L 2020).

* ``theta``: unconstrained ``(*, 10)``; any real value maps to a
  physically valid inertia.
* ``pi_o``: ``[m, m*p, I_o(6)]`` with rotational inertia about the body
  origin; vector order ``[Ixx, Iyy, Izz, Ixy, Ixz, Iyz]``.
* ``pi_cm``: the same with inertia about the center of mass.

All conversions broadcast over leading batch dims.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import Tensor

from dair_pll_tpu_torch.ops.tensor import (skew_symmetric,
                                           symmetric_offdiagonal)


def parallel_axis_theorem(I_BBa_B: Tensor, m_B: Tensor, p_BaBb_B: Tensor,
                          Ba_is_Bcm: bool = True) -> Tensor:
    r"""Shifts rotational inertia between reference points (one must be
    the center of mass): :math:`I_R = I_C - m [d]^2`."""
    skew = skew_symmetric(p_BaBb_B)
    term = (skew @ skew) * m_B[..., None, None]
    return I_BBa_B - term if Ba_is_Bcm else I_BBa_B + term


def inertia_matrix_from_vector(I_vec: Tensor) -> Tensor:
    r"""``[Ixx, Iyy, Izz, Ixy, Ixz, Iyz]`` to a symmetric ``(*, 3, 3)``."""
    diags = I_vec[..., :3]
    diag_mat = diags[..., None] * torch.eye(3, dtype=I_vec.dtype,
                                            device=I_vec.device)
    # symmetric_offdiagonal places [a, b, c] at (yz, xz, xy); feed reversed.
    off = symmetric_offdiagonal(torch.flip(I_vec[..., 3:], dims=(-1,)))
    return diag_mat + off


def inertia_vector_from_matrix(I_mat: Tensor) -> Tensor:
    r"""Symmetric ``(*, 3, 3)`` to ``[Ixx, Iyy, Izz, Ixy, Ixz, Iyz]``."""
    return torch.stack((
        I_mat[..., 0, 0], I_mat[..., 1, 1], I_mat[..., 2, 2],
        I_mat[..., 0, 1], I_mat[..., 0, 2], I_mat[..., 1, 2]), dim=-1)


def theta_to_pi_o(theta: Tensor) -> Tensor:
    """``theta = [alpha, d1, d2, d3, s12, s23, s13, t1, t2, t3]`` to
    ``pi_o``."""
    alpha = theta[..., 0]
    d_1, d_2, d_3 = theta[..., 1], theta[..., 2], theta[..., 3]
    s_12, s_23, s_13 = theta[..., 4], theta[..., 5], theta[..., 6]
    t_1, t_2, t_3 = theta[..., 7], theta[..., 8], theta[..., 9]

    s_dot_s = s_12 * s_12 + s_23 * s_23 + s_13 * s_13
    t_dot_t = t_1 * t_1 + t_2 * t_2 + t_3 * t_3

    e1, e2, e3 = torch.exp(d_1), torch.exp(d_2), torch.exp(d_3)
    scaled = torch.stack((
        t_dot_t + 1.0,
        t_1 * e1,
        t_1 * s_12 + t_2 * e2,
        t_1 * s_13 + t_2 * s_23 + t_3 * e3,
        s_dot_s + e2 * e2 + e3 * e3,
        s_13 * s_13 + s_23 * s_23 + e1 * e1 + e3 * e3,
        s_12 * s_12 + e1 * e1 + e2 * e2,
        -s_12 * e1,
        -s_13 * e1,
        -s_12 * s_13 - s_23 * e2,
    ), dim=-1)
    return torch.exp(2.0 * alpha)[..., None] * scaled


def pi_o_to_theta(pi_o: Tensor) -> Tensor:
    """``pi_o`` to ``theta``: the hand-derived local inverse of
    :func:`theta_to_pi_o` for valid ``pi_o``."""
    ea_ed1 = torch.sqrt(0.5 * (pi_o[..., 5] + pi_o[..., 6] - pi_o[..., 4]))
    ea_s12 = -pi_o[..., 7] / ea_ed1
    ea_s13 = -pi_o[..., 8] / ea_ed1
    ea_ed2 = torch.sqrt(pi_o[..., 6] - ea_ed1 ** 2 - ea_s12 ** 2)
    ea_s23 = (-pi_o[..., 9] - ea_s12 * ea_s13) / ea_ed2
    ea_ed3 = torch.sqrt(
        pi_o[..., 5] - ea_ed1 ** 2 - ea_s13 ** 2 - ea_s23 ** 2)
    ea_t1 = pi_o[..., 1] / ea_ed1
    ea_t2 = (pi_o[..., 2] - ea_t1 * ea_s12) / ea_ed2
    ea_t3 = (pi_o[..., 3] - ea_t1 * ea_s13 - ea_t2 * ea_s23) / ea_ed3
    ea = torch.sqrt(pi_o[..., 0] - ea_t1 ** 2 - ea_t2 ** 2 - ea_t3 ** 2)

    alpha = torch.log(ea)
    d_vec = torch.log(torch.stack((ea_ed1, ea_ed2, ea_ed3), dim=-1) /
                      ea[..., None])
    s_and_t = torch.stack(
        (ea_s12, ea_s23, ea_s13, ea_t1, ea_t2, ea_t3), dim=-1) / ea[..., None]
    return torch.cat((alpha[..., None], d_vec, s_and_t), dim=-1)


def _shift_pi(pi: Tensor, to_cm: bool) -> Tensor:
    mass = pi[..., 0:1]
    p_BoBcm_B = pi[..., 1:4] / mass
    I_mat = inertia_matrix_from_vector(pi[..., 4:])
    shifted = parallel_axis_theorem(
        I_mat, mass[..., 0], p_BoBcm_B, Ba_is_Bcm=not to_cm)
    I_vec = inertia_vector_from_matrix(shifted)
    return torch.cat((mass, pi[..., 1:4], I_vec), dim=-1)


def pi_o_to_pi_cm(pi_o: Tensor) -> Tensor:
    """Shifts rotational inertia from the body origin to the CoM."""
    return _shift_pi(pi_o, to_cm=True)


def pi_cm_to_pi_o(pi_cm: Tensor) -> Tensor:
    """Shifts rotational inertia from the CoM to the body origin."""
    return _shift_pi(pi_cm, to_cm=False)


def theta_to_pi_cm(theta: Tensor) -> Tensor:
    """Chained :func:`theta_to_pi_o` and :func:`pi_o_to_pi_cm`."""
    return pi_o_to_pi_cm(theta_to_pi_o(theta))


def pi_cm_to_theta(pi_cm: Tensor) -> Tensor:
    """Chained :func:`pi_cm_to_pi_o` and :func:`pi_o_to_theta`."""
    return pi_o_to_theta(pi_cm_to_pi_o(pi_cm))


def pi_cm_to_urdf(pi_cm) -> Tuple[str, str, List[str]]:
    """One ``(10,)`` ``pi_cm`` vector (a tensor or an array) to URDF string
    pieces ``(mass, "px py pz", [six inertia strings])``."""
    pi_cm = np.asarray(torch.as_tensor(pi_cm).detach().cpu(),
                       dtype=np.float64)
    if pi_cm.shape != (10,):
        raise ValueError(f"pi_cm has shape {pi_cm.shape}, expected (10,)")
    mass = str(float(pi_cm[0]))
    com = " ".join(str(float(c / pi_cm[0])) for c in pi_cm[1:4])
    inertia = [str(float(v)) for v in pi_cm[4:]]
    return mass, com, inertia


INERTIA_SCALARS = ["I_xx", "I_yy", "I_zz", "I_xy", "I_xz", "I_yz"]
AXES = ["x", "y", "z"]


def pi_cm_to_scalars(pi_cm) -> Dict[str, float]:
    """One ``(10,)`` ``pi_cm`` vector to logging scalars: mass, centre of
    mass and inertia about it (reference ``inertia.py:444-458``)."""
    pi_cm = np.asarray(pi_cm, dtype=np.float64)
    mass = float(pi_cm[0])
    scalars = {"m": mass}
    for axis, value in zip(AXES, pi_cm[1:4]):
        scalars[f"com_{axis}"] = float(value) / mass
    for name, value in zip(INERTIA_SCALARS, pi_cm[4:]):
        scalars[name] = float(value)
    return scalars
