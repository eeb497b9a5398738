r"""Forward kinematics and body Jacobians over a kinematic tree (PyTorch).

Counterpart of ``dair_pll_tpu/multibody/kinematics.py``, with the batch
written out: every function takes configurations ``(*, n_q)`` and returns
stacked tensors with the same leading dimensions. The body loop unrolls
in Python over the (small, static) body list.

Velocity convention: for each floating model the generalized velocity is
``[omega_B (body frame, 3), v_W (world frame, 3), joint rates]``; the
Jacobians map it to world-frame quantities:

* ``Jw[b] @ v = omega_WB_W``, the world-frame angular velocity of body b;
* ``Jv[b] @ v = v_WBo_W``, the world-frame velocity of body b's origin.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import Tensor

from dair_pll_tpu_torch.ops import quaternion
from dair_pll_tpu_torch.ops.tensor import (skew_symmetric, small_matmul,
                                           small_matvec)


class BodyKinematics(NamedTuple):
    """Stacked world-frame kinematics of all bodies.

    Attributes:
        R_WB: ``(*, n_bodies, 3, 3)`` body rotations.
        p_WB: ``(*, n_bodies, 3)`` body origins.
        Jw: ``(*, n_bodies, 3, n_v)`` angular velocity Jacobians.
        Jv: ``(*, n_bodies, 3, n_v)`` origin velocity Jacobians.
    """
    R_WB: Tensor
    p_WB: Tensor
    Jw: Tensor
    Jv: Tensor


def _const(value, like: Tensor) -> Tensor:
    return torch.as_tensor(np.asarray(value, dtype=np.float64),
                           dtype=like.dtype, device=like.device)


def _columns(block: Tensor, offset: int, n_v: int) -> Tensor:
    """``(*, 3, c)`` placed at columns ``offset:offset + c`` of a zero
    ``(*, 3, n_v)``."""
    c = block.shape[-1]
    shape = block.shape[:-1]
    return torch.cat((block.new_zeros(shape + (offset,)), block,
                      block.new_zeros(shape + (n_v - offset - c,))), dim=-1)


def _axis_angle_rotation(axis: Tensor, angle: Tensor) -> Tensor:
    """Rodrigues rotation about a fixed unit ``axis`` ``(3,)`` by
    ``angle`` ``(*,)``."""
    skew = skew_symmetric(axis)
    eye = torch.eye(3, dtype=angle.dtype, device=angle.device)
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    outer = axis[:, None] * axis[None, :]
    return c * eye + s * skew + (1.0 - c) * outer


def body_kinematics(model, q: Tensor) -> BodyKinematics:
    """World pose and velocity Jacobians of every body at ``q``
    ``(*, n_q)``."""
    n_v = model.n_v
    batch = q.shape[:-1]
    zeros_jac = q.new_zeros(batch + (3, n_v))
    R_list, p_list, Jw_list, Jv_list = [], [], [], []

    def parent_frame(parent: int):
        if parent == -1:
            return (torch.eye(3, dtype=q.dtype, device=q.device).expand(
                batch + (3, 3)), q.new_zeros(batch + (3,)), zeros_jac,
                zeros_jac)
        return (R_list[parent], p_list[parent], Jw_list[parent],
                Jv_list[parent])

    for index, body in enumerate(model.bodies):
        joint = body.joint
        q_off = model.body_q_offset(index)
        v_off = model.body_v_offset(index)

        if joint.joint_type == "free":
            R_WB = quaternion.to_rotation_matrix(q[..., q_off:q_off + 4])
            p_WB = q[..., q_off + 4:q_off + 7]
            Jw = _columns(R_WB, v_off, n_v)
            Jv = _columns(torch.eye(3, dtype=q.dtype, device=q.device)
                          .expand(batch + (3, 3)), v_off + 3, n_v)
        elif joint.joint_type == "revolute":
            R_WP, p_WP, Jw_P, Jv_P = parent_frame(joint.parent)
            R_PJ = _const(joint.R_PJ, q)
            p_PJ = _const(joint.p_PJ, q)
            axis = _const(joint.axis, q)
            R_WJ = small_matmul(R_WP, R_PJ)
            p_WB = p_WP + small_matvec(R_WP, p_PJ)
            R_WB = small_matmul(R_WJ, _axis_angle_rotation(axis,
                                                           q[..., q_off]))
            axis_W = small_matvec(R_WJ, axis)
            r = p_WB - p_WP
            Jw = Jw_P + _columns(axis_W[..., None], v_off, n_v)
            Jv = Jv_P - small_matmul(skew_symmetric(r), Jw_P)
        elif joint.joint_type == "prismatic":
            R_WP, p_WP, Jw_P, Jv_P = parent_frame(joint.parent)
            R_PJ = _const(joint.R_PJ, q)
            p_PJ = _const(joint.p_PJ, q)
            axis = _const(joint.axis, q)
            R_WJ = small_matmul(R_WP, R_PJ)
            axis_W = small_matvec(R_WJ, axis)
            p_WB = p_WP + small_matvec(R_WP, p_PJ) + \
                q[..., q_off, None] * axis_W
            R_WB = R_WJ
            r = p_WB - p_WP
            Jw = Jw_P
            Jv = (Jv_P - small_matmul(skew_symmetric(r), Jw_P)) + \
                _columns(axis_W[..., None], v_off, n_v)
        elif joint.joint_type in ("fixed", "weld"):
            R_PJ = _const(joint.R_PJ, q)
            p_PJ = _const(joint.p_PJ, q)
            if joint.parent == -1:
                R_WB = R_PJ.expand(batch + (3, 3))
                p_WB = p_PJ.expand(batch + (3,))
                Jw = Jv = zeros_jac
            else:
                R_WP, p_WP, Jw_P, Jv_P = parent_frame(joint.parent)
                R_WB = small_matmul(R_WP, R_PJ)
                p_WB = p_WP + small_matvec(R_WP, p_PJ)
                r = p_WB - p_WP
                Jw = Jw_P
                Jv = Jv_P - small_matmul(skew_symmetric(r), Jw_P)
        else:
            raise ValueError(f"unknown joint type {joint.joint_type}")
        R_list.append(R_WB)
        p_list.append(p_WB)
        Jw_list.append(Jw)
        Jv_list.append(Jv)

    return BodyKinematics(R_WB=torch.stack(R_list, dim=-3),
                          p_WB=torch.stack(p_list, dim=-2),
                          Jw=torch.stack(Jw_list, dim=-3),
                          Jv=torch.stack(Jv_list, dim=-3))


def configuration_rate(model, q: Tensor, v: Tensor) -> Tensor:
    r"""``dq/dt`` ``(*, n_q)``: the quaternion rate
    :math:`\tfrac12 q \otimes [0, \omega_B]`; base position and joint
    coordinates differentiate directly."""
    pieces = []
    for index, body in enumerate(model.bodies):
        joint = body.joint
        q_off = model.body_q_offset(index)
        v_off = model.body_v_offset(index)
        if joint.joint_type == "free":
            omega_quat = torch.cat((v.new_zeros(v.shape[:-1] + (1,)),
                                    v[..., v_off:v_off + 3]), dim=-1)
            pieces.append(0.5 * quaternion.multiply(q[..., q_off:q_off + 4],
                                                    omega_quat))
            pieces.append(v[..., v_off + 3:v_off + 6])
        elif joint.joint_type in ("revolute", "prismatic"):
            pieces.append(v[..., v_off:v_off + 1])
    if not pieces:
        return torch.zeros_like(q)
    return torch.cat(pieces, dim=-1)


def geometry_kinematics(model, kin: BodyKinematics, q: Tensor
                        ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """World-frame pose and Jacobians of every collision geometry:
    ``R_WG (*, n_g, 3, 3)``, ``p_WG (*, n_g, 3)``, ``Jw_G`` and ``Jv_G``
    ``(*, n_g, 3, n_v)``. World-attached geometries have their spec's pose
    and zero Jacobians."""
    n_v = model.n_v
    batch = q.shape[:-1]
    R_out, p_out, Jw_out, Jv_out = [], [], [], []
    for geom in model.geometries:
        R_BG = _const(geom.R_BG, q)
        p_BG = _const(geom.p_BG, q)
        if geom.body == -1:
            R_out.append(R_BG.expand(batch + (3, 3)))
            p_out.append(p_BG.expand(batch + (3,)))
            Jw_out.append(q.new_zeros(batch + (3, n_v)))
            Jv_out.append(q.new_zeros(batch + (3, n_v)))
            continue
        R_WB = kin.R_WB[..., geom.body, :, :]
        Jw = kin.Jw[..., geom.body, :, :]
        offset_W = small_matvec(R_WB, p_BG)
        R_out.append(small_matmul(R_WB, R_BG))
        p_out.append(kin.p_WB[..., geom.body, :] + offset_W)
        Jw_out.append(Jw)
        Jv_out.append(kin.Jv[..., geom.body, :, :] -
                      small_matmul(skew_symmetric(offset_W), Jw))
    return (torch.stack(R_out, dim=-3), torch.stack(p_out, dim=-2),
            torch.stack(Jw_out, dim=-3), torch.stack(Jv_out, dim=-3))
