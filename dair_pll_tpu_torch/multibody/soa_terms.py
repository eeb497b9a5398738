r"""Batch-minor (SoA) multibody terms, fused forward dynamics and the fused
ContactNets loss (PyTorch).

Counterpart of ``dair_pll_tpu/multibody/soa_terms.py``: every per-sample
scalar is a ``(B,)`` tensor, all small-dimension structure unrolls in
Python (``ops/soa.py``). One rollout step runs forward kinematics, the mass
matrix, the Coriolis terms (a forward-mode JVP through the kinematics), the
witness-point contact terms (box, polygon, sphere or deep-support ICNN
against a plane), the warm-started hybrid cone solve (the CUDA kernel K5
of ``ops/soa_kernels.py`` for CUDA tensors) and the velocity update. The
ContactNets loss (:func:`soa_contactnets_loss`,
:func:`soa_contactnets_loss_warm`) runs the same terms at the observed next
state, a detached hybrid solve (K4 cold, K5 warm, for CUDA tensors) and the
loss assembly; its gradient comes from torch autograd through the terms
and the assembly. These loss functions are the plain versions that the
CUDA loss kernels of ``ops/soa_loss_kernels.py`` are held against, and the
training path on the card for models those kernels do not cover (ICNN
geometry).

Supported models (``supports_fused``): kinematic trees of free, revolute,
prismatic and fixed joints whose collision pairs are all plane-vs-convex.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch
from torch import Tensor

from dair_pll_tpu_torch.geometry import _UNIT_BOX_VERTICES
from dair_pll_tpu_torch.multibody.model import MultibodyModel, MultibodyParams
from dair_pll_tpu_torch.ops import icnn, soa, soa_solver
from dair_pll_tpu_torch.ops.soa import Smat, Svec
from dair_pll_tpu_torch.ops.soa_kernels import (
    pack_qp, solve_contact_impulse_soa_cuda, solve_warm_hybrid_soa_cuda,
    solve_warm_hybrid_soa_cuda_packed, unpack_qp)

GRAVITY_ACCELERATION = 9.81

_FUSED_JOINTS = ("free", "revolute", "prismatic", "fixed", "weld")
_FUSED_CONVEX = ("box", "polygon", "sphere", "deep_support_convex")


def supports_fused(model: MultibodyModel) -> bool:
    """Whether the fused SoA path covers this model."""
    for body in model.bodies:
        if body.joint.joint_type not in _FUSED_JOINTS:
            return False
    for (a, b) in model.collision_candidates:
        if model.geometries[a].geom_type != "plane":
            return False
        if model.geometries[b].geom_type not in _FUSED_CONVEX:
            return False
    return True


def has_deep_support(model: MultibodyModel) -> bool:
    """Whether a geometry of the model is a deep-support (ICNN) convex,
    which the JAX package's single-kernel loss leaves out."""
    return any(g.geom_type == "deep_support_convex" for g in model.geometries)


# -- derived scalar parameters ---------------------------------------------------
def derive_scalar_params(model: MultibodyModel, params: MultibodyParams):
    """The derived parameters the terms chain consumes: ``pi`` body
    inertial vectors (``pi_cm``), ``mu`` per-geometry friction
    magnitudes, ``geom`` per-geometry shapes with absolute values folded
    in (15 scalars for the cube; an ICNN geometry carries its network and
    perturbations whole)."""
    geom_derived = []
    for spec, gparams in zip(model.geometries, params.geometry):
        if spec.geom_type == "box":
            geom_derived.append(
                {"half": torch.abs(gparams["half_lengths"]).reshape(3)})
        elif spec.geom_type == "polygon":
            geom_derived.append({"verts": gparams["vertices"]})
        elif spec.geom_type == "sphere":
            geom_derived.append({"radius": torch.abs(gparams["radius"])})
        elif spec.geom_type == "deep_support_convex":
            # Not scalar: the network's weights, carried as they are.
            geom_derived.append({"icnn": gparams})
        else:
            geom_derived.append({})
    return {"pi": params.pi_cm(), "mu": torch.abs(params.friction),
            "geom": tuple(geom_derived)}


def scalarize_derived(model: MultibodyModel, derived) -> dict:
    """Indexes the derived parameters into nested Python lists of 0-d
    tensors (``sp["pi"][b][i]``, ``sp["mu"][g]``,
    ``sp["geom"][g]["half"][i]``...)."""
    sp_geom = []
    for spec, entry in zip(model.geometries, derived["geom"]):
        if spec.geom_type == "box":
            sp_geom.append({"half": [entry["half"][i] for i in range(3)]})
        elif spec.geom_type == "polygon":
            verts = entry["verts"]
            sp_geom.append({"verts": [
                [verts[i, j] for j in range(3)]
                for i in range(verts.shape[0])]})
        elif spec.geom_type == "sphere":
            sp_geom.append({"radius": entry["radius"]})
        elif spec.geom_type == "deep_support_convex":
            sp_geom.append({"icnn": entry["icnn"]})
        else:
            sp_geom.append({})
    pi = derived["pi"]
    return {
        "pi": [[pi[b, i] for i in range(10)]
               for b in range(model.n_bodies)],
        "mu": [derived["mu"][g] for g in range(len(model.geometries))],
        "geom": sp_geom,
    }


class SoaKinematics(NamedTuple):
    """Per-body world kinematics in SoA form."""
    R_WB: List[Smat]    # each (3, 3)
    p_WB: List[Svec]    # each (3,)
    Jw: List[Smat]      # each (3, n_v)
    Jv: List[Smat]      # each (3, n_v)


def _quat_to_rotmat(q: Svec) -> Smat:
    """wxyz unit quaternion -> rotation matrix."""
    w, x, y, z = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return [[1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
            [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
            [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)]]


def _const(value: float, like: Tensor) -> Tensor:
    return torch.full((), float(value), dtype=like.dtype, device=like.device)


def _const_mat(values, like: Tensor) -> Smat:
    """Static (numpy) matrix -> smat of 0-d constants."""
    arr = np.asarray(values)
    return [[_const(arr[i, j], like) for j in range(arr.shape[1])]
            for i in range(arr.shape[0])]


def _const_vec(values, like: Tensor) -> Svec:
    arr = np.asarray(values)
    return [_const(arr[i], like) for i in range(arr.shape[0])]


def _axis_angle_rotation(axis: Svec, angle: Tensor) -> Smat:
    """Rodrigues rotation about a constant unit axis."""
    s = torch.sin(angle)
    c = torch.cos(angle)
    one_c = 1.0 - c
    K = soa.skew(axis)
    out = []
    for i in range(3):
        row = []
        for j in range(3):
            ident = c if i == j else torch.zeros_like(c)
            row.append(ident + s * K[i][j] + one_c * axis[i] * axis[j])
        out.append(row)
    return out


def soa_body_kinematics(model: MultibodyModel, q: Svec) -> SoaKinematics:
    """World poses and angular/linear Jacobians of every body."""
    n_v = model.n_v
    like = q[0]

    R_list, p_list, Jw_list, Jv_list = [], [], [], []

    def parent_frame(parent: int):
        """Parent pose/Jacobians; the world frame for ``-1``."""
        if parent == -1:
            return (soa.eye(3, like), soa.zero_svec(3, like),
                    soa.zero_smat(3, n_v, like), soa.zero_smat(3, n_v, like))
        return (R_list[parent], p_list[parent], Jw_list[parent],
                Jv_list[parent])

    for index, body in enumerate(model.bodies):
        joint = body.joint
        q_off = model.body_q_offset(index)
        v_off = model.body_v_offset(index)

        if joint.joint_type == "free":
            R_WB = _quat_to_rotmat(q[q_off:q_off + 4])
            p_WB = q[q_off + 4:q_off + 7]
            Jw = soa.zero_smat(3, n_v, like)
            Jv = soa.zero_smat(3, n_v, like)
            for i in range(3):
                for j in range(3):
                    Jw[i][v_off + j] = R_WB[i][j]
                Jv[i][v_off + 3 + i] = torch.ones_like(like)
        elif joint.joint_type == "revolute":
            R_WP, p_WP, Jw_P, Jv_P = parent_frame(joint.parent)
            R_PJ = _const_mat(joint.R_PJ, like)
            p_PJ = _const_vec(joint.p_PJ, like)
            axis = _const_vec(joint.axis, like)

            R_WJ = soa.matmul(R_WP, R_PJ)
            p_WB = soa.vadd(p_WP, soa.matvec(R_WP, p_PJ))
            R_WB = soa.matmul(R_WJ, _axis_angle_rotation(axis, q[q_off]))

            axis_W = soa.matvec(R_WJ, axis)
            r = soa.vsub(p_WB, p_WP)
            Jw = [row[:] for row in Jw_P]
            for i in range(3):
                Jw[i][v_off] = Jw[i][v_off] + axis_W[i]
            Jv = soa.msub(Jv_P, soa.matmul(soa.skew(r), Jw_P))
        elif joint.joint_type == "prismatic":
            R_WP, p_WP, Jw_P, Jv_P = parent_frame(joint.parent)
            R_PJ = _const_mat(joint.R_PJ, like)
            p_PJ = _const_vec(joint.p_PJ, like)
            axis = _const_vec(joint.axis, like)

            R_WJ = soa.matmul(R_WP, R_PJ)
            axis_W = soa.matvec(R_WJ, axis)
            disp = q[q_off]
            offset = soa.matvec(R_WP, p_PJ)
            p_WB = [p_WP[i] + offset[i] + disp * axis_W[i] for i in range(3)]
            R_WB = R_WJ
            r = soa.vsub(p_WB, p_WP)
            Jw = Jw_P
            Jv = [row[:] for row in
                  soa.msub(Jv_P, soa.matmul(soa.skew(r), Jw_P))]
            for i in range(3):
                Jv[i][v_off] = Jv[i][v_off] + axis_W[i]
        elif joint.joint_type in ("fixed", "weld"):
            parent = joint.parent
            R_PJ = _const_mat(joint.R_PJ, like)
            p_PJ = _const_vec(joint.p_PJ, like)
            if parent == -1:
                R_WB = [[v.expand(like.shape) for v in row] for row in R_PJ]
                p_WB = [v.expand(like.shape) for v in p_PJ]
                Jw = soa.zero_smat(3, n_v, like)
                Jv = soa.zero_smat(3, n_v, like)
            else:
                R_WP = R_list[parent]
                p_WP = p_list[parent]
                R_WB = soa.matmul(R_WP, R_PJ)
                p_WB = soa.vadd(p_WP, soa.matvec(R_WP, p_PJ))
                r = soa.vsub(p_WB, p_WP)
                Jw = Jw_list[parent]
                Jv = soa.msub(Jv_list[parent],
                              soa.matmul(soa.skew(r), Jw_list[parent]))
        else:
            raise ValueError(f"unknown joint type {joint.joint_type}")

        R_list.append(R_WB)
        p_list.append(p_WB)
        Jw_list.append(Jw)
        Jv_list.append(Jv)
    return SoaKinematics(R_list, p_list, Jw_list, Jv_list)


def soa_configuration_rate(model: MultibodyModel, q: Svec,
                           v: Svec) -> Svec:
    """``qdot`` from ``(q, v)``: quaternion rate ``0.5 q (x) [0, w_B]``,
    base and joint rates copied."""
    qdot = [torch.zeros_like(leaf) for leaf in q]
    for index, body in enumerate(model.bodies):
        joint = body.joint
        q_off = model.body_q_offset(index)
        v_off = model.body_v_offset(index)
        if joint.joint_type == "free":
            qw, qx, qy, qz = q[q_off:q_off + 4]
            wx, wy, wz = v[v_off:v_off + 3]
            qdot[q_off] = 0.5 * (-qx * wx - qy * wy - qz * wz)
            qdot[q_off + 1] = 0.5 * (qw * wx + qy * wz - qz * wy)
            qdot[q_off + 2] = 0.5 * (qw * wy + qz * wx - qx * wz)
            qdot[q_off + 3] = 0.5 * (qw * wz + qx * wy - qy * wx)
            for i in range(3):
                qdot[q_off + 4 + i] = v[v_off + 3 + i]
        elif joint.joint_type in ("revolute", "prismatic"):
            qdot[q_off] = v[v_off]
    return qdot


# -- geometry -----------------------------------------------------------------
def soa_geometry_kinematics(model: MultibodyModel, kin: SoaKinematics,
                            like: Tensor
                            ) -> Tuple[List[Smat], List[Svec],
                                       List[Smat], List[Smat]]:
    """World poses and Jacobians of every collision geometry frame."""
    n_v = model.n_v
    R_out, p_out, Jw_out, Jv_out = [], [], [], []
    for geom in model.geometries:
        R_BG = _const_mat(geom.R_BG, like)
        p_BG = _const_vec(geom.p_BG, like)
        if geom.body == -1:
            R_out.append(R_BG)
            p_out.append(p_BG)
            Jw_out.append(soa.zero_smat(3, n_v, like))
            Jv_out.append(soa.zero_smat(3, n_v, like))
            continue
        R_WB = kin.R_WB[geom.body]
        p_WB = kin.p_WB[geom.body]
        offset_W = soa.matvec(R_WB, p_BG)
        R_out.append(soa.matmul(R_WB, R_BG))
        p_out.append(soa.vadd(p_WB, offset_W))
        Jw_out.append(kin.Jw[geom.body])
        Jv_out.append(soa.msub(
            kin.Jv[geom.body],
            soa.matmul(soa.skew(offset_W), kin.Jw[geom.body])))
    return R_out, p_out, Jw_out, Jv_out


def _soa_vertices(spec, geom_entry) -> List[Svec]:
    """Vertex set as 3-vectors of 0-d leaves (absolute values already
    folded into the derived entry)."""
    if spec.geom_type == "box":
        half = geom_entry["half"]
        return [[float(s) * half[i] for i, s in enumerate(signs)]
                for signs in _UNIT_BOX_VERTICES]
    if spec.geom_type == "polygon":
        return [list(row) for row in geom_entry["verts"]]
    raise ValueError(f"no vertex set for {spec.geom_type}")


def _soa_support_points(spec, geom_entry, direction: Svec) -> List[Svec]:
    """Witness points for one support direction: the top ``n_query``
    vertices by support value, through the same compare-exchange network
    as the JAX package (its tie order picks the witnesses). Deep-support
    (ICNN) witnesses are the support points of the perturbed, normalised
    directions, evaluated batch-major, ``(B n_query, 3)`` through the
    width-``W`` layers, and split back into SoA leaves."""
    if spec.geom_type == "sphere":
        radius = geom_entry["radius"]
        return [[direction[i] * radius for i in range(3)]]
    if spec.geom_type == "deep_support_convex":
        params = geom_entry["icnn"]
        d_major = torch.stack(torch.broadcast_tensors(*direction),
                              dim=-1)                          # (B, 3)
        perturbed = d_major[:, None, :] + params["perturbations"][None]
        perturbed = perturbed / torch.sqrt(torch.sum(
            perturbed * perturbed, dim=-1, keepdim=True))      # (B, n_q, 3)
        points = icnn.icnn_support_points(
            params["icnn"], perturbed.reshape(-1, 3),
            spec.icnn_negative_slope).reshape(perturbed.shape)
        return [[points[:, c, i] for i in range(3)]
                for c in range(spec.n_query)]
    vertices = _soa_vertices(spec, geom_entry)
    dots = [soa.dot(vert, direction) for vert in vertices]
    payloads = [[vert[i] for vert in vertices] for i in range(3)]
    _, sorted_payloads = soa.sort_with_payload(dots, payloads,
                                               descending=True)
    return [[sorted_payloads[i][c] for i in range(3)]
            for c in range(spec.n_query)]


def _soa_collide_plane_convex(spec_b, params_b, R_AB: Smat,
                              p_AoBo_A: Svec
                              ) -> Tuple[List[Tensor], List[Svec],
                                         List[Svec]]:
    """Plane (frame A) vs convex B: per contact ``(phi, p_AoAc_A,
    p_BoBc_B)``; the contact frame is A's axes."""
    # Support direction on B: -z axis of A, in B coordinates = -R_AB[2, :].
    direction_b = [-R_AB[2][i] for i in range(3)]
    witnesses_B = _soa_support_points(spec_b, params_b, direction_b)
    phi_list, p_A_list = [], []
    for w_B in witnesses_B:
        w_A = soa.vadd(soa.matvec(R_AB, w_B), p_AoBo_A)
        phi_list.append(w_A[2])
        p_A_list.append([w_A[0], w_A[1], torch.zeros_like(w_A[2])])
    return phi_list, p_A_list, witnesses_B


def soa_contact_terms(model: MultibodyModel, sp: dict,
                      kin: SoaKinematics, like: Tensor
                      ) -> Tuple[Tensor, List[List[Tensor]]]:
    """Signed distances and the cone-major contact Jacobian
    ``[J_n; mu J_t]``.

    Returns:
        phi: ``(k, B)`` signed distances.
        Jc: ``(3, n_v)`` nested list of ``(k, B)`` leaves, component rows
        ordered ``[normal, mu t_x, mu t_y]``.
    """
    n_v = model.n_v
    mu_all = sp["mu"]
    R_WG, p_WG, Jw_G, Jv_G = soa_geometry_kinematics(model, kin, like)

    phi_pairs: List[Tensor] = []
    Jc_pairs: List[List[List[Tensor]]] = []
    for (a, b) in model.collision_candidates:
        spec_b = model.geometries[b]
        R_WA, p_WA = R_WG[a], p_WG[a]
        R_WB, p_WB = R_WG[b], p_WG[b]

        R_AB = soa.matmul_t(R_WA, R_WB)
        p_AoBo_A = soa.matvec_t(R_WA, soa.vsub(p_WB, p_WA))

        phi_i, p_AoAc_A, p_BoBc_B = _soa_collide_plane_convex(
            spec_b, sp["geom"][b], R_AB, p_AoBo_A)

        mu_a, mu_b = mu_all[a], mu_all[b]
        mu_pair = (2.0 * mu_a * mu_b) / (mu_a + mu_b)

        # This pair's witnesses stacked along a leading contact axis.
        pa = [soa.stack_contacts([p[i].expand(like.shape)
                                  for p in p_AoAc_A]) for i in range(3)]
        pb = [soa.stack_contacts([p[i].expand(like.shape)
                                  for p in p_BoBc_B]) for i in range(3)]

        # World-frame witness offsets, (n_c, B) per component.
        off_A = [sum(R_WA[i][j] * pa[j] for j in range(3))
                 for i in range(3)]
        off_B = [sum(R_WB[i][j] * pb[j] for j in range(3))
                 for i in range(3)]

        # J_rel = (J_Bc - J_Ac) with J_*c = Jv - skew(off) Jw; rows
        # [t_x, t_y, n] in the contact frame via R_WA^T.
        dJv = soa.msub(Jv_G[b], Jv_G[a])
        J_rel_W: List[List[Tensor]] = [[None] * n_v for _ in range(3)]
        for v in range(n_v):
            sB0 = off_B[1] * Jw_G[b][2][v] - off_B[2] * Jw_G[b][1][v]
            sB1 = off_B[2] * Jw_G[b][0][v] - off_B[0] * Jw_G[b][2][v]
            sB2 = off_B[0] * Jw_G[b][1][v] - off_B[1] * Jw_G[b][0][v]
            sA0 = off_A[1] * Jw_G[a][2][v] - off_A[2] * Jw_G[a][1][v]
            sA1 = off_A[2] * Jw_G[a][0][v] - off_A[0] * Jw_G[a][2][v]
            sA2 = off_A[0] * Jw_G[a][1][v] - off_A[1] * Jw_G[a][0][v]
            J_rel_W[0][v] = dJv[0][v] - sB0 + sA0
            J_rel_W[1][v] = dJv[1][v] - sB1 + sA1
            J_rel_W[2][v] = dJv[2][v] - sB2 + sA2

        Jc_pair: List[List[Tensor]] = [[None] * n_v for _ in range(3)]
        for v in range(n_v):
            t_x = sum(R_WA[j][0] * J_rel_W[j][v] for j in range(3))
            t_y = sum(R_WA[j][1] * J_rel_W[j][v] for j in range(3))
            n_r = sum(R_WA[j][2] * J_rel_W[j][v] for j in range(3))
            Jc_pair[0][v] = n_r
            Jc_pair[1][v] = mu_pair * t_x
            Jc_pair[2][v] = mu_pair * t_y

        phi_pairs.append(soa.stack_contacts(
            [p.expand(like.shape) for p in phi_i]))
        Jc_pairs.append(Jc_pair)

    phi = torch.cat(phi_pairs, dim=0)
    if len(Jc_pairs) == 1:
        Jc = Jc_pairs[0]
    else:
        Jc = [[torch.cat([Jp[i][v] for Jp in Jc_pairs], dim=0)
               for v in range(n_v)] for i in range(3)]
    return phi, Jc


# -- Lagrangian terms -----------------------------------------------------------
def soa_lagrangian_terms(model: MultibodyModel, pi: List[List[Tensor]],
                         kin: SoaKinematics, kin_dot: SoaKinematics,
                         v: Svec, u: Svec) -> Tuple[Smat, Svec]:
    """Mass matrix ``M`` and non-contact generalized force ``F``
    (gravity, Coriolis/centrifugal bias, actuation) from the body
    kinematics and their time derivatives.

    Args:
        pi: per-body ``pi_cm`` vectors as nested 0-d lists
          (:func:`scalarize_derived`).
    """
    like = v[0]
    n_v = model.n_v
    M: Smat = soa.zero_smat(n_v, n_v, like)
    F: Svec = soa.zero_svec(n_v, like)
    g_W = [torch.zeros_like(like), torch.zeros_like(like),
           _const(-GRAVITY_ACCELERATION, like)]

    for b in range(model.n_bodies):
        mass = pi[b][0]
        c_B = [pi[b][1 + i] / mass for i in range(3)]
        I_vec = pi[b][4:]
        # [Ixx, Iyy, Izz, Ixy, Ixz, Iyz] -> symmetric 3x3.
        I_cm_B = [[I_vec[0], I_vec[3], I_vec[4]],
                  [I_vec[3], I_vec[1], I_vec[5]],
                  [I_vec[4], I_vec[5], I_vec[2]]]

        R = kin.R_WB[b]
        R_dot = kin_dot.R_WB[b]
        c_W = soa.matvec(R, c_B)
        c_W_dot = soa.matvec(R_dot, c_B)
        Jw, Jw_dot = kin.Jw[b], kin_dot.Jw[b]
        J_cm = soa.msub(kin.Jv[b], soa.matmul(soa.skew(c_W), Jw))
        J_cm_dot = soa.msub(
            soa.msub(kin_dot.Jv[b],
                     soa.matmul(soa.skew(c_W_dot), Jw)),
            soa.matmul(soa.skew(c_W), Jw_dot))

        omega = soa.matvec(Jw, v)
        omega_dot_bias = soa.matvec(Jw_dot, v)
        a_cm_bias = soa.matvec(J_cm_dot, v)

        I_cm_W = soa.matmul(soa.matmul(R, I_cm_B), soa.transpose(R))

        for i in range(n_v):
            for j in range(i + 1):
                acc = M[i][j]
                for a in range(3):
                    acc = acc + mass * J_cm[a][i] * J_cm[a][j]
                for x in range(3):
                    for y in range(3):
                        acc = acc + Jw[x][i] * I_cm_W[x][y] * Jw[y][j]
                M[i][j] = acc

        I_omega = soa.matvec(I_cm_W, omega)
        torque_bias = soa.vadd(soa.matvec(I_cm_W, omega_dot_bias),
                               soa.cross3(omega, I_omega))
        force_bias = [mass * a for a in a_cm_bias]
        for i in range(n_v):
            cor = torch.zeros_like(like)
            grav = torch.zeros_like(like)
            for a in range(3):
                cor = cor + Jw[a][i] * torque_bias[a] + \
                    J_cm[a][i] * force_bias[a]
                grav = grav + J_cm[a][i] * mass * g_W[a]
            F[i] = F[i] + grav - cor

    # Symmetrize M from the lower triangle.
    for i in range(n_v):
        for j in range(i + 1, n_v):
            M[i][j] = M[j][i]

    if model.n_u > 0:
        u_index = 0
        for body_index, body in enumerate(model.bodies):
            if body.joint.joint_type in ("revolute", "prismatic") and \
                    body.joint.actuated:
                v_off = model.body_v_offset(body_index)
                F[v_off] = F[v_off] + u[u_index]
                u_index += 1
    return M, F


def soa_multibody_terms_scalar(model: MultibodyModel, sp: dict, q: Svec,
                               v: Svec, u: Svec
                               ) -> Tuple[Smat, List[List[Tensor]], Tensor,
                                          Svec]:
    """SoA terms from scalarized derived parameters; see
    :func:`soa_multibody_terms`. The kinematics' time derivatives come
    from a forward-mode JVP along ``qdot``, which also runs under
    ``torch.no_grad``."""
    qdot = soa_configuration_rate(model, q, v)
    kin, kin_dot = torch.func.jvp(
        lambda q_inner: soa_body_kinematics(model, q_inner), (q,), (qdot,))

    M, F = soa_lagrangian_terms(model, sp["pi"], kin, kin_dot, v, u)
    phi, Jc = soa_contact_terms(model, sp, kin, q[0])
    a_nc = soa.spd_solve(M, F)
    return M, Jc, phi, a_nc


def soa_multibody_terms(model: MultibodyModel, params: MultibodyParams,
                        q: Svec, v: Svec, u: Svec
                        ) -> Tuple[Smat, List[List[Tensor]], Tensor, Svec]:
    """Shared-kinematics multibody terms, matrix-free (no dense Delassus
    operator).

    Returns:
        M: ``(n_v, n_v)`` smat mass matrix of ``(B,)`` leaves.
        Jc: cone-major contact Jacobian, ``(3, n_v)`` nested list of
          ``(k, B)`` leaves.
        phi: ``(k, B)`` signed distances.
        a_nc: ``(n_v,)`` svec contact-free acceleration.
    """
    sp = scalarize_derived(model, derive_scalar_params(model, params))
    return soa_multibody_terms_scalar(model, sp, q, v, u)


# -- fused forward dynamics (rollouts) ----------------------------------------
def soa_rollout_qp(model: MultibodyModel, params: MultibodyParams,
                   x: Tensor, dt: float):
    """The contact QP of one zero-control rollout step at ``x (B, n_x)``,
    in the solve kernel's packed layout: returns ``(m (n_v*n_v, B),
    jc (3, n_v, k, B), qc (3, k, B), phi (k, B), v_minus)`` with
    ``qc = J v^- + [phi/dt; 0]`` and ``v^- = v + dt a_nc`` an svec."""
    n_q = model.n_q
    n_v = model.n_v
    xT = x.T.contiguous()
    q = soa.unstack(xT[:n_q])
    v = soa.unstack(xT[n_q:n_q + n_v])
    # Zero-control rollouts; actuated models still need the leaves.
    u_soa: List[Tensor] = [torch.zeros_like(v[0])
                           for _ in range(model.n_u)]

    M, Jc, phi, a_nc = soa_multibody_terms(model, params, q, v, u_soa)
    v_minus = [v[i] + dt * a_nc[i] for i in range(n_v)]
    jv = soa_solver.j_dot(Jc, v_minus)
    m, jc, qc = pack_qp(M, Jc, [jv[0] + phi / dt, jv[1], jv[2]])
    return m, jc, qc, phi, v_minus


def soa_forward_dynamics_batch(model: MultibodyModel,
                               params: MultibodyParams, x: Tensor,
                               w0: Tensor, dt: float,
                               dynamics_epsilon: float,
                               contact_filter_eps: float,
                               ipm_iterations: int,
                               newton_iterations: int
                               ) -> Tuple[Tensor, Tensor]:
    """Fused batched Anitescu forward dynamics: ``(B, n_x) -> (B, n_v)``.

    Terms, the warm-started hybrid solve (short IPM phase, then
    exact-line-search Newton from the better of the carried and IPM
    starts), the contact activation filter and the velocity update, all
    in SoA form. The solve runs through
    :func:`~dair_pll_tpu_torch.ops.soa_kernels.solve_warm_hybrid_soa_cuda_packed`:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    Args:
        x: ``(B, n_x)`` states.
        w0: ``(B, n_v)`` carried warm-start primals (zeros to cold-start).

    Returns:
        ``(v_plus (B, n_v), w (B, n_v))``; ``w`` is a transposed view,
        so carrying it into the next step copies nothing.
    """
    n_v = model.n_v
    m, jc, qc, phi, v_minus = soa_rollout_qp(model, params, x, dt)
    force, w, _ = solve_warm_hybrid_soa_cuda_packed(
        m, jc, qc, w0.T.contiguous(), float(dynamics_epsilon),
        ipm_iterations, newton_iterations)

    # Contact activation filter (inactive at physical scales). Failure
    # masking happens inside the solve.
    gamma = torch.where(phi <= contact_filter_eps, force, 0.0).unbind(0)

    # J^T gamma with one reduction a row: no kernel repeats this update,
    # so it need not fold the contacts in order as soa_solver.jt_dot does.
    M, Jc = unpack_qp(m, jc)
    dv = soa.spd_solve(M, [torch.sum(Jc[0][v] * gamma[0] + Jc[1][v] * gamma[1]
                                     + Jc[2][v] * gamma[2], dim=0)
                           for v in range(n_v)])
    v_plus = torch.stack([v_minus[i] + dv[i] for i in range(n_v)], dim=-1)
    return v_plus, w.T


# -- ContactNets loss -------------------------------------------------------------
def soa_loss_parts(model: MultibodyModel, sp: dict, v: Svec, q_plus: Svec,
                   v_plus: Svec, u_soa: Svec, dt: float):
    """Everything before the cone solve: terms at the observed next state
    and the ContactNets QP pieces.

    Returns:
        ``(M, Jc, phi, qc, dv)``: mass smat, cone-major Jacobian, signed
        distances ``(k, B)``, QP linear cone field, velocity residual.
    """
    n_v = model.n_v
    M, Jc, phi, a_nc = soa_multibody_terms_scalar(model, sp, q_plus, v_plus,
                                                  u_soa)

    # q_vec = q_pred + q_comp + q_diss, assembled as a cone field.
    dv = [v_plus[i] - (v[i] + a_nc[i] * dt) for i in range(n_v)]
    j_dv = soa_solver.j_dot(Jc, dv)
    j_vplus = soa_solver.j_dot(Jc, v_plus)

    s1, s2 = j_vplus[1], j_vplus[2]            # (k, B) sliding velocities
    sliding_sq = s1 * s1 + s2 * s2
    # Safe norm at exactly resting contacts (value exact, gradient 0).
    at_rest = sliding_sq < 1e-24
    sliding_speed = torch.sqrt(torch.where(at_rest, 1.0, sliding_sq))
    sliding_speed = torch.where(at_rest, 0.0, sliding_speed)
    qc = [-j_dv[0] + torch.abs(phi) + dt * sliding_speed,
          -j_dv[1] + dt * s1,
          -j_dv[2] + dt * s2]
    return M, Jc, phi, qc, dv


def soa_loss_assemble(M: Smat, Jc, phi: Tensor, qc, dv: Svec, force,
                      valid: Tensor, eps: float) -> Tensor:
    """Loss ``(B,)`` given the (detached) solve result: ``0.5 f'(D + eps I)
    f + f'q + 0.5 dv'M dv + sum max(-phi, 0)^2`` with ``f'D f`` computed
    matrix-free as ``(J'f)' M^{-1} (J'f)``; 0 where the solve failed."""
    jtf = soa_solver.jt_dot(Jc, force)
    minv_jtf = soa.spd_solve(M, jtf)
    f_sq = soa.sum_rows(force[0] ** 2 + force[1] ** 2 + force[2] ** 2)
    f_dot_q = soa.sum_rows(force[0] * qc[0] + force[1] * qc[1] +
                           force[2] * qc[2])
    quad = soa.dot(jtf, minv_jtf) + eps * f_sq

    penetration = soa.sum_rows(torch.clamp_min(-phi, 0.0) ** 2)
    constant = 0.5 * soa.dot(dv, soa.matvec(M, dv)) + penetration

    loss = 0.5 * quad + f_dot_q + constant
    return torch.where(valid, loss, 0.0)


def _loss_inputs(model: MultibodyModel, params: MultibodyParams, x: Tensor,
                 u: Tensor, x_plus: Tensor):
    """``(sp, v, q_plus, v_plus, u_soa)`` from ``(B, n_x)`` states."""
    n_q, n_v = model.n_q, model.n_v
    xT = x.T
    xpT = x_plus.T
    v = soa.unstack(xT[n_q:n_q + n_v])
    q_plus = soa.unstack(xpT[:n_q])
    v_plus = soa.unstack(xpT[n_q:n_q + n_v])
    u_soa = soa.unstack(u.T) if model.n_u > 0 else []
    sp = scalarize_derived(model, derive_scalar_params(model, params))
    return sp, v, q_plus, v_plus, u_soa


def soa_contactnets_loss(model: MultibodyModel, params: MultibodyParams,
                         x: Tensor, u: Tensor, x_plus: Tensor, dt: float,
                         loss_epsilon: float, ipm_iterations: int,
                         newton_iterations: int
                         ) -> Tuple[Tensor, List[Tensor], Tensor]:
    """Fused batched ContactNets loss: ``(B, n_x) -> (B,)``.

    Terms at the observed next state, the detached cold hybrid solve (the
    gradient flows only through the terms and the assembly at the solved
    impulse: the envelope theorem), then the loss assembly. The solve runs
    through :func:`~dair_pll_tpu_torch.ops.soa_kernels.
    solve_contact_impulse_soa_cuda`: the CUDA kernel K4 for CUDA tensors,
    its plain version for CPU tensors. Returns
    ``(loss (B,), force cone field, valid (B,))``; ``force`` is detached,
    so a caller can seed an impulse cache for
    :func:`soa_contactnets_loss_warm` with it (the JAX function returns
    the loss alone).
    """
    sp, v, q_plus, v_plus, u_soa = _loss_inputs(model, params, x, u, x_plus)
    M, Jc, phi, qc, dv = soa_loss_parts(model, sp, v, q_plus, v_plus, u_soa,
                                        dt)
    with torch.no_grad():
        force, valid = solve_contact_impulse_soa_cuda(
            M, Jc, qc, loss_epsilon, ipm_iterations, newton_iterations)
    loss = soa_loss_assemble(M, Jc, phi, qc, dv, force, valid, loss_epsilon)
    return loss, force, valid


def soa_contactnets_loss_warm(model: MultibodyModel,
                              params: MultibodyParams, x: Tensor, u: Tensor,
                              x_plus: Tensor, dt: float, loss_epsilon: float,
                              ipm_iterations: int, newton_iterations: int,
                              force_prev: List[Tensor]
                              ) -> Tuple[Tensor, List[Tensor], Tensor]:
    """Epoch-warm-started fused ContactNets loss.

    Like :func:`soa_contactnets_loss`, but the detached hybrid solve
    warm-starts from the impulses the same samples solved to on a previous
    visit: the carried primal is ``w = M^{-1} J^T f_prev`` at the current
    parameters, and SAP-Newton starts from the better (by primal cost) of
    that and a short ``ipm_iterations`` central path
    (:func:`~dair_pll_tpu_torch.ops.soa_solver.solve_warm_hybrid_soa`),
    through :func:`~dair_pll_tpu_torch.ops.soa_kernels.
    solve_warm_hybrid_soa_cuda`: the CUDA kernel K5 for CUDA tensors, its
    plain version for CPU tensors. ``force_prev`` is a cone field of
    ``(k, B)`` leaves (zeros for cold samples). Returns ``(loss (B,),
    force cone field, valid (B,))``; ``force`` is detached.
    """
    sp, v, q_plus, v_plus, u_soa = _loss_inputs(model, params, x, u, x_plus)
    M, Jc, phi, qc, dv = soa_loss_parts(model, sp, v, q_plus, v_plus, u_soa,
                                        dt)
    with torch.no_grad():
        w_carry = soa.spd_solve(M, soa_solver.jt_dot(Jc, force_prev))
        force, _, valid = solve_warm_hybrid_soa_cuda(
            M, Jc, qc, w_carry, loss_epsilon, ipm_iterations,
            newton_iterations)
    loss = soa_loss_assemble(M, Jc, phi, qc, dv, force, valid, loss_epsilon)
    return loss, force, valid
