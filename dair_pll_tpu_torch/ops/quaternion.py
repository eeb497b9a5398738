r"""Quaternion-based :math:`SO(3)` operations (PyTorch).

Counterpart of ``dair_pll_tpu/ops/quaternion.py``: branchless batched
quaternion algebra with the "double-where" trick at the singular points.
Quaternions are scalar-first ``[w, x, y, z]``.
"""
from __future__ import annotations

import torch
from torch import Tensor

__all__ = [
    "inverse",
    "multiply",
    "rotate",
    "sinc",
    "log",
    "exp",
    "to_rotation_matrix",
    "from_rotation_matrix",
    "normalize",
]

_EPS_BY_DTYPE = {
    torch.float32: 1e-7,
    torch.float64: 1e-14,
}


def _eps(x: Tensor) -> float:
    return _EPS_BY_DTYPE.get(x.dtype, 1e-7)


def normalize(q: Tensor) -> Tensor:
    """``(*, 4)`` quaternions to unit norm."""
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def inverse(q: Tensor) -> Tensor:
    """Quaternion inverse (conjugate for unit quaternions)."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def multiply(q: Tensor, r: Tensor) -> Tensor:
    r"""Hamilton product ``q * r`` of ``(*, 4)`` batches."""
    q_w, q_xyz = q[..., :1], q[..., 1:]
    r_w, r_xyz = r[..., :1], r[..., 1:]
    qr_w = q_w * r_w - torch.sum(q_xyz * r_xyz, dim=-1, keepdim=True)
    qr_xyz = q_w * r_xyz + r_w * q_xyz + torch.linalg.cross(q_xyz, r_xyz)
    return torch.cat((qr_w, qr_xyz), dim=-1)


def rotate(q: Tensor, p: Tensor) -> Tensor:
    r"""Rotates ``(*, 3)`` vectors ``p`` by ``(*, 4)`` quaternions ``q``."""
    q_w, q_xyz = q[..., :1], q[..., 1:]
    c1 = torch.linalg.cross(q_xyz, p)
    c2 = torch.linalg.cross(q_xyz, c1)
    dot = torch.sum(q_xyz * p, dim=-1, keepdim=True)
    return q_xyz * dot + q_w * (2.0 * c1 + q_w * p) + c2


def sinc(x: Tensor) -> Tensor:
    r"""Unnormalized, branchless :math:`\sin(x)/x` with ``sinc(0) = 1``."""
    small = torch.abs(x) < _eps(x)
    x_safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(x_safe) / x_safe)


def log(q: Tensor) -> Tensor:
    r"""Quaternion to rotation vector: for
    :math:`q = [\cos(\theta/2), \hat u \sin(\theta/2)]` returns
    :math:`\theta \hat u` (limit 2 of :math:`\theta/\sin(\theta/2)` at the
    identity)."""
    cos_half = q[..., 0:1]
    q_xyz = q[..., 1:]
    eps = _eps(q)
    sin_sq = torch.sum(q_xyz * q_xyz, dim=-1, keepdim=True)
    small = sin_sq < eps * eps
    sin_half = torch.sqrt(torch.where(small, torch.ones_like(sin_sq), sin_sq))
    sin_half = torch.where(small, torch.zeros_like(sin_half), sin_half)
    theta = 2.0 * torch.atan2(sin_half, cos_half)
    sin_safe = torch.where(small, torch.ones_like(sin_half), sin_half)
    mul = torch.where(small, torch.full_like(sin_half, 2.0),
                      theta / sin_safe)
    return q_xyz * mul


def exp(r: Tensor) -> Tensor:
    r"""Rotation vector :math:`\theta\hat u` to quaternion
    :math:`[\cos(\theta/2), \hat u\sin(\theta/2)]`."""
    sq = torch.sum(r * r, dim=-1, keepdim=True)
    eps = _eps(r)
    small = sq < eps * eps
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    angle = torch.where(small, torch.zeros_like(angle), angle)
    return torch.cat(
        (torch.cos(angle / 2.0), r * sinc(angle / 2.0) / 2.0), dim=-1)


def to_rotation_matrix(q: Tensor) -> Tensor:
    """``(*, 4)`` unit quaternions to ``(*, 3, 3)`` rotation matrices."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack(
        (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)), dim=-1)
    row1 = torch.stack(
        (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)), dim=-1)
    row2 = torch.stack(
        (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)), dim=-1)
    return torch.stack((row0, row1, row2), dim=-2)


def from_rotation_matrix(R: Tensor) -> Tensor:
    """``(*, 3, 3)`` rotation matrices to unit quaternions with a
    non-negative scalar part (branchless Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    eps = _eps(R)

    def _safe_sqrt(v):
        return torch.sqrt(torch.clamp_min(v, eps))

    qw = torch.stack((
        _safe_sqrt(1.0 + tr),
        (m21 - m12) / _safe_sqrt(1.0 + m00 - m11 - m22),
        (m02 - m20) / _safe_sqrt(1.0 - m00 + m11 - m22),
        (m10 - m01) / _safe_sqrt(1.0 - m00 - m11 + m22),
    ), dim=-1)
    qx = torch.stack((
        (m21 - m12) / _safe_sqrt(1.0 + tr),
        _safe_sqrt(1.0 + m00 - m11 - m22),
        (m01 + m10) / _safe_sqrt(1.0 - m00 + m11 - m22),
        (m02 + m20) / _safe_sqrt(1.0 - m00 - m11 + m22),
    ), dim=-1)
    qy = torch.stack((
        (m02 - m20) / _safe_sqrt(1.0 + tr),
        (m01 + m10) / _safe_sqrt(1.0 + m00 - m11 - m22),
        _safe_sqrt(1.0 - m00 + m11 - m22),
        (m12 + m21) / _safe_sqrt(1.0 - m00 - m11 + m22),
    ), dim=-1)
    qz = torch.stack((
        (m10 - m01) / _safe_sqrt(1.0 + tr),
        (m02 + m20) / _safe_sqrt(1.0 + m00 - m11 - m22),
        (m12 + m21) / _safe_sqrt(1.0 - m00 + m11 - m22),
        _safe_sqrt(1.0 - m00 - m11 + m22),
    ), dim=-1)

    scores = torch.stack(
        (tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22), dim=-1)
    best = torch.argmax(scores, dim=-1, keepdim=True)
    q = 0.5 * torch.stack((
        torch.gather(qw, -1, best)[..., 0],
        torch.gather(qx, -1, best)[..., 0],
        torch.gather(qy, -1, best)[..., 0],
        torch.gather(qz, -1, best)[..., 0],
    ), dim=-1)
    q = normalize(q)
    sign = torch.where(q[..., 0:1] < 0.0, -1.0, 1.0)
    return q * sign
