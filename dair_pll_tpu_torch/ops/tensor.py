r"""Batched tensor utilities for multibody dynamics (PyTorch).

Counterparts of the functions of ``dair_pll_tpu/ops/tensor.py`` that the
inertia and geometry modules call.
"""
from __future__ import annotations

import torch
from torch import Tensor

__all__ = [
    "skew_symmetric",
    "symmetric_offdiagonal",
    "rotation_matrix_from_one_vector",
]


def skew_symmetric(vectors: Tensor) -> Tensor:
    r"""``(*, 3)`` vectors to ``(*, 3, 3)`` cross-product matrices:
    ``S(v) @ p == v x p``."""
    x, y, z = vectors[..., 0], vectors[..., 1], vectors[..., 2]
    zero = torch.zeros_like(x)
    row0 = torch.stack((zero, -z, y), dim=-1)
    row1 = torch.stack((z, zero, -x), dim=-1)
    row2 = torch.stack((-y, x, zero), dim=-1)
    return torch.stack((row0, row1, row2), dim=-2)


def symmetric_offdiagonal(vectors: Tensor) -> Tensor:
    r"""``(*, 3)`` vectors ``[a, b, c]`` to symmetric zero-diagonal
    matrices ``[[0, c, b], [c, 0, a], [b, a, 0]]``."""
    a, b, c = vectors[..., 0], vectors[..., 1], vectors[..., 2]
    zero = torch.zeros_like(a)
    row0 = torch.stack((zero, c, b), dim=-1)
    row1 = torch.stack((c, zero, a), dim=-1)
    row2 = torch.stack((b, a, zero), dim=-1)
    return torch.stack((row0, row1, row2), dim=-2)


def rotation_matrix_from_one_vector(directions: Tensor, axis: int) -> Tensor:
    r"""Rotation matrices whose ``axis`` column equals the normalized
    ``directions`` (Drake's ``MakeFromOneVector``, branchless: the
    minimum-magnitude component is selected with one-hot rows).

    Args:
        directions: ``(*, 3)`` directions (need not be unit length).
        axis: 0, 1, or 2.

    Returns:
        ``(*, 3, 3)`` rotation matrices.
    """
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
    a = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)

    i_idx = torch.argmin(torch.abs(a), dim=-1)
    e_i = torch.eye(3, dtype=a.dtype, device=a.device)[i_idx]   # (*, 3)
    e_j = torch.roll(e_i, 1, dims=-1)
    e_k = torch.roll(e_i, 2, dims=-1)

    a_i = torch.sum(a * e_i, dim=-1, keepdim=True)
    a_j = torch.sum(a * e_j, dim=-1, keepdim=True)
    a_k = torch.sum(a * e_k, dim=-1, keepdim=True)

    # |a_i| <= 1/sqrt(3), so mag_u lies in [sqrt(2/3), 1].
    mag_u = torch.sqrt(1.0 - a_i * a_i)
    corr = -a_i / mag_u

    column_b = e_j * (-a_k / mag_u) + e_k * (a_j / mag_u)
    column_c = e_i * mag_u + e_j * (corr * a_j) + e_k * (corr * a_k)

    columns = [None, None, None]
    columns[axis] = a
    columns[(axis + 1) % 3] = column_b
    columns[(axis + 2) % 3] = column_c
    return torch.stack(columns, dim=-1)
