r"""Batched tensor utilities for multibody dynamics (PyTorch).

Counterparts of the functions of ``dair_pll_tpu/ops/tensor.py``. Stacked
contact impulses are laid out as ``[n_1 .. n_k, t_1x, t_1y, .. t_kx,
t_ky]``: all normal components first, then per-contact tangential pairs.
"""
from __future__ import annotations

import torch
from torch import Tensor

__all__ = [
    "pbmm",
    "small_matmul",
    "small_matvec",
    "skew_symmetric",
    "symmetric_offdiagonal",
    "spatial_to_point_jacobian",
    "rotation_matrix_from_one_vector",
    "broadcast_lorentz",
    "project_lorentz",
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


def pbmm(a: Tensor, b: Tensor) -> Tensor:
    """Batched matrix product, broadcasting over leading dims."""
    return torch.matmul(a, b)


def small_matmul(a: Tensor, b: Tensor) -> Tensor:
    """``(*, m, k) @ (*, k, n)``. The JAX package writes tiny products as
    broadcast-multiply-reduce to keep them out of padded TPU layouts; on
    the card a plain ``matmul`` serves."""
    return torch.matmul(a, b)


def small_matvec(a: Tensor, v: Tensor) -> Tensor:
    """``(*, m, k) x (*, k) -> (*, m)``."""
    return torch.matmul(a, v.unsqueeze(-1)).squeeze(-1)


def spatial_to_point_jacobian(p_BoP_E: Tensor) -> Tensor:
    r"""Jacobian ``[-S(p), I_3]`` ``(*, 3, 6)`` of a body-fixed point's
    velocity w.r.t. the body's spatial velocity ``[omega; v_Bo]``."""
    left = -skew_symmetric(p_BoP_E)
    eye = torch.eye(3, dtype=p_BoP_E.dtype, device=p_BoP_E.device).expand(
        p_BoP_E.shape[:-1] + (3, 3))
    return torch.cat((left, eye), dim=-1)


def broadcast_lorentz(vectors: Tensor) -> Tensor:
    r"""Per-cone scalars ``(*, n)`` into the stacked Lorentz layout
    ``(*, 3n)``: ``[v_1 .. v_n, v_1, v_1, .. v_n, v_n]``."""
    return torch.cat((vectors, torch.repeat_interleave(vectors, 2, dim=-1)),
                     dim=-1)


def project_lorentz(vectors: Tensor) -> Tensor:
    r"""Projects stacked ``(*, 3k)`` vectors ``[n_1 .. n_k, t_1x t_1y ..]``
    onto the product of Lorentz cones ``{n >= ||t||}``: unchanged inside
    the cone, zero inside the polar cone, else ``((n + ||t||)/2) [1;
    t/||t||]`` (branchless)."""
    k = vectors.shape[-1] // 3
    normals = vectors[..., :k]
    tangents = vectors[..., k:]
    t_pairs = tangents.reshape(tangents.shape[:-1] + (k, 2))
    t_sq = torch.sum(t_pairs * t_pairs, dim=-1)
    t_norm = torch.sqrt(torch.clamp(t_sq, min=1e-30))

    in_cone = t_norm <= normals
    in_polar = t_norm <= -normals
    zero = torch.zeros_like(normals)
    half = 0.5 * (normals + t_norm)
    n_proj = torch.where(in_cone, normals, torch.where(in_polar, zero, half))
    t_scale = torch.where(in_cone, torch.ones_like(t_norm),
                          torch.where(in_polar, zero, half / t_norm))
    t_proj = (t_pairs * t_scale[..., None]).reshape(tangents.shape)
    return torch.cat((n_proj, t_proj), dim=-1)
