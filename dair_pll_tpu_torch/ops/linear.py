r"""Small-matrix linear algebra, unrolled over the matrix dimension
(PyTorch).

Counterpart of ``dair_pll_tpu/ops/linear.py``: the Cholesky factor and
the substitutions of the ``n_v x n_v`` mass matrices and the solvers'
Schur complements (``n <= 20``) are written out entry by entry over a
batch of leading dimensions, so they run in the same order as the JAX
package's and differentiate through ordinary autograd. Larger matrices
go to ``torch.linalg``.
"""
from __future__ import annotations

from typing import List

import torch
from torch import Tensor

#: Above this size the factorization goes to ``torch.linalg``.
MAX_UNROLL_DIM = 20


def cholesky_unrolled(M: Tensor) -> Tensor:
    """Lower Cholesky factor ``L`` of SPD ``M``: ``(*, n, n) -> (*, n, n)``
    with ``L L^T = M``."""
    n = M.shape[-1]
    if n > MAX_UNROLL_DIM:
        return torch.linalg.cholesky(M)
    L: List[List[Tensor]] = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    zero = torch.zeros_like(M[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero
                                     for j in range(n)], dim=-1)
                        for i in range(n)], dim=-2)


def cho_solve_unrolled(L: Tensor, rhs: Tensor) -> Tensor:
    """Solves ``L L^T x = rhs`` by forward and back substitution.

    Args:
        L: ``(*, n, n)`` lower Cholesky factors.
        rhs: ``(*, n)`` or ``(*, n, m)``.

    Returns:
        The solution, shaped as ``rhs``.
    """
    n = L.shape[-1]
    vector_rhs = rhs.dim() == L.dim() - 1
    if vector_rhs:
        rhs = rhs[..., None]
    if n > MAX_UNROLL_DIM:
        x = torch.cholesky_solve(rhs, L)
        return x[..., 0] if vector_rhs else x

    y: List[Tensor] = []
    for i in range(n):
        s = rhs[..., i, :]
        for k in range(i):
            s = s - L[..., i, k, None] * y[k]
        y.append(s / L[..., i, i, None])

    x: List[Tensor] = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i, None] * x[k]
        x[i] = s / L[..., i, i, None]

    out = torch.stack(x, dim=-2)
    return out[..., 0] if vector_rhs else out


def spd_solve(M: Tensor, rhs: Tensor) -> Tensor:
    """Solves ``M x = rhs`` for small SPD ``M`` by the unrolled
    Cholesky."""
    return cho_solve_unrolled(cholesky_unrolled(M), rhs)
