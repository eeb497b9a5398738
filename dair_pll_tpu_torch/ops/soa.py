r"""Structure-of-arrays (batch-minor) small-matrix dialect in PyTorch.

Counterpart of ``dair_pll_tpu/ops/soa.py``: a *batched scalar* is a
``(B,)`` tensor, a small vector is a Python ``list`` of batched scalars
and a small matrix is a nested list. Every small-dimension loop unrolls
in Python into elementwise tensor arithmetic with the batch as the only
(minor) axis. Leaves may also be ``(k, B)`` (a cone axis in front) or
0-d parameter scalars; broadcasting handles the mix.

The operation order of every function matches the JAX module, so the two
agree to the last few ulps; :func:`sort_with_payload` is the same
insertion network, because its tie order decides which box vertices
become contact witnesses.

Conventions: ``svec`` = ``List[Tensor]``; ``smat`` =
``List[List[Tensor]]`` (row-major).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import Tensor

Svec = List[Tensor]
Smat = List[List[Tensor]]


# -- packing -------------------------------------------------------------------
def unstack(arr: Tensor) -> Svec:
    """``(n, B)`` (or ``(n,)``) tensor -> list of ``n`` rows."""
    return [arr[i] for i in range(arr.shape[0])]


def stack(vec: Sequence[Tensor]) -> Tensor:
    """List of ``(B,)`` -> ``(n, B)``."""
    return torch.stack(list(vec), dim=0)


def stack_mat(mat: Smat) -> Tensor:
    """Nested list -> ``(m, n, B)``."""
    return torch.stack([torch.stack(row, dim=0) for row in mat], dim=0)


def unstack_mat(arr: Tensor) -> Smat:
    """``(m, n, B)`` -> nested list."""
    return [[arr[i, j] for j in range(arr.shape[1])]
            for i in range(arr.shape[0])]


def stack_contacts(leaves: Sequence[Tensor]) -> Tensor:
    """Stacks per-contact ``(B,)`` leaves along a leading contact axis."""
    return torch.stack(list(leaves), dim=0)


def eye(n: int, like: Tensor) -> Smat:
    one = torch.ones_like(like)
    zero = torch.zeros_like(like)
    return [[one if i == j else zero for j in range(n)] for i in range(n)]


def zero_svec(n: int, like: Tensor) -> Svec:
    z = torch.zeros_like(like)
    return [z for _ in range(n)]


def zero_smat(m: int, n: int, like: Tensor) -> Smat:
    z = torch.zeros_like(like)
    return [[z for _ in range(n)] for _ in range(m)]


# -- vector algebra ------------------------------------------------------------
def vadd(a: Svec, b: Svec) -> Svec:
    return [x + y for x, y in zip(a, b)]


def vsub(a: Svec, b: Svec) -> Svec:
    return [x - y for x, y in zip(a, b)]


def vscale(s, a: Svec) -> Svec:
    return [s * x for x in a]


def dot(a: Svec, b: Svec) -> Tensor:
    acc = a[0] * b[0]
    for x, y in zip(a[1:], b[1:]):
        acc = acc + x * y
    return acc


def sum_rows(t: Tensor) -> Tensor:
    """Sum over the leading (contact) axis of ``(k, B)``, added in row
    order: ``((t[0] + t[1]) + t[2]) + ...``. The CUDA kernels add in this
    order, and so does ``torch.sum`` over a few rows on the CPU; on the
    card ``torch.sum`` may pair the rows otherwise, so the plain versions
    fold explicitly and repeat the kernels' rounding on either device."""
    acc = t[0]
    for i in range(1, t.shape[0]):
        acc = acc + t[i]
    return acc


def norm(a: Svec, floor: float = 0.0) -> Tensor:
    return torch.sqrt(torch.clamp_min(dot(a, a), floor))


def cross3(a: Svec, b: Svec) -> Svec:
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


# -- matrix algebra --------------------------------------------------------------
def matvec(A: Smat, x: Svec) -> Svec:
    return [dot(row, x) for row in A]


def matvec_t(A: Smat, x: Svec) -> Svec:
    """``A^T x`` without forming the transpose."""
    n = len(A[0])
    out = []
    for j in range(n):
        acc = A[0][j] * x[0]
        for i in range(1, len(A)):
            acc = acc + A[i][j] * x[i]
        out.append(acc)
    return out


def matmul(A: Smat, B: Smat) -> Smat:
    m, kk, n = len(A), len(B), len(B[0])
    out = []
    for i in range(m):
        row = []
        for j in range(n):
            acc = A[i][0] * B[0][j]
            for k in range(1, kk):
                acc = acc + A[i][k] * B[k][j]
            row.append(acc)
        out.append(row)
    return out


def transpose(A: Smat) -> Smat:
    return [list(col) for col in zip(*A)]


def matmul_t(A: Smat, B: Smat) -> Smat:
    """``A^T B``."""
    return matmul(transpose(A), B)


def madd(A: Smat, B: Smat) -> Smat:
    return [[x + y for x, y in zip(ra, rb)] for ra, rb in zip(A, B)]


def msub(A: Smat, B: Smat) -> Smat:
    return [[x - y for x, y in zip(ra, rb)] for ra, rb in zip(A, B)]


def mscale(s, A: Smat) -> Smat:
    return [[s * x for x in row] for row in A]


def outer(a: Svec, b: Svec) -> Smat:
    return [[x * y for y in b] for x in a]


def skew(v: Svec) -> Smat:
    """Cross-product matrix of a 3-vector."""
    z = torch.zeros_like(v[0])
    return [[z, -v[2], v[1]],
            [v[2], z, -v[0]],
            [-v[1], v[0], z]]


# -- factorizations --------------------------------------------------------------
def cholesky(M: Smat) -> Smat:
    """Unrolled lower-Cholesky of a small SPD ``smat`` (only the lower
    triangle is filled)."""
    n = len(M)
    L: List[List[Tensor]] = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = M[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    return L


def cho_solve(L: Smat, rhs: Svec) -> Svec:
    """Solves ``L L^T x = rhs`` (forward + back substitution, unrolled)."""
    n = len(L)
    y: List[Tensor] = []
    for i in range(n):
        s = rhs[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y.append(s / L[i][i])
    x: List[Tensor] = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def ldlt(M: Smat) -> Tuple[Smat, Svec]:
    """Unrolled ``L D L^T`` factorization of a small SPD ``smat``.

    Returns ``(L, d_inv)`` with ``L`` unit-lower-triangular (only the
    strict lower triangle is filled; the rest is never read) and ``d_inv``
    the reciprocal diagonal of ``D``, so :func:`ldlt_solve` is
    division-free.
    """
    n = len(M)
    L: List[List[Tensor]] = [[None] * n for _ in range(n)]
    # C[i][j] = L[i][j] * d[j], kept so inner updates are multiply-adds.
    C: List[List[Tensor]] = [[None] * n for _ in range(n)]
    d_inv: List[Tensor] = []
    for j in range(n):
        s = M[j][j]
        for k in range(j):
            s = s - L[j][k] * C[j][k]
        dj_inv = 1.0 / s
        d_inv.append(dj_inv)
        for i in range(j + 1, n):
            c = M[i][j]
            for k in range(j):
                c = c - L[i][k] * C[j][k]
            C[i][j] = c
            L[i][j] = c * dj_inv
    return L, d_inv


def ldlt_solve(fac: Tuple[Smat, Svec], rhs: Svec) -> Svec:
    """Solves ``L D L^T x = rhs`` from :func:`ldlt` with zero divisions."""
    L, d_inv = fac
    n = len(L)
    y: List[Tensor] = []
    for i in range(n):
        s = rhs[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y.append(s)
    x: List[Tensor] = [None] * n
    for i in reversed(range(n)):
        s = y[i] * d_inv[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s
    return x


def spd_solve(M: Smat, rhs: Svec) -> Svec:
    return ldlt_solve(ldlt(M), rhs)


def sym3_inverse(A: Smat, floor: float = 1e-30) -> Smat:
    """Analytic inverse of a symmetric 3x3 ``smat`` via the adjugate."""
    a, b, c = A[0][0], A[0][1], A[0][2]
    d, e = A[1][1], A[1][2]
    f = A[2][2]
    co_a = d * f - e * e
    co_b = c * e - b * f
    co_c = b * e - c * d
    co_d = a * f - c * c
    co_e = b * c - a * e
    co_f = a * d - b * b
    det3 = a * co_a + b * co_b + c * co_c
    det3 = torch.where(torch.abs(det3) > floor, det3, floor)
    inv = 1.0 / det3
    return [[co_a * inv, co_b * inv, co_c * inv],
            [co_b * inv, co_d * inv, co_e * inv],
            [co_c * inv, co_e * inv, co_f * inv]]


# -- sorting networks --------------------------------------------------------------
def sort_with_payload(keys: Svec, payloads: List[Svec],
                      descending: bool = False
                      ) -> Tuple[Svec, List[Svec]]:
    """Sorts ``keys`` per batch element with the insertion-style
    compare-exchange network of the JAX module, carrying ``payloads``
    (each a list parallel to ``keys``) through the same swaps. Equal keys
    never swap, so ties keep their input order."""
    n = len(keys)
    keys = list(keys)
    payloads = [list(p) for p in payloads]
    for i in range(1, n):
        for j in range(i, 0, -1):
            a, b = keys[j - 1], keys[j]
            swap = (a < b) if descending else (a > b)
            keys[j - 1] = torch.where(swap, b, a)
            keys[j] = torch.where(swap, a, b)
            for p in payloads:
                pa, pb = p[j - 1], p[j]
                p[j - 1] = torch.where(swap, pb, pa)
                p[j] = torch.where(swap, pa, pb)
    return keys, payloads
