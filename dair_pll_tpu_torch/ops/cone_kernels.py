r"""The batched APGD cone-QP solve kernel K6, its plain version and its
launch counter.

Counterpart of ``dair_pll_tpu/ops/pallas_cone_solver.py``
(``solve_cone_qp_pallas`` and ``solve_contact_impulse_pallas``, the TPU
kernel ``_make_kernel``): the whole APGD solve of a batch of cone QPs in
one launch of ``csrc/apgd_cone_solve.cuh``, a group of 8, 16 or 32 lanes
of a warp per problem (a warp with several rows a lane beyond k = 10),
built at first use for each cone count ``k`` by ``ops/soa_kernels.py``.
For tensors on the CPU the wrappers call :func:`plain_apgd`; for CUDA
tensors they launch the kernel or raise. ``solve_cone_qp_cuda.launches``
counts launches (``launches_by`` by ``f"k{k}"``).

:func:`plain_apgd` runs the kernel's arithmetic in the kernel's order:
each matvec sums over the columns in order; the dot products, the
power-iteration norm ``sqrt(max(sum w^2, 1e-30))`` and the restart test
sum as a 32-lane butterfly does (a halving tree over 32 lanes, zeros
past ``n``; over the power of two of 32-row blocks that holds ``n``
beyond 32 rows), which the kernel's butterfly over its group of lanes
equals bit for bit (``tests/test_torch_apgd_groups.py``). The lax APGD of
``ops/cone_solver.py`` differs in those orders and in its norm,
``max(||w||, 1e-30)``.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from dair_pll_tpu_torch.ops.soa_kernels import (
    _CTYPE, _I, _LL, _P, _SUFFIX, Instance, check_tensor, count_launch,
    entry, on_cpu, reset_launches)
from dair_pll_tpu_torch.ops.socp_solver import mask_failures

POWER_ITERATIONS = 12
_LANES = 32


def apgd_instance(k: int, dtype) -> Instance:
    """K6 for ``k`` cones in ``dtype``."""
    name = f"apgd_cone_solve_k{k}_{_SUFFIX[dtype]}"
    return Instance(name, '#include "apgd_cone_solve.cuh"\n'
                    f"DEFINE_APGD_ENTRY({k}, {_CTYPE[dtype]}, "
                    f"{_SUFFIX[dtype]})\n",
                    ((name, (_P, _P, _P, _LL, _I, _P), _I),))


def _warp_sum(v: Tensor) -> Tensor:
    """Sum over the last axis in the order of a 32-lane butterfly
    reduction: zeros to 32 lanes, then halves added pairwise (the kernel's
    butterfly over its group of lanes gives the same bits); beyond 32
    entries zeros to the power of two of 32 that holds them, halved the
    same way (the kernel's lanes first halve their own rows)."""
    lanes = _LANES
    while lanes < v.shape[-1]:
        lanes *= 2
    v = torch.nn.functional.pad(v, (0, lanes - v.shape[-1]))
    width = lanes
    while width > 1:
        width //= 2
        v = v[..., :width] + v[..., width:2 * width]
    return v[..., 0]


def _matvec(Q: Tensor, v: Tensor) -> Tensor:
    """``Q v`` summed over the columns in order, ``(B, n, n) x (B, n)``."""
    acc = Q[..., :, 0] * v[..., 0:1]
    for j in range(1, Q.shape[-1]):
        acc = acc + Q[..., :, j] * v[..., j:j + 1]
    return acc


def _project(z: Tensor, k: int) -> Tensor:
    """The kernel's cone projection of stacked ``(B, 3k)`` vectors."""
    n = z[..., :k]
    tx = z[..., k::2]
    ty = z[..., k + 1::2]
    s = torch.sqrt(torch.clamp(tx * tx + ty * ty, min=1e-30))
    inside = s <= n
    polar = s <= -n
    zero = torch.zeros_like(s)
    h = 0.5 * (n + s)
    n_new = torch.where(inside, n, torch.where(polar, zero, h))
    scale = torch.where(inside, torch.ones_like(s),
                        torch.where(polar, zero, h / s))
    tangents = torch.stack((tx * scale, ty * scale), dim=-1)
    return torch.cat((n_new, tangents.reshape(z.shape[:-1] + (2 * k,))),
                     dim=-1)


def plain_apgd(Q: Tensor, q: Tensor, iterations: int) -> Tensor:
    """The plain PyTorch version of K6, on any device: ``Q (B, 3k, 3k)``,
    ``q (B, 3k)`` -> ``x (B, 3k)``."""
    n = q.shape[-1]
    k = n // 3
    v = torch.ones_like(q) / torch.sqrt(torch.tensor(float(n),
                                                     dtype=q.dtype))
    for _ in range(POWER_ITERATIONS):
        w = _matvec(Q, v)
        v = w / torch.sqrt(torch.clamp(_warp_sum(w * w), min=1e-30))[..., None]
    lam = _warp_sum(v * _matvec(Q, v))
    inv_L = (1.0 / (1.1 * torch.clamp(lam, min=1e-12)))[..., None]
    x = y = torch.zeros_like(q)
    t = torch.ones_like(q[..., 0])
    for _ in range(iterations):
        grad = _matvec(Q, y) + q
        x_new = _project(y - inv_L * grad, k)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        momentum = (t - 1.0) / t_new
        step = x_new - x
        restart = _warp_sum((y - x_new) * step) > 0.0
        t_new = torch.where(restart, torch.ones_like(t_new), t_new)
        momentum = torch.where(restart, torch.zeros_like(momentum), momentum)
        y = x_new + momentum[..., None] * step
        x, t = x_new, t_new
    return x


def _check(Q: Tensor, q: Tensor) -> Tuple[int, int]:
    """Raises unless the kernel takes ``(Q, q)``; returns ``(B, k)``."""
    if q.dim() != 2 or q.shape[-1] % 3:
        raise ValueError(f"q has shape {tuple(q.shape)}, expected (B, 3k)")
    B, n = q.shape
    k = n // 3
    if k < 1:
        raise ValueError(f"no APGD kernel for k = {k} cones")
    if q.dtype not in _SUFFIX:
        raise TypeError(f"no APGD kernel for dtype {q.dtype}")
    check_tensor("Q", Q, (B, n, n), q.dtype, q.device)
    check_tensor("q", q, (B, n), q.dtype, q.device)
    return B, k


def solve_cone_qp_cuda(Q: Tensor, q: Tensor, iterations: int = 200
                       ) -> Tensor:
    """Batched cone-QP solve by APGD: ``Q (B, 3k, 3k)`` PSD, ``q (B, 3k)``
    in the stacked layout -> ``x (B, 3k)``.

    CPU tensors run :func:`plain_apgd`; CUDA tensors launch K6 on the
    current stream (float32 or float64, any ``k``, built at first use;
    contiguous) or raise."""
    if on_cpu(Q, q):
        return plain_apgd(Q, q, iterations)
    B, k = _check(Q, q)
    x = torch.empty_like(q)
    if B == 0:
        return x
    fn = entry(apgd_instance(k, q.dtype))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(Q.data_ptr(), q.data_ptr(), x.data_ptr(), B,
                 int(iterations), stream)
    if err != 0:
        raise RuntimeError(f"APGD cone solve kernel launch failed: CUDA "
                           f"error {err}")
    count_launch(solve_cone_qp_cuda, f"k{k}")
    return x


reset_launches(solve_cone_qp_cuda)


def solve_contact_impulse_cuda(delassus: Tensor, q_vec: Tensor, eps,
                               iterations: int = 200
                               ) -> Tuple[Tensor, Tensor]:
    """Batched contact-impulse solve of ``Q = delassus + eps I`` on K6
    with the standard failure masking: a sample is valid when every entry
    is finite and at most 1e3 in magnitude; invalid samples are zeroed.
    Returns ``(impulse (B, 3k), valid (B,))``."""
    n = delassus.shape[-1]
    Q = delassus + eps * torch.eye(n, dtype=delassus.dtype,
                                   device=delassus.device)
    return mask_failures(solve_cone_qp_cuda(Q.contiguous(),
                                            q_vec.contiguous(), iterations))
