r"""Hand-written CUDA kernels of the ContactNets loss and their autograd.

Counterpart of ``dair_pll_tpu/ops/soa_loss_pallas.py``. The whole loss
step runs in two launches, both in ``csrc/contactnets_loss.cu``, one CUDA
thread per sample:

* **forward** (K1 cold, K3 epoch-warm): the terms at the observed next
  state, the detached hybrid cone solve and the loss assembly
  (:func:`fused_loss_fwd`, :func:`fused_loss_fwd_warm`).
* **backward** (K2, shared by both): the gradient does not flow through
  the solve (envelope theorem), so the kernel recomputes the terms and
  the assembly at the saved impulse and differentiates them in one
  reverse-mode sweep per sample, with respect to the derived scalar
  parameters (summed over the batch) and the states
  (:func:`fused_loss_bwd`).

Beside each kernel stands its plain PyTorch version (:func:`plain_loss_fwd`,
:func:`plain_loss_fwd_warm`, :func:`plain_loss_bwd`): the wrappers run it
for CPU tensors, and for CUDA tensors launch the kernel or raise. The
``launches`` attribute of each wrapper counts its kernel's launches. The
kernels are instantiated for the cube (:func:`kernels_cover`) in float32
and float64.

The chain from ``MultibodyParams`` to the packed derived vector
(``soa_terms.derive_scalar_params`` and :func:`pack_derived`) is ordinary
torch autograd outside the kernels; :class:`_FusedLoss` and
:class:`_FusedLossWarm` take it from there.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
from torch import Tensor

from dair_pll_tpu_torch.multibody.model import MultibodyModel
from dair_pll_tpu_torch.multibody.soa_terms import (
    derive_scalar_params, soa_loss_assemble, soa_loss_parts)
from dair_pll_tpu_torch.ops import soa, soa_kernels, soa_solver

_CUBE_NOT_COVERED = (
    "the ContactNets loss kernels are instantiated for the cube only (one "
    "free body, a ground plane against a box with 4 witness points); other "
    "models wait for ROADMAP.md, Queue 2: 'elbow, polygon and sphere "
    "instantiations of K1-K3'")


# -- derived-parameter packing ---------------------------------------------------
def kernels_cover(model: MultibodyModel) -> bool:
    """Whether the CUDA kernels' instantiation covers the model: the cube,
    one free body with a box (in the body frame, 4 witness points)
    against a ground plane (in the world frame), no actuation."""
    identity = tuple(tuple(row) for row in np.eye(3))
    if model.n_bodies != 1 or model.n_u != 0 or (model.n_q, model.n_v) != \
            (7, 6):
        return False
    if model.bodies[0].joint.joint_type != "free":
        return False
    if len(model.geometries) != 2 or model.collision_candidates != ((0, 1),):
        return False
    plane, box = model.geometries
    return (plane.geom_type == "plane" and plane.body == -1 and
            box.geom_type == "box" and box.body == 0 and
            box.n_query == 4 and
            all(tuple(g.R_BG) == identity and tuple(g.p_BG) == (0, 0, 0)
                for g in (plane, box)))


def _require_cover(model: MultibodyModel) -> None:
    if not kernels_cover(model):
        raise NotImplementedError(_CUBE_NOT_COVERED)


def derived_size(model: MultibodyModel) -> int:
    """Number of packed derived scalars: the body's inertial vector (10),
    the plane's and the box's friction (2), the box's half lengths (3)."""
    _require_cover(model)
    return 15


def pack_derived(model: MultibodyModel, derived) -> Tensor:
    """Flattens the derived parameters (``soa_terms.derive_scalar_params``)
    into the ``(15,)`` vector the kernels take, in the layout
    :func:`unpack_scalarized` mirrors. Differentiable: the gradient back to
    ``MultibodyParams`` is ordinary autograd."""
    _require_cover(model)
    return torch.cat([derived["pi"].reshape(-1), derived["mu"].reshape(-1),
                      derived["geom"][1]["half"].reshape(-1)])


def unpack_scalarized(model: MultibodyModel,
                      read: Callable[[int], Tensor]) -> dict:
    """Rebuilds the scalarized derived structure
    (``soa_terms.scalarize_derived``'s) from an indexed scalar reader."""
    values = [read(i) for i in range(derived_size(model))]
    return {"pi": [values[:10]], "mu": values[10:12],
            "geom": [{}, {"half": values[12:15]}]}


# -- plain versions --------------------------------------------------------------
def _split_state(model: MultibodyModel, block: Tensor):
    """``(n_x [+ n_u], B)`` -> ``(q, v, u)`` lists of ``(B,)`` rows."""
    n_q, n_v = model.n_q, model.n_v
    rows = soa.unstack(block)
    return rows[:n_q], rows[n_q:n_q + n_v], rows[n_q + n_v:]


def _parts(model, pvec, xin, xp, dt):
    sp = unpack_scalarized(model, lambda i: pvec[i])
    _, v, u = _split_state(model, xin)
    q_plus, v_plus, _ = _split_state(model, xp)
    return soa_loss_parts(model, sp, v, q_plus, v_plus, u, dt)


def plain_loss_fwd(model: MultibodyModel, pvec: Tensor, xin: Tensor,
                   xp: Tensor, dt: float, eps: float, ipm_iterations: int,
                   newton_iterations: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of K1: ``pvec (P,)``, ``xin (n_x + n_u, B)``,
    ``xp (n_x, B)`` -> ``loss (B,)``, ``force (3, k, B)``, ``valid (B,)``."""
    with torch.no_grad():
        M, Jc, phi, qc, dv = _parts(model, pvec, xin, xp, dt)
        force, valid = soa_solver.solve_contact_impulse_soa(
            M, Jc, qc, eps, ipm_iterations, newton_iterations)
        loss = soa_loss_assemble(M, Jc, phi, qc, dv, force, valid, eps)
    return loss, torch.stack(force), valid


def plain_loss_fwd_warm(model: MultibodyModel, pvec: Tensor, xin: Tensor,
                        xp: Tensor, fprev: Tensor, dt: float, eps: float,
                        ipm_iterations: int, newton_iterations: int
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of K3: as :func:`plain_loss_fwd`, with the solve
    warm-started from ``w = M^{-1} J^T fprev``, ``fprev (3, k, B)``."""
    with torch.no_grad():
        M, Jc, phi, qc, dv = _parts(model, pvec, xin, xp, dt)
        w_carry = soa.spd_solve(M, soa_solver.jt_dot(Jc, fprev.unbind(0)))
        force, _, valid = soa_solver.solve_warm_hybrid_soa(
            M, Jc, qc, w_carry, eps, ipm_iterations, newton_iterations)
        loss = soa_loss_assemble(M, Jc, phi, qc, dv, force, valid, eps)
    return loss, torch.stack(force), valid


def plain_loss_bwd(model: MultibodyModel, pvec: Tensor, xin: Tensor,
                   xp: Tensor, force: Tensor, valid: Tensor, ct: Tensor,
                   dt: float, eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of K2: torch autograd of ``sum(ct * loss)`` through
    the terms and the assembly at the saved ``force (3, k, B)`` ->
    ``dp (P,)``, ``dxin``, ``dxp`` shaped as the inputs."""
    inputs = [t.detach().requires_grad_() for t in (pvec, xin, xp)]
    with torch.enable_grad():
        M, Jc, phi, qc, dv = _parts(model, *inputs, dt)
        loss = soa_loss_assemble(M, Jc, phi, qc, dv, force.unbind(0), valid,
                                 eps)
        grads = torch.autograd.grad(torch.sum(loss * ct), inputs,
                                    allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, inputs))


# -- kernel wrappers -------------------------------------------------------------
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check_launch(model: MultibodyModel, pvec: Tensor, xin: Tensor,
                  xp: Tensor) -> Tuple[str, int]:
    """Raises unless the kernels take these inputs; returns the entry
    points' dtype suffix and the batch size."""
    _require_cover(model)
    dtype = pvec.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"no kernel for dtype {dtype}")
    B = xin.shape[-1]
    soa_kernels.check_tensor("pvec", pvec, (derived_size(model),), dtype,
                             pvec.device)
    soa_kernels.check_tensor("xin", xin, (model.n_q + model.n_v, B), dtype,
                             pvec.device)
    soa_kernels.check_tensor("xp", xp, (model.n_q + model.n_v, B), dtype,
                             pvec.device)
    return _SUFFIX[dtype], B


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _outputs(model: MultibodyModel, like: Tensor, B: int):
    k = model.n_contacts
    return (torch.empty((B,), dtype=like.dtype, device=like.device),
            torch.empty((3, k, B), dtype=like.dtype, device=like.device),
            torch.empty((B,), dtype=torch.bool, device=like.device))


def fused_loss_fwd(model: MultibodyModel, pvec: Tensor, xin: Tensor,
                   xp: Tensor, dt: float, eps: float, ipm_iterations: int,
                   newton_iterations: int) -> Tuple[Tensor, Tensor, Tensor]:
    """K1: ``(loss (B,), force (3, k, B), valid (B,))`` from
    ``pvec (P,)``, ``xin (n_x, B)``, ``xp (n_x, B)``. CPU tensors run
    :func:`plain_loss_fwd`; CUDA tensors launch the kernel on the current
    stream or raise."""
    if soa_kernels.on_cpu(pvec, xin, xp):
        return plain_loss_fwd(model, pvec, xin, xp, dt, eps, ipm_iterations,
                              newton_iterations)
    suffix, B = _check_launch(model, pvec, xin, xp)
    loss, force, valid = _outputs(model, pvec, B)
    if B == 0:
        return loss, force, valid
    fn = getattr(soa_kernels.load_library(),
                 f"contactnets_loss_fwd_cube_{suffix}")
    with torch.cuda.device(pvec.device):
        err = fn(pvec.data_ptr(), xin.data_ptr(), xp.data_ptr(),
                 loss.data_ptr(), force.data_ptr(), valid.data_ptr(), B,
                 float(dt), float(eps), int(ipm_iterations),
                 int(newton_iterations),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "ContactNets loss forward (K1)")
    fused_loss_fwd.launches += 1
    return loss, force, valid


def fused_loss_fwd_warm(model: MultibodyModel, pvec: Tensor, xin: Tensor,
                        xp: Tensor, fprev: Tensor, dt: float, eps: float,
                        ipm_iterations: int, newton_iterations: int
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """K3: as :func:`fused_loss_fwd`, with the solve warm-started from the
    previous impulses ``fprev (3, k, B)``."""
    if soa_kernels.on_cpu(pvec, xin, xp, fprev):
        return plain_loss_fwd_warm(model, pvec, xin, xp, fprev, dt, eps,
                                   ipm_iterations, newton_iterations)
    suffix, B = _check_launch(model, pvec, xin, xp)
    soa_kernels.check_tensor("fprev", fprev, (3, model.n_contacts, B),
                             pvec.dtype, pvec.device)
    loss, force, valid = _outputs(model, pvec, B)
    if B == 0:
        return loss, force, valid
    fn = getattr(soa_kernels.load_library(),
                 f"contactnets_loss_fwd_warm_cube_{suffix}")
    with torch.cuda.device(pvec.device):
        err = fn(pvec.data_ptr(), xin.data_ptr(), xp.data_ptr(),
                 fprev.data_ptr(), loss.data_ptr(), force.data_ptr(),
                 valid.data_ptr(), B, float(dt), float(eps),
                 int(ipm_iterations), int(newton_iterations),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "ContactNets loss warm forward (K3)")
    fused_loss_fwd_warm.launches += 1
    return loss, force, valid


def fused_loss_bwd(model: MultibodyModel, pvec: Tensor, xin: Tensor,
                   xp: Tensor, force: Tensor, valid: Tensor, ct: Tensor,
                   dt: float, eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    """K2: the gradient of ``sum(ct * loss)`` at the saved impulse,
    ``(dp (P,), dxin, dxp)``. CPU tensors run :func:`plain_loss_bwd`; CUDA
    tensors launch the kernel (and its pass that sums the blocks' partial
    sums of ``dp`` in a fixed order) or raise."""
    if soa_kernels.on_cpu(pvec, xin, xp, force, valid, ct):
        return plain_loss_bwd(model, pvec, xin, xp, force, valid, ct, dt,
                              eps)
    suffix, B = _check_launch(model, pvec, xin, xp)
    soa_kernels.check_tensor("force", force, (3, model.n_contacts, B),
                             pvec.dtype, pvec.device)
    soa_kernels.check_tensor("valid", valid, (B,), torch.bool, pvec.device)
    soa_kernels.check_tensor("ct", ct, (B,), pvec.dtype, pvec.device)
    dxin = torch.empty_like(xin)
    dxp = torch.empty_like(xp)
    if B == 0:
        return torch.zeros_like(pvec), dxin, dxp
    lib = soa_kernels.load_library()
    dp = torch.empty_like(pvec)
    partial = torch.empty((lib.contactnets_loss_bwd_scratch(B),),
                          dtype=pvec.dtype, device=pvec.device)
    fn = getattr(lib, f"contactnets_loss_bwd_cube_{suffix}")
    with torch.cuda.device(pvec.device):
        err = fn(pvec.data_ptr(), xin.data_ptr(), xp.data_ptr(),
                 force.data_ptr(), valid.data_ptr(), ct.data_ptr(),
                 partial.data_ptr(), dp.data_ptr(), dxin.data_ptr(),
                 dxp.data_ptr(), B, float(dt), float(eps),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "ContactNets loss backward (K2)")
    fused_loss_bwd.launches += 1
    return dp, dxin, dxp


fused_loss_fwd.launches = 0
fused_loss_fwd_warm.launches = 0
fused_loss_bwd.launches = 0


# -- autograd ----------------------------------------------------------------------
def _backward(ctx, ct: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """K2 at the impulse the forward saved: ``(dp, dxin, dxp)``."""
    pvec, xin, xp, force, valid = ctx.saved_tensors
    return fused_loss_bwd(ctx.model, pvec, xin, xp, force, valid,
                          ct.contiguous(), ctx.dt, ctx.eps)


class _FusedLoss(torch.autograd.Function):
    """``(pvec, xin, xp) -> loss (B,)``: K1 forward, K2 backward."""

    @staticmethod
    def forward(ctx, pvec, xin, xp, model, dt, eps, ipm_iterations,
                newton_iterations):
        loss, force, valid = fused_loss_fwd(model, pvec, xin, xp, dt, eps,
                                            ipm_iterations,
                                            newton_iterations)
        ctx.save_for_backward(pvec, xin, xp, force, valid)
        ctx.model, ctx.dt, ctx.eps = model, dt, eps
        return loss

    @staticmethod
    def backward(ctx, ct):
        return (*_backward(ctx, ct), None, None, None, None, None)


class _FusedLossWarm(torch.autograd.Function):
    """``(pvec, xin, xp, fprev) -> (loss (B,), force (3, k, B))``: K3
    forward, K2 backward. ``force`` is the refreshed, detached impulse
    cache; ``fprev`` gets no gradient."""

    @staticmethod
    def forward(ctx, pvec, xin, xp, fprev, model, dt, eps, ipm_iterations,
                newton_iterations):
        loss, force, valid = fused_loss_fwd_warm(
            model, pvec, xin, xp, fprev, dt, eps, ipm_iterations,
            newton_iterations)
        ctx.save_for_backward(pvec, xin, xp, force, valid)
        ctx.model, ctx.dt, ctx.eps = model, dt, eps
        ctx.mark_non_differentiable(force)
        return loss, force

    @staticmethod
    def backward(ctx, ct, _ct_force):
        # fprev, the previous impulses, gets no gradient.
        return (*_backward(ctx, ct), None, None, None, None, None, None)


def _kernel_inputs(model, params, x, u, x_plus):
    pvec = pack_derived(model, derive_scalar_params(model, params))
    xin = torch.cat([x.T, u.T], dim=0) if model.n_u > 0 else x.T
    return pvec, xin.contiguous(), x_plus.T.contiguous()


def fused_contactnets_loss_kernel(model: MultibodyModel, params, x: Tensor,
                                  u: Tensor, x_plus: Tensor, dt: float,
                                  loss_epsilon: float, ipm_iterations: int,
                                  newton_iterations: int) -> Tensor:
    """Single-kernel ContactNets loss ``(B, n_x) -> (B,)`` with the kernel
    backward: the counterpart of ``soa_terms.soa_contactnets_loss``."""
    pvec, xin, xp = _kernel_inputs(model, params, x, u, x_plus)
    return _FusedLoss.apply(pvec, xin, xp, model, float(dt),
                            float(loss_epsilon), ipm_iterations,
                            newton_iterations)


def fused_contactnets_loss_kernel_warm(model: MultibodyModel, params,
                                       x: Tensor, u: Tensor, x_plus: Tensor,
                                       dt: float, loss_epsilon: float,
                                       ipm_iterations: int,
                                       newton_iterations: int,
                                       force_prev: Tensor
                                       ) -> Tuple[Tensor, Tensor]:
    """Epoch-warm single-kernel ContactNets loss: the solve warm-starts
    from ``force_prev (3, k, B)``, the impulses these samples solved to on
    a previous visit (zeros for cold samples). Returns ``(loss (B,),
    force (3, k, B))``, ``force`` the refreshed, detached cache."""
    pvec, xin, xp = _kernel_inputs(model, params, x, u, x_plus)
    return _FusedLossWarm.apply(pvec, xin, xp,
                                force_prev.detach().contiguous(), model,
                                float(dt), float(loss_epsilon),
                                ipm_iterations, newton_iterations)
