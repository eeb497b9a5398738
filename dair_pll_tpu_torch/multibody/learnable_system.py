r"""Learnable multibody system: Anitescu dynamics and the ContactNets loss
(PyTorch).

Counterpart of ``dair_pll_tpu/multibody/learnable_system.py``. The
next-step contact impulse solves Anitescu's dual QCQP

.. math::
    \min_{f \in FC} \tfrac 12 f^T D(q) f + f^T (J(q) v^- + [I;0]\phi/dt)

over the product friction cone, with ``v^- = v + dt a_nc`` and
``v^+ = v^- + M^{-1} J^T f``. Parameters are passed in on every call, as
in the JAX package; the system holds the model, the time step, the
solver's settings and the device.

Two paths, chosen by batch size as in the JAX package:

* The fused batch-minor path (``use_fused``, the default from
  ``FUSED_ROLLOUT_MIN_BATCH`` rollouts and ``FUSED_LOSS_MIN_BATCH`` loss
  transitions): rollouts run the warm hybrid solve kernel K5 at every
  step, built at first use for the model's ``(n_v, k)`` (the cube's
  ``(6, 4)``, the elbow's ``(7, 8)``, a ball's ``(6, 1)``, ...); the loss
  of a box, polygon or sphere model runs one CUDA kernel forward and one
  backward (K1 or K3, and K2): the box cube's own, or the model-generic
  ones, built at first use for the model's size; a deep-support (ICNN)
  model runs the plain terms under autograd with its detached solve on K4
  (cold) or K5 (warm).
* The vmapped path (the batch written out as leading dimensions): the
  integrator steps :meth:`forward_dynamics`, whose hybrid solve
  differentiates by the implicit-function theorem (or, with
  ``warm_start``, :meth:`forward_dynamics_with_state`, differentiated
  through its unrolled solve, as in JAX); the loss solves its detached QPs by
  the hybrid solve, the lax APGD (``solver="apgd"``) or the APGD kernel K6
  (``use_apgd_kernel=True``). It also covers the models the fused path
  does not (convex-vs-convex pairs, cylinders).

A training step is the mean loss, ``backward`` and a
``torch.optim.Adam`` step on ``params.parameters()``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from dair_pll_tpu_torch.integrator import Integrator
from dair_pll_tpu_torch.multibody.model import MultibodyModel, MultibodyParams
from dair_pll_tpu_torch.multibody.soa_terms import (
    has_deep_support, soa_contactnets_loss, soa_contactnets_loss_warm,
    soa_forward_dynamics_batch, supports_fused)
from dair_pll_tpu_torch.multibody.terms import multibody_terms
from dair_pll_tpu_torch.ops.cone_kernels import solve_contact_impulse_cuda
from dair_pll_tpu_torch.ops.cone_solver import solve_contact_impulse
from dair_pll_tpu_torch.ops.linear import spd_solve
from dair_pll_tpu_torch.ops.sap_solver import (solve_cone_qp_hybrid_warm,
                                               solve_contact_impulse_hybrid)
from dair_pll_tpu_torch.ops.socp_solver import mask_failures
from dair_pll_tpu_torch.ops.soa_loss_kernels import (
    fused_contactnets_loss_kernel, fused_contactnets_loss_kernel_warm)
from dair_pll_tpu_torch.ops.tensor import broadcast_lorentz, small_matvec
from dair_pll_tpu_torch.system import System, SystemSummary

DYNAMICS_EPSILON = 1e-4    # dynamics QP regularization
CONTACT_FILTER_EPS = 1e6   # phi activation threshold
#: APGD iteration count (``solver="apgd"`` and the APGD kernel route).
SOLVER_ITERATIONS = 200
#: Default solver: "hybrid" (interior-point start and SAP-Newton polish)
#: or "apgd" (FISTA).
DEFAULT_SOLVER = "hybrid"
#: (ipm, newton) budget of the rollout solves, cold and warm-started. The
#: JAX package measured that fresh impacts need the full 14-step central
#: path: at (10, 6) grazing-contact QPs keep 1.7e-3 impulse error, at
#: (14, 6) the error is at machine precision.
DEFAULT_WARM_IPM_ITERATIONS = 14
DEFAULT_WARM_NEWTON_ITERATIONS = 6
#: Flattened batch size from which ``simulate_batch`` takes the fused
#: path when ``use_fused`` is not given.
FUSED_ROLLOUT_MIN_BATCH = 1024
#: Regularization of the ContactNets loss QP.
LOSS_EPSILON = 1e-3
#: (ipm, newton) budget of cold ContactNets loss solves. The JAX package
#: measured that a polish of 6 leaves ~4.7% rel-l2 batch-gradient error
#: on real data at wrong-init parameters and 10 cuts it to ~6e-4.
DEFAULT_LOSS_IPM_ITERATIONS = 10
DEFAULT_LOSS_NEWTON_ITERATIONS = 10
#: (ipm, newton) budget of epoch-warm loss solves: a 4-step central path
#: hands Newton a centred fallback; the JAX package measured (4, 10)
#: tracking cold training to <1% where (0, 10) diverges.
DEFAULT_LOSS_WARM_BUDGET = (4, 10)
#: Flattened batch size from which the ContactNets loss takes the fused
#: path when ``use_fused`` is not given.
FUSED_LOSS_MIN_BATCH = 2048


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; raises when none is present. The CPU
    is used only when the caller asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        if device.index is None:
            # Tensors report their card's index; name it, so that device
            # checks compare like with like.
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _n_batch(batch_shape) -> int:
    return int(np.prod(batch_shape)) if batch_shape else 1


class MultibodyLearnableSystem(System):
    """Contact-dynamics system with learnable inertia, friction and
    geometry; parameters (:class:`MultibodyParams`) are passed in.

    Args:
        model: the multibody model.
        dt: time step in seconds.
        solver_iterations: APGD iterations (``solver="apgd"`` and the APGD
          kernel route of the loss).
        solver: ``"hybrid"`` or ``"apgd"``, the vmapped path's solve.
        ipm_iterations, newton_iterations: the cold loss solve's budget,
          on both paths.
        warm_start: carry the SAP primal through vmapped rollouts
          (:meth:`forward_dynamics_with_state`).
        device: where the system runs; ``None`` is the CUDA card.
    """

    model: MultibodyModel
    dt: float

    def __init__(self, model: MultibodyModel, dt: float,
                 solver_iterations: int = SOLVER_ITERATIONS,
                 solver: str = DEFAULT_SOLVER,
                 ipm_iterations: int = DEFAULT_LOSS_IPM_ITERATIONS,
                 newton_iterations: int = DEFAULT_LOSS_NEWTON_ITERATIONS,
                 warm_start: bool = False, device=None) -> None:
        if solver not in ("hybrid", "apgd"):
            raise ValueError(f"unknown solver {solver!r}")
        self.model = model
        self.dt = dt
        self.solver = solver
        self.solver_iterations = solver_iterations
        self.ipm_iterations = ipm_iterations
        self.newton_iterations = newton_iterations
        self.warm_start = warm_start
        self.device = resolve_device(device)
        space = model.state_space()
        super().__init__(space, Integrator(space, self._partial_step, dt,
                                           "velocity"))

    @classmethod
    def from_urdfs(cls, urdfs: Dict[str, str], dt: float,
                   **kwargs) -> "MultibodyLearnableSystem":
        """Builds the system from named URDF files."""
        from dair_pll_tpu_torch.urdf import build_multibody_model
        mesh_representation = kwargs.pop(
            "mesh_representation", "deep_support_convex")
        model = build_multibody_model(
            urdfs, mesh_representation=mesh_representation)
        return cls(model, dt, **kwargs)

    def initial_params(self, dtype=torch.float32) -> MultibodyParams:
        """The model's initial parameters on this system's device."""
        return self.model.initial_params(dtype, self.device)

    def supports_fused_loss(self) -> bool:
        """Whether the batch-minor fused SoA path covers this model and
        solver."""
        return self.solver == "hybrid" and supports_fused(self.model)

    def _loss_kernels(self, x: Tensor) -> bool:
        """Whether the fused loss runs the fused loss kernels (K1-K3): on
        CUDA tensors, except for ICNN models, whose loss runs the plain
        terms with the solve kernels (K4, K5), as the JAX package runs them
        through XLA with its solve kernels. The loss kernels take the box
        cube (``soa_loss_kernels.cube_cover``) and every other model of the
        fused class (``generic_cover``, each size built at first use); a
        model outside it raises ``NotImplementedError``: no route runs the
        plain version on the card."""
        return x.device.type != "cpu" and not has_deep_support(self.model)

    def _check_on_device(self, **tensors: Tensor) -> None:
        for name, t in tensors.items():
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}; the system runs "
                                 f"on {self.device}")

    def _check_params_on_device(self, params: MultibodyParams) -> None:
        self._check_on_device(**{f"params.parameters()[{i}]": leaf
                                 for i, leaf in enumerate(params.parameters())})

    def _require_fused(self) -> None:
        if not self.supports_fused_loss():
            raise ValueError("use_fused=True on a model or solver the fused "
                             "SoA path does not cover (see "
                             "soa_terms.supports_fused)")

    # -- dynamics (vmapped path) -------------------------------------------------
    def _solve_contact(self, delassus: Tensor, M: Tensor, J: Tensor,
                       q_vec: Tensor, eps,
                       budget: Optional[Tuple[int, int]] = None
                       ) -> Tuple[Tensor, Tensor]:
        """The configured cone-QP solve with failure masking: ``(impulse
        (*, 3k), valid (*,))``. ``budget`` overrides the hybrid solve's
        ``(ipm, newton)``."""
        if self.solver == "hybrid":
            ipm, newton = budget or (self.ipm_iterations,
                                     self.newton_iterations)
            return solve_contact_impulse_hybrid(delassus, M, J, q_vec, eps,
                                                ipm, newton)
        return solve_contact_impulse(delassus, q_vec, eps,
                                     self.solver_iterations)

    def _rollout_qp(self, params, q, v, u):
        """Terms at ``(q, v)``, ``v^-`` and the rollout QP's cost vector."""
        delassus, M, J, phi, a_nc = multibody_terms(self.model, params, q,
                                                    v, u)
        phi_then_zero = torch.nn.functional.pad(phi, (0, 2 * phi.shape[-1]))
        v_minus = v + self.dt * a_nc
        q_full = small_matvec(J, v_minus) + phi_then_zero / self.dt
        return delassus, M, J, phi, v_minus, q_full

    def _velocity_update(self, M, J, phi, v_minus, impulse):
        # The contact activation filter (inactive at physical scales).
        active = broadcast_lorentz(phi) <= CONTACT_FILTER_EPS
        impulse = torch.where(active, impulse, torch.zeros_like(impulse))
        return v_minus + spd_solve(M, small_matvec(J.transpose(-1, -2),
                                                   impulse))

    def forward_dynamics(self, params: MultibodyParams, q: Tensor,
                         v: Tensor, u: Tensor) -> Tensor:
        """Next velocity ``v^+ (*, n_v)`` by Anitescu's convex contact
        dynamics at ``q (*, n_q)``, ``v (*, n_v)``, ``u (*, n_u)``, with the
        rollout budget; its gradient comes from the hybrid solve's
        implicit-function theorem (or the APGD's, for ``solver="apgd"``)."""
        delassus, M, J, phi, v_minus, q_full = self._rollout_qp(params, q,
                                                                v, u)
        impulse, _ = self._solve_contact(
            delassus, M, J, q_full, DYNAMICS_EPSILON,
            budget=(DEFAULT_WARM_IPM_ITERATIONS,
                    DEFAULT_WARM_NEWTON_ITERATIONS))
        return self._velocity_update(M, J, phi, v_minus, impulse)

    def forward_dynamics_with_state(self, params: MultibodyParams, q: Tensor,
                                    v: Tensor, u: Tensor, w0: Tensor
                                    ) -> Tuple[Tensor, Tensor]:
        """Warm-started forward dynamics: the hybrid solve starts Newton
        from the better by primal cost of its interior point and the
        carried primal ``w0 (*, n_v)``. Returns ``(v_plus, w)``, ``w`` the
        carry of the next step."""
        _, M, J, phi, v_minus, q_full = self._rollout_qp(params, q, v, u)
        impulse, w = solve_cone_qp_hybrid_warm(
            M, J, q_full, DYNAMICS_EPSILON, w0, DEFAULT_WARM_IPM_ITERATIONS,
            DEFAULT_WARM_NEWTON_ITERATIONS)
        impulse, valid = mask_failures(impulse)
        w = torch.where(valid[..., None], torch.nan_to_num(w),
                        torch.zeros_like(w))
        return self._velocity_update(M, J, phi, v_minus, impulse), w

    def initial_carry(self, x_0: Tensor) -> Tensor:
        """Rollout hidden state: the warm-start primal ``(*, n_v)`` with
        ``warm_start``, else empty."""
        if self.warm_start:
            return x_0.new_zeros(x_0.shape[:-1] + (self.model.n_v,))
        return super().initial_carry(x_0)

    def _partial_step(self, params: MultibodyParams, x: Tensor,
                      carry: Tensor) -> Tuple[Tensor, Tensor]:
        """The velocity integrator's callback."""
        q, v = self.space.q_v(x)
        u = x.new_zeros(x.shape[:-1] + (self.model.n_u,))
        if self.warm_start:
            return self.forward_dynamics_with_state(params, q, v, u, carry)
        return self.forward_dynamics(params, q, v, u), carry

    def sim_step(self, params: MultibodyParams, x: Tensor) -> Tensor:
        """One integration step ``x -> x^+``."""
        x_next, _ = self.integrator.step(params, x, self.initial_carry(x))
        return x_next

    def simulate_batch(self, params: MultibodyParams, x_0: Tensor,
                       steps: int,
                       use_fused: Optional[bool] = None) -> Tensor:
        """Batched rollout ``(*, n_x) -> (*, steps + 1, n_x)``.

        The fused path (the default from ``FUSED_ROLLOUT_MIN_BATCH``
        trajectories, for models it covers) runs one batch-minor step per
        time step (``soa_terms.soa_forward_dynamics_batch``: terms, the
        warm-started hybrid solve on K5 for CUDA tensors, built at first
        use for the model's ``(n_v, k)``; the velocity update), carrying
        the SAP primal ``w``, forward only, under ``torch.no_grad``. The
        vmapped path (``System.simulate_batch``)
        steps :meth:`forward_dynamics` with the batch written out, and
        differentiates through the solves' implicit-function theorem.
        ``x_0`` and ``params`` must lie on the system's device.
        """
        n_batch = _n_batch(tuple(x_0.shape[:-1]))
        if use_fused is None:
            use_fused = (n_batch >= FUSED_ROLLOUT_MIN_BATCH and
                         self.supports_fused_loss())
        self._check_on_device(x_0=x_0)
        self._check_params_on_device(params)
        if not use_fused:
            return super().simulate_batch(params, x_0, steps)
        self._require_fused()

        space = self.space
        dt = self.dt
        x = x_0.reshape(n_batch, x_0.shape[-1])
        w = torch.zeros((n_batch, self.model.n_v), dtype=x.dtype,
                        device=x.device)
        states = [x]
        with torch.no_grad():
            for _ in range(steps):
                v_plus, w = soa_forward_dynamics_batch(
                    self.model, params, x, w, dt, DYNAMICS_EPSILON,
                    CONTACT_FILTER_EPS, DEFAULT_WARM_IPM_ITERATIONS,
                    DEFAULT_WARM_NEWTON_ITERATIONS)
                q_next = space.euler_step(space.q(x), v_plus, dt)
                x = space.x(q_next, v_plus)
                states.append(x)
        trajectory = torch.stack(states, dim=1)
        return trajectory.reshape(tuple(x_0.shape[:-1]) +
                                  (steps + 1, x_0.shape[-1]))

    # -- ContactNets loss --------------------------------------------------------
    def _contactnets_qp(self, params: MultibodyParams, x: Tensor, u: Tensor,
                        x_plus: Tensor):
        """The ContactNets QP pieces of transitions ``(*, n_x)``, terms at
        the observed next state: ``(delassus, q_vec, M, J, phi, dv)``."""
        dt = self.dt
        v = self.space.v(x)
        q_plus, v_plus = self.space.q_v(x_plus)
        delassus, M, J, phi, a_nc = multibody_terms(self.model, params,
                                                    q_plus, v_plus, u)
        k = phi.shape[-1]
        phi_then_zero = torch.nn.functional.pad(phi, (0, 2 * k))
        sliding_velocities = small_matvec(J[..., k:, :], v_plus)  # (*, 2k)
        # Safe norm: at exactly resting contacts the tangential velocity is
        # 0 and the norm's gradient NaN; 1 under the sqrt there (value
        # exact, gradient 0).
        sliding_sq = torch.sum(sliding_velocities.reshape(
            sliding_velocities.shape[:-1] + (k, 2)) ** 2, dim=-1)
        at_rest = sliding_sq < 1e-24
        sliding_speeds = torch.sqrt(torch.where(
            at_rest, torch.ones_like(sliding_sq), sliding_sq))
        sliding_speeds = torch.where(at_rest, torch.zeros_like(
            sliding_speeds), sliding_speeds)

        dv = v_plus - (v + a_nc * dt)
        q_pred = -small_matvec(J, dv)
        q_comp = torch.abs(phi_then_zero)
        q_diss = dt * torch.cat((sliding_speeds, sliding_velocities), dim=-1)
        return delassus, q_pred + q_comp + q_diss, M, J, phi, dv

    def _contactnets_loss_given_force(self, delassus, q_vec, M, phi, dv,
                                      force, valid) -> Tensor:
        """Loss assembly from the QP pieces and a (detached) force:
        ``0.5 f'Qf + f'q_vec + 0.5 dv'M dv + sum max(-phi, 0)^2``, zero
        where the solve failed."""
        k = phi.shape[-1]
        Q = delassus + LOSS_EPSILON * torch.eye(3 * k, dtype=phi.dtype,
                                                device=phi.device)
        penetration = torch.sum(torch.clamp(-phi, min=0.0) ** 2, dim=-1)
        constant = 0.5 * torch.sum(dv * small_matvec(M, dv), dim=-1) + \
            penetration
        loss = 0.5 * torch.sum(force * small_matvec(Q, force), dim=-1) + \
            torch.sum(force * q_vec, dim=-1) + constant
        return torch.where(valid, loss, torch.zeros_like(loss))

    def contactnets_loss(self, params: MultibodyParams, x: Tensor,
                         u: Tensor, x_plus: Tensor) -> Tensor:
        r"""ContactNets implicit loss of transitions ``(*, n_x) -> (*)``
        with the configured solver:

        .. math::
            \tfrac 12 f^T Q f + f^T q_{vec} + \tfrac 12 dv^T M dv +
            \sum \max(-\phi, 0)^2

        with terms at the observed next state and ``f`` the solution of
        the QP, detached (the envelope theorem); failed solves zero the
        sample."""
        delassus, q_vec, M, J, phi, dv = self._contactnets_qp(params, x, u,
                                                              x_plus)
        force, valid = self._solve_contact(
            delassus.detach(), M.detach(), J.detach(), q_vec.detach(),
            LOSS_EPSILON)
        return self._contactnets_loss_given_force(
            delassus, q_vec, M, phi, dv, force.detach(), valid)

    def contactnets_loss_batch(self, params: MultibodyParams, x: Tensor,
                               u: Tensor, x_plus: Tensor,
                               use_fused: Optional[bool] = None,
                               use_apgd_kernel: Optional[bool] = None
                               ) -> Tensor:
        """Batched ContactNets loss ``(*, n_x) -> (*)``.

        Routes, as the JAX package's (``use_apgd_kernel`` stands in for
        its ``use_pallas``):

        * The fused batch-minor path, by default from
          ``FUSED_LOSS_MIN_BATCH`` transitions for models and solvers it
          covers, unless ``use_apgd_kernel`` is given; ``use_fused=True``
          forces it and ignores ``use_apgd_kernel``. Cold budget
          ``(ipm_iterations, newton_iterations)``. CUDA tensors run the
          loss kernel K1 forward and K2 backward
          (``ops/soa_loss_kernels.py``: the box cube's, or the generic ones
          of the elbow's or the polygon cube's size; other models raise);
          ICNN models run the plain version with its cold solve on K4. CPU
          tensors run the plain version (``soa_terms.soa_contactnets_loss``)
          under autograd.
        * The vmapped path otherwise: terms and loss assembly with the
          batch written out, and one detached solve over the batch: the
          APGD kernel K6 at ``solver_iterations`` with
          ``use_apgd_kernel=True`` (whatever ``solver`` is; its plain
          version on the CPU), else the hybrid solve or, for
          ``solver="apgd"``, the lax APGD.
        """
        batch_shape = tuple(x.shape[:-1])
        n_batch = _n_batch(batch_shape)
        if use_fused is None:
            use_fused = (use_apgd_kernel is None and
                         n_batch >= FUSED_LOSS_MIN_BATCH and
                         self.supports_fused_loss())
        elif use_fused:
            self._require_fused()
        self._check_on_device(x=x, u=u, x_plus=x_plus)
        self._check_params_on_device(params)
        x = x.reshape(n_batch, x.shape[-1])
        u = u.reshape(n_batch, u.shape[-1])
        x_plus = x_plus.reshape(n_batch, x_plus.shape[-1])

        if use_fused:
            args = (self.model, params, x, u, x_plus, self.dt, LOSS_EPSILON,
                    self.ipm_iterations, self.newton_iterations)
            if self._loss_kernels(x):
                loss = fused_contactnets_loss_kernel(*args)
            else:
                loss, _, _ = soa_contactnets_loss(*args)
            return loss.reshape(batch_shape)

        delassus, q_vec, M, J, phi, dv = self._contactnets_qp(params, x, u,
                                                              x_plus)
        delassus_sg, q_vec_sg = delassus.detach(), q_vec.detach()
        if use_apgd_kernel:
            force, valid = solve_contact_impulse_cuda(
                delassus_sg, q_vec_sg, LOSS_EPSILON, self.solver_iterations)
        elif self.solver == "hybrid":
            force, valid = solve_contact_impulse_hybrid(
                delassus_sg, M.detach(), J.detach(), q_vec_sg, LOSS_EPSILON,
                self.ipm_iterations, self.newton_iterations)
        else:
            force, valid = solve_contact_impulse(
                delassus_sg, q_vec_sg, LOSS_EPSILON, self.solver_iterations)
        losses = self._contactnets_loss_given_force(
            delassus, q_vec, M, phi, dv, force.detach(), valid)
        return losses.reshape(batch_shape)

    def contactnets_loss_batch_warm(
            self, params: MultibodyParams, x: Tensor, u: Tensor,
            x_plus: Tensor, force_prev: Tensor,
            budget: Optional[Tuple[int, int]] = None
            ) -> Tuple[Tensor, Tensor]:
        """Epoch-warm-started batched ContactNets loss, on the fused path
        only.

        Training revisits every sample each epoch with parameters moved by
        one optimizer step, so the previous visit's impulse is a near
        solution: the solve warm-starts from it at the reduced ``budget``
        (default ``DEFAULT_LOSS_WARM_BUDGET``). ``force_prev`` is the
        ``(3, k, n_batch)`` impulse cache (zeros for cold samples). Returns
        ``(loss (*batch,), force (3, k, n_batch))``, ``force`` the
        detached refreshed cache. CUDA tensors run the kernel K3 forward
        and K2 backward (the models of ``contactnets_loss_batch``'s loss
        kernels), or, for ICNN models, the plain version with its warm
        solve on the kernel K5; CPU tensors the plain version
        (``soa_terms.soa_contactnets_loss_warm``).

        The cache is seeded, as ``bench.py`` seeds it, by a call from zeros
        at the cold budget, ``budget=(DEFAULT_LOSS_IPM_ITERATIONS,
        DEFAULT_LOSS_NEWTON_ITERATIONS)``.
        """
        self._require_fused()
        ipm, newton = budget or DEFAULT_LOSS_WARM_BUDGET
        batch_shape = tuple(x.shape[:-1])
        n_batch = _n_batch(batch_shape)
        self._check_on_device(x=x, u=u, x_plus=x_plus, force_prev=force_prev)
        self._check_params_on_device(params)
        x = x.reshape(n_batch, x.shape[-1])
        u = u.reshape(n_batch, u.shape[-1])
        x_plus = x_plus.reshape(n_batch, x_plus.shape[-1])
        force_prev = force_prev.reshape(3, -1, n_batch)
        args = (self.model, params, x, u, x_plus, self.dt, LOSS_EPSILON, ipm,
                newton)
        if self._loss_kernels(x):
            loss, force = fused_contactnets_loss_kernel_warm(*args,
                                                             force_prev)
        else:
            loss, force, _ = soa_contactnets_loss_warm(
                *args, list(force_prev.unbind(0)))
            force = torch.stack(force)
        return loss.reshape(batch_shape), force

    # -- logging ---------------------------------------------------------------
    def summary(self, params: MultibodyParams,
                statistics: Dict) -> SystemSummary:
        """Physical-parameter scalars and learned meshes
        (``summaries.multibody_summary``)."""
        del statistics
        from dair_pll_tpu_torch.summaries import multibody_summary
        return multibody_summary(self.model, params)
