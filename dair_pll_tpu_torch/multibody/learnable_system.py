r"""Learnable multibody system: fused rollouts and the ContactNets loss
(PyTorch).

Counterpart of the rollout part of
``dair_pll_tpu/multibody/learnable_system.py``. The next-step contact
impulse solves Anitescu's dual QCQP

.. math::
    \min_{f \in FC} \tfrac 12 f^T D(q) f + f^T (J(q) v^- + [I;0]\phi/dt)

over the product friction cone, with ``v^- = v + dt a_nc`` and
``v^+ = v^- + M^{-1} J^T f``. Parameters are passed in on every call, as
in the JAX package; the system holds only the model, the time step and
the device.

Ported: the fused batch-minor rollout (``simulate_batch`` with
``use_fused``), whose every step runs the hand-written CUDA solve kernel
K5 on the card, and the fused ContactNets loss (``contactnets_loss_batch``,
cold, and ``contactnets_loss_batch_warm``, epoch-warm). On the card the
box cube's loss runs one CUDA kernel forward and one backward per step
(K1 or K3, and K2); a model with deep-support (ICNN) geometry runs the
plain terms and assembly under autograd with the detached solve as one
CUDA kernel (K4 cold, K5 warm). A training step is the mean loss,
``backward`` and a ``torch.optim.Adam`` step on ``params.parameters()``.
Not ported yet: the vmapped integrator and loss paths.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from dair_pll_tpu_torch.multibody.model import MultibodyModel, MultibodyParams
from dair_pll_tpu_torch.multibody.soa_terms import (
    has_deep_support, soa_contactnets_loss, soa_contactnets_loss_warm,
    soa_forward_dynamics_batch, supports_fused)
from dair_pll_tpu_torch.ops.soa_loss_kernels import (
    fused_contactnets_loss_kernel, fused_contactnets_loss_kernel_warm)

DYNAMICS_EPSILON = 1e-4    # dynamics QP regularization
CONTACT_FILTER_EPS = 1e6   # phi activation threshold
#: (ipm, newton) budget of warm-started rollout solves. The JAX package
#: measured that fresh impacts need the full 14-step central path: at
#: (10, 6) grazing-contact QPs keep 1.7e-3 impulse error, at (14, 6) the
#: error is at machine precision.
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

_VMAPPED_NOT_PORTED = (
    "the vmapped integrator rollout (use_fused=False, and the default "
    "below FUSED_ROLLOUT_MIN_BATCH) is not ported to dair_pll_tpu_torch yet "
    "(ROADMAP.md, Queue 1: 'Vmapped simulation and IFT gradients'); pass "
    "use_fused=True")
_VMAPPED_LOSS_NOT_PORTED = (
    "the vmapped ContactNets loss (use_fused=False, and the default below "
    "FUSED_LOSS_MIN_BATCH) is not ported to dair_pll_tpu_torch yet "
    "(ROADMAP.md, Queue 1: 'Vmapped simulation and IFT gradients'); pass "
    "use_fused=True")


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


class MultibodyLearnableSystem:
    """Contact-dynamics system with learnable inertia, friction and
    geometry; parameters (:class:`MultibodyParams`) are passed in."""

    model: MultibodyModel
    dt: float

    def __init__(self, model: MultibodyModel, dt: float,
                 device=None) -> None:
        self.model = model
        self.dt = dt
        self.device = resolve_device(device)
        self.space = model.state_space()

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
        """Whether the batch-minor fused SoA path covers this model."""
        return supports_fused(self.model)

    def _loss_kernels(self, x: Tensor) -> bool:
        """Whether the loss runs the fused loss kernels (K1-K3): on CUDA
        tensors, except for ICNN models, whose loss runs the plain terms
        with the solve kernels (K4, K5), as the JAX package runs them
        through XLA with its solve kernels. The kernels raise for other
        models they do not cover."""
        return x.device.type != "cpu" and not has_deep_support(self.model)

    def _check_on_device(self, **tensors: Tensor) -> None:
        for name, t in tensors.items():
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}; the system runs "
                                 f"on {self.device}")

    def _check_params_on_device(self, params: MultibodyParams) -> None:
        self._check_on_device(**{f"params.parameters()[{i}]": leaf
                                 for i, leaf in enumerate(params.parameters())})

    def _flat_transitions(self, params: MultibodyParams, x: Tensor,
                          u: Tensor, x_plus: Tensor,
                          use_fused: Optional[bool]):
        """Flattens ``(*, n)`` batches and checks the route: the fused
        path only, with the parameters and the states on this system's
        device."""
        batch_shape = tuple(x.shape[:-1])
        n_batch = int(np.prod(batch_shape)) if batch_shape else 1
        if use_fused is None:
            use_fused = (n_batch >= FUSED_LOSS_MIN_BATCH and
                         self.supports_fused_loss())
        if not use_fused:
            raise NotImplementedError(_VMAPPED_LOSS_NOT_PORTED)
        if not self.supports_fused_loss():
            raise ValueError("use_fused=True on a model the fused SoA path "
                             "does not cover (see soa_terms.supports_fused)")
        self._check_on_device(x=x, u=u, x_plus=x_plus)
        self._check_params_on_device(params)
        return (batch_shape, x.reshape(n_batch, x.shape[-1]),
                u.reshape(n_batch, u.shape[-1]),
                x_plus.reshape(n_batch, x_plus.shape[-1]))

    def contactnets_loss_batch(self, params: MultibodyParams, x: Tensor,
                               u: Tensor, x_plus: Tensor,
                               use_fused: Optional[bool] = None) -> Tensor:
        """Batched ContactNets loss ``(*, n_x) -> (*,)`` on the fused
        batch-minor path, with the cold solve budget
        ``(DEFAULT_LOSS_IPM_ITERATIONS, DEFAULT_LOSS_NEWTON_ITERATIONS)``.

        CUDA tensors run the loss kernel K1 forward and K2 backward
        (``ops/soa_loss_kernels.py``), float32 or float64; ICNN models run
        the plain version with its cold solve on the kernel K4; other
        models outside the kernels' instantiation raise. CPU tensors run
        the plain version (``soa_terms.soa_contactnets_loss``) under torch
        autograd.
        """
        batch_shape, x, u, x_plus = self._flat_transitions(
            params, x, u, x_plus, use_fused)
        args = (self.model, params, x, u, x_plus, self.dt, LOSS_EPSILON,
                DEFAULT_LOSS_IPM_ITERATIONS, DEFAULT_LOSS_NEWTON_ITERATIONS)
        if self._loss_kernels(x):
            loss = fused_contactnets_loss_kernel(*args)
        else:
            loss, _, _ = soa_contactnets_loss(*args)
        return loss.reshape(batch_shape)

    def contactnets_loss_batch_warm(
            self, params: MultibodyParams, x: Tensor, u: Tensor,
            x_plus: Tensor, force_prev: Tensor,
            budget: Optional[Tuple[int, int]] = None
            ) -> Tuple[Tensor, Tensor]:
        """Epoch-warm-started batched ContactNets loss.

        Training revisits every sample each epoch with parameters moved by
        one optimizer step, so the previous visit's impulse is a near
        solution: the solve warm-starts from it at the reduced ``budget``
        (default ``DEFAULT_LOSS_WARM_BUDGET``). ``force_prev`` is the
        ``(3, k, n_batch)`` impulse cache (zeros for cold samples). Returns
        ``(loss (*batch,), force (3, k, n_batch))``, ``force`` the
        detached refreshed cache. CUDA tensors run the kernel K3 forward
        and K2 backward, or, for ICNN models, the plain version with its
        warm solve on the kernel K5; CPU tensors the plain version
        (``soa_terms.soa_contactnets_loss_warm``).

        The cache is seeded, as ``bench.py`` seeds it, by a call from zeros
        at the cold budget, ``budget=(DEFAULT_LOSS_IPM_ITERATIONS,
        DEFAULT_LOSS_NEWTON_ITERATIONS)``.
        """
        ipm, newton = budget or DEFAULT_LOSS_WARM_BUDGET
        batch_shape, x, u, x_plus = self._flat_transitions(
            params, x, u, x_plus, True)
        self._check_on_device(force_prev=force_prev)
        force_prev = force_prev.reshape(3, -1, x.shape[0])
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

    def simulate_batch(self, params: MultibodyParams, x_0: Tensor,
                       steps: int,
                       use_fused: Optional[bool] = None) -> Tensor:
        """Batched rollout ``(*, n_x) -> (*, steps + 1, n_x)``.

        The fused path runs one batch-minor step per time step
        (``soa_terms.soa_forward_dynamics_batch``: terms, the
        warm-started hybrid solve, the velocity update), carrying the SAP
        primal ``w`` from step to step. The rollout is forward only and
        runs under ``torch.no_grad``. ``x_0`` and ``params`` must lie on
        the system's device.
        """
        batch_shape = tuple(x_0.shape[:-1])
        n_batch = int(np.prod(batch_shape)) if batch_shape else 1
        if use_fused is None:
            use_fused = (n_batch >= FUSED_ROLLOUT_MIN_BATCH and
                         self.supports_fused_loss())
        if not use_fused:
            raise NotImplementedError(_VMAPPED_NOT_PORTED)
        if not self.supports_fused_loss():
            raise ValueError("use_fused=True on a model the fused SoA path "
                             "does not cover (see soa_terms.supports_fused)")
        self._check_on_device(x_0=x_0)
        self._check_params_on_device(params)

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
        return trajectory.reshape(
            batch_shape + (steps + 1, x_0.shape[-1]))
