r"""Unscented Kalman filter on manifolds (UKF-M) (PyTorch).

Counterpart of ``dair_pll_tpu/ukf.py`` (reference ``ukf.py:6-216``, the
Brossard et al. UKF-M). The JAX package ``vmap``-s the callbacks over the
stacked sigma points; here the sigma points are a leading batch dimension,
so the callbacks ``f``, ``h``, ``phi`` and ``phi_inv`` take inputs with
leading batch dimensions (the mean's calls have none). Filtering a
measurement sequence is a loop (:meth:`ManifoldUKF.filter_trajectory`).

The filter acts on any :class:`~dair_pll_tpu_torch.state_space.StateSpace`
through its exponential and difference maps
(:func:`state_space_retractions`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch
from torch import Tensor

#: Jitter added to covariances before their Cholesky factors.
TOL = 1e-9


class SigmaWeights(NamedTuple):
    """Unscented-transform weights of one dimension and spread (reference
    ``ukf.py:81-87``)."""
    sqrt_d_lambda: float
    wj: float
    wm: float
    w0: float


def sigma_weights(dim: int, alpha: float) -> SigmaWeights:
    """Sigma-point weights of a dimension, in Python floats."""
    m = (alpha**2 - 1.0) * dim
    return SigmaWeights(
        sqrt_d_lambda=math.sqrt(dim + m),
        wj=1.0 / (2.0 * (dim + m)),
        wm=m / (m + dim),
        w0=m / (m + dim) + 3.0 - alpha**2,
    )


def _expand(state: Tensor, n: int) -> Tensor:
    """``state`` repeated along a new leading axis of ``n`` sigma points."""
    return state.unsqueeze(0).expand((n,) + tuple(state.shape))


@dataclasses.dataclass(frozen=True)
class ManifoldUKF:
    """Functional UKF-M.

    Attributes:
        f: propagation ``f(state, omega, w, dt) -> state`` (``w`` the noise
          input).
        h: observation ``h(state) -> (*, l)``.
        phi: retraction ``phi(state, xi) -> state``.
        phi_inv: inverse retraction ``phi_inv(state_1, state_2) -> xi``.
        Q: ``(q, q)`` propagation noise covariance.
        R: ``(l, l)`` observation noise covariance.
        alpha: three sigma-point spreads (state propagation, noise
          propagation, update).
        d: state-uncertainty dimension.
    """
    f: Callable
    h: Callable
    phi: Callable
    phi_inv: Callable
    Q: Any
    R: Any
    alpha: Tuple[float, float, float]
    d: int

    def _weights(self):
        q = self.Q.shape[0]
        return (sigma_weights(self.d, self.alpha[0]),
                sigma_weights(q, self.alpha[1]),
                sigma_weights(self.d, self.alpha[2]))

    def propagation(self, state: Tensor, P: Tensor, omega: Any,
                    dt: float) -> Tuple[Tensor, Tensor]:
        """Mean and covariance propagation (reference ``ukf.py:90-164``);
        returns ``(new_state, new_P)``."""
        d = self.d
        Q = torch.as_tensor(self.Q, dtype=P.dtype, device=P.device)
        q = Q.shape[0]
        w_d, w_q, _ = self._weights()
        P = P + TOL * torch.eye(d, dtype=P.dtype, device=P.device)
        zero_noise = P.new_zeros((q,))

        new_state = self.f(state, omega, zero_noise, dt)

        # The covariance from the state's uncertainty.
        xis = w_d.sqrt_d_lambda * torch.linalg.cholesky(P).T   # (d, d) rows
        xis_pm = torch.cat((xis, -xis), dim=0)                  # (2d, d)
        sigma = self.phi(_expand(state, 2 * d), xis_pm)
        new_xis = self.phi_inv(
            _expand(new_state, 2 * d),
            self.f(sigma, omega, _expand(zero_noise, 2 * d), dt))
        mean_xi = w_d.wj * torch.sum(new_xis, dim=0)
        centered = new_xis - mean_xi
        new_P = (w_d.wj * centered.T @ centered +
                 w_d.w0 * torch.outer(mean_xi, mean_xi))

        # The covariance from the propagation noise.
        noise_rows = w_q.sqrt_d_lambda * torch.linalg.cholesky(Q).T
        noise_pm = torch.cat((noise_rows, -noise_rows), dim=0)   # (2q, q)
        noise_xis = self.phi_inv(
            _expand(new_state, 2 * q),
            self.f(_expand(state, 2 * q), omega, noise_pm, dt))
        mean_noise = w_q.wj * torch.sum(noise_xis, dim=0)
        centered_noise = noise_xis - mean_noise
        Q_cov = (w_q.wj * centered_noise.T @ centered_noise +
                 w_q.w0 * torch.outer(mean_noise, mean_noise))
        return new_state, new_P + Q_cov

    def update(self, state: Tensor, P: Tensor,
               y: Tensor) -> Tuple[Tensor, Tensor]:
        """Measurement update (reference ``ukf.py:166-216``); returns
        ``(updated_state, updated_P)``."""
        d = self.d
        R = torch.as_tensor(self.R, dtype=P.dtype, device=P.device)
        _, _, w_u = self._weights()
        P = P + TOL * torch.eye(d, dtype=P.dtype, device=P.device)

        xis = w_u.sqrt_d_lambda * torch.linalg.cholesky(P).T
        xis_pm = torch.cat((xis, -xis), dim=0)                  # (2d, d)

        hat_y = self.h(state)
        ys = self.h(self.phi(_expand(state, 2 * d), xis_pm))

        y_bar = w_u.wm * hat_y + w_u.wj * torch.sum(ys, dim=0)
        ys_centered = ys - y_bar
        hat_y_centered = hat_y - y_bar

        P_yy = (w_u.w0 * torch.outer(hat_y_centered, hat_y_centered) +
                w_u.wj * ys_centered.T @ ys_centered + R)
        P_xiy = w_u.wj * xis_pm.T @ ys_centered

        K = torch.linalg.solve(P_yy, P_xiy.T).T
        xi_plus = K @ (y - y_bar)
        new_state = self.phi(state, xi_plus)
        new_P = P - K @ P_yy @ K.T
        return new_state, 0.5 * (new_P + new_P.T)

    def step(self, state: Tensor, P: Tensor, omega: Any, y: Tensor,
             dt: float) -> Tuple[Tensor, Tensor]:
        """One propagate-then-update cycle."""
        state, P = self.propagation(state, P, omega, dt)
        return self.update(state, P, y)

    def filter_trajectory(self, state_0: Tensor, P_0: Tensor, omegas: Any,
                          ys: Tensor, dt: float) -> Tuple[Tensor, Tensor]:
        """Filters a measurement sequence ``ys (T, l)`` with inputs
        ``omegas`` (leading dimension ``T``); returns the filtered states
        ``(T, ...)`` and covariances ``(T, d, d)``."""
        state, P = state_0, P_0
        states, Ps = [], []
        for t in range(ys.shape[0]):
            state, P = self.step(state, P, omegas[t], ys[t], dt)
            states.append(state)
            Ps.append(P)
        return torch.stack(states), torch.stack(Ps)


def state_space_retractions(space) -> Tuple[Callable, Callable]:
    """``(phi, phi_inv)`` from a state space's Lie structure: ``phi(x, xi)
    = shift_state(x, xi)``, ``phi_inv(x1, x2) = state_difference(x1,
    x2)``."""
    return space.shift_state, space.state_difference
