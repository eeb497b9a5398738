r"""Jacobian-inferring manifold UKF (JUKF) (PyTorch).

Counterpart of ``dair_pll_tpu/jukf.py`` (reference ``ukf.py:219-591``).
Instead of propagating the full covariance through sigma points, the JUKF
infers the EKF Jacobians ``F``, ``G`` and ``H`` numerically from sigma
points over a reduced subset of the uncertainty coordinates. As in
:mod:`dair_pll_tpu_torch.ukf`, the sigma points are a leading batch
dimension of the callbacks' inputs; the reduced and update index subsets
are tuples; several measurements stack by concatenating ``H`` rows and
``r`` entries with a block-diagonal ``R`` (:meth:`JUKF.state_update`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch
from torch import Tensor

from dair_pll_tpu_torch.ukf import TOL, _expand, sigma_weights


def _as(value, like: Tensor) -> Tensor:
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class JUKF:
    """Functional Jacobian-inferring UKF.

    Attributes:
        f: propagation ``f(state, omega, w, dt) -> state``.
        h: observation ``h(state) -> (*, l)``.
        phi: full-state retraction ``phi(state, xi_full) -> state``.
        Q: ``(q, q)`` propagation noise covariance.
        alpha: five sigma spreads (reduced propagation, noise, update,
          augmentation state, augmentation noise; reference
          ``ukf.py:295-321``).
        d: full uncertainty dimension.
        red_idxs: indices of the coordinates active in propagation.
        red_phi, red_phi_inv: reduced retraction and its inverse.
        up_idxs: indices of the coordinates active in updates.
        up_phi: update retraction.
    """
    f: Callable
    h: Callable
    phi: Callable
    Q: Any
    alpha: Tuple[float, float, float, float, float]
    d: int
    red_idxs: Tuple[int, ...]
    red_phi: Callable
    red_phi_inv: Callable
    up_idxs: Tuple[int, ...]
    up_phi: Callable

    def propagation(self, state: Tensor, P: Tensor, omega: Any,
                    dt: float) -> Tuple[Tensor, Tensor]:
        """EKF-style covariance propagation with numerically inferred ``F``
        and ``G`` (reference ``ukf.py:367-435``)."""
        Q = _as(self.Q, P)
        zero_noise = P.new_zeros((Q.shape[0],))
        new_state = self.f(state, omega, zero_noise, dt)
        F = self._F_num(state, new_state, P, omega, dt)
        G = self._G_num(state, new_state, omega, dt, Q)
        new_P = F @ P @ F.T + G @ Q @ G.T
        return new_state, 0.5 * (new_P + new_P.T)

    def _F_num(self, state, new_state, P: Tensor, omega, dt) -> Tensor:
        red = torch.as_tensor(self.red_idxs, device=P.device)
        red_d = len(self.red_idxs)
        w_d = sigma_weights(red_d, self.alpha[0])
        eye = torch.eye(red_d, dtype=P.dtype, device=P.device)
        P_red = P[red][:, red] + TOL * eye
        zero_noise = P.new_zeros((_as(self.Q, P).shape[0],))

        xis = w_d.sqrt_d_lambda * torch.linalg.cholesky(P_red).T
        xis_pm = torch.cat((xis, -xis), dim=0)
        n = xis_pm.shape[0]
        sigma = self.red_phi(_expand(state, n), xis_pm)
        new_xis = self.red_phi_inv(
            _expand(new_state, n),
            self.f(sigma, omega, _expand(zero_noise, n), dt))
        mean = w_d.wj * torch.sum(new_xis, dim=0)
        centered = new_xis - mean
        Xi = w_d.wj * centered.T @ xis_pm
        F_red = torch.linalg.solve(P_red, Xi.T).T
        F = torch.eye(self.d, dtype=P.dtype, device=P.device)
        F[red.unsqueeze(1), red.unsqueeze(0)] = F_red
        return F

    def _G_num(self, state, new_state, omega, dt, Q: Tensor) -> Tensor:
        q_dim = Q.shape[0]
        w_q = sigma_weights(q_dim, self.alpha[1])
        noise_rows = w_q.sqrt_d_lambda * torch.linalg.cholesky(Q).T
        noise_pm = torch.cat((noise_rows, -noise_rows), dim=0)
        n = noise_pm.shape[0]
        new_xis = self.red_phi_inv(
            _expand(new_state, n),
            self.f(_expand(state, n), omega, noise_pm, dt))
        mean = w_q.wj * torch.sum(new_xis, dim=0)
        centered = new_xis - mean
        Xi = w_q.wj * centered.T @ noise_pm
        G_red = torch.linalg.solve(Q, Xi.T).T
        G = Q.new_zeros((self.d, q_dim))
        G[torch.as_tensor(self.red_idxs, device=Q.device)] = G_red
        return G

    def H_num(self, state: Tensor, P: Tensor,
              y: Tensor) -> Tuple[Tensor, Tensor]:
        """Numerically inferred measurement Jacobian ``H`` and residual
        (reference ``ukf.py:446-490``)."""
        up = torch.as_tensor(self.up_idxs, device=P.device)
        up_d = len(self.up_idxs)
        w_u = sigma_weights(up_d, self.alpha[2])
        eye = torch.eye(up_d, dtype=P.dtype, device=P.device)
        P_up = P[up][:, up] + TOL * eye

        xis = w_u.sqrt_d_lambda * torch.linalg.cholesky(P_up).T
        xis_pm = torch.cat((xis, -xis), dim=0)
        hat_y = self.h(state)
        ys = self.h(self.up_phi(_expand(state, xis_pm.shape[0]), xis_pm))

        y_bar = w_u.wm * hat_y + w_u.wj * torch.sum(ys, dim=0)
        centered = ys - y_bar
        Y = w_u.wj * centered.T @ xis_pm
        H_up = torch.linalg.solve(P_up, Y.T).T
        H = P.new_zeros((y.shape[0], self.d))
        H[:, up] = H_up
        return H, y - y_bar

    def state_update(self, state: Tensor, P: Tensor, H: Tensor, r: Tensor,
                     R: Tensor) -> Tuple[Tensor, Tensor]:
        """Kalman update from inferred Jacobians (reference
        ``ukf.py:492-513``)."""
        S = H @ P @ H.T + R
        K = torch.linalg.solve(S, (P @ H.T).T).T
        new_state = self.phi(state, K @ r)
        new_P = (torch.eye(self.d, dtype=P.dtype, device=P.device) -
                 K @ H) @ P
        return new_state, 0.5 * (new_P + new_P.T)

    def update(self, state: Tensor, P: Tensor, y: Tensor,
               R: Tensor) -> Tuple[Tensor, Tensor]:
        """Single-measurement update."""
        H, r = self.H_num(state, P, y)
        return self.state_update(state, P, H, r, R)

    def step(self, state: Tensor, P: Tensor, omega: Any, y: Tensor,
             R: Tensor, dt: float) -> Tuple[Tensor, Tensor]:
        """One propagate-then-update cycle."""
        state, P = self.propagation(state, P, omega, dt)
        return self.update(state, P, y, R)
