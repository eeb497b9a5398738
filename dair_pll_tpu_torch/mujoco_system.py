r"""MuJoCo-backed oracle systems for cross-validation studies (PyTorch
port; the simulator is MuJoCo's C library on the host).

Counterpart of ``dair_pll_tpu/mujoco_system.py`` (reference
``mujoco_system.py:17-463``, on the ``mujoco`` bindings):

* :class:`MuJoCoSystem`: a soft-contact ground-truth simulator whose
  ``solref`` is templated from (stiffness, damping ratio) as the reference
  does (``mujoco_system.py:55-68``). It steps on the host, one trajectory
  at a time, on numpy states (``host_stepped``).
* :class:`MuJoCoUKFSystem`: a UKF-smoothing oracle. The manifold UKF
  (:class:`~dair_pll_tpu_torch.ukf.ManifoldUKF`) with the MuJoCo step as
  its propagation model estimates the state from noisy measurements; with
  ``bias=True`` it also estimates a static configuration bias.
  ``mll_estimate`` fits the initial state by Nelder-Mead (scipy).

``mujoco`` is imported when a system is built, not with this module;
without it the constructor raises ``ImportError``. The Lie-group maps run
in float64 on the CPU through the port's state space.

State conversion: MuJoCo lays free-joint coordinates out as ``[pos(3),
quat(4), joints]`` and velocities as ``[v_world(3), omega_body(3),
rates]``; the state space uses ``[quat, pos, joints]`` and ``[omega_body,
v_world, rates]`` (reference ``mujoco_system.py:17-42``).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from dair_pll_tpu_torch import state_space as space_mod
from dair_pll_tpu_torch.integrator import Integrator
from dair_pll_tpu_torch.system import System
from dair_pll_tpu_torch.ukf import TOL, ManifoldUKF, sigma_weights

SENSE_VELOCITY = True


def _import_mujoco():
    try:
        import mujoco
    except ImportError as error:
        raise ImportError("the MuJoCo systems need the 'mujoco' package, "
                          "which is not installed") from error
    return mujoco


def mujoco_to_state(qpos: np.ndarray, qvel: np.ndarray) -> np.ndarray:
    """MuJoCo ``(qpos, qvel)`` to the state-space layout."""
    pos, quat, joints = qpos[:3], qpos[3:7], qpos[7:]
    v_lin, omega, v_joints = qvel[:3], qvel[3:6], qvel[6:]
    return np.concatenate((quat, pos, joints, omega, v_lin, v_joints))


def state_to_mujoco(x: np.ndarray, n_joints: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The state-space layout to MuJoCo ``(qpos, qvel)``."""
    n_q = 7 + n_joints
    q, v = x[:n_q], x[n_q:]
    qpos = np.concatenate((q[4:7], q[:4], q[7:]))
    qvel = np.concatenate((v[3:6], v[:3], v[6:]))
    return qpos, qvel


def solref_args(stiffness: float, damping_ratio: float,
                v200: bool) -> Tuple[float, float]:
    """(stiffness, damping ratio) to MuJoCo ``solref`` arguments in both
    of the reference's conventions (``mujoco_system.py:55-68``): the
    time-constant form, and the direct negative stiffness/damping form of
    MuJoCo 2.0 and later."""
    if v200:
        total_damping = damping_ratio * 2.0 * np.sqrt(stiffness)
        return -stiffness, -total_damping
    time_constant = 1.0 / (damping_ratio * np.sqrt(stiffness))
    return time_constant, damping_ratio


class MuJoCoSystem(System):
    """Soft-contact MuJoCo simulator as a host-stepped :class:`System`
    oracle; its parameters are ``None`` (the C library owns its state)."""

    host_stepped = True

    def __init__(self, mjcf: str, dt: float, stiffness: float,
                 damping_ratio: float, v200: bool = False) -> None:
        mujoco = _import_mujoco()
        self._mujoco = mujoco
        arg1, arg2 = solref_args(stiffness, damping_ratio, v200)
        with open(mjcf, "r", encoding="utf-8") as handle:
            xml = (handle.read()
                   .replace("$solrefarg1", str(arg1))
                   .replace("$solrefarg2", str(arg2))
                   .replace("$dt", str(dt)))
        self.mj_model = mujoco.MjModel.from_xml_string(xml)
        self.mj_data = mujoco.MjData(self.mj_model)
        n_joints = self.mj_model.nq - 7
        space = space_mod.FloatingBaseSpace(n_joints)
        super().__init__(space, Integrator(space, self._partial_step, dt,
                                           "state"))
        self.n_joints = n_joints

    def _partial_step(self, params: Any, x, carry):
        raise NotImplementedError("MuJoCo steps on the host: use simulate()")

    # -- the state space's maps on numpy states, in float64 on the CPU ------
    def _shift(self, x: np.ndarray, dx: np.ndarray) -> np.ndarray:
        return self.space.shift_state(
            torch.as_tensor(np.asarray(x, np.float64)),
            torch.as_tensor(np.asarray(dx, np.float64))).numpy()

    def _difference(self, x_1: np.ndarray, x_2: np.ndarray) -> np.ndarray:
        return self.space.state_difference(
            torch.as_tensor(np.asarray(x_1, np.float64)),
            torch.as_tensor(np.asarray(x_2, np.float64))).numpy()

    def step_state(self, x: np.ndarray) -> np.ndarray:
        """One MuJoCo step from a state-space state."""
        mujoco = self._mujoco
        qpos, qvel = state_to_mujoco(np.asarray(x, np.float64),
                                     self.n_joints)
        self.mj_data.qpos[:] = qpos
        self.mj_data.qvel[:] = qvel
        mujoco.mj_forward(self.mj_model, self.mj_data)
        mujoco.mj_step(self.mj_model, self.mj_data)
        return mujoco_to_state(self.mj_data.qpos, self.mj_data.qvel)

    def simulate(self, params: Any, x_0, steps: int,
                 carry_0: Optional[Any] = None,
                 remat: bool = False) -> np.ndarray:
        """Host rollout ``(n_x,) -> (steps + 1, n_x)``, float64."""
        del params, carry_0, remat
        trajectory = [np.asarray(x_0, np.float64)]
        for _ in range(steps):
            trajectory.append(self.step_state(trajectory[-1]))
        return np.stack(trajectory)

    def simulate_batch(self, params: Any, x_0, steps: int) -> np.ndarray:
        """Host rollouts ``(*, n_x) -> (*, steps + 1, n_x)``, one after
        another."""
        x_0 = np.asarray(x_0)
        flat = x_0.reshape(-1, x_0.shape[-1])
        rollouts = np.stack([self.simulate(params, x, steps) for x in flat])
        return rollouts.reshape(x_0.shape[:-1] + rollouts.shape[1:])


class MuJoCoUKFSystem(MuJoCoSystem):
    """UKF-smoothing oracle over the MuJoCo model (reference
    ``MuJoCoUKFSystem``, ``mujoco_system.py:122-463``): the propagation
    model is the MuJoCo step perturbed on the state space's Lie algebra,
    and the measurements are the states' log coordinates.

    With ``bias=True`` the filter state appends an estimated static
    configuration bias to the sensed state (reference BIAS mode,
    ``mujoco_system.py:117-119, 252-372``, ``BIAS_VEL=False,
    SENSE_BIAS=True``): physics steps the de-biased state, the bias is a
    random constant, and the measurement observes the sensed state's log
    coordinates and a zero pseudo-measurement of the bias.
    """

    def __init__(self, mjcf: str, dt: float, stiffness: float,
                 damping_ratio: float, v200: bool = False,
                 P0: Optional[np.ndarray] = None,
                 R: Optional[np.ndarray] = None,
                 bias: bool = False) -> None:
        super().__init__(mjcf, dt, stiffness, damping_ratio, v200)
        self.bias = bias
        n_tan = (3 if bias else 2) * self.space.n_v
        self.P0 = np.eye(n_tan) if P0 is None else np.asarray(P0)
        self.R = np.eye(n_tan) * 1e-2 if R is None else np.asarray(R)

    @staticmethod
    def noise_stds_to_P0_R_stds(static_stds: np.ndarray,
                                dynamic_std: np.ndarray, dt: float,
                                bias: bool = False
                                ) -> Tuple[np.ndarray, np.ndarray]:
        """Data-noise standard deviations to the UKF's P0 and R diagonals
        (reference ``mujoco_system.py:126-160``). Without bias the
        configuration noise composes the static and dynamic stds and the
        velocity noise is the dynamic std's finite-difference
        amplification; with bias the dynamic std alone drives the state
        block, and the static std is the bias's prior and
        pseudo-measurement std."""
        nv = static_stds.size // 2
        if bias:
            composite = dynamic_std[:nv]
            state0 = np.concatenate(
                (composite, dynamic_std[:nv] * np.sqrt(2.0 / dt)))
            bias0 = static_stds + 1e-8
            P0_diag = np.concatenate((state0, bias0[:nv]))
            R_diag = P0_diag.copy() if SENSE_VELOCITY \
                else composite.copy()
            return P0_diag, R_diag
        config_noise = np.sqrt(static_stds**2 + dynamic_std**2)[:nv]
        P0_diag = np.concatenate(
            (config_noise, dynamic_std[:nv] * np.sqrt(2.0 / dt)))
        R_diag = P0_diag.copy() if SENSE_VELOCITY else config_noise.copy()
        return P0_diag, R_diag

    def _build_ukf(self) -> ManifoldUKF:
        """The state filter, with numpy callbacks of single states (run by
        :func:`_host_propagate_update`)."""
        zero = self.space.zero_state(torch.float64).numpy()

        def f(state, omega, w, dt):
            del omega, dt
            return self.step_state(self._shift(state, w))

        def h(state):
            return self._difference(zero, state)

        n_v2 = 2 * self.space.n_v
        return ManifoldUKF(
            f=f, h=h, phi=self._shift, phi_inv=self._difference,
            Q=1e-10 * np.eye(n_v2), R=self.R, alpha=(0.1, 0.1, 0.1), d=n_v2)

    def _build_bias_ukf(self) -> ManifoldUKF:
        """The bias-augmented filter: state ``[x (n_x), b (n_v)]``, tangent
        ``[dx (2 n_v), db (n_v)]`` (reference ``ukf_bias_estimate``,
        ``mujoco_system.py:252-372``)."""
        nv = self.space.n_v
        n_x = self.space.n_x
        zero = self.space.zero_state(torch.float64).numpy()

        def phi(state, delta):
            x, b = state[:n_x], state[n_x:]
            dx, db = delta[:2 * nv], delta[2 * nv:]
            return np.concatenate((self._shift(x, dx), b + db))

        def phi_inv(s1, s2):
            dx = self._difference(s1[:n_x], s2[:n_x])
            return np.concatenate((dx, s2[n_x:] - s1[n_x:]))

        def f(state, omega, w, dt):
            del omega, dt
            state = phi(state, w)
            x, b = state[:n_x], state[n_x:]
            # De-bias the sensed configuration, step the physics, re-bias;
            # the bias is a random constant.
            shift = np.concatenate((b, np.zeros_like(b)))
            real_next = self.step_state(self._shift(x, shift))
            return np.concatenate((self._shift(real_next, -shift), b))

        def h(state):
            x, b = state[:n_x], state[n_x:]
            return np.concatenate((self._difference(zero, x), b))

        d = 3 * nv
        return ManifoldUKF(
            f=f, h=h, phi=phi, phi_inv=phi_inv, Q=1e-8 * np.eye(d),
            R=self.R, alpha=(0.1, 0.1, 0.1), d=d)

    def preprocess_initial_condition(self, params: Any, x_history,
                                     carry: Any) -> Tuple[np.ndarray, Any]:
        """UKF-smooths the noisy history ``(T, n_x)`` into the starting
        state (reference ``mujoco_system.py:178-249``; bias mode
        :252-372). A history of one state is the state itself."""
        del params
        x_history = np.asarray(x_history, np.float64)
        if x_history.shape[0] > 1:
            estimate = self.ukf_bias_estimate(x_history) if self.bias \
                else self.ukf_estimate(x_history)
            return estimate, carry
        return x_history[-1], carry

    def ukf_bias_estimate(self, x_sequence: np.ndarray) -> np.ndarray:
        """Filters a noisy state sequence with the bias-augmented UKF and
        returns the final de-biased state: the smoothed sensed state
        shifted by the estimated configuration bias (reference
        ``mujoco_system.py:252-372``)."""
        nv = self.space.n_v
        n_x = self.space.n_x
        ukf = self._build_bias_ukf()
        x_sequence = np.asarray(x_sequence, np.float64)
        state = np.concatenate((x_sequence[0], np.zeros(nv)))
        P = self.P0.copy()
        for x_i in x_sequence[1:]:
            measured = np.concatenate((x_i, np.zeros(nv)))
            state, P = _host_propagate_update(ukf, state, P, measured,
                                              self.integrator.dt)
        x, b = state[:n_x], state[n_x:]
        return self._shift(x, np.concatenate((b, np.zeros_like(b))))

    def ukf_estimate(self, x_sequence: np.ndarray) -> np.ndarray:
        """Filters a noisy state sequence and returns the final smoothed
        state (reference ``mujoco_system.py:178-249``), by the reference's
        sequential algorithm with host callbacks."""
        ukf = self._build_ukf()
        x_sequence = np.asarray(x_sequence, np.float64)
        state = x_sequence[0]
        P = self.P0.copy()
        for x_i in x_sequence[1:]:
            state, P = _host_propagate_update(ukf, state, P, x_i,
                                              self.integrator.dt)
        return state

    def mll_estimate(self, x_sequence: np.ndarray,
                     max_iterations: int = 50) -> np.ndarray:
        """Maximum-likelihood initial state by Nelder-Mead over the
        rollout error (reference ``mujoco_system.py:383-463``)."""
        from scipy.optimize import minimize
        space = self.space
        x_sequence = np.asarray(x_sequence, np.float64)
        T = x_sequence.shape[0]
        x0_nominal = x_sequence[0]
        target = torch.as_tensor(x_sequence)

        def cost(xi):
            rollout = self.simulate(None, self._shift(x0_nominal, xi), T - 1)
            err = space.state_square_error(torch.as_tensor(rollout), target)
            return float(np.sum(err.numpy()))

        result = minimize(cost, np.zeros(2 * space.n_v),
                          method="Nelder-Mead",
                          options={"maxiter": max_iterations})
        return self._shift(x0_nominal, result.x)


def _host_propagate_update(ukf: ManifoldUKF, state, P, y_state, dt):
    """One UKF cycle with numpy host callbacks of single states (the
    MuJoCo step is host code): :meth:`ManifoldUKF.propagation` and
    :meth:`ManifoldUKF.update` with the sigma points in a loop."""
    d = ukf.d
    q = ukf.Q.shape[0]
    w_d = sigma_weights(d, ukf.alpha[0])
    w_q = sigma_weights(q, ukf.alpha[1])
    P = P + TOL * np.eye(d)
    zero_noise = np.zeros(q)
    new_state = ukf.f(state, None, zero_noise, dt)

    xis = w_d.sqrt_d_lambda * np.linalg.cholesky(P).T
    new_xis = []
    for sign in (1.0, -1.0):
        for j in range(d):
            s_j = ukf.phi(state, sign * xis[j])
            new_xis.append(ukf.phi_inv(new_state, ukf.f(
                s_j, None, zero_noise, dt)))
    new_xis = np.stack(new_xis)
    mean_xi = w_d.wj * new_xis.sum(axis=0)
    centered = new_xis - mean_xi
    new_P = w_d.wj * centered.T @ centered + \
        w_d.w0 * np.outer(mean_xi, mean_xi)

    cholQ = np.linalg.cholesky(ukf.Q).T
    noise_xis = []
    for sign in (1.0, -1.0):
        for j in range(q):
            w_vec = sign * w_q.sqrt_d_lambda * cholQ[j]
            noise_xis.append(ukf.phi_inv(new_state, ukf.f(
                state, None, w_vec, dt)))
    noise_xis = np.stack(noise_xis)
    mean_noise = w_q.wj * noise_xis.sum(axis=0)
    centered_noise = noise_xis - mean_noise
    Q_cov = w_q.wj * centered_noise.T @ centered_noise + \
        w_q.w0 * np.outer(mean_noise, mean_noise)
    P = new_P + Q_cov
    state = new_state

    w_u = sigma_weights(d, ukf.alpha[2])
    P = P + TOL * np.eye(d)
    xis = w_u.sqrt_d_lambda * np.linalg.cholesky(P).T
    xis_pm = np.concatenate((xis, -xis), axis=0)
    hat_y = ukf.h(state)
    ys = np.stack([ukf.h(ukf.phi(state, xi)) for xi in xis_pm])
    y = ukf.h(y_state)
    y_bar = w_u.wm * hat_y + w_u.wj * ys.sum(axis=0)
    ys_c = ys - y_bar
    hat_c = hat_y - y_bar
    P_yy = w_u.w0 * np.outer(hat_c, hat_c) + w_u.wj * ys_c.T @ ys_c + ukf.R
    P_xiy = w_u.wj * xis_pm.T @ ys_c
    K = np.linalg.solve(P_yy, P_xiy.T).T
    state = ukf.phi(state, K @ (y - y_bar))
    P = P - K @ P_yy @ K.T
    return state, 0.5 * (P + P.T)
