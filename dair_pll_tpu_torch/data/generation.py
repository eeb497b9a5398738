r"""Trajectory dataset generation: simulate, noise, save (PyTorch).

Counterpart of ``dair_pll_tpu/data/generation.py`` (reference
``dataset_generation.py:22-151``): roll out a base system from sampled
initial conditions, save ground-truth copies, add static (whole-trajectory)
and dynamic (per-step) white noise on the Lie algebra, re-project
velocities to configuration finite differences, and save the noised
learning copies.

Every batch of trajectories is one call of the system's
``simulate_batch``: for a :class:`MultibodyLearnableSystem` the fused
rollout on the warm solve kernel K5 from ``FUSED_ROLLOUT_MIN_BATCH``
(1,024) trajectories, the vmapped integrator below. Initial conditions
and noise come from a ``torch.Generator`` seeded from ``config.seed`` plus
the number of trajectories already on disk (the JAX package seeds its PRNG
key the same way, so the two draw different but equally distributed
numbers).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dair_pll_tpu_torch.params import dtype_device
from dair_pll_tpu_torch.state_space import StateSpaceSampler, WhiteNoiser
from dair_pll_tpu_torch.system import System
from dair_pll_tpu_torch.utils import file_utils


@dataclasses.dataclass
class DataGenerationConfig:
    """Dataset generation configuration (reference
    ``dataset_generation.py:22-55``).

    Attributes:
        dt: time step.
        n_pop: total number of trajectories on disk.
        trajectory_length: states per trajectory.
        static_noise: ``(2 n_v,)`` per-coordinate scale of noise applied
          once per trajectory.
        dynamic_noise: ``(2 n_v,)`` per-coordinate scale of noise applied
          each step.
        noiser_kind: "gaussian" or "uniform".
        seed: seed of the generator.
        max_velocity: if set, trajectories whose velocity coordinates
          ever exceed this bound in absolute value (or go non-finite) are
          rejected and resampled, as in the JAX package.
    """
    dt: float = 1e-3
    n_pop: int = 16384
    trajectory_length: int = 80
    static_noise: Optional[np.ndarray] = None
    dynamic_noise: Optional[np.ndarray] = None
    noiser_kind: str = "gaussian"
    seed: int = 0
    max_velocity: Optional[float] = None

    def __post_init__(self):
        assert self.dt > 0
        assert self.n_pop > 0
        assert self.trajectory_length > 0
        assert self.max_velocity is None or self.max_velocity > 0


class ExperimentDatasetGenerator:
    """Generates and stores simulated trajectories for an experiment.

    The sampled states take the dtype of the parameters and move to their
    device; ``params`` must lie on the system's device already. A
    host-stepped system (the MuJoCo oracle, ``params`` ``None``) takes
    float64 states on the CPU and returns numpy rollouts.
    """

    def __init__(self, system: System, sampler: StateSpaceSampler,
                 params, config: DataGenerationConfig) -> None:
        self.system = system
        self.sampler = sampler
        self.params = params
        self.config = config
        #: Trajectories rejected by the ``max_velocity`` divergence filter
        #: during the last :meth:`generate` call.
        self.last_rejected = 0

    def generate(self, storage: str, batch_size: int = 256) -> int:
        """Fills the storage tree up to ``n_pop`` trajectories.

        Every batch simulates ``batch_size`` trajectories (surplus rows are
        not saved), so the rollout's route is the same for every batch.
        With ``config.max_velocity`` set, diverged rollouts are dropped and
        their slots resampled (count in :attr:`last_rejected`); generation
        aborts if the acceptance rate falls below 5%.

        Returns:
            Number of newly generated trajectories.
        """
        config = self.config
        space = self.system.space
        if self.system.host_stepped:
            dtype, device = torch.float64, torch.device("cpu")
        else:
            dtype, device = dtype_device(self.params)
        existing = len(file_utils.list_trajectories(
            file_utils.trajectory_dir(storage,
                                      file_utils.GROUND_TRUTH_SUBDIR)))
        generator = torch.Generator().manual_seed(config.seed + existing)
        generated = 0
        self.last_rejected = 0
        index = existing
        while index < config.n_pop:
            x_0 = self.sampler.get_samples(generator, batch_size, dtype)
            with torch.no_grad():
                ground_truth = torch.as_tensor(self.system.simulate_batch(
                    self.params, x_0.to(device),
                    config.trajectory_length - 1), device=device)
                noised = self.make_noised_trajectories(generator,
                                                       ground_truth)
            ground_truth = ground_truth.cpu().numpy()
            noised = noised.cpu().numpy()
            if config.max_velocity is not None:
                velocity = ground_truth[..., space.n_q:]
                keep = (np.isfinite(ground_truth).all(axis=(1, 2)) &
                        (np.abs(velocity) <=
                         config.max_velocity).all(axis=(1, 2)))
                self.last_rejected += int(batch_size - keep.sum())
                ground_truth = ground_truth[keep]
                noised = noised[keep]
                if self.last_rejected > 19 * max(
                        generated + ground_truth.shape[0], batch_size):
                    raise RuntimeError(
                        f"dataset generation rejected "
                        f"{self.last_rejected} trajectories against "
                        f"{generated + ground_truth.shape[0]} accepted "
                        f"(max_velocity={config.max_velocity}); the "
                        f"sampled regime is not integrable at this dt")
            n_new = min(ground_truth.shape[0], config.n_pop - index)
            for row in range(n_new):
                file_utils.save_trajectory(
                    storage, file_utils.GROUND_TRUTH_SUBDIR, index,
                    ground_truth[row])
                file_utils.save_trajectory(
                    storage, file_utils.LEARNING_SUBDIR, index,
                    noised[row])
                index += 1
                generated += 1
        return generated

    def make_noised_trajectories(self, generator: torch.Generator,
                                 trajectories: torch.Tensor) -> torch.Tensor:
        """Applies static and dynamic noise to ``(B, T, n_x)``
        trajectories, then re-projects velocities to finite differences
        (reference ``dataset_generation.py:127-151``). The output is one
        state shorter than the input (finite differencing drops step 0)."""
        config = self.config
        space = self.system.space
        noiser = WhiteNoiser(space, config.noiser_kind)
        x = trajectories
        if config.static_noise is not None:
            # One draw per trajectory, shared across time.
            ranges = torch.as_tensor(np.asarray(config.static_noise),
                                     dtype=x.dtype, device=x.device)
            dx_shape = x.shape[:-1] + (2 * space.n_v,)
            draw = noiser.unit_noise(
                generator, x.shape[:-2] + (1, 2 * space.n_v), x) * ranges
            x = space.shift_state(x, draw.expand(dx_shape))
        if config.dynamic_noise is not None:
            x = noiser.noise(generator, x, np.asarray(config.dynamic_noise),
                             independent=True)
        return space.project_derivative(space.project_state(x), config.dt)
