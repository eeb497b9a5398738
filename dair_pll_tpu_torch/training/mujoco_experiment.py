r"""MuJoCo cross-validation experiments (PyTorch).

Counterpart of ``dair_pll_tpu/training/mujoco_experiment.py`` (reference
``mujoco_experiment.py:16-44``): the base (data-generating) system is a
soft-contact MuJoCo simulator and the evaluation oracle the UKF-smoothing
MuJoCo system, whose P0 and R come from the dataset's noise configuration
as in the reference (``mujoco_experiment.py:35-44``).

The MuJoCo systems step on the host, so the experiment rolls them out one
trajectory at a time (``System.host_stepped``); the learned system runs
on the experiment's device, by default the CUDA card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from dair_pll_tpu_torch.deep_learnable import DeepLearnableExperiment
from dair_pll_tpu_torch.mujoco_system import MuJoCoSystem, MuJoCoUKFSystem
from dair_pll_tpu_torch.state_space import WhiteNoiser
from dair_pll_tpu_torch.training.config import (
    SupervisedLearningExperimentConfig)
from dair_pll_tpu_torch.training.experiment import (
    SupervisedLearningExperiment)
from dair_pll_tpu_torch.training.multibody_experiment import (
    MultibodyLearnableExperiment)


@dataclasses.dataclass
class MuJoCoExperimentConfig(SupervisedLearningExperimentConfig):
    """MuJoCo experiment configuration (reference
    ``mujoco_experiment.py:16-21``).

    Attributes:
        xml: MJCF template path (``$solrefarg1``, ``$solrefarg2`` and
          ``$dt`` placeholders, reference ``mujoco_system.py:58-68``).
        stiffness, damping_ratio, v200: the contact model, templated into
          ``solref``.
        static_noise, dynamic_noise: per Lie-algebra coordinate noise
          standard deviations of the dataset (``(2 n_v,)``), mapped to the
          UKF oracle's P0 and R (reference ``mujoco_experiment.py:38-41``).
        noise_kind: ``"gaussian"`` or ``"uniform"``, for that mapping.
        ukf_bias: the bias-augmented UKF oracle (reference
          ``mujoco_system.py:252-372`` BIAS mode).
    """
    xml: str = ""
    stiffness: float = 100.0
    damping_ratio: float = 1.0
    v200: bool = False
    static_noise: Tuple[float, ...] = ()
    dynamic_noise: Tuple[float, ...] = ()
    noise_kind: str = "gaussian"
    ukf_bias: bool = False


def build_mujoco_base_system(config: MuJoCoExperimentConfig
                             ) -> Tuple[MuJoCoSystem, Any]:
    """The MuJoCo simulator as the experiment's base system (reference
    ``mujoco_experiment.py:29-33``); its parameters are ``None``."""
    system = MuJoCoSystem(config.xml, config.data_config.dt,
                          config.stiffness, config.damping_ratio,
                          config.v200)
    return system, None


def build_mujoco_oracle_system(config: MuJoCoExperimentConfig
                               ) -> Tuple[MuJoCoUKFSystem, Any]:
    """The UKF-smoothing oracle with P0 and R from the configured data
    noise (reference ``mujoco_experiment.py:35-44``)."""
    base_system, _ = build_mujoco_base_system(config)
    space = base_system.space
    n_tan = (3 if config.ukf_bias else 2) * space.n_v
    P0 = R = None
    if len(config.static_noise):
        static = np.asarray(config.static_noise, np.float64)
        dynamic = np.asarray(config.dynamic_noise, np.float64)
        P0_diag, R_diag = MuJoCoUKFSystem.noise_stds_to_P0_R_stds(
            static, dynamic, config.data_config.dt, bias=config.ukf_bias)
        # Per-coordinate variances under the configured noise kind (the
        # noiser's covariance, extended to the bias block).
        factor = WhiteNoiser(space, config.noise_kind).variance_factor
        full = np.zeros(n_tan)
        full[:P0_diag.size] = P0_diag
        P0 = np.diag(factor * full * full)
        full[:] = 0.0
        full[:R_diag.size] = R_diag
        R = np.diag(factor * full * full)
        # Keep the filter well posed where the data is noiseless.
        eps = 1e-9 * np.eye(n_tan)
        P0 = P0 + eps
        R = R + eps
    system = MuJoCoUKFSystem(config.xml, config.data_config.dt,
                             config.stiffness, config.damping_ratio,
                             config.v200, P0=P0, R=R, bias=config.ukf_bias)
    return system, None


class _MuJoCoSystems:
    """The MuJoCo base and oracle systems of an experiment, built once."""

    def _init_mujoco(self) -> None:
        self._mujoco_base_cache: Optional[Tuple[MuJoCoSystem, Any]] = None
        self._mujoco_oracle_cache: Optional[Tuple[MuJoCoUKFSystem,
                                                  Any]] = None

    def get_base_system(self) -> Tuple[MuJoCoSystem, Any]:
        assert isinstance(self.config, MuJoCoExperimentConfig)
        if self._mujoco_base_cache is None:
            self._mujoco_base_cache = build_mujoco_base_system(self.config)
        return self._mujoco_base_cache

    def get_oracle_system(self) -> Tuple[MuJoCoUKFSystem, Any]:
        assert isinstance(self.config, MuJoCoExperimentConfig)
        if self._mujoco_oracle_cache is None:
            self._mujoco_oracle_cache = \
                build_mujoco_oracle_system(self.config)
        return self._mujoco_oracle_cache


class MuJoCoExperiment(_MuJoCoSystems, SupervisedLearningExperiment):
    """Experiment with a MuJoCo base system and a UKF-smoothing oracle
    (reference ``MuJoCoExperiment``, ``mujoco_experiment.py:24-44``).
    Subclasses or mixins supply :meth:`get_learned_system`."""

    def __init__(self, config: MuJoCoExperimentConfig, device=None,
                 dtype=torch.float32) -> None:
        super().__init__(config, device, dtype)
        self._init_mujoco()


class MuJoCoDeepLearnableExperiment(DeepLearnableExperiment,
                                    MuJoCoExperiment):
    """MuJoCo base and oracle with a deep learnable model under training
    (the reference's ``MuJoCoExperiment(DeepLearnableExperiment)``,
    ``mujoco_experiment.py:24``)."""


class MuJoCoMultibodyLearnableExperiment(_MuJoCoSystems,
                                         MultibodyLearnableExperiment):
    """MuJoCo cross-validation of the structured ContactNets model: MuJoCo
    makes or serves the data, the UKF system is the oracle and the
    learnable system is the port's multibody engine (BASELINE config 5's
    comparison on identical sets)."""

    def __init__(self, config: MuJoCoExperimentConfig, device=None,
                 dtype=torch.float32) -> None:
        super().__init__(config, device, dtype)
        self._init_mujoco()
