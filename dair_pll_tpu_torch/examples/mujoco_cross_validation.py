"""MuJoCo cross-validation with UKF smoothing (BASELINE config 5)
(PyTorch).

Counterpart of ``examples/mujoco_cross_validation.py``, with the same
options and constants and ``--device``: a MuJoCo soft-contact simulator
(templated ``solref`` stiffness and damping) generates cube tosses, noisy
measurements of them are stored for learning, a manifold-UKF oracle
smooths a few of them as a check, and the structured ContactNets model
trains on the data and is evaluated beside the UKF oracle.

MuJoCo runs on the host and needs the ``mujoco`` package; the learned
model runs on the CUDA card without ``--device``, on the CPU with
``--device cpu``. Usage::

    python -m dair_pll_tpu_torch.examples.mujoco_cross_validation
    python -m dair_pll_tpu_torch.examples.mujoco_cross_validation \\
        --device cpu --n-pop 8 --trajectory-length 12 --epochs 2
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

DT = 0.0068
STIFFNESS = 2500.0
DAMPING_RATIO = 1.04
N_POP = 64
TRAJECTORY_LENGTH = 60
NOISE_STD = 0.005
EPOCHS = 100
LEARNING_RATE = 1e-3
BATCH_SIZE = 256


def default_epoch_callback(epoch, params, train_loss, best_valid):
    del params
    if epoch % 10 == 0:
        print(f"epoch {epoch}: train {train_loss:.6g} "
              f"best valid {best_valid:.6g}", flush=True)


def generate_mujoco_tosses(oracle, storage: str, n_pop: int,
                           trajectory_length: int, noise_std: float,
                           seed: int = 0):
    """MuJoCo tosses into ``storage``: the clean ones as ground truth, the
    noisy ones (noise on every coordinate, quaternions renormalized) for
    learning. The UKF oracle smooths the first three free-flight
    prefixes; returns their ``(raw, smoothed)`` position errors."""
    from dair_pll_tpu_torch.utils import file_utils
    rng = np.random.default_rng(seed)
    ukf_improvements = []
    for index in range(n_pop):
        x0 = np.zeros(13)
        rot = 0.5 * rng.standard_normal(3)
        angle = np.linalg.norm(rot)
        axis = rot / (angle + 1e-12)
        x0[0] = np.cos(angle / 2)
        x0[1:4] = axis * np.sin(angle / 2)
        x0[4:6] = 0.02 * rng.standard_normal(2)
        x0[6] = 0.15 + 0.05 * rng.random()
        x0[7:10] = 2.0 * rng.standard_normal(3)
        x0[10:12] = 0.5 * rng.standard_normal(2)
        clean = oracle.simulate(None, x0, trajectory_length - 1)
        noisy = clean + noise_std * rng.standard_normal(clean.shape)
        noisy[:, :4] /= np.linalg.norm(noisy[:, :4], axis=-1, keepdims=True)
        file_utils.save_trajectory(storage, file_utils.GROUND_TRUTH_SUBDIR,
                                   index, clean.astype(np.float32))
        file_utils.save_trajectory(storage, file_utils.LEARNING_SUBDIR,
                                   index, noisy.astype(np.float32))
        if index < 3:
            # The UKF smooths the first free-flight prefixes, a check of
            # the oracle (reference mujoco_experiment.py:47-199).
            window = noisy[:10]
            estimate = oracle.ukf_estimate(window)
            end = window.shape[0] - 1
            err_raw = float(np.linalg.norm(window[-1][4:7] -
                                           clean[end][4:7]))
            err_ukf = float(np.linalg.norm(estimate[4:7] - clean[end][4:7]))
            ukf_improvements.append((err_raw, err_ukf))
    return ukf_improvements


def run(stiffness: float = STIFFNESS, damping_ratio: float = DAMPING_RATIO,
        n_pop: int = N_POP, trajectory_length: int = TRAJECTORY_LENGTH,
        noise_std: float = NOISE_STD, storage: str = "./storage_mujoco",
        epochs: int = EPOCHS, device: Optional[str] = None,
        dtype=torch.float32, batch_size: int = BATCH_SIZE,
        epoch_callback: Callable = default_epoch_callback,
        **experiment_options) -> Dict:
    """Generates the MuJoCo data, trains (or resumes) the structured cube
    with the ContactNets loss and evaluates it beside the UKF oracle.
    ``experiment_options`` are further fields of ``MuJoCoExperimentConfig``
    (e.g. ``video_period``).

    Returns:
        ``{"experiment", "best_params", "statistics",
        "ukf_improvements"}``.
    """
    from dair_pll_tpu_torch.assets import get_asset
    from dair_pll_tpu_torch.data.config import (DataConfig,
                                                TrajectorySliceConfig)
    from dair_pll_tpu_torch.hyperparameter import Float, Int
    from dair_pll_tpu_torch.mujoco_system import MuJoCoUKFSystem
    from dair_pll_tpu_torch.training.config import OptimizerConfig
    from dair_pll_tpu_torch.training.mujoco_experiment import (
        MuJoCoExperimentConfig, MuJoCoMultibodyLearnableExperiment)
    from dair_pll_tpu_torch.training.multibody_experiment import (
        MultibodyLearnableSystemConfig, MultibodyLosses,
        MultibodySystemConfig)

    mjcf = get_asset("cube_mjcf")
    oracle = MuJoCoUKFSystem(mjcf, DT, stiffness, damping_ratio)
    print("generating MuJoCo trajectories...", flush=True)
    ukf_improvements = generate_mujoco_tosses(oracle, storage, n_pop,
                                              trajectory_length, noise_std)
    print(f"UKF position errors (raw vs smoothed): {ukf_improvements}",
          flush=True)

    urdf = get_asset("cube")
    experiment_options.setdefault("run_name", "mujoco_cross_validation")
    config = MuJoCoExperimentConfig(
        data_config=DataConfig(
            dt=DT, train_fraction=0.5, valid_fraction=0.25,
            test_fraction=0.25, slice_config=TrajectorySliceConfig()),
        base_config=MultibodySystemConfig(urdfs={"cube": urdf}),
        learnable_config=MultibodyLearnableSystemConfig(
            urdfs={"cube": urdf}, loss=MultibodyLosses.CONTACTNETS_LOSS),
        optimizer_config=OptimizerConfig(
            lr=Float(LEARNING_RATE), wd=Float(0.0), patience=epochs,
            epochs=epochs, batch_size=Int(batch_size)),
        storage=storage, xml=mjcf, stiffness=stiffness,
        damping_ratio=damping_ratio,
        static_noise=tuple([noise_std] * 12),
        dynamic_noise=tuple([noise_std] * 12), **experiment_options)
    # The MuJoCo simulator is the base system and the UKF-smoothing system
    # the oracle evaluated beside the learned model (reference
    # mujoco_experiment.py:24-44).
    experiment = MuJoCoMultibodyLearnableExperiment(config, device=device,
                                                    dtype=dtype)
    best_params, stats = experiment.generate_results(epoch_callback)
    print("\nfinal statistics (learned on MuJoCo data):", flush=True)
    for key in sorted(stats):
        if key.endswith("_mean"):
            print(f"  {key}: {stats[key]:.6g}", flush=True)
    return {"experiment": experiment, "best_params": best_params,
            "statistics": stats, "ukf_improvements": ukf_improvements}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="MuJoCo cross-validation of the ContactNets cube with "
                    "a UKF-smoothing oracle.")
    parser.add_argument("--stiffness", type=float, default=STIFFNESS)
    parser.add_argument("--damping-ratio", type=float,
                        default=DAMPING_RATIO)
    parser.add_argument("--n-pop", type=int, default=N_POP)
    parser.add_argument("--trajectory-length", type=int,
                        default=TRAJECTORY_LENGTH)
    parser.add_argument("--noise-std", type=float, default=NOISE_STD)
    parser.add_argument("--storage", default="./storage_mujoco")
    parser.add_argument("--epochs", type=int, default=EPOCHS)
    parser.add_argument("--device", default=None,
                        help="torch device of the learned model (default: "
                             "the CUDA card; 'cpu' runs on the CPU)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(**vars(parse_args(argv)))


if __name__ == "__main__":
    main()
