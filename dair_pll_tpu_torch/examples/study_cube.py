"""Cube hyperparameter study (PyTorch).

Counterpart of ``examples/study_cube.py`` (the reference ``study.py``
``__main__`` flow, ``/root/reference/dair_pll/study.py:163-203``), with
the same options and constants and ``--device``: optimize ContactNets
training hyperparameters on simulated cube tosses with Sobol, TPE or
random sampling and successive halving, then, with ``--sweep``, a
dataset-size sweep at the optimum (its plot needs matplotlib). It is
written with ``argparse``.

Without ``--device`` it runs on the CUDA card; ``--device cpu`` runs on
the CPU. Usage::

    python -m dair_pll_tpu_torch.examples.study_cube --n-trials 8
    python -m dair_pll_tpu_torch.examples.study_cube --device cpu \\
        --n-trials 2 --max-epochs 2 --n-pop 8 --sampler tpe
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

DT = 1.0 / 148.0  # study time step (reference study.py:174)


def generate_data(storage: str, n_target: int, device: Optional[str] = None,
                  trajectory_length: int = 80) -> None:
    """Ensures ``storage`` holds ``n_target`` simulated cube tosses (the
    JAX package's example's sampler: height 0.21 m, random pose and
    velocity)."""
    from dair_pll_tpu_torch.assets import get_asset
    from dair_pll_tpu_torch.data.generation import (
        DataGenerationConfig, ExperimentDatasetGenerator)
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    from dair_pll_tpu_torch.state_space import UniformSampler
    from dair_pll_tpu_torch.urdf import build_multibody_model

    model = build_multibody_model({"cube": get_asset("cube")})
    base = MultibodyLearnableSystem(model, DT, device=device)
    space = base.space
    x_0 = space.zero_state(torch.float32).numpy().copy()
    x_0[6] = 0.21
    ranges = np.ones(2 * space.n_v, dtype=np.float32)
    ranges[:3] = 2 * np.pi
    ranges[3:6] = 0.05
    ranges[space.n_v:space.n_v + 3] = 4.0
    ranges[space.n_v + 3:] = 1.0
    sampler = UniformSampler(space, torch.as_tensor(ranges),
                             x_0=torch.as_tensor(x_0))
    ExperimentDatasetGenerator(
        base, sampler, base.initial_params(),
        DataGenerationConfig(dt=DT, n_pop=n_target,
                             trajectory_length=trajectory_length)
    ).generate(storage)


def run(storage: str = "./storage_study", n_trials: int = 8,
        max_epochs: int = 32, n_pop: int = 64, sweep: bool = False,
        sampler: str = "sobol", device: Optional[str] = None,
        trajectory_length: int = 80) -> Dict:
    """The study end to end; returns ``{"best", "study", "sweep",
    "plot"}`` (the best hyperparameter values, the ``Study``, the sweep's
    results and its plot's path, ``None`` without ``--sweep`` or
    matplotlib)."""
    from dair_pll_tpu_torch.assets import get_asset
    from dair_pll_tpu_torch.data.config import (DataConfig,
                                                TrajectorySliceConfig)
    from dair_pll_tpu_torch.hyperparameter import Float, Int, load_suggestion
    from dair_pll_tpu_torch.study import Study, StudyConfig
    from dair_pll_tpu_torch.training.config import (
        OptimizerConfig, SupervisedLearningExperimentConfig)
    from dair_pll_tpu_torch.training.multibody_experiment import (
        MultibodyLearnableExperiment, MultibodyLearnableSystemConfig,
        MultibodyLosses, MultibodySystemConfig)

    urdf = get_asset("cube")
    generate_data(storage, n_pop, device, trajectory_length)
    base_config = SupervisedLearningExperimentConfig(
        data_config=DataConfig(
            dt=DT, train_fraction=0.5, valid_fraction=0.25,
            test_fraction=0.25, slice_config=TrajectorySliceConfig()),
        base_config=MultibodySystemConfig(urdfs={"cube": urdf}),
        learnable_config=MultibodyLearnableSystemConfig(
            urdfs={"cube": urdf}, loss=MultibodyLosses.CONTACTNETS_LOSS),
        optimizer_config=OptimizerConfig(
            lr=Float(1e-3), wd=Float(1e-6), patience=max_epochs,
            epochs=max_epochs, batch_size=Int(64)),
        storage=storage, run_name="study",
    )
    study = Study(StudyConfig(
        experiment_factory=lambda config: MultibodyLearnableExperiment(
            config, device=device),
        base_config=base_config, study_name="cube_study",
        n_trials=n_trials, min_epochs=max(2, max_epochs // 8),
        sampler=sampler))
    best = study.optimize_hyperparameters()
    print(f"best hyperparameters: {best}", flush=True)

    results = path = None
    if sweep:
        load_suggestion(base_config, best)
        results = study.run_datasweep_sample(
            [n_pop // 4, n_pop // 2, n_pop],
            lambda n: generate_data(storage, n, device, trajectory_length))
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            print("sweep plot: skipped (no matplotlib)", flush=True)
        else:
            from dair_pll_tpu_torch.sweep_plot import plot_sweep_metric
            path = plot_sweep_metric(
                results, "test_model_trajectory_mse_mean",
                os.path.join(storage, "plots"))
            print(f"sweep plot: {path}", flush=True)
    return {"best": best, "study": study, "sweep": results, "plot": path}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Cube hyperparameter study with successive halving.")
    parser.add_argument("--storage", default="./storage_study")
    parser.add_argument("--n-trials", type=int, default=8)
    parser.add_argument("--max-epochs", type=int, default=32)
    parser.add_argument("--n-pop", type=int, default=64)
    sweep = parser.add_mutually_exclusive_group()
    sweep.add_argument("--sweep", dest="sweep", action="store_true",
                       default=False,
                       help="Also run a dataset-size sweep at the optimum.")
    sweep.add_argument("--no-sweep", dest="sweep", action="store_false")
    parser.add_argument("--sampler", default="sobol",
                        choices=["sobol", "tpe", "random"],
                        help="Trial sampler (tpe = Sobol explore then "
                             "Parzen-surrogate exploit).")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; "
                             "'cpu' runs on the CPU)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(**vars(parse_args(argv)))


if __name__ == "__main__":
    main()
