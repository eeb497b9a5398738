"""Residual physics: a structured contact model plus a learned correction
(PyTorch).

Counterpart of ``examples/residual_physics_cube.py``, with the same
options and constants and ``--device``: generate cube tosses from a true
system with an unmodeled linear velocity drag (outside the Anitescu model
class), then train the composite
:class:`~dair_pll_tpu_torch.residual.ResidualPhysicsSystem` (structured
contact dynamics plus an MLP velocity residual) with the prediction loss.
The rollouts, the data's and the model's, step the vmapped integrator.

Without ``--device`` it runs on the CUDA card; ``--device cpu`` runs on
the CPU. Usage::

    python -m dair_pll_tpu_torch.examples.residual_physics_cube \\
        --epochs 30 --n-pop 64
    python -m dair_pll_tpu_torch.examples.residual_physics_cube \\
        --device cpu --epochs 2 --n-pop 8
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from dair_pll_tpu_torch.integrator import Integrator
from dair_pll_tpu_torch.residual import ResidualPhysicsExperiment
from dair_pll_tpu_torch.system import System
from dair_pll_tpu_torch.training.experiment import (
    SupervisedLearningExperiment)

DT = 0.0068
TRAJECTORY_LENGTH = 60
DRAG = 0.08
EPOCHS = 30
N_POP = 64
LEARNING_RATE = 1e-3
BATCH_SIZE = 256
EVALUATION_SAMPLES = 8
#: Trajectories a ``simulate_batch`` call of the generator (the JAX
#: package's default, at most ``n_pop``).
GENERATION_BATCH = 256


def default_epoch_callback(epoch, params, train_loss, best_valid):
    del params
    if epoch % 5 == 0:
        print(f"epoch {epoch}: train {train_loss:.6g} "
              f"best valid {best_valid:.6g}", flush=True)


class DraggedCubeSystem(System):
    """Ground truth: the structured cube's contact dynamics plus a linear
    velocity drag ``-DRAG v``."""

    def __init__(self, structured, use_drag: bool = True) -> None:
        self.structured = structured
        self.use_drag = use_drag
        space = structured.space
        super().__init__(space, Integrator(space, self._partial_step, DT,
                                           "velocity"))

    def _partial_step(self, params, x, carry):
        q, v = self.space.q_v(x)
        u = x.new_zeros(x.shape[:-1] + (self.structured.model.n_u,))
        v_plus = self.structured.forward_dynamics(params, q, v, u)
        if self.use_drag:
            v_plus = v_plus - DRAG * v
        return v_plus, carry


def true_system(use_drag: bool = True, device: Optional[str] = None,
                dtype=torch.float32):
    """The dragged cube and its parameters (the URDF's)."""
    from dair_pll_tpu_torch.assets import get_asset
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    structured = MultibodyLearnableSystem.from_urdfs(
        {"cube": get_asset("cube")}, DT, mesh_representation="polygon",
        device=device)
    return DraggedCubeSystem(structured, use_drag), \
        structured.initial_params(dtype)


def generate_dragged_tosses(storage: str, n_pop: int,
                            trajectory_length: int = TRAJECTORY_LENGTH,
                            use_drag: bool = True,
                            device: Optional[str] = None,
                            dtype=torch.float32) -> int:
    """Simulates tosses of the dragged cube into ``storage`` (up to
    ``n_pop``); returns how many were generated."""
    from dair_pll_tpu_torch.data.generation import (
        DataGenerationConfig, ExperimentDatasetGenerator)
    from dair_pll_tpu_torch.state_space import UniformSampler
    system, params = true_system(use_drag, device, dtype)
    space = system.space
    x_0 = space.zero_state(torch.float32).numpy().copy()
    x_0[6] = 0.21
    ranges = np.ones(2 * space.n_v, dtype=np.float32)
    ranges[:3] = 2 * np.pi
    ranges[3:5] = 0.02
    ranges[5] = 0.05
    ranges[space.n_v:space.n_v + 3] = 4.0
    ranges[space.n_v + 3:space.n_v + 6] = 1.0
    sampler = UniformSampler(space, torch.as_tensor(ranges),
                             x_0=torch.as_tensor(x_0))
    generator = ExperimentDatasetGenerator(
        system, sampler, params,
        DataGenerationConfig(dt=DT, n_pop=n_pop,
                             trajectory_length=trajectory_length,
                             static_noise=None, dynamic_noise=None))
    return generator.generate(storage,
                              batch_size=min(GENERATION_BATCH, n_pop))


class ResidualCubeExperiment(ResidualPhysicsExperiment,
                             SupervisedLearningExperiment):
    """The residual cube against the dragged cube as its base system."""

    use_drag = True
    _base_cache = None

    def get_base_system(self):
        if self._base_cache is None:
            self._base_cache = true_system(self.use_drag, self.device,
                                           self.dtype)
        return self._base_cache


def build_experiment(epochs: int = EPOCHS,
                     storage: str = "./storage_residual",
                     use_drag: bool = True, device: Optional[str] = None,
                     dtype=torch.float32, batch_size: int = BATCH_SIZE,
                     eval_period: Optional[int] = None,
                     eval_samples: int = EVALUATION_SAMPLES,
                     **experiment_options) -> ResidualCubeExperiment:
    """The residual cube's experiment on the storage's trajectories:
    evaluations every ``eval_period`` epochs (default ``max(1, epochs //
    2)``) of ``eval_samples`` trajectories; ``experiment_options`` are
    further fields of ``SupervisedLearningExperimentConfig``."""
    from dair_pll_tpu_torch.assets import get_asset
    from dair_pll_tpu_torch.data.config import (DataConfig,
                                                TrajectorySliceConfig)
    from dair_pll_tpu_torch.hyperparameter import Float, Int
    from dair_pll_tpu_torch.residual import ResidualPhysicsLearnableConfig
    from dair_pll_tpu_torch.training.config import (
        OptimizerConfig, SupervisedLearningExperimentConfig)
    from dair_pll_tpu_torch.training.multibody_experiment import (
        MultibodySystemConfig)

    urdf = get_asset("cube")
    experiment_options.setdefault("run_name", "residual_cube")
    experiment_options.setdefault("run_wandb", False)
    config = SupervisedLearningExperimentConfig(
        data_config=DataConfig(
            dt=DT, train_fraction=0.5, valid_fraction=0.25,
            test_fraction=0.25, slice_config=TrajectorySliceConfig()),
        base_config=MultibodySystemConfig(urdfs={"cube": urdf}),
        learnable_config=ResidualPhysicsLearnableConfig(
            urdfs={"cube": urdf}),
        optimizer_config=OptimizerConfig(
            lr=Float(LEARNING_RATE), wd=Float(0.0), patience=epochs,
            epochs=epochs, batch_size=Int(batch_size)),
        full_evaluation_period=(max(1, epochs // 2) if eval_period is None
                                else eval_period),
        full_evaluation_samples=eval_samples,
        storage=storage, **experiment_options)
    experiment = ResidualCubeExperiment(config, device=device, dtype=dtype)
    experiment.use_drag = use_drag
    return experiment


def run(epochs: int = EPOCHS, n_pop: int = N_POP,
        storage: str = "./storage_residual", use_drag: bool = True,
        device: Optional[str] = None, dtype=torch.float32,
        trajectory_length: Optional[int] = None,
        batch_size: int = BATCH_SIZE, eval_period: Optional[int] = None,
        eval_samples: int = EVALUATION_SAMPLES,
        epoch_callback: Callable = default_epoch_callback,
        **experiment_options) -> Dict:
    """Generates the dragged tosses (those missing from ``storage``) of
    ``trajectory_length`` states (default ``TRAJECTORY_LENGTH``), trains
    (or resumes) the residual cube and evaluates it (the other arguments
    are :func:`build_experiment`'s).

    Returns:
        ``{"experiment", "best_params", "statistics", "generated"}``.
    """
    generated = generate_dragged_tosses(
        storage, n_pop, trajectory_length or TRAJECTORY_LENGTH, use_drag,
        device, dtype)
    print(f"generated {generated} trajectories "
          f"(drag={'on' if use_drag else 'off'})", flush=True)
    experiment = build_experiment(epochs, storage, use_drag, device, dtype,
                                  batch_size, eval_period, eval_samples,
                                  **experiment_options)
    best_params, stats = experiment.generate_results(epoch_callback)
    print("\nfinal statistics:", flush=True)
    for key in sorted(stats):
        if key.endswith("_mean"):
            print(f"  {key}: {stats[key]:.6g}", flush=True)
    return {"experiment": experiment, "best_params": best_params,
            "statistics": stats, "generated": generated}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Trains a structured cube with a learned velocity "
                    "residual on dragged tosses.")
    parser.add_argument("--epochs", type=int, default=EPOCHS)
    parser.add_argument("--n-pop", type=int, default=N_POP)
    parser.add_argument("--storage", default="./storage_residual")
    drag = parser.add_mutually_exclusive_group()
    drag.add_argument("--drag", dest="use_drag", action="store_true",
                      default=True,
                      help="add unmodeled drag to the data-generating "
                           "system (default)")
    drag.add_argument("--no-drag", dest="use_drag", action="store_false")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; "
                             "'cpu' runs on the CPU)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(**vars(parse_args(argv)))


if __name__ == "__main__":
    main()
