"""Deep learnable (MLP or recurrent) dynamics baselines on cube-toss data
(PyTorch).

Counterpart of ``examples/deep_learnable_baseline.py``, with the same
options and constants and ``--device``: train a black-box MLP or GRU
dynamics model with the prediction loss on the same trajectory batches as
the structured ContactNets model, for a like-for-like comparison
(BASELINE config 4). The storage must hold trajectories already, e.g.
those of ``contactnets_simple`` (its ``generate_tosses``). The final
evaluation rolls the ground-truth cube out beside the model (the fused
rollout on K5 from 1,024 trajectories).

Without ``--device`` it runs on the CUDA card; ``--device cpu`` runs on
the CPU. Usage::

    python -m dair_pll_tpu_torch.examples.deep_learnable_baseline \\
        --model mlp --storage ./storage
    python -m dair_pll_tpu_torch.examples.deep_learnable_baseline \\
        --device cpu --model recurrent --t-history 4 --epochs 2
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, Optional, Sequence

import torch

from dair_pll_tpu_torch.deep_learnable import DeepLearnableExperiment
from dair_pll_tpu_torch.training.experiment import (
    SupervisedLearningExperiment)

DT = 0.0068
EPOCHS = 200
HIDDEN_SIZE = 128
LAYERS = 2
LEARNING_RATE = 1e-3
BATCH_SIZE = 256


def default_epoch_callback(epoch, params, train_loss, best_valid):
    del params
    if epoch % 10 == 0:
        print(f"epoch {epoch}: train {train_loss:.6g} "
              f"best valid {best_valid:.6g}", flush=True)


class DeepBaselineExperiment(DeepLearnableExperiment,
                             SupervisedLearningExperiment):
    """Prediction-loss experiment with a deep learnable system; the base
    (oracle) system is the box cube at its URDF's parameters."""

    _base_cache = None

    def get_base_system(self):
        if self._base_cache is None:
            from dair_pll_tpu_torch.assets import get_asset
            from dair_pll_tpu_torch.multibody.learnable_system import (
                MultibodyLearnableSystem)
            from dair_pll_tpu_torch.urdf import build_multibody_model
            model = build_multibody_model({"cube": get_asset("cube")})
            system = MultibodyLearnableSystem(model, DT, device=self.device)
            self._base_cache = (system, system.initial_params(self.dtype))
        return self._base_cache


def build_experiment(model_kind: str = "mlp", storage: str = "./storage",
                     run_name: Optional[str] = None, epochs: int = EPOCHS,
                     hidden_size: int = HIDDEN_SIZE, layers: int = LAYERS,
                     t_history: int = 1, device: Optional[str] = None,
                     dtype=torch.float32, batch_size: int = BATCH_SIZE,
                     **experiment_options) -> DeepBaselineExperiment:
    """The deep baseline's experiment on the storage's trajectories.
    ``experiment_options`` are further fields of
    ``SupervisedLearningExperimentConfig`` (e.g.
    ``full_evaluation_period``)."""
    from dair_pll_tpu_torch.assets import get_asset
    from dair_pll_tpu_torch.data.config import (DataConfig,
                                                TrajectorySliceConfig)
    from dair_pll_tpu_torch.deep_learnable import DeepLearnableSystemConfig
    from dair_pll_tpu_torch.hyperparameter import Float, Int
    from dair_pll_tpu_torch.training.config import (
        OptimizerConfig, SupervisedLearningExperimentConfig)
    from dair_pll_tpu_torch.training.multibody_experiment import (
        MultibodySystemConfig)

    run_name = run_name or f"deep_{model_kind}"
    deep_config = DeepLearnableSystemConfig(
        integrator_kind="velocity", layers=layers, hidden_size=hidden_size,
        model_kind=model_kind)
    config = SupervisedLearningExperimentConfig(
        data_config=DataConfig(
            dt=DT, train_fraction=0.5, valid_fraction=0.25,
            test_fraction=0.25,
            slice_config=TrajectorySliceConfig(
                t_skip=max(0, t_history - 1), t_history=t_history)),
        base_config=MultibodySystemConfig(urdfs={"cube": get_asset("cube")}),
        learnable_config=deep_config,
        optimizer_config=OptimizerConfig(
            lr=Float(LEARNING_RATE), wd=Float(0.0), patience=epochs,
            epochs=epochs, batch_size=Int(batch_size)),
        storage=storage, run_name=run_name, **experiment_options)
    return DeepBaselineExperiment(config, device=device, dtype=dtype)


def run(model_kind: str = "mlp", storage: str = "./storage",
        run_name: Optional[str] = None, epochs: int = EPOCHS,
        hidden_size: int = HIDDEN_SIZE, layers: int = LAYERS,
        t_history: int = 1, device: Optional[str] = None,
        dtype=torch.float32, batch_size: int = BATCH_SIZE,
        epoch_callback: Callable = default_epoch_callback,
        **experiment_options) -> Dict:
    """Trains (or resumes) the deep baseline on the storage's trajectories
    and evaluates it beside the ground-truth cube (the arguments of
    :func:`build_experiment`).

    Returns:
        ``{"experiment", "best_params", "statistics"}``.
    """
    experiment = build_experiment(model_kind, storage, run_name, epochs,
                                  hidden_size, layers, t_history, device,
                                  dtype, batch_size, **experiment_options)
    best_params, stats = experiment.generate_results(epoch_callback)
    print("\nfinal statistics:", flush=True)
    for key in sorted(stats):
        if key.endswith("_mean"):
            print(f"  {key}: {stats[key]:.6g}", flush=True)
    return {"experiment": experiment, "best_params": best_params,
            "statistics": stats}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Trains a deep learnable dynamics baseline on cube "
                    "tosses.")
    parser.add_argument("--model", dest="model_kind",
                        choices=["mlp", "recurrent"], default="mlp")
    parser.add_argument("--storage", default="./storage",
                        help="storage tree with trajectories (e.g. made by "
                             "contactnets_simple)")
    parser.add_argument("--run-name", default=None)
    parser.add_argument("--epochs", type=int, default=EPOCHS)
    parser.add_argument("--hidden-size", type=int, default=HIDDEN_SIZE)
    parser.add_argument("--layers", type=int, default=LAYERS)
    parser.add_argument("--t-history", type=int, default=1,
                        help="history window (recurrent warm-up length)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; "
                             "'cpu' runs on the CPU)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(**vars(parse_args(argv)))


if __name__ == "__main__":
    main()
