"""Cube ContactNets experiment on a dataset that grows while it trains
(PyTorch).

Counterpart of ``examples/contactnets_cube_dynamic_data_source.py``, with
the same options and constants and ``--device``: trajectories are
drip-fed into the storage tree while training runs with
``DataConfig.update_dynamically = True``, so every epoch rescans the data
directory and folds new trajectories into the persisted train/valid/test
split. The drip is simulated in process: every ``--drip-period`` epochs
another batch of source trajectories is copied into storage. Under dynamic
updates the epoch-warm loss is off (the slice set changes), so training
runs the cold ContactNets loss.

Without ``--device`` it runs on the CUDA card; ``--device cpu`` runs on
the CPU. Usage::

    python -m dair_pll_tpu_torch.examples.contactnets_cube_dynamic_data_source \\
        --source-data-dir ./storage/data/learning
"""
from __future__ import annotations

import argparse
import os
from glob import glob
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

DT = 0.0068
EPOCHS = 200
DRIP_PERIOD = 10
DRIP_SIZE = 32
LEARNING_RATE = 1e-3
BATCH_SIZE = 256


def run(source_data_dir: str, storage: str = "./storage_dynamic",
        run_name: str = "cube_dynamic", epochs: int = EPOCHS,
        drip_period: int = DRIP_PERIOD, drip_size: int = DRIP_SIZE,
        device: Optional[str] = None, dtype=torch.float32,
        batch_size: int = BATCH_SIZE,
        epoch_callback: Optional[Callable] = None,
        **experiment_options) -> Dict:
    """Drips the source trajectories into ``storage`` while the cube
    trains on them. ``epoch_callback``, if given, runs after each epoch's
    drip and report; ``experiment_options`` are further fields of
    ``SupervisedLearningExperimentConfig`` or of
    ``MultibodyLearnableSystemConfig``.

    Returns:
        ``{"experiment", "best_params", "statistics", "dripped"}``, the
        last the trajectory count after each arrival.
    """
    import dataclasses

    from dair_pll_tpu_torch.assets import get_asset
    from dair_pll_tpu_torch.data.config import (DataConfig,
                                                TrajectorySliceConfig)
    from dair_pll_tpu_torch.hyperparameter import Float, Int
    from dair_pll_tpu_torch.training.config import (
        OptimizerConfig, SupervisedLearningExperimentConfig)
    from dair_pll_tpu_torch.training.multibody_experiment import (
        MultibodyLearnableExperiment, MultibodyLearnableSystemConfig,
        MultibodyLosses, MultibodySystemConfig)
    from dair_pll_tpu_torch.utils import file_utils

    sources = sorted(glob(os.path.join(source_data_dir, "*.pt")) +
                     glob(os.path.join(source_data_dir, "*.npy")))
    if not sources:
        raise ValueError(f"no trajectories in {source_data_dir}")
    state = {"next": 0}
    dripped = []

    def drip() -> int:
        end = min(state["next"] + drip_size, len(sources))
        for i in range(state["next"], end):
            trajectory = file_utils.load_trajectory(sources[i])
            file_utils.save_trajectory(storage, file_utils.LEARNING_SUBDIR,
                                       i, trajectory.astype(np.float32))
        added = end - state["next"]
        state["next"] = end
        dripped.append(end)
        return added

    drip()  # the first arrival

    learnable_fields = {f.name for f in dataclasses.fields(
        MultibodyLearnableSystemConfig)}
    learnable_options = {key: experiment_options.pop(key)
                         for key in list(experiment_options)
                         if key in learnable_fields}
    urdf = get_asset("cube")
    config = SupervisedLearningExperimentConfig(
        data_config=DataConfig(
            dt=DT, train_fraction=0.5, valid_fraction=0.25,
            test_fraction=0.25, slice_config=TrajectorySliceConfig(),
            update_dynamically=True),
        base_config=MultibodySystemConfig(urdfs={"cube": urdf}),
        learnable_config=MultibodyLearnableSystemConfig(
            urdfs={"cube": urdf}, loss=MultibodyLosses.CONTACTNETS_LOSS,
            **learnable_options),
        optimizer_config=OptimizerConfig(
            lr=Float(LEARNING_RATE), wd=Float(0.0), patience=epochs,
            epochs=epochs, batch_size=Int(batch_size)),
        storage=storage, run_name=run_name, **experiment_options)
    experiment = MultibodyLearnableExperiment(config, device=device,
                                              dtype=dtype)

    def callback(epoch, params, train_loss, best_valid):
        if epoch % drip_period == 0 and state["next"] < len(sources):
            added = drip()
            print(f"epoch {epoch}: dripped {added} trajectories "
                  f"(total {state['next']})", flush=True)
        if epoch % 10 == 0:
            print(f"epoch {epoch}: train {train_loss:.6g} "
                  f"best valid {best_valid:.6g}", flush=True)
        if epoch_callback is not None:
            epoch_callback(epoch, params, train_loss, best_valid)

    best_params, stats = experiment.generate_results(callback)
    print("final valid loss: "
          f"{stats.get('valid_model_loss_mean', float('nan')):.6g}",
          flush=True)
    return {"experiment": experiment, "best_params": best_params,
            "statistics": stats, "dripped": dripped}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Trains the ContactNets cube while trajectories "
                    "arrive.")
    parser.add_argument("--source-data-dir", required=True,
                        help="directory of trajectories to drip-feed (.pt "
                             "or .npy)")
    parser.add_argument("--storage", default="./storage_dynamic")
    parser.add_argument("--run-name", default="cube_dynamic")
    parser.add_argument("--epochs", type=int, default=EPOCHS)
    parser.add_argument("--drip-period", type=int, default=DRIP_PERIOD,
                        help="epochs between data arrivals")
    parser.add_argument("--drip-size", type=int, default=DRIP_SIZE,
                        help="trajectories per arrival")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; "
                             "'cpu' runs on the CPU)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(**vars(parse_args(argv)))


if __name__ == "__main__":
    main()
