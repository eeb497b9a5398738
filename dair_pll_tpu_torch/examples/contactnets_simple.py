"""Canonical cube/elbow ContactNets system-identification command line
(PyTorch).

Counterpart of ``examples/contactnets_simple.py`` (reference
``examples/contactnets_simple.py:52-268``), with the same options and
constants and ``--device``: identify the inertia, friction and geometry
of a cube (or an articulated elbow) from tossed trajectories, with the
ContactNets implicit loss or the trajectory-prediction loss, from
simulated or real data, with box or learned-mesh geometry. It is written
with ``argparse``, which needs nothing beyond the standard library.

Defaults: dt = 0.0068 s, 256 simulated trajectories of 80 (cube) or 120
(elbow) states, Adam at lr 1e-3, 500 epochs, patience 500, batch 256.
Without ``--device`` it runs on the CUDA card; ``--device cpu`` runs on
the CPU. Usage::

    python -m dair_pll_tpu_torch.examples.contactnets_simple \\
        --system cube --source simulation
    python -m dair_pll_tpu_torch.examples.contactnets_simple \\
        --device cpu --epochs 2 --n-pop 8
    torchrun --nproc-per-node 4 -m \\
        dair_pll_tpu_torch.examples.contactnets_simple \\
        --shard-training --shard-evaluation

(the last on four cards: each minibatch splits over the four processes).
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

DT = 0.0068
N_POP = 256
TRAJECTORY_LENGTHS = {"cube": 80, "elbow": 120}
LEARNING_RATE = 1e-3
EPOCHS = 500
PATIENCE = 500
BATCH_SIZE = 256
#: Trajectories simulated per ``simulate_batch`` call of the dataset
#: generator (the JAX package's default; at most ``n_pop``); from 1,024 the
#: rollout takes the fused path on the warm solve kernel K5.
GENERATION_BATCH = 256


def default_epoch_callback(epoch, params, train_loss, best_valid):
    del params
    if epoch % 10 == 0:
        print(f"epoch {epoch}: train {train_loss:.6g} "
              f"best valid {best_valid:.6g}", flush=True)


def generate_tosses(system: str, storage: str, n_pop: int,
                   trajectory_length: int, box: bool = True,
                   device: Optional[str] = None,
                   generation_batch: int = GENERATION_BATCH) -> int:
    """Simulates tosses of the ground-truth system into ``storage`` (up to
    ``n_pop`` trajectories); returns how many were generated."""
    from dair_pll_tpu_torch.assets import get_asset
    from dair_pll_tpu_torch.data.generation import (
        DataGenerationConfig, ExperimentDatasetGenerator)
    from dair_pll_tpu_torch.multibody.learnable_system import (
        MultibodyLearnableSystem)
    from dair_pll_tpu_torch.state_space import UniformSampler
    from dair_pll_tpu_torch.urdf import build_multibody_model

    urdf = get_asset(system if box else f"{system}_mesh")
    # Ground-truth generator: exact polygon hulls for mesh geometry.
    model = build_multibody_model({system: urdf},
                                  mesh_representation="polygon")
    base = MultibodyLearnableSystem(model, DT, device=device)
    space = base.space
    # Tossed above the plane with randomized pose and velocity (role of
    # reference :57-71).
    x_0 = space.zero_state(torch.float32).numpy().copy()
    x_0[6] = 0.21 if system == "cube" else 0.3
    ranges = np.ones(2 * space.n_v, dtype=np.float32)
    ranges[:3] = 2 * np.pi          # orientation
    ranges[3:5] = 0.02              # x/y position
    ranges[5] = 0.05                # height
    ranges[space.n_v:space.n_v + 3] = 4.0    # angular velocity
    ranges[space.n_v + 3:space.n_v + 6] = 1.0  # linear velocity
    sampler = UniformSampler(space, torch.as_tensor(ranges),
                             x_0=torch.as_tensor(x_0))
    generator = ExperimentDatasetGenerator(
        base, sampler, base.initial_params(),
        DataGenerationConfig(dt=DT, n_pop=n_pop,
                             trajectory_length=trajectory_length,
                             static_noise=None, dynamic_noise=None))
    return generator.generate(storage,
                              batch_size=min(generation_batch, n_pop))


def build_experiment(system: str = "cube", contactnets: bool = True,
                     box: bool = True, storage: str = "./storage",
                     run_name: str = "run", epochs: int = EPOCHS,
                     eval_period: int = 1, eval_samples: int = 5,
                     use_wandb: bool = False, device: Optional[str] = None,
                     batch_size: int = BATCH_SIZE,
                     initial_urdf: Optional[str] = None,
                     dtype=torch.float32, **experiment_options):
    """The CLI's experiment on ``storage`` (its data generated or
    imported already): the ``MultibodyLearnableExperiment`` of the
    options :func:`run` takes."""
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

    learnable_fields = {f.name for f in dataclasses.fields(
        MultibodyLearnableSystemConfig)}
    learnable_options = {key: experiment_options.pop(key)
                         for key in list(experiment_options)
                         if key in learnable_fields}
    urdf = get_asset(system if box else f"{system}_mesh")
    config = SupervisedLearningExperimentConfig(
        data_config=DataConfig(
            dt=DT, train_fraction=0.5, valid_fraction=0.25,
            test_fraction=0.25, slice_config=TrajectorySliceConfig()),
        base_config=MultibodySystemConfig(urdfs={system: urdf}),
        learnable_config=MultibodyLearnableSystemConfig(
            urdfs={system: initial_urdf or urdf},
            loss=(MultibodyLosses.CONTACTNETS_LOSS if contactnets else
                  MultibodyLosses.PREDICTION_LOSS),
            **learnable_options),
        optimizer_config=OptimizerConfig(
            lr=Float(LEARNING_RATE), wd=Float(0.0), patience=PATIENCE,
            epochs=epochs, batch_size=Int(batch_size)),
        full_evaluation_period=eval_period,
        full_evaluation_samples=eval_samples,
        storage=storage, run_name=run_name, run_wandb=use_wandb,
        **experiment_options,
    )
    return MultibodyLearnableExperiment(config, device=device, dtype=dtype)


def run(system: str = "cube", source: str = "simulation",
        contactnets: bool = True, box: bool = True,
        real_data_dir: Optional[str] = None, storage: str = "./storage",
        run_name: Optional[str] = None, epochs: int = EPOCHS,
        n_pop: int = N_POP, eval_period: int = 1, eval_samples: int = 5,
        use_wandb: bool = False, device: Optional[str] = None,
        generation_batch: int = GENERATION_BATCH,
        epoch_callback: Callable = default_epoch_callback,
        batch_size: int = BATCH_SIZE, initial_urdf: Optional[str] = None,
        dtype=torch.float32, **experiment_options) -> Dict:
    """Runs the ContactNets system-identification experiment end to end:
    data generation (or import), training with evaluation and checkpoints,
    the final evaluation, and the learned URDFs' export.

    ``initial_urdf`` is the URDF the learned system starts from (default:
    the ground truth's, as in the JAX package's CLI), ``dtype`` the
    parameters' (float32, as in the JAX package). ``experiment_options``
    are further fields of
    ``SupervisedLearningExperimentConfig`` (e.g. ``video_period``,
    ``shard_training``, ``shard_evaluation``) or of
    ``MultibodyLearnableSystemConfig`` (e.g. ``use_warm_loss``).

    In a process group (``parallel/multiprocess.initialize``) every rank
    calls ``run``: rank 0 generates the data and writes the run's files,
    the others wait for its data and write nothing.

    Returns:
        ``{"experiment", "best_params", "statistics", "generated",
        "urdfs"}``.
    """
    from dair_pll_tpu_torch.parallel import sharding
    from dair_pll_tpu_torch.utils import file_utils

    run_name = run_name or (
        f"{system}_{source}_"
        f"{'contactnets' if contactnets else 'prediction'}_"
        f"{'box' if box else 'mesh'}")

    generated = 0
    if sharding.rank() == 0:
        if source == "real":
            if system != "cube":
                raise ValueError("real data is available for the cube")
            if not real_data_dir:
                raise ValueError("--real-data-dir is required with "
                                 "--source real")
            count = file_utils.import_data_to_storage(storage,
                                                      real_data_dir)
            print(f"imported {count} real trajectories", flush=True)
        else:
            generated = generate_tosses(system, storage, n_pop,
                                        TRAJECTORY_LENGTHS[system], box,
                                        device, generation_batch)
            print(f"generated {generated} trajectories", flush=True)
    sharding.barrier()

    experiment = build_experiment(
        system, contactnets, box, storage, run_name, epochs, eval_period,
        eval_samples, use_wandb, device, batch_size, initial_urdf, dtype,
        **experiment_options)
    best_params, stats = experiment.generate_results(epoch_callback)
    urdfs = experiment.generate_updated_urdfs(best_params) \
        if experiment.writer else {}

    print("\nfinal statistics:", flush=True)
    for key in sorted(stats):
        if key.endswith("_mean"):
            print(f"  {key}: {stats[key]:.6g}", flush=True)
    return {"experiment": experiment, "best_params": best_params,
            "statistics": stats, "generated": generated, "urdfs": urdfs}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Runs the ContactNets system-identification experiment "
                    "end to end.")
    parser.add_argument("--system", choices=["cube", "elbow"],
                        default="cube")
    parser.add_argument("--source", choices=["simulation", "real"],
                        default="simulation")
    loss = parser.add_mutually_exclusive_group()
    loss.add_argument("--contactnets", dest="contactnets",
                      action="store_true", default=True,
                      help="ContactNets implicit loss (default).")
    loss.add_argument("--prediction", dest="contactnets",
                      action="store_false", help="Prediction loss.")
    geometry = parser.add_mutually_exclusive_group()
    geometry.add_argument("--box", dest="box", action="store_true",
                          default=True, help="Box geometry (default).")
    geometry.add_argument("--mesh", dest="box", action="store_false",
                          help="Learned deep-support mesh.")
    parser.add_argument("--real-data-dir", default=None,
                        help="Directory of real trajectories (.pt or .npy).")
    parser.add_argument("--storage", default="./storage")
    parser.add_argument("--run-name", default=None)
    parser.add_argument("--epochs", type=int, default=EPOCHS)
    parser.add_argument("--n-pop", type=int, default=N_POP)
    parser.add_argument("--eval-period", type=int, default=1,
                        help="epochs between full trajectory evaluations")
    parser.add_argument("--eval-samples", type=int, default=5,
                        help="trajectories sampled per full evaluation")
    tracking = parser.add_mutually_exclusive_group()
    tracking.add_argument("--wandb", dest="use_wandb", action="store_true",
                          default=False)
    tracking.add_argument("--no-wandb", dest="use_wandb",
                          action="store_false")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; "
                             "'cpu' runs on the CPU)")
    parser.add_argument("--shard-training", action="store_true",
                        help="split every minibatch over the ranks of "
                             "torchrun's process group")
    parser.add_argument("--shard-evaluation", action="store_true",
                        help="split the evaluation rollouts over the "
                             "ranks")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """The CLI. Under ``torchrun`` (``WORLD_SIZE`` above 1 in the
    environment) each process joins the process group first, on the card
    of its ``LOCAL_RANK``, or on the CPU when ``--device cpu`` asks for
    it; without a card and without ``--device cpu`` it raises."""
    from dair_pll_tpu_torch.parallel import multiprocess
    args = vars(parse_args(argv))
    device = multiprocess.initialize_from_env(args["device"])
    if device is not None:
        args["device"] = str(device)
    run(**args)


if __name__ == "__main__":
    main()
