r"""Experiment configuration dataclasses.

A copy of ``dair_pll_tpu/training/config.py`` (it imports no JAX). The two
sharding flags work over ``torch.distributed``: with a process group of
more than one rank (one process per card, as ``torchrun`` starts them;
``parallel/multiprocess.initialize``), ``shard_training`` splits every
minibatch over the ranks and averages the gradients, and
``shard_evaluation`` splits the evaluation rollouts
(``training/experiment.py``'s ``training_mesh`` and
``evaluation_mesh``); with no process group or one rank the run is
unsharded.

Mirrors the reference's ``experiment_config.py``
(``dair_pll/experiment_config.py:12-71``) with the same
hyperparameter-typed optimizer fields and default priors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from dair_pll_tpu_torch.data.config import DataConfig
from dair_pll_tpu_torch.hyperparameter import Float, Int


@dataclasses.dataclass
class SystemConfig:
    """Base class for configs describing a system (reference
    ``experiment_config.py:12-16``)."""


@dataclasses.dataclass
class OptimizerConfig:
    """Optimizer configuration (Adam, ``torch.optim``, with optax's
    semantics).

    Default hyperpriors match reference ``experiment_config.py:19-34``:
    lr = 1e-5 (log), wd = 4e-5 (log), batch = 64 (log), epochs = 1e4,
    patience = 30.

    ``lr_schedule`` selects the learning-rate schedule (beyond the
    reference, which only trains at constant lr): ``"constant"`` or
    ``"cosine"`` (cosine decay from ``lr`` to ``cosine_alpha * lr`` over
    the full ``epochs`` budget, measured in optimizer steps with the
    initial epoch's step count; late-phase lr decay settles the
    geometry/friction trade-off that constant-lr runs keep oscillating
    across — see ``results/cube_mesh_r3.json``).
    """
    lr: Float = dataclasses.field(default_factory=lambda: Float(1e-5))
    wd: Float = dataclasses.field(default_factory=lambda: Float(4e-5))
    patience: int = 30
    epochs: int = 10000
    batch_size: Int = dataclasses.field(default_factory=lambda: Int(64))
    lr_schedule: str = "constant"
    cosine_alpha: float = 0.1
    #: Global-norm gradient clip (0 = off). Stabilizes wrong-init
    #: training on high-energy data protocols (e.g. sliding-rich elbow
    #: tosses), where the first epochs' gradients overwhelm Adam.
    grad_clip: float = 0.0

    def __post_init__(self):
        assert self.lr_schedule in ("constant", "cosine")


_SELECTION_METRICS = ("prediction", "objective")


@dataclasses.dataclass
class SupervisedLearningExperimentConfig:
    """Complete experiment configuration (reference
    ``experiment_config.py:37-71``).

    Attributes:
        data_config: dataset layout and splits.
        base_config: config of the ground-truth data-generating system.
        learnable_config: config of the system to be trained.
        optimizer_config: optimization settings.
        storage: storage tree root directory.
        run_name: run identifier (subdirectory under ``runs/``).
        run_wandb / wandb_project: external experiment tracking (optional;
          local JSONL logging always happens).
        full_evaluation_period: epochs between full trajectory evaluations.
        full_evaluation_samples: trajectories per full evaluation.
        selection_metric: metric monitored for model selection and early
          stopping: ``"prediction"`` (the validation trajectory-evaluation
          prediction loss, the reference's behavior,
          ``experiment.py:647-657``) or ``"objective"`` (the training
          objective evaluated on the validation slices — e.g. the
          ContactNets loss for ContactNets runs; robust on high-energy
          protocols whose wrong-init rollout metrics are noisy/diverging
          while the objective is already informative).
        video_period: full evaluations between overlay-video renders
          (rendering is host-side matplotlib and dominates logging wall
          time on small machines — ``results/cube_mesh_r4_fused.json``
          ``wall_seconds_split``); ``0`` disables videos.
        video_max_frames: frame decimation cap per overlay video.
        video_height / video_width: overlay render resolution. Defaults
          are half the reference's 480x640 (dominating cost is
          per-pixel rasterization, so this is ~4x cheaper); set 480/640
          to match the reference exactly.
        update_geometry_in_videos: regenerate visualization geometry.
        shard_evaluation, shard_training: the JAX package's data-parallel
          evaluation and training over several devices. The port runs on
          one card; ``True`` raises until ``ROADMAP.md`` Queue 1 item 6
          (scale-out) is ported.
    """
    data_config: DataConfig = dataclasses.field(default_factory=DataConfig)
    base_config: SystemConfig = dataclasses.field(
        default_factory=SystemConfig)
    learnable_config: SystemConfig = dataclasses.field(
        default_factory=SystemConfig)
    optimizer_config: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    storage: str = "./storage"
    run_name: str = "default_run"
    run_wandb: bool = False
    wandb_project: Optional[str] = None
    full_evaluation_period: int = 1
    full_evaluation_samples: int = 5
    selection_metric: str = "prediction"
    #: With an epoch-warm training loss (``warm_loss_callback``): epochs
    #: between full-budget re-seeding epochs (0 = seed only the first
    #: epoch). Warm solves can STALL at cone creases when started from a
    #: carried near-solution (the semismooth Newton polish makes no
    #: progress there), and stalled entries persist in the cache —
    #: compounding across epochs into contaminated gradients
    #: (``scripts/diag_warm_divergence.py``). Periodic re-seeding
    #: bounds the drift to ``warm_seed_period`` epochs.
    warm_seed_period: int = 8
    video_period: int = 1
    video_max_frames: int = 30
    video_height: int = 240
    video_width: int = 320
    update_geometry_in_videos: bool = False
    shard_evaluation: bool = False
    shard_training: bool = False

    def __post_init__(self):
        assert self.selection_metric in _SELECTION_METRICS, (
            f"selection_metric must be one of {_SELECTION_METRICS}")
