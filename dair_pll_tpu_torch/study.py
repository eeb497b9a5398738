r"""Hyperparameter optimization and dataset-size sweep studies (PyTorch).

A copy of ``dair_pll_tpu/study.py`` on the port's experiment layer (it
imports no JAX): the samplers, the successive-halving rungs, the
cross-process trial coordinators (``parallel/multiprocess.py``) and the
dataset sweep are the JAX package's; each trial trains the port's
experiment on the card. Rebuild of the reference's ``study.py``
(``/root/reference/dair_pll/study.py:27-203``). The reference delegates
search to optuna (TPE sampler + Hyperband pruner, optional remote RDB
server); optuna is not a dependency here, so the study layer implements a
self-contained sampler stack — **Sobol quasi-random** (default),
**TPE-style adaptive** (Sobol exploration then Parzen-surrogate
exploitation), or i.i.d. random — **with successive-halving
(Hyperband-style) pruning**: trials are sampled from the hyperparameter
distributions embedded in the config (``dair_pll_tpu_torch.hyperparameter``),
run in rungs of increasing epoch budget, and the worst fraction is
pruned at each rung.

Trials are embarrassingly parallel — the natural multi-slice decomposition
(mirroring the reference's parallel-trials-over-RDB design,
``study.py:134-148``); each trial's inner training step can itself be
data-parallel over cards (``shard_training``).
"""
from __future__ import annotations

import copy
import dataclasses
import math
import os
from typing import Any, Callable, Dict, List

import numpy as np

from dair_pll_tpu_torch.hyperparameter import (
    generate_quasirandom_suggestions, generate_suggestion,
    generate_tpe_suggestions, load_suggestion)
from dair_pll_tpu_torch.training.config import SupervisedLearningExperimentConfig
from dair_pll_tpu_torch.utils import file_utils

ExperimentFactory = Callable[[SupervisedLearningExperimentConfig], Any]


@dataclasses.dataclass
class StudyConfig:
    """Study configuration (role of reference ``StudyConfig``,
    ``study.py:27-38``).

    Attributes:
        experiment_factory: builds an experiment from a config.
        base_config: template experiment config (with hyperparameter
          objects embedded).
        study_name: name for the storage tree.
        n_trials: total trials to sample.
        min_epochs: epoch budget of the first rung.
        reduction_factor: successive-halving reduction per rung (eta).
        seed: sampling seed.
        sampler: ``"sobol"`` (default — scrambled low-discrepancy
          sequence, better space coverage at equal trial budgets),
          ``"tpe"`` (adaptive: the first half of the trial budget
          explores via Sobol, then a Parzen good/bad surrogate
          conditioned on those results proposes the second half — the
          self-contained analogue of the reference's optuna TPE,
          ``study.py:127-160``), or ``"random"`` (i.i.d. draws, the
          round-1 behavior).
        coordination_dir: optional shared directory for cross-process
          trial dispatch (``parallel.multiprocess.FileTrialCoordinator``
          — the analogue of the reference's shared-optuna-RDB parallel
          trials, ``study.py:134-148``). Every participating process
          runs ``optimize_hyperparameters`` with the same config/seed;
          trials are claimed atomically, results gathered per rung.
        coordination_address: optional ``host:port`` of a running
          :class:`parallel.multiprocess.TrialCoordinatorServer` — the
          genuinely cross-HOST dispatch mechanism (no shared filesystem
          needed; the direct analogue of the reference's
          ``OPTUNA_SERVER`` RDB). Mutually exclusive with
          ``coordination_dir``.
    """
    experiment_factory: ExperimentFactory
    base_config: SupervisedLearningExperimentConfig
    study_name: str = "study"
    n_trials: int = 16
    min_epochs: int = 2
    reduction_factor: int = 2
    seed: int = 0
    sampler: str = "sobol"
    coordination_dir: str = ""
    coordination_address: str = ""


@dataclasses.dataclass
class Trial:
    """One hyperparameter trial's bookkeeping."""
    index: int
    suggestion: Dict[str, Any]
    valid_loss: float = math.inf
    epochs_run: int = 0
    pruned: bool = False


class Study:
    """Runs hyperparameter optimization over an experiment config."""

    def __init__(self, config: StudyConfig) -> None:
        self.config = config

    def _run_trial(self, trial: Trial, epochs: int) -> float:
        """(Re)runs a trial up to ``epochs`` epochs, resuming from its
        checkpoint if present; returns best validation loss."""
        config = copy.deepcopy(self.config.base_config)
        load_suggestion(config, trial.suggestion)
        config.optimizer_config.epochs = epochs
        config.run_name = (f"{self.config.study_name}_trial_"
                           f"{trial.index}")
        experiment = self.config.experiment_factory(config)
        _, best_valid, _ = experiment.train(lambda *args: None)
        trial.epochs_run = epochs
        trial.valid_loss = float(best_valid)
        return trial.valid_loss

    def _sample_suggestions(self, n: int, completed: List[Trial]) -> \
            List[Dict[str, Any]]:
        """Draws ``n`` suggestions per the configured sampler; ``tpe``
        conditions on completed trials (deterministic in seed+results so
        cross-process studies stay consistent)."""
        study_config = self.config
        if study_config.sampler == "tpe" and completed:
            return generate_tpe_suggestions(
                study_config.base_config,
                [trial.suggestion for trial in completed],
                [trial.valid_loss for trial in completed], n,
                # Offset the seed so the exploit phase's candidate draws
                # decorrelate from the Sobol exploration scramble.
                seed=study_config.seed + 7919)
        if study_config.sampler in ("sobol", "tpe"):
            return generate_quasirandom_suggestions(
                study_config.base_config, n, study_config.seed)
        rng = np.random.default_rng(study_config.seed)
        suggestions = []
        for _ in range(n):
            config = copy.deepcopy(study_config.base_config)
            suggestions.append(generate_suggestion(config, rng))
        return suggestions

    def _run_rung_loop(self, active: List[Trial], coordinator,
                       round_index: int) -> int:
        """Successive-halving rung loop over ``active`` trials; returns
        the next unused round index (rung indices are unique study-wide
        for the cross-process coordinator)."""
        study_config = self.config
        epochs = study_config.min_epochs
        max_epochs = study_config.base_config.optimizer_config.epochs
        while active:
            rung_epochs = min(epochs, max_epochs)
            if coordinator is None:
                for trial in active:
                    self._run_trial(trial, rung_epochs)
            else:
                # Cross-process rung: claim trials atomically, run the
                # claimed subset, then gather everyone's results. All
                # processes derive identical suggestions (same seed +
                # identical gathered results), so the rung state stays
                # consistent without messaging.
                indices = [trial.index for trial in active]
                by_index = {trial.index: trial for trial in active}
                for index in coordinator.claim_iter(round_index, indices):
                    trial = by_index[index]
                    self._run_trial(trial, rung_epochs)
                    coordinator.publish_result(
                        round_index, index,
                        {"valid_loss": trial.valid_loss,
                         "epochs_run": trial.epochs_run})
                results = coordinator.gather_results(round_index, indices)
                for index, payload in results.items():
                    by_index[index].valid_loss = payload["valid_loss"]
                    by_index[index].epochs_run = payload["epochs_run"]
            round_index += 1
            active.sort(key=lambda t: t.valid_loss)
            if len(active) == 1 or epochs >= max_epochs:
                break
            keep = max(1, len(active) // study_config.reduction_factor)
            for trial in active[keep:]:
                trial.pruned = True
            active = active[:keep]
            epochs *= study_config.reduction_factor
        return round_index

    def optimize_hyperparameters(self) -> Dict[str, Any]:
        """Sampled search + successive halving; returns (and saves) the
        best hyperparameter values (role of reference
        ``optimize_hyperparameters``, ``study.py:127-160``). With
        ``sampler="tpe"`` the trial budget splits into a Sobol
        exploration phase and a surrogate-guided exploitation phase, each
        with its own halving rungs."""
        study_config = self.config

        coordinator = None
        assert not (study_config.coordination_dir and
                    study_config.coordination_address), (
            "coordination_dir and coordination_address are mutually "
            "exclusive")
        if study_config.coordination_dir:
            from dair_pll_tpu_torch.parallel.multiprocess import (
                FileTrialCoordinator)
            coordinator = FileTrialCoordinator(
                study_config.coordination_dir)
        elif study_config.coordination_address:
            from dair_pll_tpu_torch.parallel.multiprocess import (
                TcpTrialCoordinator)
            coordinator = TcpTrialCoordinator(
                study_config.coordination_address)

        if study_config.sampler == "tpe":
            n_explore = max(2, study_config.n_trials // 2)
            phases = [n_explore, study_config.n_trials - n_explore]
            phases = [count for count in phases if count > 0]
        else:
            phases = [study_config.n_trials]

        trials: List[Trial] = []
        round_index = 0
        for phase_count in phases:
            suggestions = self._sample_suggestions(phase_count, trials)
            phase_trials = [
                Trial(index=len(trials) + offset, suggestion=suggestion)
                for offset, suggestion in enumerate(suggestions)]
            trials.extend(phase_trials)
            round_index = self._run_rung_loop(
                list(phase_trials), coordinator, round_index)

        best = min(trials, key=lambda t: t.valid_loss)
        file_utils.save_hyperparameters(
            study_config.base_config.storage, study_config.study_name,
            {"values": best.suggestion, "valid_loss": best.valid_loss,
             "trials": [dataclasses.asdict(t) for t in trials]})
        return best.suggestion

    def run_datasweep_sample(self, data_sizes: List[int],
                             generate_data: Callable[[int], None],
                             repetitions: int = 1) -> Dict[int, List[Dict]]:
        """Dataset-size sweep: trains the (fixed-hyperparameter) config on
        increasing data populations (role of reference ``study``/
        ``run_datasweep_sample``, ``study.py:74-112``).

        Args:
            data_sizes: trajectory counts to train with.
            generate_data: callback ensuring at least n trajectories exist.
            repetitions: independent repetitions per size.

        Returns:
            size -> list of final statistics dictionaries.
        """
        results: Dict[int, List[Dict]] = {}
        for size in data_sizes:
            generate_data(size)
            results[size] = []
            for repetition in range(repetitions):
                config = copy.deepcopy(self.config.base_config)
                config.run_name = (f"{self.config.study_name}_sweep_"
                                   f"{size}_{repetition}")
                experiment = self.config.experiment_factory(config)
                _, stats = experiment.generate_results(lambda *a: None)
                results[size].append(stats)
        sweep_path = os.path.join(
            file_utils.study_dir(self.config.base_config.storage,
                                 self.config.study_name),
            "datasweep.pkl")
        file_utils.save_pickle(sweep_path, results)
        return results
