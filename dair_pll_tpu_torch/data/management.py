r"""Trajectory dataset management: splits, slicing, batched device arrays.

A copy of ``dair_pll_tpu/data/management.py`` (it imports no JAX). The
experiment moves the stacked slices to the device once per run.

Rebuild of the reference's ``dataset_management.py``
(``dair_pll/dataset_management.py:17-230``): instead of a
``torch.utils.data.Dataset`` of per-slice tensors consumed by a
``DataLoader``, slices are stacked into contiguous ``(n_slices, t, n_x)``
arrays, which the experiment moves to the device once and gathers batches
from by index.

Split determinism mirrors the reference: trajectory indices are split by
fraction under a seeded permutation, and the split is stored in the
checkpoint so resume restores the identical partition
(``dataset_management.py:150-186``, ``experiment.py:502-532``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dair_pll_tpu_torch.data.config import DataConfig
from dair_pll_tpu_torch.utils import file_utils


@dataclasses.dataclass
class TrajectorySet:
    """Trajectories plus their stacked (history, future) slices.

    Attributes:
        trajectories: list of ``(T_i, n_x)`` arrays (lengths may differ).
        indices: on-disk index of each trajectory.
        slices_past: ``(n_slices, t_history, n_x)`` stacked history windows.
        slices_future: ``(n_slices, t_prediction, n_x)`` stacked futures.
    """
    trajectories: List[np.ndarray]
    indices: List[int]
    slices_past: np.ndarray
    slices_future: np.ndarray

    @property
    def n_slices(self) -> int:
        return self.slices_past.shape[0]


def slice_trajectories(trajectories: Sequence[np.ndarray], t_skip: int,
                       t_history: int, t_prediction: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Slices trajectories into stacked (history, future) pairs.

    For each trajectory and each start ``t`` with
    ``t >= t_skip + t_history - 1`` and room for ``t_prediction`` future
    steps, emits ``x[t - t_history + 1 : t + 1]`` and
    ``x[t + 1 : t + 1 + t_prediction]`` (reference
    ``dataset_management.py:17-67``).

    Returns:
        past: ``(n_slices, t_history, n_x)``.
        future: ``(n_slices, t_prediction, n_x)``.
    """
    # Prefer the native threaded slicer (native/slicer.cpp) when built;
    # the Python loop below is the reference implementation and fallback.
    if len(trajectories):
        from dair_pll_tpu_torch.data import native
        if native.native_available():
            return native.slice_trajectories_native(
                trajectories, t_skip, t_history, t_prediction)

    pasts, futures = [], []
    for trajectory in trajectories:
        T = trajectory.shape[0]
        # Predict-from times start at t_skip (the slice config guarantees
        # t_skip + 1 >= t_history, so the history window is in range).
        for t in range(t_skip, T - t_prediction):
            pasts.append(trajectory[t - t_history + 1:t + 1])
            futures.append(trajectory[t + 1:t + 1 + t_prediction])
    if not pasts:
        n_x = trajectories[0].shape[-1] if len(trajectories) else 0
        return (np.zeros((0, t_history, n_x)),
                np.zeros((0, t_prediction, n_x)))
    return np.stack(pasts), np.stack(futures)


class ExperimentDataManager:
    """Splits on-disk trajectories into train/valid/test trajectory sets.

    Mirrors reference ``ExperimentDataManager``
    (``dataset_management.py:108-230``): a seeded permutation of on-disk
    indices is partitioned by the configured fractions; with
    ``update_dynamically`` the directory is re-scanned and new
    trajectories appended to the (persisted) permutation.
    """

    def __init__(self, storage: str, config: DataConfig,
                 split_indices: Optional[Tuple[Sequence[int], Sequence[int],
                                               Sequence[int]]] = None,
                 seed: int = 0,
                 subdir: str = file_utils.LEARNING_SUBDIR) -> None:
        self.storage = storage
        self.config = config
        self.seed = seed
        self.subdir = subdir
        self._rng = np.random.default_rng(seed)
        if split_indices is not None:
            self._train_indices = list(split_indices[0])
            self._valid_indices = list(split_indices[1])
            self._test_indices = list(split_indices[2])
        else:
            self._train_indices = []
            self._valid_indices = []
            self._test_indices = []
        self._assigned = set(self._train_indices + self._valid_indices +
                             self._test_indices)
        self._cache: dict = {}

    def trajectory_set_indices(self) -> Tuple[List[int], List[int],
                                              List[int]]:
        """Current train/valid/test on-disk index partition (persisted in
        checkpoints for split-identity on resume)."""
        return (list(self._train_indices), list(self._valid_indices),
                list(self._test_indices))

    def _scan_and_assign(self) -> None:
        directory = file_utils.trajectory_dir(self.storage, self.subdir)
        paths = file_utils.list_trajectories(directory)
        new_indices = [i for i in range(len(paths))
                       if i not in self._assigned]
        if not new_indices:
            return
        config = self.config
        perm = self._rng.permutation(len(new_indices))
        shuffled = [new_indices[i] for i in perm]
        n = len(shuffled)
        n_train = int(round(config.train_fraction * n))
        n_valid = int(round(config.valid_fraction * n))
        self._train_indices.extend(shuffled[:n_train])
        self._valid_indices.extend(shuffled[n_train:n_train + n_valid])
        n_test = int(round(config.test_fraction * n))
        self._test_indices.extend(
            shuffled[n_train + n_valid:n_train + n_valid + n_test])
        self._assigned.update(shuffled[:n_train + n_valid + n_test])

    def _load_set(self, indices: List[int]) -> TrajectorySet:
        key = tuple(indices)
        if key in self._cache:
            return self._cache[key]
        directory = file_utils.trajectory_dir(self.storage, self.subdir)
        paths = file_utils.list_trajectories(directory)
        trajectories = [
            np.asarray(file_utils.load_trajectory(paths[i]),
                       dtype=np.float32) for i in indices]
        slice_config = self.config.slice_config
        past, future = slice_trajectories(
            trajectories, slice_config.t_skip, slice_config.t_history,
            slice_config.t_prediction)
        result = TrajectorySet(
            trajectories=trajectories, indices=list(indices),
            slices_past=past, slices_future=future)
        self._cache[key] = result
        return result

    def make_sampled_set(self, trajectory_set: TrajectorySet,
                         n_samples: int) -> TrajectorySet:
        """A sub-``TrajectorySet`` of the first ``n_samples`` trajectories,
        re-sliced — the per-epoch evaluation sample of reference
        ``experiment.py:446-466``."""
        n = min(n_samples, len(trajectory_set.trajectories))
        trajectories = trajectory_set.trajectories[:n]
        slice_config = self.config.slice_config
        past, future = slice_trajectories(
            trajectories, slice_config.t_skip, slice_config.t_history,
            slice_config.t_prediction)
        return TrajectorySet(
            trajectories=trajectories,
            indices=list(trajectory_set.indices[:n]),
            slices_past=past, slices_future=future)

    def get_trajectory_sets(self) -> Tuple[TrajectorySet, TrajectorySet,
                                           TrajectorySet]:
        """Scans the data directory (assigning any new trajectories) and
        returns (train, valid, test) trajectory sets."""
        self._scan_and_assign()
        return (self._load_set(self._train_indices),
                self._load_set(self._valid_indices),
                self._load_set(self._test_indices))

    # alias matching the reference API name (dataset_management.py:200).
    get_updated_trajectory_sets = get_trajectory_sets
