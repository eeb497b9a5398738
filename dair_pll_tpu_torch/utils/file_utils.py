r"""On-disk storage layout and save/load helpers.

A copy of ``dair_pll_tpu/utils/file_utils.py`` (it imports no JAX), kept
in the port so that the port imports nothing of the JAX package; the
storage trees of the two packages are the same.

Mirrors the storage tree of the reference's ``file_utils.py``
(``dair_pll/file_utils.py:16-33``)::

    <storage>/
      data/
        ground_truth/{i}.npy         # clean trajectories
        learning/{i}.npy             # noised trajectories
      runs/<run_name>/
        checkpoint.npz               # training state
        statistics.pkl               # final evaluation
        config.pkl                   # experiment config provenance
        urdfs/                       # re-exported learned URDFs
        log.jsonl                    # per-epoch scalar log
      studies/<study_name>/
        optimal_hyperparameters.json

Trajectories are stored as ``.npy`` (or loaded from the reference's ``.pt``
through torch) — both formats are transparent to
:func:`load_trajectory`.
"""
from __future__ import annotations

import json
import os
import pickle
from glob import glob
from typing import Any, Dict, List

import numpy as np

GROUND_TRUTH_SUBDIR = "ground_truth"
LEARNING_SUBDIR = "learning"


def data_dir(storage: str) -> str:
    """``<storage>/data`` (creates it)."""
    path = os.path.join(storage, "data")
    os.makedirs(path, exist_ok=True)
    return path


def trajectory_dir(storage: str, subdir: str) -> str:
    """``<storage>/data/<subdir>`` (creates it)."""
    path = os.path.join(data_dir(storage), subdir)
    os.makedirs(path, exist_ok=True)
    return path


def run_dir(storage: str, run_name: str) -> str:
    """``<storage>/runs/<run_name>`` (creates it)."""
    path = os.path.join(storage, "runs", run_name)
    os.makedirs(path, exist_ok=True)
    return path


def urdf_dir(storage: str, run_name: str) -> str:
    """``<storage>/runs/<run_name>/urdfs`` (creates it)."""
    path = os.path.join(run_dir(storage, run_name), "urdfs")
    os.makedirs(path, exist_ok=True)
    return path


def study_dir(storage: str, study_name: str) -> str:
    """``<storage>/studies/<study_name>`` (creates it)."""
    path = os.path.join(storage, "studies", study_name)
    os.makedirs(path, exist_ok=True)
    return path


def checkpoint_path(storage: str, run_name: str) -> str:
    """Training-state checkpoint file path."""
    return os.path.join(run_dir(storage, run_name), "checkpoint.npz")


def log_path(storage: str, run_name: str) -> str:
    """Per-epoch scalar log path."""
    return os.path.join(run_dir(storage, run_name), "log.jsonl")


def trajectory_path(storage: str, subdir: str, index: int) -> str:
    """Numbered trajectory file path (``.npy``)."""
    return os.path.join(trajectory_dir(storage, subdir), f"{index}.npy")


def save_trajectory(storage: str, subdir: str, index: int,
                    trajectory: np.ndarray) -> str:
    """Saves one ``(T, n_x)`` trajectory."""
    path = trajectory_path(storage, subdir, index)
    np.save(path, np.asarray(trajectory))
    return path


def load_trajectory(path: str) -> np.ndarray:
    """Loads a trajectory from ``.npy``/``.npz`` or the reference's ``.pt``
    format."""
    if path.endswith(".pt"):
        import torch
        return torch.load(path, weights_only=True).numpy()
    arr = np.load(path, allow_pickle=False)
    return np.asarray(arr)


def list_trajectories(directory: str) -> List[str]:
    """Numbered trajectory files ``{i}.npy`` / ``{i}.pt`` in order,
    consecutively from 0 (matching reference ``file_utils.py:106-135``)."""
    paths = []
    index = 0
    while True:
        found = None
        for extension in (".npy", ".pt"):
            candidate = os.path.join(directory, f"{index}{extension}")
            if os.path.exists(candidate):
                found = candidate
                break
        if found is None:
            break
        paths.append(found)
        index += 1
    return paths


def save_pickle(path: str, obj: Any) -> None:
    """Pickles an object to a path."""
    with open(path, "wb") as handle:
        pickle.dump(obj, handle)


def load_pickle(path: str) -> Any:
    """Unpickles an object from a path."""
    with open(path, "rb") as handle:
        return pickle.load(handle)


def save_evaluation(storage: str, run_name: str,
                    evaluation: Dict) -> None:
    """Saves a statistics dictionary to ``statistics.pkl``."""
    save_pickle(
        os.path.join(run_dir(storage, run_name), "statistics.pkl"),
        evaluation)


def load_evaluation(storage: str, run_name: str) -> Dict:
    """Loads ``statistics.pkl`` (raises ``FileNotFoundError`` if absent)."""
    path = os.path.join(run_dir(storage, run_name), "statistics.pkl")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return load_pickle(path)


def save_config(storage: str, run_name: str, config: Any) -> None:
    """Pickles the experiment config for provenance."""
    save_pickle(os.path.join(run_dir(storage, run_name), "config.pkl"),
                config)


def save_string(path: str, string: str) -> None:
    """Writes a string to a file."""
    with open(path, "w", encoding="utf-8") as handle:
        handle.write(string)


def save_hyperparameters(storage: str, study_name: str,
                         values: Dict) -> None:
    """Saves optimal hyperparameters as JSON (reference
    ``file_utils.py:33``)."""
    path = os.path.join(study_dir(storage, study_name),
                        "optimal_hyperparameters.json")
    with open(path, "w", encoding="utf-8") as handle:
        json.dump(values, handle, indent=2)


def load_hyperparameters(storage: str, study_name: str) -> Dict:
    """Loads optimal hyperparameters JSON."""
    path = os.path.join(study_dir(storage, study_name),
                        "optimal_hyperparameters.json")
    with open(path, "r", encoding="utf-8") as handle:
        return json.load(handle)


def import_data_to_storage(storage: str, import_data_dir: str,
                           subdir: str = LEARNING_SUBDIR) -> int:
    """Copies external trajectory files into the storage tree (reference
    ``file_utils.py:82-103``), converting ``.pt`` to ``.npy``.

    Returns:
        Number of trajectories imported.
    """
    sources = sorted(
        glob(os.path.join(import_data_dir, "*.pt")) +
        glob(os.path.join(import_data_dir, "*.npy")))
    count = 0
    for source in sources:
        trajectory = load_trajectory(source)
        save_trajectory(storage, subdir, count, trajectory)
        count += 1
    return count
