r"""Training-state checkpointing (PyTorch).

Counterpart of ``dair_pll_tpu/utils/checkpoint.py``: the complete
resumable state (the train/valid/test split, the best and current
parameters, the optimizer state, the epoch counters, the best validation
loss, the run id and the finished flag) pickled as one file whose arrays
are host numpy arrays, written atomically with SIGINT ignored, as the
reference's ``experiment.py:671-679`` writes it.

Parameters are stored as the list of their leaves in ``parameters()``
order (JAX's ``tree_leaves`` order) and read back by
:func:`~dair_pll_tpu_torch.params.tree_from_leaves`.
The optimizer state is the ``torch.optim`` state dict with every tensor
moved to numpy. A checkpoint holds only builtins and numpy arrays, so it
unpickles without either package's classes.
"""
from __future__ import annotations

import dataclasses
import io
import os
import pickle
import signal
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class TrainingState:
    """Complete summary of the training process state. In memory the
    parameters are :class:`MultibodyParams` (or leaf lists) and the
    optimizer state a state dict of tensors; :func:`load_checkpoint` gives
    numpy leaves and numpy state."""
    split_indices: Tuple[List[int], List[int], List[int]]
    best_params: Any
    current_params: Any
    optimizer_state: Any
    epoch: int = 1
    epochs_since_best: int = 0
    best_valid_loss: float = 1e10
    run_id: Optional[str] = None
    finished_training: bool = False


def to_host(tree: Any) -> Any:
    """Tensors of nested dictionaries, lists and tuples as numpy arrays;
    parameters (anything with ``parameters()``) as their leaf list."""
    if hasattr(tree, "parameters"):
        tree = tree.parameters()
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {key: to_host(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(value) for value in tree)
    return tree


def to_device(tree: Any, device) -> Any:
    """The inverse of :func:`to_host` for state dicts: numpy arrays as
    tensors on ``device``."""
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree, device=device)
    if isinstance(tree, dict):
        return {key: to_device(value, device) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(value, device) for value in tree)
    return tree


def save_checkpoint(path: str, state: TrainingState) -> None:
    """Atomically saves a training state, ignoring SIGINT during the
    write."""
    payload = {
        "split_indices": state.split_indices,
        "best_params": to_host(state.best_params),
        "current_params": to_host(state.current_params),
        "optimizer_state": to_host(state.optimizer_state),
        "epoch": state.epoch,
        "epochs_since_best": state.epochs_since_best,
        "best_valid_loss": float(state.best_valid_loss),
        "run_id": state.run_id,
        "finished_training": state.finished_training,
    }

    previous = signal.getsignal(signal.SIGINT)
    try:
        signal.signal(signal.SIGINT, signal.SIG_IGN)
    except ValueError:
        previous = None  # not the main thread
    try:
        buffer = io.BytesIO()
        pickle.dump(payload, buffer)
        tmp_path = path + ".tmp"
        with open(tmp_path, "wb") as handle:
            handle.write(buffer.getvalue())
        os.replace(tmp_path, path)
    finally:
        if previous is not None:
            signal.signal(signal.SIGINT, previous)


def load_checkpoint(path: str) -> Optional[TrainingState]:
    """Loads a training state; ``None`` if no checkpoint exists."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as handle:
        payload = pickle.load(handle)
    return TrainingState(**payload)
