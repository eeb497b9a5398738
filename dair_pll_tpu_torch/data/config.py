r"""Data pipeline configuration.

A copy of ``dair_pll_tpu/data/config.py`` (it imports no JAX).

Mirrors the reference's ``data_config.py``
(``dair_pll/data_config.py:4-45``) with the same validity
contracts in ``__post_init__``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TrajectorySliceConfig:
    """How trajectories are sliced into (history, future) training pairs.

    Attributes:
        t_skip: index of first time to predict from.
        t_history: number of history states in each slice input.
        t_prediction: number of future states in each slice target.
    """
    t_skip: int = 0
    t_history: int = 1
    t_prediction: int = 1

    def __post_init__(self):
        assert self.t_skip >= 0
        assert self.t_history >= 1
        assert self.t_prediction >= 1
        # first predicted step must see a full history window
        assert self.t_skip + 1 >= self.t_history


@dataclasses.dataclass
class DataConfig:
    """Dataset configuration.

    Attributes:
        dt: trajectory time step in seconds.
        train_fraction/valid_fraction/test_fraction: split proportions
          (must sum to at most 1).
        slice_config: slicing layout.
        update_dynamically: re-scan the data directory every epoch (the
          reference's drip-feed mode, ``data_config.py:36-38``).
    """
    dt: float = 1e-3
    train_fraction: float = 0.5
    valid_fraction: float = 0.25
    test_fraction: float = 0.25
    slice_config: TrajectorySliceConfig = dataclasses.field(
        default_factory=TrajectorySliceConfig)
    update_dynamically: bool = False

    def __post_init__(self):
        assert self.dt > 0
        total = (self.train_fraction + self.valid_fraction +
                 self.test_fraction)
        assert total <= 1.0 + 1e-9
        assert min(self.train_fraction, self.valid_fraction,
                   self.test_fraction) >= 0
