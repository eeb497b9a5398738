r"""Dataset-size sweep plots with log-Gaussian confidence bands.

A copy of ``dair_pll_tpu/sweep_plot.py`` for the port's studies
(``matplotlib`` is imported inside the functions). Rebuild of the reference's ``sweep_plot.py``
(``/root/reference/dair_pll/sweep_plot.py:36-119``): for each swept metric,
plots the geometric mean over repetitions against dataset size with a
one-geometric-standard-deviation band, on log-log axes.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from dair_pll_tpu_torch.plot_styler import save_figure, set_default_styling


def log_gaussian_band(values: np.ndarray):
    """Geometric mean and one-geometric-sigma band of positive samples."""
    logs = np.log(np.maximum(values, 1e-30))
    mean = logs.mean()
    std = logs.std()
    return np.exp(mean), np.exp(mean - std), np.exp(mean + std)


def plot_sweep_metric(sweep_results: Dict[int, List[Dict]], metric: str,
                      output_dir: str, label: str = "") -> str:
    """Plots one statistics-dictionary metric across dataset sizes.

    Args:
        sweep_results: dataset size -> list of statistics dicts (from
          :meth:`dair_pll_tpu_torch.study.Study.run_datasweep_sample`).
        metric: statistics key to plot (e.g.
          ``"test_model_trajectory_mse_mean"``).
        output_dir: output directory for the png.
        label: y-axis label (defaults to the metric name).

    Returns:
        Saved figure path.
    """
    set_default_styling()
    import matplotlib.pyplot as plt

    sizes = sorted(sweep_results)
    means, lows, highs = [], [], []
    for size in sizes:
        values = np.array([
            float(stats[metric]) for stats in sweep_results[size]
            if metric in stats])
        mean, low, high = log_gaussian_band(values)
        means.append(mean)
        lows.append(low)
        highs.append(high)

    figure, axis = plt.subplots(figsize=(6, 4))
    axis.plot(sizes, means, marker="o")
    axis.fill_between(sizes, lows, highs, alpha=0.25)
    axis.set_xscale("log")
    axis.set_yscale("log")
    axis.set_xlabel("number of training trajectories")
    axis.set_ylabel(label or metric)
    path = save_figure(figure, output_dir, f"sweep_{metric}")
    plt.close(figure)
    return path
