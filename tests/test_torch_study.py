"""The PyTorch port's study layer (``dair_pll_tpu_torch/study.py``, a copy
of the JAX package's on the port's experiment) and its example
(``dair_pll_tpu_torch.examples.study_cube``), mirroring
``tests/test_study.py``: successive halving with the Sobol and the TPE
sampler on a deterministic stand-in experiment, held against the JAX
package's ``Study`` (the same trials, suggestions, pruning and best
values), the dataset sweep with its plot, and the example end to end on
the CPU at a tiny size."""
import os

import numpy as np
import pytest

from dair_pll_tpu import study as jstudy
from dair_pll_tpu.hyperparameter import Float as JFloat
from dair_pll_tpu.training.config import (
    OptimizerConfig as JOptimizerConfig,
    SupervisedLearningExperimentConfig as JConfig)
from dair_pll_tpu.utils import file_utils as jfile_utils
from dair_pll_tpu_torch import study as tstudy
from dair_pll_tpu_torch.hyperparameter import Float
from dair_pll_tpu_torch.training.config import (
    OptimizerConfig, SupervisedLearningExperimentConfig)
from dair_pll_tpu_torch.utils import file_utils


class FakeExperiment:
    """Deterministic stand-in: valid loss = |log10 lr + 3| + 1 / epochs
    (the JAX package's test's)."""

    def __init__(self, config):
        self.config = config

    def train(self, epoch_callback):
        lr = self.config.optimizer_config.lr.value
        epochs = self.config.optimizer_config.epochs
        loss = abs(np.log10(lr) - np.log10(1e-3)) + 1.0 / epochs
        return loss, loss, None

    def generate_results(self, epoch_callback):
        loss, _, _ = self.train(epoch_callback)
        return None, {"test_model_trajectory_mse_mean": loss}


def _study(package, storage, sampler="sobol", n_trials=8, seed=0,
           epochs=16, lr=1e-3):
    float_, optimizer, config, study = (
        (JFloat, JOptimizerConfig, JConfig, jstudy) if package == "jax"
        else (Float, OptimizerConfig, SupervisedLearningExperimentConfig,
              tstudy))
    base = config(optimizer_config=optimizer(
        lr=float_(lr, log=True, low=1e-5, high=1e-1)),
        storage=str(storage), run_name="unused")
    base.optimizer_config.epochs = epochs
    return study.Study(study.StudyConfig(
        experiment_factory=FakeExperiment, base_config=base,
        study_name="test_study", n_trials=n_trials, min_epochs=2,
        reduction_factor=2, seed=seed, sampler=sampler))


@pytest.mark.parametrize("sampler", ["sobol", "tpe", "random"])
def test_optimize_hyperparameters_matches_jax(tmp_path, sampler):
    """Each sampler's study on the stand-in: the same saved trials (their
    suggestions, losses, epochs and pruning) and best values as the JAX
    package's, most trials pruned, the winner within the bounds."""
    kwargs = dict(sampler=sampler, n_trials=12 if sampler == "tpe" else 8,
                  seed=1 if sampler == "tpe" else 0,
                  epochs=8 if sampler == "tpe" else 16,
                  lr=1e-2 if sampler == "tpe" else 1e-3)
    best = _study("torch", tmp_path / "torch", **kwargs) \
        .optimize_hyperparameters()
    want = _study("jax", tmp_path / "jax", **kwargs) \
        .optimize_hyperparameters()
    assert best == want
    saved = file_utils.load_hyperparameters(str(tmp_path / "torch"),
                                            "test_study")
    reference = jfile_utils.load_hyperparameters(str(tmp_path / "jax"),
                                                 "test_study")
    assert saved == reference
    assert saved["values"] == best
    assert 1e-5 < best["optimizer_config.lr"] < 1e-1
    assert len([t for t in saved["trials"] if t["pruned"]]) >= 4


def test_study_tpe_sampler_end_to_end(tmp_path):
    """``sampler="tpe"``: both phases run, every trial is recorded, and
    the exploitation phase lands a trial at least as close to the optimum
    as the exploration median."""
    best = _study("torch", tmp_path, sampler="tpe", n_trials=12, seed=1,
                  epochs=8, lr=1e-2).optimize_hyperparameters()
    saved = file_utils.load_hyperparameters(str(tmp_path), "test_study")
    assert len(saved["trials"]) == 12
    errs = [abs(np.log10(t["suggestion"]["optimizer_config.lr"]) + 3.0)
            for t in saved["trials"]]
    explore_median = np.median(errs[:6])
    assert min(errs[6:]) <= explore_median
    assert abs(np.log10(best["optimizer_config.lr"]) + 3.0) <= \
        explore_median


def test_datasweep_and_plot(tmp_path):
    """The dataset sweep calls the generator per size and saves every
    repetition's statistics; its plot (log-Gaussian bands) is a png, the
    same band as the JAX package's, in the JAX package's house style
    (``plot_styler``: the same settings and colours)."""
    study = _study("torch", tmp_path, n_trials=2)
    generated = []
    results = study.run_datasweep_sample(
        [4, 16], generate_data=generated.append, repetitions=2)
    assert generated == [4, 16]
    assert set(results) == {4, 16} and len(results[4]) == 2
    assert "test_model_trajectory_mse_mean" in results[4][0]
    from dair_pll_tpu import sweep_plot as jsweep
    from dair_pll_tpu_torch import sweep_plot
    values = np.array([0.5, 2.0, 1.0])
    assert sweep_plot.log_gaussian_band(values) == \
        jsweep.log_gaussian_band(values)
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt
    from dair_pll_tpu import plot_styler as jstyler
    from dair_pll_tpu_torch import plot_styler
    keys = ("figure.dpi", "font.size", "legend.fontsize", "axes.grid",
            "lines.linewidth", "savefig.bbox", "axes.prop_cycle")
    jstyler.set_default_styling(font_size=12)
    want = {key: plt.rcParams[key] for key in keys}
    plt.rcdefaults()
    plot_styler.set_default_styling(font_size=12)
    assert {key: plt.rcParams[key] for key in keys} == want
    assert plot_styler.COLORS == jstyler.COLORS
    path = sweep_plot.plot_sweep_metric(
        results, "test_model_trajectory_mse_mean", str(tmp_path / "plots"))
    assert path.endswith(".png") and os.path.getsize(path) > 0


def test_study_cube_example_on_the_cpu(tmp_path):
    """``python -m dair_pll_tpu_torch.examples.study_cube`` on the CPU:
    two trials of two epochs on 4 tosses of 8 states with the TPE
    sampler train the port's experiment, save the study and return the
    best values; the main entry parses the same options."""
    from dair_pll_tpu_torch.examples import study_cube
    out = study_cube.run(storage=str(tmp_path), n_trials=2, max_epochs=2,
                         n_pop=4, sampler="tpe", device="cpu",
                         trajectory_length=8)
    saved = file_utils.load_hyperparameters(str(tmp_path), "cube_study")
    assert saved["values"] == out["best"]
    assert len(saved["trials"]) == 2
    assert all(np.isfinite(t["valid_loss"]) for t in saved["trials"])
    args = study_cube.parse_args(["--device", "cpu", "--n-trials", "3",
                                  "--sampler", "random", "--sweep"])
    assert (args.device, args.n_trials, args.sampler, args.sweep) == \
        ("cpu", 3, "random", True)
