"""The port's baseline and cross-validation examples in process on the
CPU, at tiny sizes, as ``tests/test_torch_examples.py`` runs the ContactNets
CLI: ``deep_learnable_baseline`` (MLP and recurrent),
``residual_physics_cube``, ``mujoco_cross_validation`` and
``contactnets_cube_dynamic_data_source``. Each runs through ``run`` with
``device="cpu"`` (a falling train loss where the data is not the model's
own, the files written), then through ``main`` with ``--device cpu`` on
the same storage, which must resume from the finished checkpoint. The
trajectories are cut to 8 to 12 states (every vmapped rollout step costs
about 0.2 s on a CPU).
"""
import json
import os

import pytest

from dair_pll_tpu_torch.examples import (contactnets_cube_dynamic_data_source
                                         as dynamic)
from dair_pll_tpu_torch.examples import contactnets_simple
from dair_pll_tpu_torch.examples import deep_learnable_baseline as deep
from dair_pll_tpu_torch.examples import residual_physics_cube as residual
from dair_pll_tpu_torch.utils import file_utils

SHORT = 8


def recorder():
    epochs = []

    def callback(epoch, params, train_loss, best_valid):
        epochs.append((epoch, train_loss))
    return epochs, callback


def assert_run_files(storage, run_name, epochs):
    run_dir = os.path.join(storage, "runs", run_name)
    for name in ("checkpoint.npz", "log.jsonl", "statistics.pkl"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    with open(os.path.join(run_dir, "log.jsonl"), encoding="utf-8") as f:
        logged = [json.loads(line)["epoch"] for line in f if line.strip()]
    assert [e for e in logged if e >= 0] == list(range(epochs + 1))


def assert_falls(epochs):
    """The last reported train loss under epoch 0's. (With the examples'
    patience equal to the epochs, the last epoch reports no callback when
    the validation loss never improved: it ends the run.)"""
    losses = [loss for _, loss in epochs]
    assert [e for e, _ in epochs][:3] == [0, 1, 2]
    assert losses[-1] < losses[0], losses


@pytest.fixture(scope="module")
def tosses(tmp_path_factory):
    """Eight cube tosses of 8 states from the ContactNets CLI's
    generator."""
    storage = str(tmp_path_factory.mktemp("tosses"))
    contactnets_simple.generate_tosses("cube", storage, 8, SHORT,
                                       device="cpu")
    return storage


@pytest.mark.parametrize("model,history", [("mlp", 1), ("recurrent", 3)])
def test_deep_baseline(tosses, tmp_path, capsys, model, history):
    import shutil
    storage = str(tmp_path / "storage")
    shutil.copytree(tosses, storage)
    epochs, callback = recorder()
    out = deep.run(model, storage, epochs=3, hidden_size=16,
                   t_history=history, device="cpu", epoch_callback=callback)
    assert_falls(epochs)
    assert_run_files(storage, f"deep_{model}", 3)
    assert "test_model_loss_mean" in out["statistics"]
    assert "train_oracle_trajectory_mse_mean" in out["statistics"]
    capsys.readouterr()
    deep.main(["--device", "cpu", "--model", model, "--storage", storage,
               "--epochs", "3", "--hidden-size", "16", "--t-history",
               str(history)])
    printed = capsys.readouterr().out
    assert "final statistics:" in printed and "epoch 0" not in printed


def test_residual_physics(tmp_path, capsys, monkeypatch):
    storage = str(tmp_path / "storage")
    epochs, callback = recorder()
    out = residual.run(epochs=3, n_pop=8, storage=storage, device="cpu",
                       trajectory_length=SHORT, epoch_callback=callback)
    assert out["generated"] == 8
    assert_falls(epochs)
    assert_run_files(storage, "residual_cube", 3)
    assert "residual_weight_norm" in json.loads(open(os.path.join(
        storage, "runs", "residual_cube", "log.jsonl")).readline())
    capsys.readouterr()
    monkeypatch.setattr(residual, "TRAJECTORY_LENGTH", SHORT)
    residual.main(["--device", "cpu", "--epochs", "3", "--n-pop", "8",
                   "--storage", storage])
    printed = capsys.readouterr().out
    assert "generated 0 trajectories" in printed
    assert "final statistics:" in printed and "epoch 0" not in printed


def test_mujoco_cross_validation(tmp_path, capsys):
    pytest.importorskip("mujoco")
    from dair_pll_tpu_torch.examples import mujoco_cross_validation as mjx
    storage = str(tmp_path / "storage")
    epochs, callback = recorder()
    out = mjx.run(n_pop=8, trajectory_length=12, epochs=2, storage=storage,
                  device="cpu", epoch_callback=callback, video_period=0)
    assert [e for e, _ in epochs][:2] == [0, 1]
    assert len(out["ukf_improvements"]) == 3
    assert_run_files(storage, "mujoco_cross_validation", 2)
    stats = out["statistics"]
    for key in ("test_oracle_loss_mean", "test_model_loss_mean"):
        assert key in stats
    assert len(file_utils.list_trajectories(file_utils.trajectory_dir(
        storage, file_utils.GROUND_TRUTH_SUBDIR))) == 8
    capsys.readouterr()
    mjx.main(["--device", "cpu", "--n-pop", "8", "--trajectory-length",
              "12", "--epochs", "2", "--storage", storage])
    printed = capsys.readouterr().out
    assert "UKF position errors" in printed
    assert "final statistics" in printed and "epoch 0" not in printed


def test_dynamic_data_source(tosses, tmp_path, capsys):
    """Four trajectories arrive at the start and four after epoch 0's
    report, before the first training epoch rescans; the split grows (the data are the model's own, so its loss starts at
    rounding level and is not asked to fall)."""
    source = file_utils.trajectory_dir(tosses, file_utils.LEARNING_SUBDIR)
    storage = str(tmp_path / "storage")
    sizes = []

    def callback(epoch, params, train_loss, best_valid):
        sizes.append(len(file_utils.list_trajectories(
            file_utils.trajectory_dir(storage, file_utils.LEARNING_SUBDIR))))

    out = dynamic.run(source, storage, epochs=2, drip_period=1,
                      drip_size=4, device="cpu", epoch_callback=callback,
                      video_period=0)
    assert out["dripped"] == [4, 8]
    assert sizes[:2] == [8, 8]
    split = out["experiment"].data_manager.trajectory_set_indices()
    assert sum(len(s) for s in split) == 8
    assert_run_files(storage, "cube_dynamic", 2)
    capsys.readouterr()
    dynamic.main(["--device", "cpu", "--source-data-dir", source,
                  "--storage", storage, "--epochs", "2"])
    printed = capsys.readouterr().out
    assert "final valid loss" in printed and "epoch 0" not in printed
