"""The port's ContactNets CLI (``python -m
dair_pll_tpu_torch.examples.contactnets_simple``) on the CPU, and a scan of
the port's sources for imports of ``jax``, ``dair_pll_tpu`` and ``click``.

The CLI runs in process through its ``main`` with ``--device cpu --epochs
2 --n-pop 8``, for the box cube (then again, which must resume), the ICNN
cube (``--mesh``) and the elbow. The trajectories are cut from the CLI's
80 and 120 states to 8 (``TRAJECTORY_LENGTHS``, patched for the test):
every rollout step of the vmapped integrator costs about 0.2 s on this
CPU, and the flow is the same at any length.
"""
import ast
import json
import os

import pytest

from dair_pll_tpu_torch.examples import contactnets_simple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHORT_LENGTHS = {"cube": 8, "elbow": 8}
FORBIDDEN = ("jax", "dair_pll_tpu", "click")


def _run(capsys, monkeypatch, storage, *flags):
    monkeypatch.setattr(contactnets_simple, "TRAJECTORY_LENGTHS",
                        SHORT_LENGTHS)
    contactnets_simple.main(["--device", "cpu", "--epochs", "2",
                             "--n-pop", "8", "--storage", storage, *flags])
    return capsys.readouterr().out


def _check_output(out: str, generated: int) -> None:
    assert f"generated {generated} trajectories" in out, out
    assert "final statistics:" in out, out
    means = [line for line in out.splitlines()
             if line.strip().split(":")[0].endswith("_mean")]
    keys = {line.strip().split(":")[0] for line in means}
    for key in ("test_model_loss_mean", "valid_model_trajectory_mse_mean",
                "train_oracle_loss_mean", "train_delta_v_squared_mean"):
        assert key in keys, sorted(keys)


def _logged_epochs(run_dir: str):
    """The epochs of the training log (the final evaluation's videos log
    as epoch -1)."""
    with open(os.path.join(run_dir, "log.jsonl"), encoding="utf-8") as f:
        records = [json.loads(line) for line in f if line.strip()]
    for record in records:
        if record["epoch"] >= 0:
            for key in ("train_loss", "valid_loss", "training_duration",
                        "evaluation_duration", "logging_duration",
                        "cube::body_m"):
                assert key in record, sorted(record)
    return [r["epoch"] for r in records if r["epoch"] >= 0]


def test_cli_cube_box_and_resume(capsys, monkeypatch, tmp_path):
    storage = str(tmp_path)
    out = _run(capsys, monkeypatch, storage)
    _check_output(out, 8)
    assert "epoch 0: train" in out, out
    run_dir = os.path.join(storage, "runs", "cube_simulation_contactnets_box")
    for name in ("checkpoint.npz", "log.jsonl", "statistics.pkl",
                 os.path.join("urdfs", "cube.urdf")):
        assert os.path.exists(os.path.join(run_dir, name)), name
    assert _logged_epochs(run_dir) == [0, 1, 2]

    out = _run(capsys, monkeypatch, storage)
    _check_output(out, 0)
    # The finished run resumes from its checkpoint: no epoch runs again.
    assert "epoch 0: train" not in out, out
    assert _logged_epochs(run_dir) == [0, 1, 2]


@pytest.mark.parametrize("flags", [("--mesh",), ("--system", "elbow")],
                         ids=["cube_mesh", "elbow"])
def test_cli_mesh_and_elbow(capsys, monkeypatch, tmp_path, flags):
    out = _run(capsys, monkeypatch, str(tmp_path), *flags)
    _check_output(out, 8)
    assert "epoch 0: train" in out, out


def test_cli_rejects_bad_arguments(capsys):
    with pytest.raises(SystemExit):
        contactnets_simple.parse_args(["--system", "paddle"])
    with pytest.raises(ValueError, match="real-data-dir"):
        contactnets_simple.run(source="real", device="cpu")


def _imported_modules(path: str):
    with open(path, encoding="utf-8") as handle:
        tree = ast.parse(handle.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_import_no_jax_or_click():
    """Every import statement of the port, those inside functions too."""
    found = []
    package = os.path.join(REPO, "dair_pll_tpu_torch")
    for root, _, files in os.walk(package):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            for module in _imported_modules(path):
                if module.split(".")[0] in FORBIDDEN:
                    found.append((os.path.relpath(path, REPO), module))
    assert not found, found
    assert os.path.exists(os.path.join(
        package, "examples", "contactnets_simple.py"))
