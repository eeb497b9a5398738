"""The PyTorch port's cross-process layer
(``dair_pll_tpu_torch/parallel/multiprocess.py``), mirroring
``tests/test_multiprocess.py``: the file and TCP trial coordinators
(claims, results, rounds, the shared token, expired leases and stale
claims, two real processes), held against the JAX package's, whose
server and client speak to the port's in both directions; the port's
study through a coordinator; concurrent asset reads; and
``initialize``, ``initialize_from_env`` and ``global_batch`` with a
gloo process group of two processes on the CPU. Every subprocess has a
free port and a timeout of its own."""
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from dair_pll_tpu.parallel import multiprocess as jmp
from dair_pll_tpu_torch.parallel import multiprocess as tmp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"torch": tmp, "jax": jmp}
TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _race(coords, indices):
    """Each coordinator claims what it can of ``indices`` in a thread of
    its own and publishes each claim's result; returns the wins."""
    wins = {name: [] for name in coords}

    def run(name, coord):
        for index in coord.claim_iter(0, indices):
            wins[name].append(index)
            coord.publish_result(0, index, {"valid_loss": float(index),
                                            "epochs_run": 2})

    threads = [threading.Thread(target=run, args=item)
               for item in coords.items()]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=TIMEOUT)
    return wins


def test_concurrent_get_asset_never_tears(tmp_path):
    """Concurrent ``get_asset`` callers sharing one cache directory never
    read a truncated file."""
    cache = str(tmp_path / "assets")
    script = (
        "import sys, xml.etree.ElementTree as ET\n"
        "sys.path.insert(0, %r)\n"
        "from dair_pll_tpu_torch.assets import get_asset\n"
        "for _ in range(50):\n"
        "    ET.parse(get_asset('cube', cache_dir=%r))\n"
        "    ET.parse(get_asset('elbow', cache_dir=%r))\n"
        "print('ok')\n" % (REPO, cache, cache))
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for _ in range(4)]
    for proc in procs:
        out, _ = proc.communicate(timeout=TIMEOUT)
        assert proc.returncode == 0, out.decode(errors="replace")[-2000:]


@pytest.mark.parametrize("other", ["torch", "jax"])
def test_file_trial_coordinator_claims_and_gathers(tmp_path, other):
    """Two claimants (the port's, and the port's or the JAX package's on
    the same directory) claim every trial exactly once; the results
    gather."""
    root = str(tmp_path / "coord")
    a = tmp.FileTrialCoordinator(root)
    b = PACKAGES[other].FileTrialCoordinator(root)
    indices = list(range(12))
    wins = _race({"a": a, "b": b}, indices)
    assert sorted(wins["a"] + wins["b"]) == indices
    results = a.gather_results(0, indices, timeout_s=5.0)
    assert set(results) == set(indices)
    assert results[7]["valid_loss"] == 7.0


@pytest.mark.parametrize("server_side,client_side",
                         [("torch", "torch"), ("torch", "jax"),
                          ("jax", "torch")])
def test_tcp_trial_coordinator_claims_and_gathers(server_side, client_side):
    """The same contract over TCP, the port's server and clients speaking
    the JAX package's protocol: every trial claimed once, results
    gathered, rounds independent."""
    server = PACKAGES[server_side].TrialCoordinatorServer(host="127.0.0.1")
    address = server.start()
    try:
        a = tmp.TcpTrialCoordinator(address)
        b = PACKAGES[client_side].TcpTrialCoordinator(address)
        indices = list(range(12))
        wins = _race({"a": a, "b": b}, indices)
        assert sorted(wins["a"] + wins["b"]) == indices
        results = b.gather_results(0, indices, timeout_s=5.0)
        assert set(results) == set(indices)
        assert results[7]["valid_loss"] == 7.0
        assert a.try_claim(1, 0) and not b.try_claim(1, 0)
    finally:
        server.shutdown()


def test_tcp_trial_coordinator_two_processes():
    """Two real worker processes race through the port's TCP server;
    every trial is claimed once and each result names its claimant."""
    server = tmp.TrialCoordinatorServer(host="127.0.0.1")
    address = server.start()
    script = (
        "import os, sys\n"
        "sys.path.insert(0, %r)\n"
        "from dair_pll_tpu_torch.parallel.multiprocess import "
        "TcpTrialCoordinator\n"
        "coord = TcpTrialCoordinator(%r)\n"
        "for index in coord.claim_iter(0, range(16)):\n"
        "    coord.publish_result(0, index, {'pid': os.getpid()})\n"
        "print('ok')\n" % (REPO, address))
    try:
        procs = [subprocess.Popen([sys.executable, "-c", script],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
                 for _ in range(2)]
        for proc in procs:
            out, _ = proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0, out.decode(errors="replace")[-2000:]
        results = tmp.TcpTrialCoordinator(address).gather_results(
            0, range(16), timeout_s=5.0)
        assert set(results) == set(range(16))
        assert all("pid" in payload for payload in results.values())
    finally:
        server.shutdown()


def test_tcp_coordinator_rejects_bad_token():
    """Requests without the server's shared token are refused."""
    server = tmp.TrialCoordinatorServer(host="127.0.0.1")
    address = server.start()
    try:
        assert "?token=" in address
        intruder = tmp.TcpTrialCoordinator(address.partition("?")[0])
        with pytest.raises(PermissionError):
            intruder.try_claim(0, 0)
        with pytest.raises(PermissionError):
            intruder.publish_result(0, 0, {"valid_loss": -1e9})
        assert tmp.TcpTrialCoordinator(address).try_claim(0, 0)
    finally:
        server.shutdown()


def test_tcp_coordinator_reclaims_expired_lease():
    """An orphaned claim becomes claimable after the lease; a published
    trial never does. The lease is 2 s, so that a loaded machine does not
    outlast it between the first claim and the second."""
    server = tmp.TrialCoordinatorServer(host="127.0.0.1", claim_ttl_s=2.0)
    address = server.start()
    try:
        a = tmp.TcpTrialCoordinator(address)
        b = tmp.TcpTrialCoordinator(address)
        assert a.try_claim(0, 0) and a.try_claim(0, 1)
        a.publish_result(0, 1, {"valid_loss": 1.0})
        assert not b.try_claim(0, 0)
        time.sleep(2.1)
        assert b.try_claim(0, 0)
        assert not b.try_claim(0, 1)
    finally:
        server.shutdown()


def test_file_coordinator_steals_stale_claim(tmp_path):
    """An old claim file with no result is stolen exactly once."""
    root = str(tmp_path / "coord")
    crashed = tmp.FileTrialCoordinator(root, claim_ttl_s=0.2)
    assert crashed.try_claim(0, 0) and crashed.try_claim(0, 1)
    crashed.publish_result(0, 1, {"valid_loss": 1.0})
    assert not tmp.FileTrialCoordinator(root, claim_ttl_s=3600.0) \
        .try_claim(0, 0)
    time.sleep(0.3)
    stealers = [tmp.FileTrialCoordinator(root, claim_ttl_s=0.2)
                for _ in range(4)]
    wins = []
    threads = [threading.Thread(
        target=lambda c=c: wins.append(1) if c.try_claim(0, 0) else None)
        for c in stealers]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=TIMEOUT)
    assert len(wins) == 1
    assert not stealers[0].try_claim(0, 1)


def _stub_study(tmp_path, calls, **coordination):
    from dair_pll_tpu_torch import study as study_mod
    from dair_pll_tpu_torch.data.config import (DataConfig,
                                                TrajectorySliceConfig)
    from dair_pll_tpu_torch.hyperparameter import Float, Int
    from dair_pll_tpu_torch.training.config import (
        OptimizerConfig, SupervisedLearningExperimentConfig)

    class StubExperiment:
        def __init__(self, config):
            self.config = config

        def train(self, callback):
            calls.append(self.config.run_name)
            lr = float(self.config.optimizer_config.lr.value)
            return 0.0, abs(np.log10(lr) + 4.0), None

    base = SupervisedLearningExperimentConfig(
        data_config=DataConfig(dt=0.01,
                               slice_config=TrajectorySliceConfig()),
        base_config=None, learnable_config=None,
        optimizer_config=OptimizerConfig(
            lr=Float(1e-3, log=True, low=1e-6, high=1e-1),
            wd=Float(0.0, log=False, low=0.0, high=0.1),
            patience=4, epochs=4, batch_size=Int(8)),
        storage=str(tmp_path / "storage"), run_name="stub")
    return study_mod.Study(study_mod.StudyConfig(
        experiment_factory=StubExperiment, base_config=base,
        study_name="coordinated", n_trials=4, min_epochs=2,
        **coordination))


def test_study_with_tcp_coordinator(tmp_path):
    """The port's study runs its rungs through the TCP coordinator, with
    the best values of the serial study."""
    calls = []
    server = tmp.TrialCoordinatorServer(host="127.0.0.1")
    address = server.start()
    try:
        best = _stub_study(tmp_path / "tcp", calls,
                           coordination_address=address) \
            .optimize_hyperparameters()
    finally:
        server.shutdown()
    assert "optimizer_config.lr" in best and calls
    assert best == _stub_study(tmp_path / "serial", []) \
        .optimize_hyperparameters()


def test_study_with_coordinator_single_process(tmp_path):
    """With a file coordinator one process claims every trial, and the
    study runs each once per rung, as the serial one does."""
    calls, serial = [], []
    best = _stub_study(tmp_path / "file", calls,
                       coordination_dir=str(tmp_path / "coord")) \
        .optimize_hyperparameters()
    want = _stub_study(tmp_path / "serial", serial) \
        .optimize_hyperparameters()
    assert best == want and calls == serial


def test_initialize_two_processes(monkeypatch):
    """``initialize`` joins two processes in a gloo group over ``tcp://``
    (on the CPU, as the caller asks); ``initialize_from_env`` reads torchrun's
    variables; ``global_batch`` keeps a rank's rows; an all_reduce sums
    the ranks'."""
    port = _free_port()
    script = (
        "import os, sys\n"
        "sys.path.insert(0, %r)\n"
        "import torch, torch.distributed as dist\n"
        "from dair_pll_tpu_torch.parallel import multiprocess, sharding\n"
        "device = multiprocess.initialize_from_env('cpu')\n"
        "assert str(device) == 'cpu' and dist.get_backend() == 'gloo'\n"
        "rank = sharding.rank()\n"
        "rows = multiprocess.global_batch(torch.full((2,), rank + 1.0))\n"
        "total = sharding.all_reduce_sum(rows.clone(), sharding.make_mesh())\n"
        "assert total.tolist() == [3.0, 3.0], total\n"
        "assert multiprocess.initialize_from_env() is None\n"
        "dist.destroy_process_group()\n"
        "print('ok', rank)\n" % REPO)
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen([sys.executable, "-c", script],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, env=env))
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for other in procs:
                other.kill()
            pytest.fail("a process of the group timed out")
        assert proc.returncode == 0, out.decode(errors="replace")[-2000:]
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmp.initialize_from_env() is None
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tmp.initialize_from_env() is None


def test_torchrun_without_a_card_raises(monkeypatch, tmp_path):
    """Under a torchrun environment with no card, neither
    ``initialize_from_env`` nor the CLI falls back to the CPU: both raise
    unless the caller passes the CPU, before any process group is
    joined."""
    import torch
    import torch.distributed as dist
    from dair_pll_tpu_torch.examples import contactnets_simple
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, value in (("MASTER_ADDR", "127.0.0.1"),
                        ("MASTER_PORT", str(_free_port())),
                        ("WORLD_SIZE", "2"), ("RANK", "0"),
                        ("LOCAL_RANK", "0")):
        monkeypatch.setenv(name, value)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmp.initialize_from_env()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        contactnets_simple.main(["--storage", str(tmp_path),
                                 "--epochs", "1", "--no-wandb"])
    assert not dist.is_initialized()
