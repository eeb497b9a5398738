"""Data-parallel training and rollouts of the PyTorch port
(``dair_pll_tpu_torch/parallel/sharding.py``) and the experiment's
sharding flags, mirroring the JAX package's ``tests/test_parallel.py``:
two processes in one gloo process group on the CPU
(``tests/torch_parallel_worker.py``, each with a free port and a timeout)
against the same computation in this process, unsharded. The bars are
the JAX package's (``tests/test_parallel.py``): a step's loss rtol 1e-5
and parameters rtol 1e-4 atol 1e-7 (here in float64, so tighter:
rtol 1e-10), gradients to 1e-5 of their largest entry, rollouts atol
1e-5, and the sharded experiment's losses rtol 1e-4 and parameters rtol
1e-6 atol 1e-10 (``tests/test_parallel.py:219-224``). No JAX."""
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from dair_pll_tpu_torch.parallel import sharding

HERE = os.path.dirname(os.path.abspath(__file__))
#: Seconds the two workers may take, startup included.
WORKER_TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def storage(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tosses"))
    cases.toss_storage(path)
    return path


@pytest.fixture(scope="module")
def two_ranks(storage, tmp_path_factory):
    """Both ranks' readings of the two-process run (each on its own copy
    of the tosses)."""
    work = tmp_path_factory.mktemp("two_ranks")
    port = _free_port()
    procs = []
    for rank in range(2):
        copy = str(work / f"storage_{rank}")
        shutil.copytree(storage, copy)
        out = str(work / f"rank{rank}.json")
        env = dict(os.environ, OMP_NUM_THREADS="2")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
             str(port), "2", str(rank), copy, out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env),
            out))
    readings = []
    for proc, out in procs:
        try:
            log, _ = proc.communicate(timeout=WORKER_TIMEOUT)
        except subprocess.TimeoutExpired:
            for other, _ in procs:
                other.kill()
            pytest.fail("a worker of the two-process run timed out")
        assert proc.returncode == 0, log.decode(errors="replace")[-3000:]
        with open(out, encoding="utf-8") as handle:
            readings.append(json.load(handle))
    return readings


@pytest.fixture(scope="module")
def one_rank(storage, tmp_path_factory):
    """The same cases in this process, with no process group."""
    copy = str(tmp_path_factory.mktemp("one_rank") / "storage")
    shutil.copytree(storage, copy)
    mesh = sharding.make_mesh()
    return {"step": cases.data_parallel_steps(mesh),
            "rollout": cases.data_parallel_rollout(mesh),
            "experiment": cases.experiment_run(copy, shard=False)}


def test_mesh_without_a_process_group():
    """Without a process group a mesh has one rank, which takes every row,
    and the experiment's meshes are ``None`` (unsharded), as the JAX
    package's on one device."""
    mesh = sharding.make_mesh()
    assert (mesh.size, mesh.rank, mesh.world) == (1, 0, 1)
    assert mesh.rows(8) == slice(0, 8)
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(sharding.shard_batch(x, mesh), x)
    assert torch.equal(sharding.gather_rows(x, mesh, 3), x)
    halves = sharding.Mesh(2, 1, 3)
    assert halves.rows(8) == slice(4, 8)
    assert sharding.Mesh(2, 2, 3).rows(8) == slice(8, 8)
    with pytest.raises(ValueError):
        halves.rows(7)


def test_sharded_step_matches_single_device(two_ranks, one_rank):
    """Three data-parallel steps over two ranks equal the unsharded ones:
    the losses and the parameters, on both ranks."""
    want = one_rank["step"]
    for rank in two_ranks:
        got = rank["step"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-10)
        for a, b in zip(got["params"], want["params"]):
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14)


def test_sharded_grad_matches_and_loss_decreases(two_ranks, one_rank):
    """The averaged gradient equals the unsharded one leaf for leaf, and
    the steps from perturbed parameters lower the loss."""
    for a, b in zip(two_ranks[0]["step"]["grads"],
                    one_rank["step"]["grads"]):
        scale = np.abs(np.asarray(b)).max() + 1e-8
        np.testing.assert_allclose(np.asarray(a) / scale,
                                   np.asarray(b) / scale, atol=1e-5)
    losses = two_ranks[0]["step"]["losses"]
    assert losses[0] > 0.0 and losses[-1] < losses[0], losses


def test_sharded_rollout_matches(two_ranks, one_rank):
    """The data-parallel rollout (15 states padded to 16, 8 a rank) equals
    the unsharded rollout on every rank."""
    for rank in two_ranks:
        np.testing.assert_allclose(rank["rollout"], one_rank["rollout"],
                                   atol=1e-5)
    assert np.asarray(one_rank["rollout"]).shape == (
        cases.B - 1, cases.ROLLOUT_STEPS + 1, 13)


def test_sharded_training_experiment_matches(two_ranks, one_rank):
    """``train()`` with ``shard_training`` splits each batch of 32 over
    the two ranks (a mesh of 2) and reproduces the unsharded run: the
    losses, the best valid loss and the parameters after two epochs (the
    warm cache's seed and a warm epoch, whose cache merges the ranks'
    columns); the sharded evaluation rollouts too. Rank 0 alone writes
    the run's files."""
    want = one_rank["experiment"]
    assert want["mesh_size"] is None and want["writer"]
    for rank in two_ranks:
        got = rank["experiment"]
        assert got["mesh_size"] == 2
        assert got["writer"] == (rank["rank"] == 0)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        np.testing.assert_allclose(got["best_valid"], want["best_valid"],
                                   rtol=1e-4)
        for a, b in zip(got["params"], want["params"]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-10)
        np.testing.assert_allclose(got["predictions"], want["predictions"],
                                   atol=1e-5)
