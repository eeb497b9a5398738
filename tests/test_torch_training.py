"""The port's training layer against the JAX package's, on the CPU.

* The optimizer chain (non-finite zero-out, global-norm clip, cosine
  schedule, Adam and AdamW, update mask) against optax on a fixed gradient
  sequence, float64: parameters within rtol 1e-12.
* One training epoch of the port against the JAX package's jitted
  ``epoch_fn`` on the same slices, parameters and batch table (batch 16,
  float64): the vmapped ContactNets loss and the prediction loss. Every
  step's loss within rtol 1e-8, the parameters after the epoch within rtol
  1e-6. The JAX epoch runs one batch a call, so that each step's loss is
  read.
* The warm epoch's cache gather and scatter against a hand loop of
  ``contactnets_loss_batch_warm``, and the reseeding cadence. (The JAX
  warm epoch jits the fused loss gradient, which takes minutes on this
  CPU, and is not run here.)
* Checkpoint and resume, resume with a larger budget, the rollback on
  non-finite parameters, the unbiased evaluation pass, the forced
  evaluation of the final epoch and ``selection_metric``.

``test_torch_evaluation.py`` holds the rest of the layer's parity tests
(``evaluate_systems_on_sets``, a JAX checkpoint's parameters, the
multistep and ``loss_dtype`` callbacks); the two share
``torch_experiment_parity.py``.
"""
import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dair_pll_tpu.hyperparameter import Float as JFloat
from dair_pll_tpu.training import config as jconfig
from dair_pll_tpu.training import experiment as jexperiment
from dair_pll_tpu.training import multibody_experiment as jmulti
from dair_pll_tpu_torch.data.management import ExperimentDataManager
from dair_pll_tpu_torch.hyperparameter import Float
from dair_pll_tpu_torch.multibody.learnable_system import (
    MultibodyLearnableSystem)
from dair_pll_tpu_torch.params import tree_from_leaves
from dair_pll_tpu_torch.training import experiment as texperiment
from dair_pll_tpu_torch.training.config import OptimizerConfig
from dair_pll_tpu_torch.training.multibody_experiment import (
    MultibodyLearnableExperiment, MultibodyLosses)
from dair_pll_tpu_torch.utils import file_utils
from dair_pll_tpu_torch.utils.checkpoint import load_checkpoint
from torch_experiment_parity import (BATCH, cube_storage, jax_config,
                                     jax_leaves, jax_params_from_leaves,
                                     port_config)
from torch_parity import perturbed_params

LOSS_RTOL = 1e-8
PARAM_RTOL = 1e-6
OPTIMIZER_RTOL = 1e-12


@pytest.fixture(scope="module")
def storage(tmp_path_factory):
    return cube_storage(str(tmp_path_factory.mktemp("storage")))


# -- the optimizer chain --------------------------------------------------------

OPTIMIZER_CASES = {
    "adam": dict(wd=0.0),
    "adamw_cosine": dict(wd=0.01, lr_schedule="cosine"),
    "clip_mask": dict(wd=0.0, grad_clip=0.5),
    "clip_adamw_cosine": dict(wd=0.003, grad_clip=0.05,
                              lr_schedule="cosine"),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZER_CASES))
def test_optimizer_chain_matches_optax(case):
    options = dict(OPTIMIZER_CASES[case])
    wd = options.pop("wd")
    steps, decay_steps = 7, 5
    rng = np.random.default_rng(17)
    shapes = [(2, 3), (4,), (1,)]
    start = [rng.normal(size=s) for s in shapes]
    grads = [[rng.normal(size=s) * 10 ** rng.uniform(-3, 1) for s in shapes]
             for _ in range(steps)]
    grads[2][0][0, 1] = np.nan
    grads[4][1][2] = np.inf
    masked = "mask" in case
    mask = [np.ones(s) for s in shapes]
    if masked:
        mask[0][0, 0] = 0.0
    sanitised = options.get("grad_clip", 0.0) > 0

    jopt = jconfig.OptimizerConfig(lr=JFloat(1e-2), wd=JFloat(wd),
                                   **options)
    lr = 1e-2
    if jopt.lr_schedule == "cosine":
        lr = optax.cosine_decay_schedule(1e-2, decay_steps=decay_steps,
                                         alpha=jopt.cosine_alpha)
    chain = jexperiment.build_optimizer(jopt, lr)
    j_params = [jnp.asarray(p) for p in start]
    state = chain.init(j_params)

    topt = OptimizerConfig(lr=Float(1e-2), wd=Float(wd), **options)
    leaves = [torch.tensor(p, requires_grad=True) for p in start]
    optimizer = texperiment.build_optimizer(
        topt, leaves,
        decay_steps if topt.lr_schedule == "cosine" else None)
    for step, g in enumerate(grads):
        if not sanitised and not all(np.isfinite(x).all() for x in g):
            continue
        j_grads = [jnp.asarray(x * m) for x, m in zip(g, mask)]
        updates, state = chain.update(j_grads, state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for leaf, x in zip(leaves, g):
            leaf.grad = torch.as_tensor(x)
        optimizer.step([torch.as_tensor(m) for m in mask])
    for leaf, ref in zip(leaves, j_params):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(ref),
                                   rtol=OPTIMIZER_RTOL, atol=1e-15)


def test_leaf_without_gradient_steps_like_optax():
    """A leaf whose ``.grad`` is ``None`` moves as optax moves a leaf with
    a zero gradient (its Adam moments decay; weight decay applies)."""
    topt = OptimizerConfig(lr=Float(1e-2), wd=Float(0.1))
    jopt = jconfig.OptimizerConfig(lr=JFloat(1e-2), wd=JFloat(0.1))
    chain = jexperiment.build_optimizer(jopt, 1e-2)
    j_params = [jnp.asarray([1.0, -2.0]), jnp.asarray([0.5])]
    state = chain.init(j_params)
    leaves = [torch.tensor([1.0, -2.0], dtype=torch.float64,
                           requires_grad=True),
              torch.tensor([0.5], dtype=torch.float64, requires_grad=True)]
    optimizer = texperiment.build_optimizer(topt, leaves)
    for g in ([0.3, -0.1], [0.2, 0.4], [-0.5, 0.1]):
        updates, state = chain.update(
            [jnp.asarray(g), jnp.zeros(1)], state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        leaves[0].grad = torch.tensor(g, dtype=torch.float64)
        optimizer.step()
    for leaf, ref in zip(leaves, j_params):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(ref),
                                   rtol=OPTIMIZER_RTOL, atol=1e-15)


def test_grad_clip_sanitises_poisoned_gradients():
    leaves = [torch.zeros(3, dtype=torch.float64, requires_grad=True),
              torch.zeros(2, dtype=torch.float64, requires_grad=True)]
    optimizer = texperiment.build_optimizer(
        OptimizerConfig(lr=Float(1e-2), wd=Float(0.0), grad_clip=1.0),
        leaves)
    leaves[0].grad = torch.tensor([np.nan, np.inf, 1e30],
                                  dtype=torch.float64)
    leaves[1].grad = torch.tensor([-np.inf, 2.0], dtype=torch.float64)
    optimizer.step()
    assert all(torch.isfinite(leaf).all() for leaf in leaves)
    leaves[0].grad = torch.tensor([1.0, -1.0, 0.5], dtype=torch.float64)
    leaves[1].grad = torch.tensor([0.1, -0.2], dtype=torch.float64)
    before = [leaf.detach().clone() for leaf in leaves]
    optimizer.step()
    for leaf, old in zip(leaves, before):
        assert (torch.abs(leaf - old) <= 1.1e-2).all()


# -- one epoch against the JAX package's jitted epoch ---------------------------

@pytest.mark.parametrize("loss_name", ["CONTACTNETS_LOSS",
                                       "PREDICTION_LOSS"])
def test_epoch_matches_jax(storage, loss_name):
    jexp = jmulti.MultibodyLearnableExperiment(
        jax_config(storage, f"jax_epoch_{loss_name}", loss_name))
    jexp.learned_system, j_init = jexp.get_learned_system()
    texp = MultibodyLearnableExperiment(
        port_config(storage, f"port_epoch_{loss_name}",
                    getattr(MultibodyLosses, loss_name)), device="cpu")
    texp.learned_system, _ = texp.get_learned_system()

    train_set = ExperimentDataManager(
        storage, texp.config.data_config).get_trajectory_sets()[0]
    past = train_set.slices_past.astype(np.float64)
    future = train_set.slices_future.astype(np.float64)
    perm, _ = texperiment.SupervisedLearningExperiment._epoch_permutation(
        np.random.default_rng(713), train_set.n_slices, BATCH)
    j_perm, _ = jexperiment.SupervisedLearningExperiment._epoch_permutation(
        np.random.default_rng(713), train_set.n_slices, BATCH)
    np.testing.assert_array_equal(perm, j_perm)
    batches = perm.reshape(-1, BATCH)
    assert len(batches) >= 2

    rng = np.random.default_rng(23)
    theta, friction, geometry = perturbed_params(
        rng, np.asarray(j_init.theta, np.float64),
        np.asarray(j_init.friction, np.float64),
        [None if g is None else {k: np.asarray(v, np.float64)
                                 for k, v in g.items()}
         for g in j_init.geometry])
    start = [theta, friction] + [g["half_lengths"] for g in geometry
                                 if g is not None]

    chain = jexperiment.build_optimizer(jexp.config.optimizer_config, 1e-3)
    j_params = jax_params_from_leaves(j_init, start)
    j_state = chain.init(j_params)
    epoch_fn, _ = jexp._build_train_epoch(chain, BATCH)
    j_losses = []
    for batch in batches:
        j_params, j_state, loss = epoch_fn(
            j_params, j_state, jnp.asarray(past), jnp.asarray(future),
            jnp.asarray(batch[None]))
        j_losses.append(float(loss))

    params = tree_from_leaves(
        texp.learned_system.model.initial_params(torch.float64), start)
    for leaf in params.parameters():
        leaf.requires_grad_(True)
    optimizer = texperiment.build_optimizer(texp.config.optimizer_config,
                                            params.parameters())
    t_epoch, _ = texp._build_train_epoch(optimizer, BATCH)
    losses = t_epoch(params, optimizer, torch.as_tensor(past),
                     torch.as_tensor(future), torch.as_tensor(batches))
    np.testing.assert_allclose(losses.numpy(), j_losses, rtol=LOSS_RTOL,
                               atol=0)
    for leaf, ref in zip(params.parameters(), jax_leaves(j_params)):
        np.testing.assert_allclose(leaf.detach().numpy(), ref,
                                   rtol=PARAM_RTOL, atol=1e-12)


# -- the warm epoch ------------------------------------------------------------

def test_warm_epoch_cache_against_hand_loop(storage):
    """The warm epochs gather and scatter the impulse cache as a hand loop
    of ``contactnets_loss_batch_warm`` does, bit for bit (the port's CPU
    route: the plain fused loss), a seed epoch then a warm one, on a batch
    table with wraparound duplicates."""
    config = port_config(storage, "warm_epoch", batch=24,
                         learnable={"use_warm_loss": True})
    texp = MultibodyLearnableExperiment(config, device="cpu")
    texp.learned_system, init = texp.get_learned_system()
    system = texp.learned_system
    make_warm_fn, init_cache = texp.warm_loss_callback()
    train_set = ExperimentDataManager(
        storage, config.data_config).get_trajectory_sets()[0]
    past = torch.as_tensor(train_set.slices_past)
    future = torch.as_tensor(train_set.slices_future)
    rng = np.random.default_rng(3)
    tables = [torch.as_tensor(
        texperiment.SupervisedLearningExperiment._epoch_permutation(
            rng, train_set.n_slices, 24)[0].reshape(-1, 24))
        for _ in range(2)]
    assert train_set.n_slices % 24 != 0

    def fresh():
        params = init.map(lambda leaf: leaf.detach().clone())
        for leaf in params.parameters():
            leaf.requires_grad_(True)
        return params, texperiment.build_optimizer(
            config.optimizer_config, params.parameters())

    params, optimizer = fresh()
    cache = init_cache(train_set.n_slices, past.dtype, "cpu")
    got = []
    for seed, table in zip((True, False), tables):
        epoch_fn = texp._build_warm_train_epoch(optimizer, 24, seed)
        got.append(epoch_fn(params, optimizer, cache, past, future, table))

    ref_params, ref_optimizer = fresh()
    ref_cache = torch.zeros_like(cache)
    mask = texp.parameter_update_mask(ref_params).parameters()
    budgets = ((system.ipm_iterations, system.newton_iterations), None)
    want = []
    for budget, table in zip(budgets, tables):
        losses = []
        for indices in table:
            x = past[indices, -1]
            loss, force = system.contactnets_loss_batch_warm(
                ref_params, x, x.new_zeros((len(indices), 0)),
                future[indices, 0], ref_cache[..., indices], budget=budget)
            loss = loss.mean()
            loss.backward()
            for column, index in enumerate(indices.tolist()):
                ref_cache[..., index] = force[..., column].detach()
            ref_optimizer.step(mask)
            losses.append(loss.detach())
        want.append(torch.stack(losses))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.testing.assert_close(cache, ref_cache, rtol=0, atol=0)
    for leaf, ref in zip(params.parameters(), ref_params.parameters()):
        torch.testing.assert_close(leaf, ref, rtol=0, atol=0)
    assert make_warm_fn(True) is not None


def test_warm_epochs_reseed_every_period(storage, monkeypatch):
    """Seed epochs at the cold budget on the first epoch of a process run
    and every ``warm_seed_period`` epochs; warm epochs between. Off on
    the CPU unless asked for."""
    calls = []
    original = MultibodyLearnableSystem.contactnets_loss_batch_warm

    def recording(self, *args, budget=None, **kwargs):
        calls.append(budget)
        return original(self, *args, budget=budget, **kwargs)

    monkeypatch.setattr(MultibodyLearnableSystem,
                        "contactnets_loss_batch_warm", recording)
    config = port_config(storage, "reseed", epochs=4, batch=64,
                         warm_seed_period=2,
                         learnable={"use_warm_loss": True})
    texp = MultibodyLearnableExperiment(config, device="cpu")
    texp.train(lambda *a: None)
    seed = (texp.learned_system.ipm_iterations,
            texp.learned_system.newton_iterations)
    steps = len(calls) // 4
    per_epoch = [calls[i * steps:(i + 1) * steps] for i in range(4)]
    assert [set(c) for c in per_epoch] == [{seed}, {None}, {None}, {seed}]

    auto = MultibodyLearnableExperiment(
        port_config(storage, "auto_warm"), device="cpu")
    auto.learned_system, _ = auto.get_learned_system()
    assert auto.warm_loss_callback() is None
    with pytest.raises(ValueError, match="ContactNets"):
        bad = MultibodyLearnableExperiment(port_config(
            storage, "bad_warm", MultibodyLosses.PREDICTION_LOSS,
            learnable={"use_warm_loss": True}), device="cpu")
        bad.learned_system, _ = bad.get_learned_system()
        bad.warm_loss_callback()


# -- evaluation ------------------------------------------------------------------

def test_eval_epoch_unbiased_by_wraparound(storage):
    config = port_config(storage, "unbiased")

    class Deterministic(MultibodyLearnableExperiment):
        def loss_callback(self):
            def per_slice(params, x_past, x_future):
                return (torch.mean(x_past ** 2, dim=(-2, -1)) +
                        torch.mean(x_future ** 3, dim=(-2, -1)))
            return per_slice

    texp = Deterministic(config, device="cpu")
    optimizer, state = texp.setup_training()
    train_set = texp.data_manager.get_trajectory_sets()[0]
    past = torch.as_tensor(train_set.slices_past, dtype=torch.float64)
    future = torch.as_tensor(train_set.slices_future, dtype=torch.float64)
    batch = 7
    assert train_set.n_slices % batch != 0
    perm, weights = texp._epoch_permutation(np.random.default_rng(0),
                                            train_set.n_slices, batch)
    _, eval_epoch_fn = texp._build_train_epoch(optimizer, batch)
    weighted = float(eval_epoch_fn(
        state.current_params, past, future,
        torch.as_tensor(perm.reshape(-1, batch)),
        torch.as_tensor(weights.reshape(-1, batch), dtype=torch.float64)))
    exact = float(torch.mean(texp.loss_callback()(None, past, future)))
    assert weighted == pytest.approx(exact, rel=1e-12)


# -- the training loop -------------------------------------------------------------

def _log(storage, run_name):
    with open(file_utils.log_path(storage, run_name), encoding="utf-8") as f:
        return {r["epoch"]: r for r in map(json.loads, f)}


def test_checkpoint_resume_and_larger_budget(storage):
    config = port_config(storage, "resume", epochs=2)
    texp = MultibodyLearnableExperiment(config, device="cpu")
    losses = []
    train_loss, best_valid, best = texp.train(
        lambda e, p, tl, bv: losses.append(tl))
    assert losses[-1] < losses[0]
    path = file_utils.checkpoint_path(storage, "resume")
    state = load_checkpoint(path)
    assert state.finished_training and state.epoch == 3
    assert all(isinstance(leaf, np.ndarray) for leaf in state.best_params)
    for leaf, stored in zip(best.parameters(), state.best_params):
        np.testing.assert_array_equal(leaf.detach().numpy(), stored)

    # A finished run resumes without training.
    again = MultibodyLearnableExperiment(config, device="cpu")
    calls = []
    _, best_valid_again, best_again = again.train(
        lambda *a: calls.append(a))
    assert not calls and best_valid_again == best_valid
    assert again.data_manager.trajectory_set_indices() == \
        tuple(map(list, state.split_indices)) or \
        again.data_manager.trajectory_set_indices() == state.split_indices
    for leaf, stored in zip(best_again.parameters(), state.best_params):
        np.testing.assert_array_equal(leaf.detach().numpy(), stored)

    # A larger budget continues from the stored optimizer state.
    longer = MultibodyLearnableExperiment(
        port_config(storage, "resume", epochs=3), device="cpu")
    optimizer, restored = longer.setup_training()
    stored_state = state.optimizer_state["optimizer"]["state"]
    for index, entry in optimizer.state_dict()["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(entry[key].numpy(),
                                          stored_state[index][key])
    epochs = []
    longer.train(lambda e, *a: epochs.append(e))
    assert epochs == [3]
    assert load_checkpoint(path).epoch == 4

    # The checkpoint unpickles without either package.
    code = ("import pickle, sys\n"
            "sys.modules['dair_pll_tpu'] = None\n"
            "sys.modules['dair_pll_tpu_torch'] = None\n"
            "sys.modules['torch'] = None\n"
            f"payload = pickle.load(open({path!r}, 'rb'))\n"
            "print(payload['epoch'])\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0 and proc.stdout.strip() == "4", proc.stderr


def test_non_finite_parameters_roll_back(storage):
    class Exploding(MultibodyLearnableExperiment):
        def loss_callback(self):
            inner = super().loss_callback()

            def loss(params, x_past, x_future):
                # A gradient of inf on theta poisons Adam's step.
                return inner(params, x_past, x_future) + \
                    torch.sum(params.theta) * float("inf")
            return loss

    config = port_config(storage, "explode", epochs=2,
                         learnable={"fix_inertial_scale": False})
    texp = Exploding(config, device="cpu")
    with pytest.raises(RuntimeError, match="non-finite parameters"):
        texp.train(lambda *a: None)
    state = load_checkpoint(file_utils.checkpoint_path(storage, "explode"))
    assert all(np.isfinite(leaf).all() for leaf in state.current_params)
    initial = texp.learned_system.initial_params()
    for leaf, stored in zip(initial.parameters(), state.current_params):
        np.testing.assert_array_equal(leaf.numpy(), stored)


def test_final_epoch_forces_full_evaluation_and_selection(storage):
    """With an evaluation period longer than the run, epochs 0 and the
    last (forced) evaluate; ``selection_metric="objective"`` selects on
    the training objective of the validation slices; the sharding flags
    leave a run without a process group unsharded."""
    config = port_config(storage, "final_eval", epochs=2,
                         selection_metric="objective",
                         full_evaluation_period=100,
                         full_evaluation_samples=1, video_period=0)
    texp = MultibodyLearnableExperiment(config, device="cpu")
    _, best_valid, _ = texp.train(lambda *a: None)
    log = _log(storage, "final_eval")
    assert "valid_trajectory_mse" in log[0]
    assert "valid_trajectory_mse" not in log[1]
    assert "valid_trajectory_mse" in log[2]
    for key in ("training_duration", "evaluation_duration",
                "logging_duration", "cube::body_m", "cube::body_len_x",
                "cube::body_mu"):
        assert key in log[2], sorted(log[2])
    assert best_valid == pytest.approx(min(
        log[e]["valid_loss"] for e in (0, 1, 2)))
    with pytest.raises(AssertionError):
        port_config(storage, "bad", selection_metric="latest")
    # The sharding flags are taken; with no process group the run is
    # unsharded, as the JAX package's on one device.
    sharded = MultibodyLearnableExperiment(
        port_config(storage, "sharded", shard_training=True,
                    shard_evaluation=True), device="cpu")
    assert sharded.training_mesh(BATCH) is None
    assert sharded.evaluation_mesh() is None
