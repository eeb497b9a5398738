"""The port's deep learnable baselines against the JAX package's, on the
CPU, float64, with JAX's weights carried across
(``deep_params_from_numpy``): the MLP, GRU and zero partial steps (rtol
1e-10), rollouts with the recurrent warm-up (rtol 1e-10), the prediction
loss's gradient against ``jax.grad`` (rtol 1e-9), one epoch of the deep
experiment against the JAX package's jitted epoch (losses rtol 1e-8,
parameters rtol 1e-6, as ``test_torch_training.py``), checkpoint and
resume, and the four tests of ``tests/test_deep_learnable.py`` mirrored.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dair_pll_tpu import deep_learnable as jdeep
from dair_pll_tpu.integrator import Integrator as JIntegrator
from dair_pll_tpu.multibody.learnable_system import (
    MultibodyLearnableSystem as JSystem)
from dair_pll_tpu.state_space import FixedBaseSpace as JFixedBaseSpace
from dair_pll_tpu.system import System as JBaseSystem
from dair_pll_tpu.training import config as jconfig
from dair_pll_tpu.training import experiment as jexperiment
from dair_pll_tpu.urdf import build_multibody_model as jbuild
from dair_pll_tpu.assets import get_asset as jget_asset
from dair_pll_tpu.data.config import (DataConfig as JDataConfig,
                                      TrajectorySliceConfig as JSliceConfig)
from dair_pll_tpu.hyperparameter import Float as JFloat, Int as JInt
from dair_pll_tpu_torch.data.management import ExperimentDataManager
from dair_pll_tpu_torch.deep_learnable import (DeepLearnableSystem,
                                               DeepLearnableSystemConfig,
                                               deep_params_from_numpy)
from dair_pll_tpu_torch.examples import deep_learnable_baseline as example
from dair_pll_tpu_torch.integrator import Integrator
from dair_pll_tpu_torch.params import tree_from_leaves
from dair_pll_tpu_torch.state_space import FixedBaseSpace
from dair_pll_tpu_torch.system import System
from dair_pll_tpu_torch.training import experiment as texperiment
from dair_pll_tpu_torch.utils import file_utils
from dair_pll_tpu_torch.utils.checkpoint import load_checkpoint
from torch_experiment_parity import BATCH, DT, cube_storage, jax_leaves

STEP_RTOL = 1e-10
GRAD_RTOL = 1e-9
LOSS_RTOL = 1e-8
PARAM_RTOL = 1e-6
KINDS = ("mlp", "recurrent", "zero")


class DummyBase(System):
    def __init__(self, space, dt):
        super().__init__(space, Integrator(space, lambda p, x, c: (x, c), dt,
                                           "state"))


class JDummyBase(JBaseSystem):
    def __init__(self, space, dt):
        super().__init__(space, JIntegrator(space, lambda p, x, c: (x, c),
                                            dt, "state"))


def jax_numpy(tree):
    return jax.tree_util.tree_map(lambda leaf: np.asarray(leaf), tree)


def pair(kind, n_joints=2, hidden=16, layers=2, nonlinearity="tanh"):
    """The JAX system and the port's, the port at JAX's weights."""
    config = dict(integrator_kind="velocity", layers=layers,
                  hidden_size=hidden, model_kind=kind,
                  nonlinearity=nonlinearity)
    jsystem = jdeep.DeepLearnableSystem(
        JDummyBase(JFixedBaseSpace(n_joints), 0.01),
        jdeep.DeepLearnableSystemConfig(**config), jax.random.PRNGKey(3),
        dtype=jnp.float64)
    system = DeepLearnableSystem(
        DummyBase(FixedBaseSpace(n_joints), 0.01),
        DeepLearnableSystemConfig(**config), torch.Generator().manual_seed(0),
        dtype=torch.float64, device="cpu")
    j_params = jsystem.initial_params()
    params = deep_params_from_numpy(system, jax_numpy(j_params))
    return jsystem, j_params, system, params


@pytest.mark.parametrize("kind", KINDS)
def test_partial_step_matches_jax(kind):
    jsystem, j_params, system, params = pair(kind)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 4))
    h = rng.normal(size=(6, 16))
    want_out, want_h = jax.vmap(
        lambda xi, hi: jsystem._partial_step(j_params, xi, hi))(
            jnp.asarray(x), jnp.asarray(h))
    out, carry = system._partial_step(params, torch.as_tensor(x),
                                      torch.as_tensor(h))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=STEP_RTOL, atol=1e-14)
    np.testing.assert_allclose(carry.numpy(), np.asarray(want_h),
                               rtol=STEP_RTOL, atol=1e-14)
    # JAX's leaves, in order, are the port's.
    for leaf, ref in zip(params.parameters(), jax_leaves(j_params)):
        np.testing.assert_array_equal(leaf.numpy(), ref)


@pytest.mark.parametrize("kind", KINDS)
def test_rollout_with_warm_up_matches_jax(kind):
    jsystem, j_params, system, params = pair(kind)
    rng = np.random.default_rng(2)
    history = 0.5 * rng.normal(size=(3, 4, 4))

    def one(hist):
        x_0, carry = jsystem.preprocess_initial_condition(
            j_params, hist, jsystem.initial_carry(hist[-1]))
        return jsystem.simulate(j_params, x_0, 6, carry_0=carry)

    want = jax.vmap(one)(jnp.asarray(history))
    hist = torch.as_tensor(history)
    x_0, carry = system.preprocess_initial_condition(
        params, hist, system.initial_carry(hist[..., -1, :]))
    got = system.simulate(params, x_0, 6, carry_0=carry)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=STEP_RTOL, atol=1e-13)


@pytest.mark.parametrize("kind", ("mlp", "recurrent"))
def test_prediction_loss_gradient_matches_jax(kind):
    jsystem, j_params, system, params = pair(kind, nonlinearity="elu")
    rng = np.random.default_rng(4)
    past = 0.5 * rng.normal(size=(5, 3, 4))
    future = 0.5 * rng.normal(size=(5, 2, 4))
    jexp = object.__new__(jexperiment.SupervisedLearningExperiment)
    want = jax.grad(lambda p: jnp.mean(jexp.prediction_loss(
        jsystem, p, jnp.asarray(past), jnp.asarray(future))))(j_params)
    texp = object.__new__(texperiment.SupervisedLearningExperiment)
    for leaf in params.parameters():
        leaf.requires_grad_(True)
    torch.mean(texp.prediction_loss(system, params, torch.as_tensor(past),
                                    torch.as_tensor(future))).backward()
    for leaf, ref in zip(params.parameters(), jax_leaves(want)):
        np.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=GRAD_RTOL,
                                   atol=1e-13)


# -- the experiment ------------------------------------------------------------

@pytest.fixture(scope="module")
def storage(tmp_path_factory):
    return cube_storage(str(tmp_path_factory.mktemp("deep_storage")))


class JDeepExperiment(jdeep.DeepLearnableExperiment,
                      jexperiment.SupervisedLearningExperiment):
    def get_base_system(self):
        model = jbuild({"cube": jget_asset("cube")})
        return JSystem(model, DT), model.initial_params()


def configs(storage, run_name, kind, t_history):
    slice_kw = dict(t_skip=t_history - 1, t_history=t_history)
    deep = dict(layers=2, hidden_size=16, model_kind=kind)
    jcfg = jconfig.SupervisedLearningExperimentConfig(
        data_config=JDataConfig(dt=DT, slice_config=JSliceConfig(**slice_kw)),
        learnable_config=jdeep.DeepLearnableSystemConfig(**deep),
        optimizer_config=jconfig.OptimizerConfig(
            lr=JFloat(1e-3), wd=JFloat(0.0), patience=50, epochs=1,
            batch_size=JInt(BATCH)),
        storage=storage, run_name=f"jax_{run_name}",
        full_evaluation_samples=0)
    texp = example.build_experiment(
        kind, storage, run_name=f"port_{run_name}", epochs=1,
        hidden_size=16, layers=2, t_history=t_history, device="cpu",
        dtype=torch.float64, batch_size=BATCH, full_evaluation_samples=0)
    return JDeepExperiment(jcfg), texp


@pytest.mark.parametrize("kind,t_history", [("mlp", 1), ("recurrent", 3)])
def test_epoch_matches_jax(storage, kind, t_history):
    jexp, texp = configs(storage, f"epoch_{kind}", kind, t_history)
    jexp.learned_system, j_init = jexp.get_learned_system()
    texp.learned_system, _ = texp.get_learned_system()
    train_set = ExperimentDataManager(
        storage, texp.config.data_config).get_trajectory_sets()[0]
    past = train_set.slices_past.astype(np.float64)
    future = train_set.slices_future.astype(np.float64)
    perm, _ = texperiment.SupervisedLearningExperiment._epoch_permutation(
        np.random.default_rng(713), train_set.n_slices, BATCH)
    batches = perm.reshape(-1, BATCH)
    assert len(batches) >= 2

    j_params = jax.tree_util.tree_map(
        lambda leaf: jnp.asarray(leaf, jnp.float64), j_init)
    chain = jexperiment.build_optimizer(jexp.config.optimizer_config, 1e-3)
    j_state = chain.init(j_params)
    epoch_fn, _ = jexp._build_train_epoch(chain, BATCH)
    j_losses = []
    for batch in batches:
        j_params, j_state, loss = epoch_fn(
            j_params, j_state, jnp.asarray(past), jnp.asarray(future),
            jnp.asarray(batch[None]))
        j_losses.append(float(loss))

    params = deep_params_from_numpy(texp.learned_system,
                                    jax_numpy(j_init))
    for leaf in params.parameters():
        leaf.requires_grad_(True)
    optimizer = texperiment.build_optimizer(texp.config.optimizer_config,
                                            params.parameters())
    t_epoch, _ = texp._build_train_epoch(optimizer, BATCH)
    losses = t_epoch(params, optimizer, torch.as_tensor(past),
                     torch.as_tensor(future), torch.as_tensor(batches))
    np.testing.assert_allclose(losses.numpy(), j_losses, rtol=LOSS_RTOL,
                               atol=0)
    # mean and std are leaves: Adam moves them, as in JAX.
    for leaf, ref in zip(params.parameters(), jax_leaves(j_params)):
        np.testing.assert_allclose(leaf.detach().numpy(), ref,
                                   rtol=PARAM_RTOL, atol=1e-12)


def test_checkpoint_resumes(storage):
    """A run of one epoch, then the same run with two: the second starts
    from the checkpoint's parameters and optimizer state and trains epoch
    2 alone."""
    def build(epochs):
        return example.build_experiment(
            "recurrent", storage, run_name="resume", epochs=epochs,
            hidden_size=8, layers=2, t_history=2, device="cpu",
            dtype=torch.float64, batch_size=BATCH,
            full_evaluation_samples=0)

    build(1).train(lambda *a: None)
    path = file_utils.checkpoint_path(storage, "resume")
    saved = load_checkpoint(path)
    assert saved.finished_training and saved.epoch == 2
    resumed = build(2)
    optimizer, state = resumed.setup_training()
    for leaf, ref in zip(state.current_params.parameters(),
                         saved.current_params):
        np.testing.assert_array_equal(leaf.detach().numpy(), ref)
    assert optimizer.optimizer.state_dict()["state"][0]["step"] > 0
    epochs = []
    resumed = build(2)
    resumed.train(lambda e, *a: epochs.append(e))
    assert epochs == [2]
    final = load_checkpoint(path)
    rebuilt = tree_from_leaves(resumed.learned_system.initial_params(),
                               final.current_params)
    assert all(bool(torch.isfinite(leaf).all())
               for leaf in rebuilt.parameters())


# -- tests/test_deep_learnable.py, mirrored ---------------------------------------

def make_system(model_kind, space=None, hidden=32, layers=1):
    space = space or FixedBaseSpace(2)
    config = DeepLearnableSystemConfig(
        integrator_kind="velocity", layers=layers, hidden_size=hidden,
        model_kind=model_kind)
    system = DeepLearnableSystem(DummyBase(space, 0.01), config,
                                 torch.Generator().manual_seed(0),
                                 device="cpu")
    return system, system.initial_params()


def test_mlp_rollout_shapes():
    system, params = make_system("mlp")
    with torch.no_grad():
        trajectory = system.simulate(params, torch.zeros(4), 10)
        assert trajectory.shape == (11, 4)
        batch = system.simulate_batch(params, torch.zeros((3, 4)), 5)
    assert batch.shape == (3, 6, 4)


def test_recurrent_rollout_and_preprocess():
    system, params = make_system("recurrent")
    history = torch.as_tensor(
        np.random.default_rng(0).standard_normal((4, 4)), dtype=torch.float32)
    with torch.no_grad():
        x0, carry = system.preprocess_initial_condition(
            params, history, system.initial_carry(history[-1]))
        np.testing.assert_allclose(x0.numpy(), history[-1].numpy())
        assert carry.shape == (32,)
        assert float(carry.abs().max()) > 0  # the hidden state warmed up
        trajectory = system.simulate(params, x0, 5, carry_0=carry)
    assert trajectory.shape == (6, 4)


def test_zero_model_keeps_configuration():
    system, params = make_system("zero")
    with torch.no_grad():
        trajectory = system.simulate(
            params, torch.tensor([1.0, 2.0, 0.0, 0.0]), 3)
    np.testing.assert_allclose(trajectory[-1, :2].numpy(), [1.0, 2.0])


def test_mlp_learns_linear_dynamics(rng):
    """An MLP trained on v_next = A v data reduces the prediction error."""
    system, params = make_system("mlp", hidden=32, layers=2)
    A = np.array([[0.9, 0.1], [-0.1, 0.9]])
    x = torch.as_tensor(rng.standard_normal((512, 4)), dtype=torch.float32)
    v_next = x[:, 2:] @ torch.as_tensor(A.T, dtype=torch.float32)
    for leaf in params.parameters():
        leaf.requires_grad_(True)
    optimizer = torch.optim.Adam(params.parameters(), lr=1e-2)

    def loss_fn():
        return torch.mean((system._partial_step(params, x, None)[0] -
                           v_next) ** 2)

    loss0 = float(loss_fn())
    for _ in range(200):
        optimizer.zero_grad()
        loss = loss_fn()
        loss.backward()
        optimizer.step()
    assert float(loss) < 0.1 * loss0
