"""The port's residual-physics cube against the JAX package's, on the CPU,
float64, with JAX's weights carried across
(``residual_params_from_numpy``): the residual step and rollouts (atol
1e-7, ``tests/test_multibody.py:234``), the gradients of both halves (the
structured one through the hybrid solve's implicit backward, the
residual's through autograd) against ``jax.grad`` (rtol 1e-6), one epoch
of the residual experiment against the JAX package's jitted epoch (losses
rtol 1e-8, parameters rtol 1e-6), checkpoint and resume, and the three
tests of ``tests/test_residual.py`` mirrored (the drag fit at B 256).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dair_pll_tpu import residual as jresidual
from dair_pll_tpu.assets import get_asset as jget_asset
from dair_pll_tpu.data.config import (DataConfig as JDataConfig,
                                      TrajectorySliceConfig as JSliceConfig)
from dair_pll_tpu.hyperparameter import Float as JFloat, Int as JInt
from dair_pll_tpu.multibody.learnable_system import (
    MultibodyLearnableSystem as JSystem)
from dair_pll_tpu.training import config as jconfig
from dair_pll_tpu.training import experiment as jexperiment
from dair_pll_tpu.urdf import build_multibody_model as jbuild
from dair_pll_tpu_torch.assets import get_asset
from dair_pll_tpu_torch.data.management import ExperimentDataManager
from dair_pll_tpu_torch.examples import residual_physics_cube as example
from dair_pll_tpu_torch.multibody.learnable_system import (
    MultibodyLearnableSystem)
from dair_pll_tpu_torch.residual import (ResidualPhysicsConfig,
                                         ResidualPhysicsExperiment,
                                         ResidualPhysicsLearnableConfig,
                                         ResidualPhysicsSystem,
                                         residual_params_from_numpy)
from dair_pll_tpu_torch.training import experiment as texperiment
from dair_pll_tpu_torch.utils import file_utils
from dair_pll_tpu_torch.utils.checkpoint import load_checkpoint
from torch_experiment_parity import BATCH, DT, cube_storage, jax_leaves

ROLLOUT_ATOL = 1e-7
GRAD_RTOL = 1e-6
LOSS_RTOL = 1e-8
PARAM_RTOL = 1e-6


def carried(jparams, system):
    """The port's parameters at a JAX residual system's."""
    structured = jparams["structured"]
    return residual_params_from_numpy(
        system,
        {"theta": np.asarray(structured.theta),
         "friction": np.asarray(structured.friction),
         "geometry": [None if g is None else
                      {k: np.asarray(v) for k, v in g.items()}
                      for g in structured.geometry]},
        jax.tree_util.tree_map(np.asarray, jparams["residual"]))


@pytest.fixture(scope="module")
def pair():
    config = dict(residual_scale=0.1, hidden_size=16, layers=2)
    jstructured = JSystem(jbuild({"cube": jget_asset("cube")}), DT)
    jsystem = jresidual.ResidualPhysicsSystem(
        jstructured, jresidual.ResidualPhysicsConfig(**config),
        jax.random.PRNGKey(0), dtype=jnp.float64)
    structured = MultibodyLearnableSystem.from_urdfs(
        {"cube": get_asset("cube")}, DT, mesh_representation="polygon",
        device="cpu")
    system = ResidualPhysicsSystem(structured,
                                   ResidualPhysicsConfig(**config),
                                   torch.Generator().manual_seed(0),
                                   dtype=torch.float64)
    j_params = jsystem.initial_params()
    return jsystem, j_params, system, carried(j_params, system)


def states(n, seed):
    """Cube states near and on the ground, moving."""
    rng = np.random.default_rng(seed)
    quat = rng.standard_normal((n, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    return np.concatenate(
        [quat, 0.02 * rng.standard_normal((n, 2)),
         0.05 + 0.05 * rng.random((n, 1)),
         rng.standard_normal((n, 6)) * [2, 2, 2, 0.5, 0.5, 0.2]], axis=-1)


def test_step_and_rollout_match_jax(pair):
    jsystem, j_params, system, params = pair
    x = states(4, 1)
    # The velocity integrator: a state's velocity is the step's output.
    want = jax.jit(jax.vmap(lambda xi: jsystem.simulate(j_params, xi, 4)))(
        jnp.asarray(x))
    with torch.no_grad():
        step, _ = system._partial_step(params, torch.as_tensor(x), None)
        got = system.simulate(params, torch.as_tensor(x), 4)
    np.testing.assert_allclose(step.numpy(), np.asarray(want[:, 1, 7:]),
                               rtol=0, atol=ROLLOUT_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ROLLOUT_ATOL)
    assert float(np.abs(np.asarray(want[:, -1, 7:]) - x[:, 7:]).max()) > 1e-3


# -- the experiment ------------------------------------------------------------

@pytest.fixture(scope="module")
def storage(tmp_path_factory):
    return cube_storage(str(tmp_path_factory.mktemp("residual_storage")))


class JResidualExperiment(jresidual.ResidualPhysicsExperiment,
                          jexperiment.SupervisedLearningExperiment):
    def get_base_system(self):
        model = jbuild({"cube": jget_asset("cube")})
        return JSystem(model, DT), model.initial_params()


@pytest.fixture(scope="module")
def experiments(storage):
    """Both packages' residual experiments on the storage, the port's at
    JAX's initial weights, the train slices, two batches of the epoch's
    table, and JAX's jitted loss and gradient (compiled once for the
    gradient and the epoch tests: it takes most of this file's time)."""
    jexp = JResidualExperiment(jconfig.SupervisedLearningExperimentConfig(
        data_config=JDataConfig(dt=DT, slice_config=JSliceConfig()),
        learnable_config=jresidual.ResidualPhysicsLearnableConfig(
            urdfs={"cube": jget_asset("cube")},
            residual=jresidual.ResidualPhysicsConfig(hidden_size=16)),
        optimizer_config=jconfig.OptimizerConfig(
            lr=JFloat(1e-3), wd=JFloat(0.0), patience=50, epochs=1,
            batch_size=JInt(BATCH)),
        storage=storage, run_name="jax_residual_epoch",
        full_evaluation_samples=0))
    jexp.learned_system, j_init = jexp.get_learned_system()
    texp = example.build_experiment(
        epochs=1, storage=storage, device="cpu", dtype=torch.float64,
        batch_size=BATCH, eval_samples=0, run_name="port_residual_epoch")
    texp.config.learnable_config.residual = ResidualPhysicsConfig(
        hidden_size=16)
    texp.learned_system, _ = texp.get_learned_system()
    train_set = ExperimentDataManager(
        storage, texp.config.data_config).get_trajectory_sets()[0]
    perm, _ = texperiment.SupervisedLearningExperiment._epoch_permutation(
        np.random.default_rng(713), train_set.n_slices, BATCH)
    loss_fn = jexp.loss_callback()
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, past, future: jnp.mean(loss_fn(p, past, future))))
    return {"jexp": jexp, "texp": texp,
            "j_init": jax.tree_util.tree_map(
                lambda leaf: jnp.asarray(leaf, jnp.float64), j_init),
            "past": train_set.slices_past.astype(np.float64),
            "future": train_set.slices_future.astype(np.float64),
            "batches": perm.reshape(-1, BATCH)[:2],
            "value_and_grad": value_and_grad}


def test_gradients_of_both_halves_match_jax(experiments):
    """The mean prediction loss's gradient on a batch of training slices:
    the structured leaves through the implicit backward, the residual's
    through autograd."""
    e = experiments
    batch = e["batches"][0]
    past, future = e["past"][batch], e["future"][batch]
    _, want = e["value_and_grad"](e["j_init"], jnp.asarray(past),
                                  jnp.asarray(future))
    params = carried(e["j_init"], e["texp"].learned_system)
    for leaf in params.parameters():
        leaf.requires_grad_(True)
    torch.mean(e["texp"].loss_callback()(
        params, torch.as_tensor(past), torch.as_tensor(future))).backward()
    grads = [leaf.grad for leaf in params.parameters()]
    n_residual = len(jax.tree_util.tree_leaves(e["j_init"]["residual"]))
    structured_grads = grads[n_residual:]
    assert float(structured_grads[0].abs().max()) > 0   # theta
    assert float(grads[0].abs().max()) > 0              # the residual's
    for got, ref in zip(grads, jax_leaves(want)):
        got = np.zeros_like(ref) if got is None else got.numpy()
        np.testing.assert_allclose(got, ref, rtol=GRAD_RTOL,
                                   atol=1e-9 * float(np.abs(ref).max() + 1))


def test_epoch_matches_jax(experiments):
    """Two steps of the port's epoch against JAX's loss callback and
    optimizer chain on the same batches (float64)."""
    e = experiments
    texp, jexp = e["texp"], e["jexp"]
    past, future, batches = e["past"], e["future"], e["batches"]
    j_params = e["j_init"]
    chain = jexperiment.build_optimizer(jexp.config.optimizer_config, 1e-3)
    j_state = chain.init(j_params)
    j_losses = []
    for batch in batches:
        loss, grads = e["value_and_grad"](j_params, jnp.asarray(past[batch]),
                                          jnp.asarray(future[batch]))
        updates, j_state = chain.update(grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        j_losses.append(float(loss))

    params = carried(e["j_init"], texp.learned_system)
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


def test_checkpoint_resumes(storage):
    """One epoch, then the same run with two epochs: it starts from the
    checkpoint's parameters (a ``MultibodyParams`` inside the tree) and
    optimizer state."""
    def build(epochs):
        return example.build_experiment(
            epochs=epochs, storage=storage, device="cpu",
            dtype=torch.float64, batch_size=64, eval_samples=0,
            run_name="residual_resume")

    build(1).train(lambda *a: None)
    saved = load_checkpoint(file_utils.checkpoint_path(storage,
                                                       "residual_resume"))
    assert saved.finished_training
    optimizer, state = build(2).setup_training()
    leaves = state.current_params.parameters()
    assert len(leaves) == len(saved.current_params)
    for leaf, ref in zip(leaves, saved.current_params):
        np.testing.assert_array_equal(leaf.detach().numpy(), ref)
    assert state.current_params["structured"].theta.shape == (1, 10)
    assert optimizer.optimizer.state_dict()["state"][0]["step"] > 0


# -- tests/test_residual.py, mirrored -------------------------------------------

def cube_residual_system(residual_scale=0.1):
    structured = MultibodyLearnableSystem.from_urdfs(
        {"cube": get_asset("cube")}, DT, mesh_representation="polygon",
        device="cpu")
    system = ResidualPhysicsSystem(
        structured, ResidualPhysicsConfig(residual_scale=residual_scale,
                                          hidden_size=16, layers=2),
        torch.Generator().manual_seed(0), dtype=torch.float64)
    return system, structured


def test_zero_scale_matches_structured():
    """With residual_scale = 0 the composite system is the structured
    system."""
    system, structured = cube_residual_system(residual_scale=0.0)
    params = system.initial_params()
    x0 = torch.tensor([1.0, 0, 0, 0, 0, 0, 0.1,
                       1.0, 0.5, 0.2, 0.3, -0.2, 0.0], dtype=torch.float64)
    with torch.no_grad():
        trajectory = system.simulate(params, x0, 30)
        reference = structured.simulate(params["structured"], x0, 30)
    torch.testing.assert_close(trajectory, reference, rtol=0, atol=0)


def test_residual_learns_unmodeled_drag():
    """Training the residual head alone on data of a true system with
    linear drag (which the structured model cannot represent) brings the
    prediction error under a fifth of the structured-only fit's. The
    structured velocity does not depend on the residual's weights, so it
    is computed once."""
    system, structured = cube_residual_system(residual_scale=0.1)
    params = system.initial_params()
    rng = np.random.default_rng(0)
    B = 256
    quat = rng.standard_normal((B, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    x = torch.as_tensor(np.concatenate(
        [quat, 0.02 * rng.standard_normal((B, 2)),
         0.05 + 0.1 * rng.random((B, 1)),
         rng.standard_normal((B, 6)) * [2, 2, 2, 0.5, 0.5, 0.2]], axis=-1))
    space = structured.space
    q, v = space.q_v(x)
    u = x.new_zeros((B, 0))
    with torch.no_grad():
        v_structured = structured.forward_dynamics(params["structured"], q,
                                                   v, u)
    v_true = v_structured - 0.08 * v

    residual = {key: value for key, value in params["residual"].items()}
    residual["net"] = [{k: t.detach().clone().requires_grad_(True)
                        for k, t in layer.items()}
                       for layer in residual["net"]]
    residual["mean"] = residual["mean"].clone().requires_grad_(True)
    residual["std"] = residual["std"].clone().requires_grad_(True)

    def loss_fn():
        v_pred = v_structured + system.residual_velocity(
            {"residual": residual}, x)
        return torch.mean((v_pred - v_true) ** 2)

    leaves = [t for layer in residual["net"] for t in layer.values()] + \
        [residual["mean"], residual["std"]]
    optimizer = torch.optim.Adam(leaves, lr=3e-3)
    init_loss = float(loss_fn())
    for _ in range(400):
        optimizer.zero_grad()
        loss = loss_fn()
        loss.backward()
        optimizer.step()
    assert float(loss) < 0.2 * init_loss, (init_loss, float(loss))


def test_experiment_binding_config():
    """The mixin builds a residual system from the learnable config (the
    composition of ``DeepLearnableExperiment``)."""
    class Holder:
        pass

    experiment = ResidualPhysicsExperiment()
    experiment.device = "cpu"
    experiment.config = Holder()
    experiment.config.learnable_config = ResidualPhysicsLearnableConfig(
        urdfs={"cube": get_asset("cube")})
    experiment.config.data_config = Holder()
    experiment.config.data_config.dt = DT
    system, params = experiment.get_learned_system()
    assert isinstance(system, ResidualPhysicsSystem)
    assert "structured" in params and "residual" in params
    summary = system.summary(params, {})
    assert "residual_weight_norm" in summary.scalars
