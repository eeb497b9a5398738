"""The port's evaluation and the experiment's loss callbacks against the
JAX package's, on the CPU (the rest of ``test_torch_training.py``'s
layer; both use ``torch_experiment_parity.py``).

* ``evaluate_systems_on_sets``: keys and values against the JAX package's
  in float64 (atol 1e-7), the JAX side with its padding in float64.
* A JAX checkpoint's ``best_params``, flattened with
  ``jax.tree_util.tree_leaves``, give JAX's loss in the port.
* ``contactnets_multistep`` (``torch.utils.checkpoint``) and
  ``loss_dtype`` against the loss written out by hand.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dair_pll_tpu.assets import get_asset as jget_asset
from dair_pll_tpu.data.management import TrajectorySet as JTrajectorySet
from dair_pll_tpu.multibody.learnable_system import (
    MultibodyLearnableSystem as JSystem)
from dair_pll_tpu.training import experiment as jexperiment
from dair_pll_tpu.training import multibody_experiment as jmulti
from dair_pll_tpu.urdf import build_multibody_model as jbuild
from dair_pll_tpu.utils import checkpoint as jcheckpoint
from dair_pll_tpu_torch.assets import get_asset
from dair_pll_tpu_torch.data.config import TrajectorySliceConfig
from dair_pll_tpu_torch.data.management import (ExperimentDataManager,
                                                TrajectorySet,
                                                slice_trajectories)
from dair_pll_tpu_torch.multibody.learnable_system import (
    MultibodyLearnableSystem)
from dair_pll_tpu_torch.params import tree_from_leaves
from dair_pll_tpu_torch.training.multibody_experiment import (
    MultibodyLearnableExperiment)
from dair_pll_tpu_torch.utils import file_utils
from torch_experiment_parity import (DT, cube_storage, jax_config,
                                     jax_leaves, jax_params_from_leaves,
                                     port_config)

EVAL_ATOL = 1e-7


@pytest.fixture(scope="module")
def storage(tmp_path_factory):
    return cube_storage(str(tmp_path_factory.mktemp("storage")))


class _Float64Padding:
    """numpy for the JAX experiment module with ``float32`` as float64: its
    ``trajectory_predict`` pads the histories in float32, and its rollout
    keeps their dtype, so float64 parameters need float64 padding. The
    stored trajectories are float32 values, so the padding's values are the
    same either way."""
    float32 = np.float64

    def __getattr__(self, name):
        return getattr(np, name)


def test_evaluate_systems_on_sets_matches_jax(storage, monkeypatch):
    """Float64 statistics of two sets of three stored trajectories; the
    JAX side with float64 padding (``_Float64Padding``)."""
    texp = MultibodyLearnableExperiment(
        port_config(storage, "port_eval"), device="cpu")
    texp.learned_system, _ = texp.get_learned_system()
    jexp = jmulti.MultibodyLearnableExperiment(jax_config(storage,
                                                          "jax_eval"))
    jexp.learned_system, j_init = jexp.get_learned_system()
    monkeypatch.setattr(jexperiment, "np", _Float64Padding())
    paths = file_utils.list_trajectories(file_utils.trajectory_dir(
        storage, file_utils.LEARNING_SUBDIR))
    trajectories = [file_utils.load_trajectory(path).astype(np.float64)
                    for path in paths]
    sets, j_sets = {}, {}
    for name, rows in (("train", [0, 1, 2]), ("valid", [3, 4, 5])):
        chosen = [trajectories[r] for r in rows]
        past, future = jmanagement_slice(chosen)
        sets[name] = TrajectorySet(chosen, rows, past, future)
        j_sets[name] = JTrajectorySet(chosen, rows, past, future)
    leaves = [leaf.astype(np.float64) for leaf in jax_leaves(j_init)]
    j_params = jax_params_from_leaves(j_init, leaves)
    params = tree_from_leaves(
        texp.learned_system.model.initial_params(torch.float64), leaves)
    stats = texp.evaluate_systems_on_sets(
        {"model": (texp.learned_system, params)}, sets)
    j_stats = jexp.evaluate_systems_on_sets(
        {"model": (jexp.learned_system, j_params)}, j_sets)
    assert set(stats) == set(j_stats)
    for key, want in j_stats.items():
        got = stats[key]
        if isinstance(want, list):
            assert len(got) == len(want), key
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=0, atol=EVAL_ATOL,
                                           err_msg=key)
        else:
            np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                       atol=EVAL_ATOL, err_msg=key)


def jmanagement_slice(trajectories):
    """float64 slices (the native slicer gives float32)."""
    return tuple(part.astype(np.float64)
                 for part in slice_trajectories(trajectories, 0, 1, 1))



def test_jax_checkpoint_params_give_jax_loss(tmp_path):
    """A JAX run's stored ``best_params``, flattened with
    ``jax.tree_util.tree_leaves``, carried into the port by
    ``tree_from_leaves``, give the JAX loss; the ICNN cube's nested
    parameters carry leaf for leaf."""
    jmodel = jbuild({"cube": jget_asset("cube")})
    j_init = jmodel.initial_params(jnp.float64)
    rng = np.random.default_rng(8)
    leaves = [leaf * (1 + 0.05 * rng.standard_normal(leaf.shape))
              for leaf in jax_leaves(j_init)]
    j_params = jax_params_from_leaves(j_init, leaves)
    path = str(tmp_path / "checkpoint.npz")
    jcheckpoint.save_checkpoint(path, jcheckpoint.TrainingState(
        split_indices=([0], [1], [2]), best_params=j_params,
        current_params=j_params, optimizer_state=()))
    stored = jax.tree_util.tree_leaves(
        jcheckpoint.load_checkpoint(path).best_params)

    system = MultibodyLearnableSystem.from_urdfs(
        {"cube": get_asset("cube")}, DT, device="cpu")
    params = tree_from_leaves(system.model.initial_params(torch.float64),
                              stored)
    jsystem = JSystem(jmodel, DT)
    data = rng.standard_normal((6, 13)) * 0.1
    data[:, 0] += 1.0
    data[:, 6] = 0.05
    data[:, :4] /= np.linalg.norm(data[:, :4], axis=1, keepdims=True)
    x = data
    x_plus = x.copy()
    x_plus[:, 7:] *= 0.9
    u = np.zeros((6, 0))
    want = np.asarray(jax.jit(
        lambda p, a, b: jsystem.contactnets_loss_batch(
            p, a, jnp.asarray(u), b, use_fused=True))(
        j_params, jnp.asarray(x), jnp.asarray(x_plus)))
    with torch.no_grad():
        got = system.contactnets_loss_batch(
            params, torch.as_tensor(x), torch.as_tensor(u),
            torch.as_tensor(x_plus), use_fused=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)

    jmesh = jbuild({"cube": jget_asset("cube_mesh")})
    mesh_leaves = jax_leaves(jmesh.initial_params(jnp.float64))
    tmesh = MultibodyLearnableSystem.from_urdfs(
        {"cube": get_asset("cube_mesh")}, DT, device="cpu").model
    template = tmesh.initial_params(torch.float64)
    carried = tree_from_leaves(template, mesh_leaves).parameters()
    assert len(carried) == len(mesh_leaves)
    for leaf, ref in zip(carried, mesh_leaves):
        np.testing.assert_array_equal(leaf.numpy(), ref)
    with pytest.raises(ValueError):
        tree_from_leaves(template, mesh_leaves[:-1])



def test_multistep_and_loss_dtype_callbacks(storage):
    """``contactnets_multistep`` averages the loss over the window, each
    step's state from the model's own rollout (recomputed in the backward
    pass: the same gradient as without ``torch.utils.checkpoint``);
    ``loss_dtype="float64"`` casts at the loss boundary and returns the
    gradient in the parameters' dtype."""
    config = port_config(storage, "multistep",
                         learnable={"contactnets_multistep": True})
    config.data_config.slice_config = TrajectorySliceConfig(t_prediction=2)
    texp = MultibodyLearnableExperiment(config, device="cpu",
                                        dtype=torch.float64)
    texp.learned_system, params = texp.get_learned_system()
    system = texp.learned_system
    train_set = ExperimentDataManager(
        storage, config.data_config).get_trajectory_sets()[0]
    past = torch.as_tensor(train_set.slices_past[:6], dtype=torch.float64)
    future = torch.as_tensor(train_set.slices_future[:6],
                             dtype=torch.float64)
    for leaf in params.parameters():
        leaf.requires_grad_(True)
    loss = texp.loss_callback()(params, past, future).sum()
    grads = torch.autograd.grad(loss, params.parameters()[:2])

    u = past.new_zeros((6, 0))
    x = past[:, -1]
    first = system.contactnets_loss_batch(params, x, u, future[:, 0])
    x_next = system.sim_step(params, x)
    second = system.contactnets_loss_batch(params, x_next, u, future[:, 1])
    want = ((first + second) / 2).sum()
    want_grads = torch.autograd.grad(want, params.parameters()[:2])
    torch.testing.assert_close(loss, want, rtol=1e-12, atol=0)
    for got, ref in zip(grads, want_grads):
        torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-14)

    cast = MultibodyLearnableExperiment(
        port_config(storage, "cast", learnable={"loss_dtype": "float64"}),
        device="cpu")
    cast.learned_system, params32 = cast.get_learned_system()
    for leaf in params32.parameters():
        leaf.requires_grad_(True)
    past32, future32 = past.float(), future.float()
    loss32 = cast.loss_callback()(params32, past32, future32)
    assert loss32.dtype == torch.float64
    loss32.sum().backward()
    assert params32.theta.grad.dtype == torch.float32
    params64 = params32.map(lambda leaf: leaf.detach().double())
    with torch.no_grad():
        ref = cast.learned_system.contactnets_loss_batch(
            params64, past32[:, -1].double(), u, future32[:, 0].double())
    torch.testing.assert_close(loss32.detach(), ref, rtol=1e-12, atol=0)
