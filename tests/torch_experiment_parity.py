"""Shared pieces of the experiment-layer parity tests
(``test_torch_training.py``, ``test_torch_evaluation.py``): a storage of
simulated cube tosses, the two packages' experiment configurations, and
JAX parameters to and from their flattened leaves."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dair_pll_tpu.assets import get_asset as jget_asset
from dair_pll_tpu.data.config import (DataConfig as JDataConfig,
                                      TrajectorySliceConfig as JSliceConfig)
from dair_pll_tpu.hyperparameter import Float as JFloat, Int as JInt
from dair_pll_tpu.training import config as jconfig
from dair_pll_tpu.training import multibody_experiment as jmulti
from dair_pll_tpu_torch.assets import get_asset
from dair_pll_tpu_torch.data.config import DataConfig, TrajectorySliceConfig
from dair_pll_tpu_torch.hyperparameter import Float, Int
from dair_pll_tpu_torch.multibody.learnable_system import (
    MultibodyLearnableSystem)
from dair_pll_tpu_torch.training.config import (
    OptimizerConfig, SupervisedLearningExperimentConfig)
from dair_pll_tpu_torch.training.multibody_experiment import (
    MultibodyLearnableSystemConfig, MultibodyLosses, MultibodySystemConfig)
from dair_pll_tpu_torch.utils import file_utils

DT = 0.0068
BATCH = 16


def cube_storage(root: str) -> str:
    """Eight cube tosses of 12 states near the ground in ``root``, from the
    port's vmapped rollout (float64, stored as float32 like any
    trajectory), for the experiment-layer tests."""
    system = MultibodyLearnableSystem.from_urdfs(
        {"cube": get_asset("cube")}, DT, mesh_representation="polygon",
        device="cpu")
    rng = np.random.default_rng(5)
    n = 8
    x_0 = system.space.zero_state(torch.float64).repeat(n, 1)
    axis = rng.normal(size=(n, 3))
    x_0[:, :4] = torch.as_tensor(np.concatenate(
        [np.cos(0.3 * np.ones((n, 1))),
         np.sin(0.3) * axis / np.linalg.norm(axis, axis=1, keepdims=True)],
        axis=1))
    x_0[:, 6] = torch.as_tensor(0.07 + 0.03 * rng.random(n))
    x_0[:, 7:] = torch.as_tensor(rng.normal(size=(n, 6)) *
                                 [2, 2, 2, 0.4, 0.4, 0.3])
    with torch.no_grad():
        trajectories = system.simulate_batch(
            system.initial_params(torch.float64), x_0, 11)
    for i in range(n):
        file_utils.save_trajectory(root, file_utils.LEARNING_SUBDIR, i,
                                   trajectories[i].numpy().astype(np.float32))
    return root


def port_config(storage, run_name, loss=MultibodyLosses.CONTACTNETS_LOSS,
                epochs=2, batch=BATCH, learnable=None, **kwargs):
    kwargs.setdefault("full_evaluation_samples", 0)
    return SupervisedLearningExperimentConfig(
        data_config=DataConfig(dt=DT, slice_config=TrajectorySliceConfig()),
        base_config=MultibodySystemConfig(urdfs={"cube": get_asset("cube")}),
        learnable_config=MultibodyLearnableSystemConfig(
            urdfs={"cube": get_asset("cube")}, loss=loss,
            **(learnable or {})),
        optimizer_config=OptimizerConfig(
            lr=Float(1e-3), wd=Float(0.0), patience=50, epochs=epochs,
            batch_size=Int(batch)),
        storage=storage, run_name=run_name, **kwargs)


def jax_config(storage, run_name, loss_name="CONTACTNETS_LOSS", **kwargs):
    return jconfig.SupervisedLearningExperimentConfig(
        data_config=JDataConfig(dt=DT, slice_config=JSliceConfig()),
        base_config=jmulti.MultibodySystemConfig(
            urdfs={"cube": jget_asset("cube")}),
        learnable_config=jmulti.MultibodyLearnableSystemConfig(
            urdfs={"cube": jget_asset("cube")},
            loss=getattr(jmulti.MultibodyLosses, loss_name)),
        optimizer_config=jconfig.OptimizerConfig(
            lr=JFloat(1e-3), wd=JFloat(0.0), patience=50, epochs=2,
            batch_size=JInt(BATCH)),
        storage=storage, run_name=run_name, **kwargs)


def jax_leaves(params):
    return [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(params)]


def jax_params_from_leaves(template, leaves):
    structure = jax.tree_util.tree_structure(template)
    return jax.tree_util.tree_unflatten(
        structure, [jnp.asarray(leaf) for leaf in leaves])
