"""The port's MuJoCo oracle and its experiments against the JAX
package's, on the CPU (MuJoCo is host C code in both): the state
conversions and ``solref_args`` (exact), MuJoCo rollouts (1e-12, one C
library), the UKF, bias and ``mll`` estimates (rtol 1e-8), the
experiments (the oracle is the UKF system; the deep and the multibody
ones end to end in float64 from JAX's initial parameters, every final
``_mean`` statistic against JAX's within rtol 1e-6, the multibody one's
model rows at JAX's trained parameters; the multibody oracle binding;
the UKF preprocess smoothing the history), and the ten tests of
``tests/test_mujoco_system.py`` and ``tests/test_mujoco_experiment.py``
mirrored; the dataset generator on the host system. Skipped only where
``mujoco`` is missing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from dair_pll_tpu import mujoco_system as jmujoco  # noqa: E402
from dair_pll_tpu.assets import get_asset as jget_asset  # noqa: E402
from dair_pll_tpu.data import management as jmanagement  # noqa: E402
from dair_pll_tpu.data.config import (  # noqa: E402
    DataConfig as JDataConfig, TrajectorySliceConfig as JSliceConfig)
from dair_pll_tpu.deep_learnable import (  # noqa: E402
    DeepLearnableSystemConfig as JDeepConfig)
from dair_pll_tpu.hyperparameter import (  # noqa: E402
    Float as JFloat, Int as JInt)
from dair_pll_tpu.training import config as jconfig  # noqa: E402
from dair_pll_tpu.training import experiment as jexperiment  # noqa: E402
from dair_pll_tpu.training import mujoco_experiment as jmexp  # noqa: E402
from dair_pll_tpu.training import multibody_experiment as jmulti  # noqa: E402
from dair_pll_tpu_torch.assets import get_asset  # noqa: E402
from dair_pll_tpu_torch.data.config import (  # noqa: E402
    DataConfig, TrajectorySliceConfig)
from dair_pll_tpu_torch.deep_learnable import (  # noqa: E402
    DeepLearnableSystemConfig, deep_params_from_numpy)
from dair_pll_tpu_torch.hyperparameter import Float, Int  # noqa: E402
from dair_pll_tpu_torch.mujoco_system import (  # noqa: E402
    MuJoCoSystem, MuJoCoUKFSystem, mujoco_to_state, solref_args,
    state_to_mujoco)
from dair_pll_tpu_torch.params import tree_from_leaves  # noqa: E402
from dair_pll_tpu_torch.training.config import OptimizerConfig  # noqa: E402
from dair_pll_tpu_torch.training.mujoco_experiment import (  # noqa: E402
    MuJoCoDeepLearnableExperiment, MuJoCoExperimentConfig,
    MuJoCoMultibodyLearnableExperiment, build_mujoco_oracle_system)
from dair_pll_tpu_torch.training.multibody_experiment import (  # noqa: E402
    MultibodyLearnableSystemConfig, MultibodyLosses)
from dair_pll_tpu_torch.utils import file_utils  # noqa: E402
from torch_experiment_parity import jax_leaves  # noqa: E402

DT = 0.0068
ESTIMATE_RTOL = 1e-8
MEAN_RTOL = 1e-6
#: Parameters after an epoch, as ``tests/test_torch_training.py``.
PARAM_RTOL = 1e-6


@pytest.fixture(scope="module")
def cube_mjcf():
    return get_asset("cube_mjcf")


def free_flight(rng, noise=0.01, steps=10):
    system = MuJoCoSystem(get_asset("cube_mjcf"), DT, 2500.0, 1.04)
    x0 = np.zeros(13)
    x0[0] = 1.0
    x0[6] = 0.3       # free flight (no contact)
    x0[10] = 0.5
    clean = system.simulate(None, x0, steps)
    noisy = clean + noise * rng.standard_normal(clean.shape)
    noisy[:, :4] /= np.linalg.norm(noisy[:, :4], axis=-1, keepdims=True)
    return clean, noisy


def test_conversions_and_solref_match_jax(rng):
    for n_joints in (0, 2):
        x = rng.standard_normal(13 + 2 * n_joints)
        x[:4] /= np.linalg.norm(x[:4])
        for got, want in zip(state_to_mujoco(x, n_joints),
                             jmujoco.state_to_mujoco(x, n_joints)):
            np.testing.assert_array_equal(got, want)
        qpos, qvel = state_to_mujoco(x, n_joints)
        np.testing.assert_array_equal(mujoco_to_state(qpos, qvel),
                                      jmujoco.mujoco_to_state(qpos, qvel))
    for v200 in (False, True):
        assert solref_args(2500.0, 1.04, v200) == \
            jmujoco.solref_args(2500.0, 1.04, v200)


def test_rollouts_match_jax(cube_mjcf, rng):
    """A toss that lands and rolls: the same C library, the same steps."""
    x0 = np.zeros(13)
    x0[:4] = rng.standard_normal(4)
    x0[:4] /= np.linalg.norm(x0[:4])
    x0[6] = 0.12
    x0[7:] = rng.standard_normal(6) * [2, 2, 2, 0.5, 0.5, 0.2]
    port = MuJoCoSystem(cube_mjcf, DT, 2500.0, 1.04)
    ref = jmujoco.MuJoCoSystem(jget_asset("cube_mjcf"), DT, 2500.0, 1.04)
    got = port.simulate_batch(None, np.stack([x0, x0]), 60)
    want = ref.simulate_batch(None, np.stack([x0, x0]), 60)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got[0, -1, 6] < 0.1   # it landed


def test_estimates_match_jax(cube_mjcf, rng):
    """``ukf_estimate``, ``ukf_bias_estimate`` and ``mll_estimate`` on a
    noisy free flight: the port's maps in torch, JAX's in jnp."""
    _, noisy = free_flight(rng)
    port = MuJoCoUKFSystem(cube_mjcf, DT, 2500.0, 1.04)
    ref = jmujoco.MuJoCoUKFSystem(jget_asset("cube_mjcf"), DT, 2500.0, 1.04)
    np.testing.assert_allclose(port.ukf_estimate(noisy),
                               ref.ukf_estimate(noisy), rtol=ESTIMATE_RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(port.mll_estimate(noisy[:6], 12),
                               ref.mll_estimate(noisy[:6], 12),
                               rtol=ESTIMATE_RTOL, atol=1e-12)
    static, dynamic = np.zeros(12), np.full(12, 0.002)
    static[:3] = 0.02
    P0_diag, R_diag = MuJoCoUKFSystem.noise_stds_to_P0_R_stds(
        static, dynamic, DT, bias=True)
    want_diag = jmujoco.MuJoCoUKFSystem.noise_stds_to_P0_R_stds(
        static, dynamic, DT, bias=True)
    np.testing.assert_array_equal(P0_diag, want_diag[0])
    np.testing.assert_array_equal(R_diag, want_diag[1])
    biased = [cls(path, DT, 2500.0, 1.04, P0=np.diag(P0_diag**2) +
                  1e-9 * np.eye(18), R=np.diag(R_diag**2) + 1e-9 * np.eye(18),
                  bias=True)
              for cls, path in ((MuJoCoUKFSystem, cube_mjcf),
                                (jmujoco.MuJoCoUKFSystem,
                                 jget_asset("cube_mjcf")))]
    np.testing.assert_allclose(biased[0].ukf_bias_estimate(noisy[:6]),
                               biased[1].ukf_bias_estimate(noisy[:6]),
                               rtol=ESTIMATE_RTOL, atol=1e-12)


# -- the experiments -----------------------------------------------------------

@pytest.fixture(scope="module")
def mujoco_storage(tmp_path_factory):
    """A small MuJoCo cube-toss dataset (the JAX test's)."""
    storage = str(tmp_path_factory.mktemp("mujoco_storage"))
    system = MuJoCoSystem(get_asset("cube_mjcf"), DT, 2500.0, 1.04)
    rng = np.random.default_rng(0)
    for i in range(8):
        x0 = np.zeros(13)
        x0[0] = 1.0
        x0[4:6] = 0.01 * rng.standard_normal(2)
        x0[6] = 0.15 + 0.02 * rng.random()
        x0[7:13] = rng.standard_normal(6) * \
            np.array([1.0, 1.0, 1.0, 0.3, 0.3, 0.1])
        trajectory = system.simulate(None, x0, 19)
        file_utils.save_trajectory(storage, "learning", i,
                                   np.asarray(trajectory, np.float32))
    return storage


def make_config(storage, run_name, learnable_config, t_history=1,
                noise_std=1e-3):
    return MuJoCoExperimentConfig(
        data_config=DataConfig(
            dt=DT, train_fraction=0.5, valid_fraction=0.25,
            test_fraction=0.25,
            slice_config=TrajectorySliceConfig(
                t_skip=t_history - 1, t_history=t_history)),
        learnable_config=learnable_config,
        optimizer_config=OptimizerConfig(
            lr=Float(1e-3), wd=Float(0.0), patience=10, epochs=1,
            batch_size=Int(16)),
        storage=storage, run_name=run_name, full_evaluation_samples=0,
        video_period=0, xml=get_asset("cube_mjcf"), stiffness=2500.0,
        damping_ratio=1.04, static_noise=tuple([noise_std] * 12),
        dynamic_noise=tuple([noise_std] * 12))


def jax_config(storage, run_name, t_history=1, noise_std=1e-3,
               learnable_config=None):
    return jmexp.MuJoCoExperimentConfig(
        data_config=JDataConfig(
            dt=DT, train_fraction=0.5, valid_fraction=0.25,
            test_fraction=0.25,
            slice_config=JSliceConfig(t_skip=t_history - 1,
                                      t_history=t_history)),
        learnable_config=learnable_config or JDeepConfig(layers=2,
                                                         hidden_size=32),
        optimizer_config=jconfig.OptimizerConfig(
            lr=JFloat(1e-3), wd=JFloat(0.0), patience=10, epochs=1,
            batch_size=JInt(16)),
        storage=storage, run_name=run_name, full_evaluation_samples=0,
        xml=jget_asset("cube_mjcf"), stiffness=2500.0, damping_ratio=1.04,
        static_noise=tuple([noise_std] * 12),
        dynamic_noise=tuple([noise_std] * 12))


def test_oracle_system_is_ukf(mujoco_storage):
    experiment = MuJoCoDeepLearnableExperiment(
        make_config(mujoco_storage, "mjc_oracle",
                    DeepLearnableSystemConfig(layers=2, hidden_size=32)),
        device="cpu")
    oracle, oracle_params = experiment.get_oracle_system()
    assert isinstance(oracle, MuJoCoUKFSystem)
    assert oracle.host_stepped and oracle_params is None
    # P0 and R come from the configured noise, not the defaults.
    assert oracle.P0.shape == (12, 12)
    assert not np.allclose(oracle.P0, np.eye(12))
    jref, _ = jmexp.build_mujoco_oracle_system(
        jax_config(mujoco_storage, "mjc_oracle_jax"))
    np.testing.assert_array_equal(oracle.P0, jref.P0)
    np.testing.assert_array_equal(oracle.R, jref.R)
    base, _ = experiment.get_base_system()
    assert isinstance(base, MuJoCoSystem)
    assert not isinstance(base, MuJoCoUKFSystem)


class _Float64Numpy:
    """numpy with ``float32`` as float64, for the JAX package's data
    manager and experiment modules: they load the trajectories and pad the
    histories in float32, and a rollout keeps its inputs' dtype, so
    float64 parameters need float64 data (the stored trajectories are
    float32 values: the data's values are the same)."""
    float32 = np.float64

    def __getattr__(self, name):
        return getattr(np, name)


@pytest.fixture
def jax_float64_data(monkeypatch):
    """The JAX package's experiment on float64 data (``_Float64Numpy``,
    and float64 slices: its native slicer gives float32)."""
    slice_trajectories = jmanagement.slice_trajectories
    monkeypatch.setattr(jexperiment, "np", _Float64Numpy())
    monkeypatch.setattr(jmanagement, "np", _Float64Numpy())
    monkeypatch.setattr(
        jmanagement, "slice_trajectories",
        lambda *args: tuple(part.astype(np.float64)
                            for part in slice_trajectories(*args)))


def float64_tree(tree):
    return jax.tree_util.tree_map(lambda leaf: jnp.asarray(leaf, jnp.float64),
                                  tree)


def jax_float64(cls):
    """A JAX experiment class whose learned parameters start in float64."""
    class Float64(cls):
        def get_learned_system(self):
            system, params = super().get_learned_system()
            return system, float64_tree(params)
    return Float64


def carried(cls, to_port):
    """A port experiment class whose learned parameters start at JAX's
    initial ones (``to_port(system)``)."""
    class Carried(cls):
        def get_learned_system(self):
            system, _ = super().get_learned_system()
            return system, to_port(system)
    return Carried


def assert_means_match(stats, j_stats, model_rows=True):
    assert set(stats) == set(j_stats)
    compared = [key for key in j_stats if key.endswith("_mean") and
                (model_rows or "_model_" not in key)]
    # 3 sets x (2 data rows + 4 oracle rows + 4 model rows)
    assert len(compared) == (30 if model_rows else 18)
    for key in compared:
        np.testing.assert_allclose(stats[key], j_stats[key], rtol=MEAN_RTOL,
                                   atol=1e-15, err_msg=key)


def test_mujoco_deep_experiment_end_to_end(mujoco_storage, jax_float64_data):
    """One epoch and the final evaluation through the experiment layer,
    with the oracle's rows from the UKF system (host rollouts), against
    the JAX package's run on the same storage: both in float64, the port
    from JAX's initial weights (``deep_params_from_numpy``)."""
    jexp = jax_float64(jmexp.MuJoCoDeepLearnableExperiment)(
        jax_config(mujoco_storage, "mjc_e2e_jax"))
    _, j_init = jexp.get_learned_system()
    _, j_stats = jexp.generate_results(lambda *a: None)
    initial = jax.tree_util.tree_map(np.asarray, j_init)
    experiment = carried(
        MuJoCoDeepLearnableExperiment,
        lambda system: deep_params_from_numpy(system, initial))(
        make_config(mujoco_storage, "mjc_e2e",
                    DeepLearnableSystemConfig(layers=2, hidden_size=32)),
        device="cpu", dtype=torch.float64)
    _, stats = experiment.generate_results(lambda *a: None)
    for key in ("train_oracle_loss_mean", "valid_oracle_loss_mean",
                "test_oracle_loss_mean", "train_oracle_trajectory_mse_mean",
                "train_oracle_rot_err_mean", "train_model_loss_mean"):
        assert key in stats, f"missing {key}"
        assert np.isfinite(stats[key])
    # The UKF oracle propagates the true simulator: on clean data its
    # one-step loss is far below the velocity scale.
    assert stats["test_oracle_loss_mean"] < \
        0.1 * stats["test_v_plus_squared_mean"]
    assert_means_match(stats, j_stats)


def test_mujoco_multibody_experiment_end_to_end(mujoco_storage,
                                                jax_float64_data):
    """The multibody MuJoCo experiment (the ContactNets cube against the
    UKF oracle), one epoch and the final evaluation in both packages on
    the same storage, in float64 from the URDF's initial parameters, cold
    ContactNets solves: the trained parameters within rtol 1e-6, the data
    and oracle ``_mean`` statistics within rtol 1e-6, and every ``_mean``
    statistic of the port's final evaluation at JAX's trained parameters
    within rtol 1e-6. (The run's own model rows agree to what the epoch's
    parameters allow: the valid loss, 1.1e-7 on nearly resting tosses,
    came 4.8e-6 apart from parameters 4.8e-8 apart.)"""
    jexp = jax_float64(jmexp.MuJoCoMultibodyLearnableExperiment)(
        jax_config(mujoco_storage, "mjc_mb_e2e_jax",
                   learnable_config=jmulti.MultibodyLearnableSystemConfig(
                       urdfs={"cube": jget_asset("cube")},
                       loss=jmulti.MultibodyLosses.CONTACTNETS_LOSS,
                       use_warm_loss=False)))
    j_best, j_stats = jexp.generate_results(lambda *a: None)
    experiment = MuJoCoMultibodyLearnableExperiment(
        make_config(mujoco_storage, "mjc_mb_e2e",
                    MultibodyLearnableSystemConfig(
                        urdfs={"cube": get_asset("cube")},
                        loss=MultibodyLosses.CONTACTNETS_LOSS,
                        use_warm_loss=False)),
        device="cpu", dtype=torch.float64)
    best, stats = experiment.generate_results(lambda *a: None)
    assert_means_match(stats, j_stats, model_rows=False)
    j_leaves = jax_leaves(j_best)
    for leaf, ref in zip(best.parameters(), j_leaves, strict=True):
        np.testing.assert_allclose(leaf.detach().numpy(), ref,
                                   rtol=PARAM_RTOL, atol=1e-12)
    assert_means_match(
        experiment._evaluation(tree_from_leaves(best, j_leaves)), j_stats)


def test_mujoco_multibody_experiment_oracle_binding(mujoco_storage):
    experiment = MuJoCoMultibodyLearnableExperiment(
        make_config(mujoco_storage, "mjc_mb", MultibodyLearnableSystemConfig(
            urdfs={"cube": get_asset("cube")},
            loss=MultibodyLosses.CONTACTNETS_LOSS)), device="cpu")
    oracle, _ = experiment.get_oracle_system()
    assert isinstance(oracle, MuJoCoUKFSystem)
    # The learnable system is the port's multibody engine.
    system, params = experiment.get_learned_system()
    assert not system.host_stepped
    assert params is not None and system.device.type == "cpu"


def test_ukf_preprocess_smooths_history(mujoco_storage, rng):
    """With t_history > 1 the oracle's preprocess runs the UKF over the
    noisy history and lands nearer the true state than the raw last
    measurement; it equals JAX's within rtol 1e-8."""
    noise_std = 5e-3
    oracle, _ = build_mujoco_oracle_system(make_config(
        mujoco_storage, "mjc_ukf_pre",
        DeepLearnableSystemConfig(layers=2, hidden_size=16), t_history=8,
        noise_std=noise_std))
    x0 = np.zeros(13)
    x0[0] = 1.0
    x0[6] = 0.5   # free flight throughout the window
    x0[10] = 0.2
    clean = oracle.simulate(None, x0, 7)
    noisy = clean.copy()
    noisy[:, 4:7] += noise_std * rng.standard_normal((8, 3))
    smoothed, _ = oracle.preprocess_initial_condition(None, noisy, None)
    err_smoothed = np.linalg.norm(smoothed[4:7] - clean[-1, 4:7])
    err_raw = np.linalg.norm(noisy[-1, 4:7] - clean[-1, 4:7])
    assert err_smoothed < err_raw
    jref, _ = jmexp.build_mujoco_oracle_system(jax_config(
        mujoco_storage, "mjc_ukf_pre_jax", t_history=8, noise_std=noise_std))
    want, _ = jref.preprocess_initial_condition(None, noisy, None)
    np.testing.assert_allclose(smoothed, want, rtol=ESTIMATE_RTOL,
                               atol=1e-12)


# -- tests/test_mujoco_system.py, mirrored ----------------------------------------

def test_state_conversion_roundtrip(rng):
    x = rng.standard_normal(13)
    x[:4] /= np.linalg.norm(x[:4])
    qpos, qvel = state_to_mujoco(x, 0)
    np.testing.assert_allclose(mujoco_to_state(qpos, qvel), x, atol=1e-12)


def test_solref_args():
    arg1, arg2 = solref_args(2500.0, 1.04, v200=False)
    np.testing.assert_allclose(arg1, 1.0 / (1.04 * np.sqrt(2500.0)))
    np.testing.assert_allclose(arg2, 1.04)
    arg1, arg2 = solref_args(2500.0, 1.04, v200=True)
    np.testing.assert_allclose(arg1, -2500.0)
    np.testing.assert_allclose(arg2, -1.04 * 2 * np.sqrt(2500.0))


def test_cube_drop_settles(cube_mjcf):
    system = MuJoCoSystem(cube_mjcf, DT, stiffness=2500.0,
                          damping_ratio=1.04)
    assert system.space.n_x == 13
    x0 = np.zeros(13)
    x0[0] = 1.0
    x0[6] = 0.15
    trajectory = system.simulate(None, x0, 200)
    z = trajectory[:, 6]
    assert z.min() > 0.0
    assert abs(z[-1] - 0.0524) < 0.02   # rests near its half edge
    assert np.linalg.norm(trajectory[-1, 7:]) < 0.1


def test_ukf_estimate_improves_state(cube_mjcf, rng):
    system = MuJoCoUKFSystem(cube_mjcf, DT, stiffness=2500.0,
                             damping_ratio=1.04)
    clean, noisy = free_flight(rng)
    estimate = system.ukf_estimate(noisy)
    err_est = np.linalg.norm(estimate[4:7] - clean[-1][4:7])
    assert np.isfinite(err_est)
    assert err_est < 0.05


def test_ukf_bias_estimate_recovers_static_offset(cube_mjcf, rng):
    """Measurements with a constant configuration offset and small dynamic
    noise: the de-biased estimate beats the raw last measurement."""
    system = MuJoCoUKFSystem(cube_mjcf, DT, stiffness=2500.0,
                             damping_ratio=1.04, bias=True)
    assert system.P0.shape == (18, 18)
    x0 = np.zeros(13)
    x0[0] = 1.0
    x0[6] = 0.3       # free flight: smooth propagation
    x0[10] = 0.5
    clean = system.simulate(None, x0, 10)
    bias = np.zeros(13)
    bias[4:7] = [0.02, -0.015, 0.01]
    noisy = clean + bias + 0.002 * rng.standard_normal(clean.shape)
    noisy[:, :4] /= np.linalg.norm(noisy[:, :4], axis=-1, keepdims=True)
    static = np.zeros(12)
    static[:3] = 0.02
    P0_diag, R_diag = MuJoCoUKFSystem.noise_stds_to_P0_R_stds(
        static, np.full(12, 0.002), DT, bias=True)
    assert P0_diag.size == 18 and R_diag.size == 18
    system.P0 = np.diag(P0_diag**2) + 1e-9 * np.eye(18)
    system.R = np.diag(R_diag**2) + 1e-9 * np.eye(18)
    estimate = system.ukf_bias_estimate(noisy)
    err_est = np.linalg.norm(estimate[4:7] - clean[-1][4:7])
    err_raw = np.linalg.norm(noisy[-1][4:7] - clean[-1][4:7])
    assert np.isfinite(err_est)
    assert err_est < err_raw


def test_ukf_bias_preprocess_routes(cube_mjcf):
    system = MuJoCoUKFSystem(cube_mjcf, DT, stiffness=2500.0,
                             damping_ratio=1.04, bias=True)
    x0 = np.zeros(13)
    x0[0] = 1.0
    x0[6] = 0.3
    history = system.simulate(None, x0, 3)
    estimate, _ = system.preprocess_initial_condition(None, history, None)
    assert estimate.shape == (13,)
    assert np.all(np.isfinite(estimate))


def test_missing_mujoco_raises(monkeypatch, cube_mjcf):
    """Without the package the constructor names it; the port's modules
    import without it."""
    import builtins
    real_import = builtins.__import__

    def no_mujoco(name, *args, **kwargs):
        if name == "mujoco":
            raise ImportError("no module named mujoco")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_mujoco)
    with pytest.raises(ImportError, match="mujoco"):
        MuJoCoSystem(cube_mjcf, DT, 2500.0, 1.04)


def test_generator_takes_the_host_system(cube_mjcf, tmp_path):
    """The dataset generator rolls the MuJoCo system out through its numpy
    ``simulate_batch`` (parameters ``None``, float64 states on the CPU),
    as the JAX package's generator does."""
    import torch
    from dair_pll_tpu_torch.data.generation import (
        DataGenerationConfig, ExperimentDatasetGenerator)
    from dair_pll_tpu_torch.state_space import UniformSampler
    system = MuJoCoSystem(cube_mjcf, DT, 2500.0, 1.04)
    x_0 = system.space.zero_state(torch.float64)
    x_0[6] = 0.2
    ranges = 0.1 * torch.ones(12, dtype=torch.float64)
    sampler = UniformSampler(system.space, ranges, x_0=x_0)
    storage = str(tmp_path)
    generator = ExperimentDatasetGenerator(
        system, sampler, None, DataGenerationConfig(
            dt=DT, n_pop=3, trajectory_length=6))
    assert generator.generate(storage, batch_size=2) == 3
    paths = file_utils.list_trajectories(file_utils.trajectory_dir(
        storage, file_utils.GROUND_TRUTH_SUBDIR))
    assert len(paths) == 3
    for path in paths:
        truth = file_utils.load_trajectory(path)
        assert truth.shape == (6, 13)
        np.testing.assert_allclose(system.simulate(None, truth[0], 5), truth,
                                   rtol=0, atol=1e-12)
