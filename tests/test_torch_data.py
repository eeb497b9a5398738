"""The port's data layer against the JAX package's, on the CPU: slicing
(the Python loop and the native slicer), the train/valid/test split, the
samplers and the white noiser, the dataset generator, the logging
manager's JSONL and the storage helpers.

The generator's rollouts are compared on identical initial states (a
``ConstantSampler`` subclass per package that hands out the same numpy
states), float64, without noise: the saved trajectories agree within
1e-7. The random draws themselves differ by package (a ``torch.Generator``
against a JAX key), so the samplers are held to their distribution
instead: the empirical mean and covariance of 20,000 draws on the Lie
algebra within 4 standard errors.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dair_pll_tpu import state_space as jspace
from dair_pll_tpu.assets import get_asset as jget_asset
from dair_pll_tpu.data import management as jmanagement
from dair_pll_tpu.data.config import DataConfig as JDataConfig
from dair_pll_tpu.data.generation import (
    DataGenerationConfig as JGenerationConfig,
    ExperimentDatasetGenerator as JGenerator)
from dair_pll_tpu.multibody.learnable_system import (
    MultibodyLearnableSystem as JSystem)
from dair_pll_tpu.ops import quaternion as jquaternion
from dair_pll_tpu.urdf import build_multibody_model as jbuild
from dair_pll_tpu.utils import file_utils as jfile_utils
from dair_pll_tpu_torch import state_space as tspace
from dair_pll_tpu_torch.assets import get_asset as tget_asset
from dair_pll_tpu_torch.data import management as tmanagement
from dair_pll_tpu_torch.data import native as tnative
from dair_pll_tpu_torch.data.config import DataConfig
from dair_pll_tpu_torch.data.generation import (DataGenerationConfig,
                                                ExperimentDatasetGenerator)
from dair_pll_tpu_torch.multibody.learnable_system import (
    MultibodyLearnableSystem as TSystem)
from dair_pll_tpu_torch.system import MeshSummary
from dair_pll_tpu_torch.utils import file_utils
from dair_pll_tpu_torch.utils.logging_manager import ExperimentLogManager

DT = 0.0068
N_DRAWS = 20000
STANDARD_ERRORS = 4.0


def _trajectories(rng, n=7, n_x=13, lengths=(3, 9, 12)):
    return [rng.standard_normal((lengths[i % len(lengths)], n_x)).astype(
        np.float32) for i in range(n)]


@pytest.mark.parametrize("layout", [(0, 1, 1), (1, 2, 2), (3, 2, 4)])
def test_slicing_matches_jax(rng, layout):
    trajectories = _trajectories(rng)
    past, future = tmanagement.slice_trajectories(trajectories, *layout)
    j_past, j_future = jmanagement.slice_trajectories(trajectories, *layout)
    np.testing.assert_array_equal(past, j_past)
    np.testing.assert_array_equal(future, j_future)


def test_native_slicer_matches_python_loop(rng, monkeypatch):
    trajectories = _trajectories(rng, n=11)
    if not tnative.native_available():
        pytest.skip("the native slicer does not build on this host")
    native = tnative.slice_trajectories_native(trajectories, 1, 2, 3)
    monkeypatch.setattr(tnative, "native_available", lambda: False)
    python = tmanagement.slice_trajectories(trajectories, 1, 2, 3)
    for got, ref in zip(native, python):
        np.testing.assert_array_equal(got, ref)


def test_split_matches_jax(rng, tmp_path):
    storage = str(tmp_path)
    for i in range(23):
        file_utils.save_trajectory(storage, file_utils.LEARNING_SUBDIR, i,
                                   rng.standard_normal((6 + i % 4, 13)))
    kwargs = dict(dt=DT, train_fraction=0.5, valid_fraction=0.3,
                  test_fraction=0.2)
    port = tmanagement.ExperimentDataManager(storage, DataConfig(**kwargs),
                                             seed=5)
    ref = jmanagement.ExperimentDataManager(storage, JDataConfig(**kwargs),
                                            seed=5)
    sets, j_sets = port.get_trajectory_sets(), ref.get_trajectory_sets()
    assert port.trajectory_set_indices() == ref.trajectory_set_indices()
    for got, want in zip(sets, j_sets):
        assert got.indices == want.indices
        np.testing.assert_array_equal(got.slices_past, want.slices_past)
        np.testing.assert_array_equal(got.slices_future, want.slices_future)
    sampled = port.make_sampled_set(sets[0], 3)
    j_sampled = ref.make_sampled_set(j_sets[0], 3)
    np.testing.assert_array_equal(sampled.slices_past, j_sampled.slices_past)
    # A stored split is restored as it was.
    again = tmanagement.ExperimentDataManager(
        storage, DataConfig(**kwargs),
        split_indices=port.trajectory_set_indices())
    again.get_trajectory_sets()
    assert again.trajectory_set_indices() == port.trajectory_set_indices()


def _space_pair():
    return tspace.FloatingBaseSpace(0), jspace.FloatingBaseSpace(0)


@pytest.mark.parametrize("kind", ["uniform", "gaussian"])
def test_sampler_covariance_matches_jax(kind):
    space, jspace_ = _space_pair()
    ranges = np.linspace(0.05, 0.6, 2 * space.n_v)
    port = tspace.CenteredSampler(space, torch.as_tensor(ranges), kind)
    ref = jspace.CenteredSampler(jspace_, jnp.asarray(ranges), kind)
    np.testing.assert_allclose(port.covariance(torch.float64).numpy(),
                               np.asarray(ref.covariance(jnp.float64)),
                               rtol=1e-15, atol=0)
    constant = tspace.ZeroSampler(space)
    np.testing.assert_array_equal(
        constant.covariance(torch.float64).numpy(),
        np.asarray(jspace.ZeroSampler(jspace_).covariance(jnp.float64)))


@pytest.mark.parametrize("cls", [tspace.UniformSampler,
                                 tspace.GaussianSampler])
def test_sampler_draws_have_their_distribution(rng, cls):
    """Shapes, unit quaternions, uniform bounds, and the draws' mean and
    covariance on the Lie algebra around ``x_0`` within 4 standard errors
    of the distribution's."""
    space = tspace.FloatingBaseSpace(0)
    x_0 = space.zero_state(torch.float64)
    x_0[:4] = torch.tensor([0.8, 0.2, -0.4, 0.4], dtype=torch.float64)
    x_0[6] = 0.21
    ranges = torch.as_tensor(np.linspace(0.05, 0.5, 2 * space.n_v))
    sampler = cls(space, ranges, x_0=x_0)
    generator = torch.Generator().manual_seed(3)
    draws = sampler.get_samples(generator, N_DRAWS, torch.float64)
    assert draws.shape == (N_DRAWS, space.n_x)
    np.testing.assert_allclose(torch.linalg.norm(draws[:, :4], dim=-1),
                               1.0, atol=1e-12)
    one = sampler.get_sample(generator, torch.float64)
    assert one.shape == (space.n_x,)

    d = space.state_difference(sampler.x_0.expand_as(draws), draws).numpy()
    r = ranges.numpy()
    if cls is tspace.UniformSampler:
        assert np.all(np.abs(d) <= r * (1 + 1e-9))
    covariance = sampler.covariance(torch.float64).numpy()
    variance = np.diag(covariance)
    mean = d.mean(axis=0)
    assert np.all(np.abs(mean) <= STANDARD_ERRORS * np.sqrt(variance /
                                                            N_DRAWS))
    empirical = np.cov(d, rowvar=False)
    fourth = np.mean(d ** 4, axis=0)
    diag_se = np.sqrt((fourth - variance ** 2) / N_DRAWS)
    assert np.all(np.abs(np.diag(empirical) - variance) <=
                  STANDARD_ERRORS * diag_se)
    off_se = np.sqrt(np.outer(variance, variance) / N_DRAWS)
    off = ~np.eye(len(variance), dtype=bool)
    assert np.all(np.abs(empirical - covariance)[off] <=
                  STANDARD_ERRORS * off_se[off])


def test_noiser_shapes_and_shared_draws():
    space = tspace.FloatingBaseSpace(1)
    noiser = tspace.WhiteNoiser(space, "gaussian")
    x = space.zero_state(torch.float64).expand(5, -1)
    ranges = torch.full((2 * space.n_v,), 0.1, dtype=torch.float64)
    noised = noiser.noise(torch.Generator().manual_seed(0), x, ranges)
    assert noised.shape == x.shape and not torch.equal(noised[0], noised[1])
    shared = noiser.noise(torch.Generator().manual_seed(0), x, ranges,
                          independent=False)
    torch.testing.assert_close(shared[0], shared[4], rtol=0, atol=0)
    with pytest.raises(ValueError):
        tspace.WhiteNoiser(space, "laplace")


def test_project_derivative_matches_jax(rng):
    space, jspace_ = _space_pair()
    x = rng.standard_normal((3, 9, space.n_x))
    x[..., :4] *= 2.0          # off the unit sphere, to be projected
    got = space.project_derivative(space.project_state(torch.as_tensor(x)),
                                   DT).numpy()
    want = np.asarray(jspace_.project_derivative(
        jspace_.project_state(jnp.asarray(x)), DT))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


class _PortStates(tspace.ConstantSampler):
    def __init__(self, space, states):
        super().__init__(space, torch.as_tensor(states[0]))
        self.states = torch.as_tensor(states)

    def get_samples(self, generator, n, dtype=torch.float32):
        return self.states[:n].to(dtype)


class _JaxStates(jspace.ConstantSampler):
    def __init__(self, space, states):
        super().__init__(space, jnp.asarray(states[0]))
        self.states = jnp.asarray(states)

    def get_samples(self, key, n, dtype=jnp.float32):
        # float64 whatever the dtype asked: the JAX generator asks for its
        # default float32, the parameters here are float64.
        return self.states[:n]


def test_generator_matches_jax(tmp_path):
    """Saved ground-truth and learning trajectories of the same initial
    states, float64, on the vmapped rollout of both packages."""
    n_pop, length = 4, 10
    jmodel = jbuild({"cube": jget_asset("cube")},
                    mesh_representation="polygon")
    jsystem = JSystem(jmodel, DT)
    tsystem = TSystem.from_urdfs({"cube": tget_asset("cube")}, DT,
                                 mesh_representation="polygon",
                                 device="cpu")
    space = tsystem.space
    rng = np.random.default_rng(11)
    states = np.zeros((n_pop, space.n_x))
    rot = rng.normal(size=(n_pop, 3)) * 0.6
    states[:, :4] = np.asarray(jax.vmap(jquaternion.exp)(jnp.asarray(rot)))
    states[:, 6] = 0.07 + 0.02 * rng.random(n_pop)
    states[:, 7:] = rng.normal(size=(n_pop, 6)) * [2, 2, 2, 0.5, 0.5, 0.5]

    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    generated = ExperimentDatasetGenerator(
        tsystem, _PortStates(space, states),
        tsystem.initial_params(torch.float64),
        DataGenerationConfig(dt=DT, n_pop=n_pop, trajectory_length=length)
    ).generate(port_dir, batch_size=n_pop)
    j_generated = JGenerator(
        jsystem, _JaxStates(jsystem.space, states),
        jmodel.initial_params(jnp.float64),
        JGenerationConfig(dt=DT, n_pop=n_pop, trajectory_length=length)
    ).generate(jax_dir, batch_size=n_pop)
    assert generated == j_generated == n_pop
    for subdir, rows in ((file_utils.GROUND_TRUTH_SUBDIR, length),
                         (file_utils.LEARNING_SUBDIR, length - 1)):
        paths = file_utils.list_trajectories(
            file_utils.trajectory_dir(port_dir, subdir))
        j_paths = jfile_utils.list_trajectories(
            jfile_utils.trajectory_dir(jax_dir, subdir))
        assert len(paths) == len(j_paths) == n_pop
        for path, j_path in zip(paths, j_paths):
            got = file_utils.load_trajectory(path)
            assert got.shape == (rows, space.n_x)
            np.testing.assert_allclose(got,
                                       jfile_utils.load_trajectory(j_path),
                                       rtol=0, atol=1e-7)
    # A second call finds the storage full.
    assert ExperimentDatasetGenerator(
        tsystem, _PortStates(space, states),
        tsystem.initial_params(torch.float64),
        DataGenerationConfig(dt=DT, n_pop=n_pop, trajectory_length=length)
    ).generate(port_dir, batch_size=n_pop) == 0


def test_generator_noise_and_rejection(tmp_path):
    """Static and dynamic noise move the learning copy off the ground
    truth, which keeps finite-difference velocities; the velocity filter
    rejects every trajectory of an unintegrable regime and aborts."""
    tsystem = TSystem.from_urdfs({"cube": tget_asset("cube")}, DT,
                                 mesh_representation="polygon",
                                 device="cpu")
    space = tsystem.space
    x_0 = space.zero_state(torch.float64)
    x_0[6] = 1.0               # in the air: no contact
    sampler = tspace.UniformSampler(
        space, torch.full((2 * space.n_v,), 0.1, dtype=torch.float64),
        x_0=x_0)
    config = DataGenerationConfig(
        dt=DT, n_pop=3, trajectory_length=5,
        static_noise=0.01 * np.ones(2 * space.n_v),
        dynamic_noise=0.005 * np.ones(2 * space.n_v))
    params = tsystem.initial_params(torch.float64)
    storage = str(tmp_path)
    assert ExperimentDatasetGenerator(tsystem, sampler, params,
                                      config).generate(storage, 3) == 3
    truth = file_utils.load_trajectory(file_utils.trajectory_path(
        storage, file_utils.GROUND_TRUTH_SUBDIR, 0))
    noised = file_utils.load_trajectory(file_utils.trajectory_path(
        storage, file_utils.LEARNING_SUBDIR, 0))
    assert noised.shape == (4, space.n_x)
    assert np.abs(noised[:, :7] - truth[1:, :7]).max() > 1e-4
    q = torch.as_tensor(noised[:, :space.n_q])
    fd = space.finite_difference(q[:-1], q[1:], DT).numpy()
    np.testing.assert_allclose(noised[1:, space.n_q:], fd, atol=1e-9)

    bad = DataGenerationConfig(dt=DT, n_pop=2, trajectory_length=3,
                               max_velocity=1e-9)
    with pytest.raises(RuntimeError, match="not integrable"):
        ExperimentDatasetGenerator(tsystem, sampler, params,
                                   bad).generate(str(tmp_path / "b"), 2)


def test_logging_manager_and_file_utils_round_trips(tmp_path, rng):
    storage = str(tmp_path)
    manager = ExperimentLogManager(storage, "run")
    assert manager.run_id.startswith("run_")
    mesh = MeshSummary(vertices=np.eye(3), faces=np.array([[0, 1, 2]]))
    video = np.zeros((1, 2, 3, 4, 4), dtype=np.uint8)
    manager.update(0, {"a": 1.5, "b": np.float32(2.0), "skip": [1, 2]},
                   {"overlay": (video, 10)}, {"cube": mesh})
    manager.update(1, {"a": 0.5})
    with open(file_utils.log_path(storage, "run"), encoding="utf-8") as f:
        records = [json.loads(line) for line in f]
    assert records == [{"epoch": 0, "a": 1.5, "b": 2.0},
                       {"epoch": 1, "a": 0.5}]
    run_dir = file_utils.run_dir(storage, "run")
    assert os.path.exists(os.path.join(run_dir, "meshes", "cube_0.obj"))
    saved = np.load(os.path.join(run_dir, "videos", "overlay_0.npz"))
    np.testing.assert_array_equal(saved["video"], video)
    resumed = ExperimentLogManager(storage, "run", resume_id="run_7")
    assert resumed.run_id == "run_7"

    trajectory = rng.standard_normal((5, 13))
    path = file_utils.save_trajectory(storage, "learning", 0, trajectory)
    np.testing.assert_array_equal(file_utils.load_trajectory(path),
                                  trajectory)
    pt = os.path.join(storage, "1.pt")
    torch.save(torch.as_tensor(trajectory), pt)
    np.testing.assert_array_equal(file_utils.load_trajectory(pt),
                                  trajectory)
    assert file_utils.import_data_to_storage(
        str(tmp_path / "imported"), storage) == 1
    file_utils.save_evaluation(storage, "run", {"x": 1})
    assert file_utils.load_evaluation(storage, "run") == {"x": 1}
    with pytest.raises(FileNotFoundError):
        file_utils.load_evaluation(storage, "other")
    file_utils.save_hyperparameters(storage, "study", {"lr": 0.1})
    assert file_utils.load_hyperparameters(storage, "study") == {"lr": 0.1}
