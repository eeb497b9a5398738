"""Visualization, mesh extraction and the interactive export of the
PyTorch port, mirroring ``tests/test_vis_and_export.py`` and held against
the JAX package: mesh extraction from a support function (the same
vertices and faces as JAX's), the ``.obj`` round trip, the overlay
video's contract (the same frames as JAX's), and the three.js page
(``dair_pll_tpu_torch/interactive_vis.py``): its embedded geometry and
poses equal the JAX package's for the same trajectory, for a box, the
ICNN cube and the elbow; the multibody experiment writes it beside its
videos."""
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dair_pll_tpu import interactive_vis as jvis
from dair_pll_tpu.assets import get_asset as jasset
from dair_pll_tpu.mesh_extraction import extract_mesh as jextract
from dair_pll_tpu.urdf import build_multibody_model as jbuild
from dair_pll_tpu_torch import assets as tassets
from dair_pll_tpu_torch import interactive_vis as tvis
from dair_pll_tpu_torch.mesh_extraction import (
    extract_mesh, extract_outward_normal_hyperplanes, mesh_to_obj)
from dair_pll_tpu_torch.multibody.learnable_system import (
    MultibodyLearnableSystem)
from dair_pll_tpu_torch.multibody.model import params_from_numpy
from dair_pll_tpu_torch.urdf import build_multibody_model, load_obj_vertices
from torch_parity import map_tree, params_numpy

HALF = np.array([0.05, 0.06, 0.07])
CORNERS = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                    for sz in (-1, 1)]) * HALF


def _box_support(directions):
    return CORNERS[np.argmax(directions @ CORNERS.T, axis=-1)]


def test_extract_mesh_from_box_support():
    """A box's support function extracts its 8 corners and 12 outward
    faces, whose extents are the half lengths; the same mesh as the JAX
    package's."""
    mesh = extract_mesh(_box_support)
    assert mesh.vertices.shape == (8, 3) and mesh.faces.shape == (12, 3)
    normals, backwards, extents = extract_outward_normal_hyperplanes(
        mesh.vertices, mesh.faces)
    assert not np.any(backwards)
    for axis, h in enumerate(HALF):
        axis_normals = np.abs(normals[:, axis]) > 0.99
        np.testing.assert_allclose(extents[axis_normals], h, atol=1e-9)
    want = jextract(_box_support)
    np.testing.assert_array_equal(mesh.vertices, np.asarray(want.vertices))
    np.testing.assert_array_equal(mesh.faces, np.asarray(want.faces))


def test_obj_roundtrip(tmp_path):
    """A mesh written as ``.obj`` reads back with its vertices."""
    path = os.path.join(str(tmp_path), "box.obj")
    with open(path, "w", encoding="utf-8") as handle:
        handle.write(mesh_to_obj(extract_mesh(_box_support)))
    vertices = load_obj_vertices(path)
    assert vertices.shape == (8, 3)
    np.testing.assert_allclose(np.abs(vertices),
                               np.broadcast_to(HALF, (8, 3)), atol=1e-9)


def test_visualize_trajectory_contract():
    """The overlay video has the reference's ``(1, T, 3, H, W)`` uint8
    contract and draws both trajectories, frame for frame the JAX
    package's."""
    pytest.importorskip("matplotlib")
    from dair_pll_tpu.vis_utils import visualize_trajectory as jvisualize
    from dair_pll_tpu_torch.vis_utils import visualize_trajectory
    model = build_multibody_model({"cube": tassets.get_asset("cube")})
    target = np.zeros((4, 13), np.float32)
    target[:, 0] = 1.0
    target[:, 6] = 0.1
    prediction = target.copy()
    prediction[:, 4] += 0.05
    video, fps = visualize_trajectory(model, model.initial_params(), target,
                                      prediction, dt=0.0068, max_frames=4)
    assert video.dtype == np.uint8
    assert video.ndim == 5 and video.shape[0] == 1 and video.shape[2] == 3
    assert fps >= 1 and video.std() > 1.0
    jmodel = jbuild({"cube": jasset("cube")})
    want, want_fps = jvisualize(jmodel, jmodel.initial_params(), target,
                                prediction, dt=0.0068, max_frames=4)
    assert fps == want_fps
    np.testing.assert_array_equal(video, np.asarray(want))


def _data(html: str) -> dict:
    return json.loads(re.search(r"const DATA = (\{.*?\});\n", html,
                                re.S).group(1))


@pytest.mark.parametrize("asset", ["cube", "cube_mesh", "elbow"])
def test_interactive_html_export(tmp_path, asset):
    """The three.js page of a rollout: one self-contained HTML whose
    embedded JSON (each body's geometry at the parameters, each frame's
    poses) equals the JAX package's page for the same trajectory and
    parameters: a box, the ICNN cube (its extracted mesh) and the elbow
    (two bodies)."""
    name = "elbow" if asset == "elbow" else "cube"
    jmodel = jbuild({name: jasset(asset)})
    tmodel = build_multibody_model({name: tassets.get_asset(asset)})
    numpy_params = params_numpy(jmodel.initial_params(jnp.float64))
    tparams = params_from_numpy(tmodel, *numpy_params)
    from torch_parity import jax_params
    jparams = jax_params(numpy_params)
    system = MultibodyLearnableSystem(tmodel, 0.0068, device="cpu")
    x0 = torch.zeros(tmodel.n_q + tmodel.n_v, dtype=torch.float64)
    x0[0], x0[6] = 1.0, 0.1
    x0[tmodel.n_q:tmodel.n_q + 3] = torch.tensor([1.0, 0.5, 0.2])
    x0[tmodel.n_q + 3:tmodel.n_q + 6] = torch.tensor([0.3, -0.2, 0.0])
    with torch.no_grad():
        traj = system.simulate(tparams, x0, 6).numpy()
    path = tvis.export_interactive_html(
        tmodel, tparams, traj, traj + 0.0, 0.0068,
        str(tmp_path / "rollout.html"), title=f"{asset} test")
    with open(path, encoding="utf-8") as handle:
        html = handle.read()
    assert "three" in html and f"{asset} test" in html
    data = _data(html)
    assert len(data["prediction"]) == traj.shape[0]
    assert len(data["prediction"][0]) == tmodel.n_bodies
    assert len(data["prediction"][0][0]) == 7
    want_path = jvis.export_interactive_html(
        jmodel, jparams, traj, traj + 0.0, 0.0068,
        str(tmp_path / "jax.html"), title=f"{asset} test")
    with open(want_path, encoding="utf-8") as handle:
        want = _data(handle.read())
    for key in ("prediction", "target"):
        np.testing.assert_allclose(data[key], want[key], atol=2e-5)
    assert data["dt"] == want["dt"]
    for got_body, want_body in zip(data["bodies"], want["bodies"]):
        assert len(got_body["geometries"]) == len(want_body["geometries"])
        for got, ref in zip(got_body["geometries"],
                            want_body["geometries"]):
            assert got["type"] == ref["type"]
            for field in ("R_BG", "p_BG", "half_lengths", "radius",
                          "vertices"):
                if field in ref:
                    np.testing.assert_allclose(got[field], ref[field],
                                               atol=1e-6)
            if "faces" in ref:
                assert got["faces"] == ref["faces"]
    if asset == "cube":
        assert data["bodies"][0]["geometries"][0]["type"] == "box"


def test_experiment_writes_the_page(tmp_path):
    """The multibody experiment's comparison summary writes the three.js
    page of each set's first sampled pair under the run's
    ``interactive/``, with or without matplotlib."""
    from dair_pll_tpu_torch.examples import contactnets_simple as cli
    cli.generate_tosses("cube", str(tmp_path), 4, 8, device="cpu")
    experiment = cli.build_experiment(storage=str(tmp_path), run_name="vis",
                                      epochs=1, device="cpu")
    experiment.setup_training()
    _, params = experiment.get_learned_system()
    sets = dict(zip(("train", "valid"),
                    experiment.data_manager.get_trajectory_sets()))
    stats = experiment.evaluate_systems_on_sets(
        {"model": (experiment.learned_system, params)}, sets)
    experiment.base_and_learned_comparison_summary(stats, params)
    pages = sorted(os.listdir(os.path.join(str(tmp_path), "runs", "vis",
                                           "interactive")))
    assert pages == ["train_overlay.html", "valid_overlay.html"]
