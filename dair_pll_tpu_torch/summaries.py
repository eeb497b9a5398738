r"""Physical-parameter summaries for logging (PyTorch).

Counterpart of ``dair_pll_tpu/summaries.py`` (reference
``multibody_terms.py:536-582`` and ``multibody_learnable_system.py:315-333``):
per-body inertial scalars, per-geometry shape scalars, friction
coefficients and learned-shape meshes, keyed ``{body}_{scalar}``. It runs
on the host at logging time; parameters may lie on any device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dair_pll_tpu_torch import geometry as geometry_mod
from dair_pll_tpu_torch import inertia as inertia_mod
from dair_pll_tpu_torch.system import MeshSummary, SystemSummary


def _host(tensor: torch.Tensor) -> np.ndarray:
    return tensor.detach().cpu().numpy()


def multibody_summary(model, params) -> SystemSummary:
    """Scalars and meshes describing the current parameter values.

    Args:
        model: :class:`MultibodyModel`.
        params: :class:`MultibodyParams`.

    Returns:
        :class:`SystemSummary` with scalars and learned meshes (videos are
        attached by the experiment layer).
    """
    scalars: Dict[str, float] = {}
    meshes: Dict[str, MeshSummary] = {}

    with torch.no_grad():
        pi_cm = _host(params.pi_cm())
        friction = _host(params.friction_coefficients())

    for body_index, body in enumerate(model.bodies):
        body_scalars = inertia_mod.pi_cm_to_scalars(pi_cm[body_index])
        scalars.update({
            f"{body.name}_{name}": value
            for name, value in body_scalars.items()
        })

    for geom_index, spec in enumerate(model.geometries):
        if spec.body < 0:
            continue
        body_name = model.bodies[spec.body].name
        geom_scalars = geometry_mod.geometry_scalars(
            spec, params.geometry[geom_index])
        scalars.update({
            f"{body_name}_{name}": value
            for name, value in geom_scalars.items()
        })
        scalars[f"{body_name}_mu"] = float(friction[geom_index])

        if spec.geom_type == "deep_support_convex":
            from dair_pll_tpu_torch.mesh_extraction import extract_mesh
            from dair_pll_tpu_torch.urdf_export import icnn_support_fn
            mesh = extract_mesh(icnn_support_fn(
                spec, params.geometry[geom_index]))
            meshes[body_name] = mesh
            vertices = mesh.vertices
            diameters = vertices.max(axis=0) - vertices.min(axis=0)
            center = vertices.min(axis=0) + diameters / 2
            for axis, (diameter, c) in enumerate(zip(diameters, center)):
                name = "xyz"[axis]
                scalars[f"{body_name}_diameter_{name}"] = float(diameter)
                scalars[f"{body_name}_center_{name}"] = float(c)

    return SystemSummary(scalars=scalars, videos={}, meshes=meshes)
