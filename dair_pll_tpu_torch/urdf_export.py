r"""Export of learned parameters back to URDF.

Counterpart of ``dair_pll_tpu/urdf_export.py``: writes the learned
inertial parameters, friction coefficients and geometry (box sizes,
sphere radii, cylinder sizes, meshes extracted from polygon vertex sets
and deep support functions) back into the original URDF XML, creating
missing elements. Every collision geometry of a link is written back,
matched to the URDF's ``<collision>`` elements in document order. The
result round-trips through :func:`dair_pll_tpu_torch.urdf.
build_multibody_model`.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict

import numpy as np
import torch

from dair_pll_tpu_torch import inertia as inertia_mod
from dair_pll_tpu_torch.mesh_extraction import extract_mesh, mesh_to_obj
from dair_pll_tpu_torch.multibody.model import MultibodyModel, MultibodyParams
from dair_pll_tpu_torch.ops import icnn

_DRAKE_URI = "https://drake.mit.edu/"
_DRAKE_NS = "{" + _DRAKE_URI + "}"

ET.register_namespace("drake", _DRAKE_URI)


def _numpy(value) -> np.ndarray:
    return torch.as_tensor(value).detach().cpu().numpy()


def _find_or_create(parent: ET.Element, tag: str) -> ET.Element:
    """The first ``tag`` child of ``parent``, created if missing."""
    element = parent.find(tag)
    if element is None:
        element = ET.SubElement(parent, tag)
    return element


def _fill_inertial(link: ET.Element, pi_cm: np.ndarray) -> None:
    """Writes a ``pi_cm`` 10-vector into the link's ``<inertial>``."""
    mass_str, com_str, inertia_strs = inertia_mod.pi_cm_to_urdf(pi_cm)
    inertial = _find_or_create(link, "inertial")
    origin = _find_or_create(inertial, "origin")
    origin.set("xyz", com_str)
    origin.set("rpy", "0 0 0")
    _find_or_create(inertial, "mass").set("value", mass_str)
    inertia_el = _find_or_create(inertial, "inertia")
    for key, value in zip(("ixx", "iyy", "izz", "ixy", "ixz", "iyz"),
                          inertia_strs):
        inertia_el.set(key, value)


def icnn_support_fn(spec, geom_params):
    """Support-point function of a deep-support geometry for
    :func:`~dair_pll_tpu_torch.mesh_extraction.extract_mesh`: numpy
    directions in, numpy points out. The directions are rounded to float32,
    as the JAX package's export rounds them, so that both evaluate the same
    directions; the network runs in its own dtype on its device and the
    points keep that dtype (the JAX package's come back in float32)."""
    net = geom_params["icnn"]
    like = net["output_weight"]

    def support_fn(directions: np.ndarray) -> np.ndarray:
        d = torch.as_tensor(directions.astype(np.float32)).to(
            dtype=like.dtype, device=like.device)
        with torch.no_grad():
            return _numpy(icnn.icnn_support_points(
                net, d, spec.icnn_negative_slope))
    return support_fn


def _fill_collision_geometry(link: ET.Element, spec, geom_params, mu: float,
                             output_dir: str, mesh_name: str,
                             collision_index: int = 0) -> None:
    """Writes learned geometry and friction into the link's
    ``collision_index``-th ``<collision>`` element, creating trailing
    elements as needed."""
    collisions = link.findall("collision")
    while len(collisions) <= collision_index:
        collisions.append(ET.SubElement(link, "collision"))
    collision = collisions[collision_index]
    geometry = _find_or_create(collision, "geometry")
    for child in list(geometry):
        geometry.remove(child)

    if spec.geom_type == "box":
        half = np.abs(_numpy(geom_params["half_lengths"])).reshape(-1)
        ET.SubElement(geometry, "box").set(
            "size", " ".join(str(2.0 * float(h)) for h in half))
    elif spec.geom_type == "sphere":
        ET.SubElement(geometry, "sphere").set(
            "radius", str(float(np.abs(_numpy(geom_params["radius"])))))
    elif spec.geom_type == "cylinder":
        cylinder = ET.SubElement(geometry, "cylinder")
        cylinder.set("radius",
                     str(float(np.abs(_numpy(geom_params["radius"])))))
        cylinder.set("length", str(2.0 * float(np.abs(_numpy(
            geom_params["half_length"])))))
    elif spec.geom_type in ("polygon", "deep_support_convex"):
        if spec.geom_type == "polygon":
            vertices = _numpy(geom_params["vertices"])

            def support_fn(directions):
                return vertices[np.argmax(directions @ vertices.T, axis=-1)]
        else:
            support_fn = icnn_support_fn(spec, geom_params)
        obj_path = os.path.join(output_dir, f"{mesh_name}.obj")
        with open(obj_path, "w", encoding="utf-8") as handle:
            handle.write(mesh_to_obj(extract_mesh(support_fn)))
        ET.SubElement(geometry, "mesh").set("filename",
                                            os.path.basename(obj_path))

    props = _find_or_create(collision, f"{_DRAKE_NS}proximity_properties")
    _find_or_create(props, f"{_DRAKE_NS}mu_static").set("value",
                                                        str(float(mu)))


def represent_multibody_terms_as_urdfs(model: MultibodyModel,
                                       params: MultibodyParams,
                                       output_dir: str) -> Dict[str, str]:
    """The learned parameters of every URDF model as URDF strings.

    Args:
        model: the :class:`MultibodyModel` (it carries the original URDF
          paths).
        params: the learned :class:`MultibodyParams`, on any device.
        output_dir: directory for the extracted meshes' ``.obj`` files.

    Returns:
        Model name to URDF XML string.
    """
    os.makedirs(output_dir, exist_ok=True)
    pi_cm = _numpy(params.pi_cm())
    friction = np.abs(_numpy(params.friction))
    urdf_paths = dict(model.urdf_paths)

    geoms_by_body: Dict[int, list] = {}
    for geom_index, spec in enumerate(model.geometries):
        if spec.body >= 0:
            geoms_by_body.setdefault(spec.body, []).append(geom_index)

    output: Dict[str, str] = {}
    for model_spec in model.models:
        tree = ET.parse(urdf_paths[model_spec.name])
        robot = tree.getroot()
        links_by_name = {link.get("name"): link
                         for link in robot.findall("link")}
        for body_index in model_spec.body_indices:
            link_name = model.bodies[body_index].name.split("::", 1)[1]
            link = links_by_name[link_name]
            _fill_inertial(link, pi_cm[body_index])
            for collision_index, geom_index in enumerate(
                    geoms_by_body.get(body_index, [])):
                _fill_collision_geometry(
                    link, model.geometries[geom_index],
                    params.geometry[geom_index], friction[geom_index],
                    output_dir,
                    mesh_name=(f"{model_spec.name}_{link_name}_"
                               f"{collision_index}"),
                    collision_index=collision_index)
        output[model_spec.name] = ET.tostring(robot, encoding="unicode")
    return output
