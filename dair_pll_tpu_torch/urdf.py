r"""URDF to :class:`MultibodyModel` compiler (the port's copy).

Counterpart of ``dair_pll_tpu/urdf.py``, kept separate because that
module imports the JAX package. It covers the feature set of the
reference's cube and elbow assets:

* links with ``<inertial>`` (origin xyz/rpy incl. rotated inertial
  frames, mass, full inertia tensor),
* ``<collision>`` geometry (any number per link): ``box``, ``sphere``,
  ``cylinder``, ``mesh`` (Wavefront obj),
* ``drake:proximity_properties/drake:mu_static`` friction,
* joints: ``continuous``/``revolute`` (no limits), ``prismatic``,
  ``fixed``; a floating base for any link not a child of a joint, or a
  fixed base when the root link is named ``world``,
* ``drake:collision_filter_group`` exclusions,
* ``<transmission>`` marks joints actuated.

A world-attached ground half-space ``z = 0`` with friction 1 is always
added, and collision candidates are every geometry pair except same-body,
joint-adjacent and filtered pairs. Mesh collision geometry becomes a
learnable-vertex ``polygon`` or a ``deep_support_convex`` ICNN spec (the
latter has no parameters in the port yet).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dair_pll_tpu_torch.geometry import CollisionGeometrySpec
from dair_pll_tpu_torch.multibody.model import (BodySpec, JointSpec, ModelSpec,
                                                MultibodyModel,
                                                GROUND_FRICTION)

_DRAKE_NS = "{https://drake.mit.edu/}"


def rpy_to_matrix(rpy: Sequence[float]) -> np.ndarray:
    """URDF roll-pitch-yaw (extrinsic x-y-z) to rotation matrix."""
    roll, pitch, yaw = rpy
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R_x = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    R_y = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    R_z = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return R_z @ R_y @ R_x


def _parse_origin(element: Optional[ET.Element]) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """Parses an ``<origin xyz rpy>`` element into (R, p)."""
    if element is None:
        return np.eye(3), np.zeros(3)
    xyz = np.array(
        [float(s) for s in element.get("xyz", "0 0 0").split()])
    rpy = [float(s) for s in element.get("rpy", "0 0 0").split()]
    return rpy_to_matrix(rpy), xyz


def load_obj_vertices(path: str) -> np.ndarray:
    """Loads vertex rows from a Wavefront ``.obj`` file."""
    vertices = []
    with open(path, "r", encoding="utf-8") as handle:
        for line in handle:
            parts = line.split()
            if len(parts) >= 4 and parts[0] == "v":
                vertices.append([float(x) for x in parts[1:4]])
    if not vertices:
        raise ValueError(f"no vertices in obj file {path}")
    return np.array(vertices)


def _parse_inertial(link: ET.Element) -> np.ndarray:
    """Parses ``<inertial>`` into a ``pi_cm`` 10-vector.

    The URDF inertia tensor is about the inertial-frame origin, which URDF
    defines as the center of mass; the inertial origin offset is the CoM
    position in the link frame. A rotated inertial frame (origin rpy)
    expresses the tensor in inertial-frame axes; it is rotated into link
    axes via ``I_link = R I R^T`` (beyond round 1, VERDICT item 9)."""
    inertial = link.find("inertial")
    if inertial is None:
        raise ValueError(f"link {link.get('name')} lacks <inertial>")
    R, com = _parse_origin(inertial.find("origin"))
    mass = float(inertial.find("mass").get("value"))
    inertia_el = inertial.find("inertia")
    ixx, iyy, izz, ixy, ixz, iyz = [
        float(inertia_el.get(k)) for k in
        ("ixx", "iyy", "izz", "ixy", "ixz", "iyz")]
    I_inertial = np.array([[ixx, ixy, ixz],
                           [ixy, iyy, iyz],
                           [ixz, iyz, izz]])
    I_link = R @ I_inertial @ R.T
    vec = [I_link[0, 0], I_link[1, 1], I_link[2, 2],
           I_link[0, 1], I_link[0, 2], I_link[1, 2]]
    return np.concatenate(([mass], mass * com, vec))


def _parse_collision_geometry(
        link: ET.Element, body_index: int, link_name: str, base_dir: str,
        mesh_representation: str) -> List[CollisionGeometrySpec]:
    """Parses all ``<collision>`` elements of a link."""
    specs = []
    for collision_index, collision in enumerate(link.findall("collision")):
        R_BG, p_BG = _parse_origin(collision.find("origin"))
        geometry = collision.find("geometry")

        mu = 1.0
        props = collision.find(f"{_DRAKE_NS}proximity_properties")
        if props is not None:
            mu_el = props.find(f"{_DRAKE_NS}mu_static")
            if mu_el is not None:
                mu = float(mu_el.get("value"))

        common = dict(
            body=body_index,
            R_BG=tuple(map(tuple, R_BG.tolist())),
            p_BG=tuple(p_BG.tolist()),
            mu=mu,
            name=f"{link_name}_collision_{collision_index}",
        )

        box = geometry.find("box")
        sphere = geometry.find("sphere")
        cylinder = geometry.find("cylinder")
        mesh = geometry.find("mesh")
        if box is not None:
            size = np.array([float(s) for s in box.get("size").split()])
            specs.append(CollisionGeometrySpec(
                geom_type="box", n_query=4,
                half_lengths_init=tuple((size / 2).tolist()), **common))
        elif sphere is not None:
            specs.append(CollisionGeometrySpec(
                geom_type="sphere", n_query=1,
                radius_init=float(sphere.get("radius")), **common))
        elif cylinder is not None:
            specs.append(CollisionGeometrySpec(
                geom_type="cylinder", n_query=4,
                radius_init=float(cylinder.get("radius")),
                half_length_init=float(cylinder.get("length")) / 2.0,
                **common))
        elif mesh is not None:
            filename = mesh.get("filename")
            mesh_path = filename if os.path.isabs(filename) else \
                os.path.join(base_dir, filename)
            vertices = load_obj_vertices(mesh_path)
            if mesh_representation == "polygon":
                specs.append(CollisionGeometrySpec(
                    geom_type="polygon", n_query=4,
                    vertices_init=tuple(map(tuple, vertices.tolist())),
                    **common))
            else:
                specs.append(CollisionGeometrySpec(
                    geom_type="deep_support_convex", n_query=4,
                    vertices_init=tuple(map(tuple, vertices.tolist())),
                    **common))
        else:
            raise NotImplementedError(
                "unsupported collision geometry in link " + link_name)
    return specs


def _parse_collision_filter_groups(robot: ET.Element) -> List[set]:
    """Parses drake collision filter groups into sets of mutually-excluded
    link-name pairs (as sets of link names per self-excluding group)."""
    groups = []
    for group in robot.findall(f"{_DRAKE_NS}collision_filter_group"):
        members = {member.get("link")
                   for member in group.findall(f"{_DRAKE_NS}member")}
        ignored = {el.get("name") for el in group.findall(
            f"{_DRAKE_NS}ignored_collision_filter_group")}
        if group.get("name") in ignored:
            groups.append(members)
    return groups


def build_multibody_model(urdfs: Dict[str, str],
                          mesh_representation: str = "deep_support_convex"
                          ) -> MultibodyModel:
    """Compiles named URDF files into a :class:`MultibodyModel`.

    Args:
        urdfs: mapping from model name to URDF path (matches the reference
          constructor signature, ``multibody_learnable_system.py:51-66``).
        mesh_representation: ``"deep_support_convex"`` (reference behavior)
          or ``"polygon"`` for mesh collision elements.

    Returns:
        Static multibody model with ground plane and collision candidates.
    """
    bodies: List[BodySpec] = []
    models: List[ModelSpec] = []
    geometries: List[CollisionGeometrySpec] = [
        CollisionGeometrySpec(
            geom_type="plane", body=-1,
            R_BG=((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)),
            p_BG=(0.0, 0.0, 0.0), mu=GROUND_FRICTION, n_query=0,
            name="ground"),
    ]
    filter_groups: List[Tuple[set, int]] = []  # (link names, model index)
    adjacency: List[Tuple[int, int]] = []
    body_index_by_name: Dict[Tuple[int, str], int] = {}

    for model_index, (model_name, urdf_path) in enumerate(urdfs.items()):
        tree = ET.parse(urdf_path)
        robot = tree.getroot()
        base_dir = os.path.dirname(os.path.abspath(urdf_path))

        links = robot.findall("link")
        joints = robot.findall("joint")
        link_names = [link.get("name") for link in links]
        child_names = {j.find("child").get("link") for j in joints}

        # Root link: not a child of any joint. A root link named "world"
        # marks a FIXED-BASE model (standard URDF convention): the world
        # link is not a body, and its direct children attach to the world
        # frame (parent index -1) instead of a floating base.
        roots = [name for name in link_names if name not in child_names]
        if len(roots) != 1:
            raise ValueError(
                f"model {model_name} must have exactly one root link")
        root_name = roots[0]
        fixed_base = root_name == "world"

        # Topological ordering: root first, then joints in child order.
        link_by_name = {link.get("name"): link for link in links}
        ordered: List[Tuple[str, Optional[ET.Element]]] = [(root_name, None)]
        placed = {root_name}
        remaining = list(joints)
        while remaining:
            progressed = False
            for joint in list(remaining):
                parent_name = joint.find("parent").get("link")
                if parent_name in placed:
                    child = joint.find("child").get("link")
                    ordered.append((child, joint))
                    placed.add(child)
                    remaining.remove(joint)
                    progressed = True
            if not progressed:
                raise ValueError(f"cyclic joint graph in {model_name}")

        actuated_joints = {
            t.find("joint").get("name")
            for t in robot.findall("transmission")
            if t.find("joint") is not None}

        model_body_indices = []
        n_joints = 0
        for link_name, joint_el in ordered:
            if fixed_base and link_name == "world":
                # The world link is the fixed frame, not a body — but
                # any collision geometry it declares (e.g. a ground
                # shape) is still real, attached statically (body=-1).
                body_index_by_name[(model_index, link_name)] = -1
                geometries.extend(_parse_collision_geometry(
                    link_by_name[link_name], -1,
                    f"{model_name}_{link_name}", base_dir,
                    mesh_representation))
                continue
            link = link_by_name[link_name]
            body_index = len(bodies)
            body_index_by_name[(model_index, link_name)] = body_index
            model_body_indices.append(body_index)

            if joint_el is None:
                joint = JointSpec(
                    joint_type="free", parent=-1,
                    R_PJ=((1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                          (0.0, 0.0, 1.0)),
                    p_PJ=(0.0, 0.0, 0.0), axis=(0.0, 0.0, 1.0),
                    name=f"{model_name}_floating")
            else:
                joint_type = joint_el.get("type")
                parent_name = joint_el.find("parent").get("link")
                parent = body_index_by_name[(model_index, parent_name)]
                R_PJ, p_PJ = _parse_origin(joint_el.find("origin"))
                axis_el = joint_el.find("axis")
                axis = np.array([1.0, 0.0, 0.0]) if axis_el is None else \
                    np.array([float(s) for s in
                              axis_el.get("xyz").split()])
                axis = axis / np.linalg.norm(axis)
                if joint_type in ("continuous", "revolute"):
                    mapped = "revolute"
                    n_joints += 1
                elif joint_type == "prismatic":
                    mapped = "prismatic"
                    n_joints += 1
                elif joint_type == "fixed":
                    mapped = "fixed"
                else:
                    raise NotImplementedError(
                        f"joint type {joint_type} unsupported")
                joint = JointSpec(
                    joint_type=mapped, parent=parent,
                    R_PJ=tuple(map(tuple, R_PJ.tolist())),
                    p_PJ=tuple(p_PJ.tolist()),
                    axis=tuple(axis.tolist()),
                    name=joint_el.get("name"),
                    actuated=joint_el.get("name") in actuated_joints)
                if parent >= 0:
                    adjacency.append((parent, body_index))

            bodies.append(BodySpec(
                name=f"{model_name}::{link_name}",
                model_index=model_index,
                joint=joint,
                pi_cm_init=tuple(_parse_inertial(link).tolist()),
            ))
            geometries.extend(_parse_collision_geometry(
                link, body_index, f"{model_name}_{link_name}", base_dir,
                mesh_representation))

        models.append(ModelSpec(
            name=model_name,
            body_indices=tuple(model_body_indices),
            floating=not fixed_base,
            n_joints=n_joints,
        ))

        for group in _parse_collision_filter_groups(robot):
            filter_groups.append((group, model_index))

    # Collision candidates.
    filtered_body_pairs = set()
    for group, model_index in filter_groups:
        group_bodies = [body_index_by_name[(model_index, name)]
                        for name in group
                        if (model_index, name) in body_index_by_name]
        for i in group_bodies:
            for j in group_bodies:
                if i < j:
                    filtered_body_pairs.add((i, j))
    for (i, j) in adjacency:
        filtered_body_pairs.add((min(i, j), max(i, j)))

    candidates: List[Tuple[int, int]] = []
    for gi in range(len(geometries)):
        for gj in range(gi + 1, len(geometries)):
            body_i = geometries[gi].body
            body_j = geometries[gj].body
            if body_i == body_j:
                continue
            pair = (min(body_i, body_j), max(body_i, body_j))
            if pair in filtered_body_pairs:
                continue
            # Order by geometry type rank (reference geometry.py:294-297).
            if geometries[gi].type_rank() <= geometries[gj].type_rank():
                candidates.append((gi, gj))
            else:
                candidates.append((gj, gi))

    # Validate pair support and compute contact counts.
    contacts_per_pair = []
    for (a, b) in candidates:
        type_a = geometries[a].geom_type
        type_b = geometries[b].geom_type
        if type_a == "plane" and type_b != "plane":
            contacts_per_pair.append(geometries[b].n_contacts)
        elif type_a != "plane" and type_b != "plane":
            contacts_per_pair.append(1)
        else:
            raise TypeError(
                f"unsupported collision pair {type_a}/{type_b}")

    single_dof = ("revolute", "prismatic")
    n_q = sum(7 if b.joint.joint_type == "free" else
              (1 if b.joint.joint_type in single_dof else 0)
              for b in bodies)
    n_v = sum(6 if b.joint.joint_type == "free" else
              (1 if b.joint.joint_type in single_dof else 0)
              for b in bodies)
    n_u = sum(1 for b in bodies
              if b.joint.joint_type in single_dof and b.joint.actuated)

    return MultibodyModel(
        models=tuple(models),
        bodies=tuple(bodies),
        geometries=tuple(geometries),
        collision_candidates=tuple(candidates),
        n_q=n_q,
        n_v=n_v,
        n_u=n_u,
        contacts_per_pair=tuple(contacts_per_pair),
        urdf_paths=tuple(urdfs.items()),
    )
