r"""Programmatic generation of the benchmark system descriptions.

The port's copy of ``dair_pll_tpu/assets.py``, kept separate because the
port imports nothing of the JAX package. URDFs are written on demand
into a directory the caller names, or by default into the port's own
``assets_generated/`` directory (listed in ``.gitignore``).

It also makes seeded states of a free body near the ground, the initial
states of the rollout checks (numpy, so that the JAX package and the port
can be fed the same states).

Physical constants are those of the reference's cube-toss and
articulated-elbow assets: cube mass 0.37 kg, edge 0.1048 m, isotropic
inertia 8.1e-4 kg m^2, friction 0.15; elbow links 0.37 kg, boxes
0.1 x 0.05 x 0.05 m, inertia 6.167e-4, friction 0.3, hinge about +y at
offset (-0.035, 0.06, 0) with the second link's frames shifted +0.035 m
in x, links mutually collision-filtered.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np

CUBE_MASS = 0.37
CUBE_EDGE = 0.1048
CUBE_INERTIA = 0.00081
CUBE_MU = 0.15

ELBOW_MASS = 0.37
ELBOW_BOX = (0.1, 0.05, 0.05)
ELBOW_INERTIA = 0.0006167
ELBOW_MU = 0.3


def _inertia_xml(ixx: float, iyy: float, izz: float) -> str:
    return (f'<inertia ixx="{ixx}" ixy="0" ixz="0" iyy="{iyy}" '
            f'iyz="0" izz="{izz}"/>')


def _box_link(name: str, size, mass: float, inertia: float, mu: float,
              origin_xyz: str = "0 0 0", color: str = "0.6 0 0 1.0",
              mesh_file: Optional[str] = None) -> str:
    geometry = (f'<mesh filename="{mesh_file}"/>' if mesh_file else
                f'<box size="{size[0]} {size[1]} {size[2]}"/>')
    return f"""  <link name="{name}">
    <inertial>
      <origin xyz="{origin_xyz}" rpy="0 0 0"/>
      <mass value="{mass}"/>
      {_inertia_xml(inertia, inertia, inertia)}
    </inertial>
    <visual>
      <origin xyz="{origin_xyz}" rpy="0 0 0"/>
      <geometry>{geometry}</geometry>
      <material name="{name}_mat"><color rgba="{color}"/></material>
    </visual>
    <collision>
      <origin xyz="{origin_xyz}" rpy="0 0 0"/>
      <geometry>{geometry}</geometry>
      <drake:proximity_properties>
        <drake:mu_static value="{mu}"/>
      </drake:proximity_properties>
    </collision>
  </link>"""


def cube_urdf(mesh_file: Optional[str] = None, edge: float = CUBE_EDGE,
              inertia: float = CUBE_INERTIA, mu: float = CUBE_MU) -> str:
    """Cube-toss system URDF (box or mesh collision geometry)."""
    link = _box_link("body", (edge,) * 3, CUBE_MASS, inertia, mu,
                     mesh_file=mesh_file)
    return ('<?xml version="1.0"?>\n'
            '<robot name="cube" xmlns:drake="https://drake.mit.edu/">\n'
            f"{link}\n</robot>\n")


def elbow_urdf(mesh_file: Optional[str] = None, box=ELBOW_BOX,
               mass: float = ELBOW_MASS, inertia: float = ELBOW_INERTIA,
               mu: float = ELBOW_MU) -> str:
    """Two-link articulated elbow URDF with a continuous hinge joint and
    mutually collision-filtered links."""
    link1 = _box_link("elbow_1", box, mass, inertia, mu, color="0 1 0 1.0",
                      mesh_file=mesh_file)
    link2 = _box_link("elbow_2", box, mass, inertia, mu,
                      origin_xyz="0.035 0 0", color="0 0 1 1.0",
                      mesh_file=mesh_file)
    return f"""<?xml version="1.0"?>
<robot name="elbow" xmlns:drake="https://drake.mit.edu/">
{link1}
{link2}
  <joint name="hinge_1_to_2" type="continuous">
    <parent link="elbow_1"/>
    <child link="elbow_2"/>
    <origin xyz="-0.035 0.06 0" rpy="0 0 0"/>
    <axis xyz="0 1 0"/>
  </joint>
  <drake:collision_filter_group name="elbow_group">
    <drake:member link="elbow_1"/>
    <drake:member link="elbow_2"/>
    <drake:ignored_collision_filter_group name="elbow_group"/>
  </drake:collision_filter_group>
</robot>
"""


def wrong_init_urdf(name: str) -> str:
    """The box cube's or elbow's URDF with wrong parameters, for learning
    runs that start away from the truth (the JAX package's wrong-init
    protocol of ``scripts/elbow_recovery.py``): friction 2x, inertia 1.5x,
    boxes 20% small, and the elbow's masses 1.5x (the cube's mass stays:
    training pins the first body's inertial scale, which the ContactNets
    loss cannot observe)."""
    if name == "cube":
        return cube_urdf(edge=0.8 * CUBE_EDGE, inertia=1.5 * CUBE_INERTIA,
                         mu=2.0 * CUBE_MU)
    if name == "elbow":
        return elbow_urdf(box=tuple(0.8 * s for s in ELBOW_BOX),
                          mass=1.5 * ELBOW_MASS,
                          inertia=1.5 * ELBOW_INERTIA, mu=2.0 * ELBOW_MU)
    raise ValueError(f"no wrong-init URDF for {name!r}")


def _cube_obj() -> str:
    """Axis-aligned cube mesh at the reference's half-edge length."""
    h = CUBE_EDGE / 2
    corners = [(sx * h, sy * h, sz * h)
               for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    lines = [f"v {x} {y} {z}" for x, y, z in corners]
    # 12 triangles over the 8 corners (1-indexed, outward via convex hull
    # ordering checked at load time — loaders here only read vertices).
    faces = [(1, 2, 4), (1, 4, 3), (5, 8, 6), (5, 7, 8),
             (1, 6, 2), (1, 5, 6), (3, 4, 8), (3, 8, 7),
             (1, 3, 7), (1, 7, 5), (2, 8, 4), (2, 6, 8)]
    lines += [f"f {a} {b} {c}" for a, b, c in faces]
    return "\n".join(lines) + "\n"


def cube_mjcf_template() -> str:
    """MJCF template of the cube-toss cross-validation oracle, with
    ``$solrefarg1``, ``$solrefarg2`` and ``$dt`` placeholders that
    :class:`~dair_pll_tpu_torch.mujoco_system.MuJoCoSystem` fills (role of
    the reference's ``assets/cube_mujoco.xml``); the cube's constants
    above."""
    half = CUBE_EDGE / 2
    return f"""<mujoco model="cube_toss">
  <option timestep="$dt">
    <flag refsafe="disable"/>
  </option>
  <worldbody>
    <geom name="floor" pos="0 0 0" size="5 5 0.1" type="plane"
          solref="$solrefarg1 $solrefarg2" friction="{CUBE_MU} 0.005 0.0001"/>
    <body name="cube" pos="0 0 0">
      <inertial pos="0 0 0" mass="{CUBE_MASS}"
                fullinertia="{CUBE_INERTIA} {CUBE_INERTIA} {CUBE_INERTIA} 0 0 0"/>
      <freejoint name="cube_free"/>
      <geom name="cube_geom" type="box" size="{half} {half} {half}"
            solref="$solrefarg1 $solrefarg2"
            friction="{CUBE_MU} 0.005 0.0001"/>
    </body>
  </worldbody>
</mujoco>
"""


def _write_atomic(path: str, content: str) -> None:
    """Atomic same-directory write (temp file + ``os.replace``): the
    asset cache is shared across processes (multi-process training,
    xdist test workers), and a plain ``open(...).write`` lets a
    concurrent reader see a truncated file mid-write. ``os.replace`` is
    atomic on POSIX, so readers always observe a complete file. Content
    is deterministic, so last-writer-wins is harmless."""
    tmp_path = f"{path}.tmp.{os.getpid()}"
    with open(tmp_path, "w", encoding="utf-8") as handle:
        handle.write(content)
    os.replace(tmp_path, path)


def write_assets(directory: str) -> Dict[str, str]:
    """Writes all benchmark assets into a directory.

    Returns:
        asset name to file path.
    """
    os.makedirs(directory, exist_ok=True)
    paths = {}

    obj_path = os.path.join(directory, "cube.obj")
    _write_atomic(obj_path, _cube_obj())
    paths["cube_obj"] = obj_path

    for name, content in (
            ("cube", cube_urdf()),
            ("cube_mesh", cube_urdf(mesh_file="cube.obj")),
            ("elbow", elbow_urdf()),
            ("elbow_mesh", elbow_urdf(mesh_file="cube.obj"))):
        path = os.path.join(directory, f"{name}.urdf")
        _write_atomic(path, content)
        paths[name] = path

    mjcf_path = os.path.join(directory, "cube_mujoco.xml")
    _write_atomic(mjcf_path, cube_mjcf_template())
    paths["cube_mjcf"] = mjcf_path
    return paths


def get_asset(name: str, cache_dir: Optional[str] = None) -> str:
    """Returns the path of a named asset, generating it if needed.

    Args:
        name: "cube", "cube_mesh", "elbow", "elbow_mesh", "cube_obj" or
          "cube_mjcf" (the MuJoCo oracle's template).
        cache_dir: where to generate (default: ``assets_generated/``
          inside this package).
    """
    if cache_dir is None:
        cache_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "assets_generated")
    paths = write_assets(cache_dir)
    return paths[name]


def _quat_to_rotmat(quat: np.ndarray) -> np.ndarray:
    w, x, y, z = np.moveaxis(quat, -1, 0)
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def states_near_ground(rng: np.random.Generator, n: int,
                       lowest: Callable[[np.ndarray], np.ndarray],
                       clearance: Tuple[float, float] = (-0.004, 0.01),
                       fall_speed: float = 0.5) -> np.ndarray:
    """``(n, 13)`` states of a free body (quaternion, position, angular and
    linear velocity) at random orientations whose lowest point sits within
    ``clearance`` of the ground, falling at about ``fall_speed`` m/s, so
    that the contact solves are active within a few steps. ``lowest`` maps
    ``(n, 3, 3)`` rotations to the lowest height ``(n,)`` of the body's
    points, rotated, with the body origin at 0; for a convex body with
    support function ``h`` (in the body frame) that is ``-h(-R[:, 2])``."""
    quat = rng.standard_normal((n, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    height = -lowest(_quat_to_rotmat(quat)) + rng.uniform(*clearance, size=n)
    pos = np.concatenate([0.02 * rng.standard_normal((n, 2)),
                          height[:, None]], axis=-1)
    vel = rng.standard_normal((n, 6)) * [2.0, 2.0, 2.0, 0.3, 0.3, 0.1]
    vel[:, 5] -= fall_speed
    return np.concatenate([quat, pos, vel], axis=-1)


def icnn_states_near_ground(rng: np.random.Generator, n: int, net,
                            negative_slope: float = 0.5) -> np.ndarray:
    """:func:`states_near_ground` of a deep-support (ICNN) body with the
    network ``net`` (the port's tensors), whose support function gives the
    lowest point, ``-h(-R[:, 2])``."""
    import torch
    from dair_pll_tpu_torch.ops import icnn

    def lowest(rot: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            down = torch.as_tensor(-rot[:, 2]).to(net["output_weight"])
            return -icnn.icnn_value(net, down, negative_slope).cpu().numpy()
    return states_near_ground(rng, n, lowest)


def cube_states_near_ground(rng: np.random.Generator, n: int,
                            clearance: Tuple[float, float] = (-0.004, 0.01),
                            fall_speed: float = 0.5) -> np.ndarray:
    """:func:`states_near_ground` of the cube (edge ``CUBE_EDGE``)."""
    corners = (CUBE_EDGE / 2) * np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
         for sz in (-1, 1)], dtype=np.float64)
    return states_near_ground(
        rng, n,
        lambda rot: np.min(np.einsum("bij,cj->bci", rot, corners)[..., 2],
                           axis=-1),
        clearance, fall_speed)


def tree_states_near_ground(rng: np.random.Generator, n: int,
                            model) -> np.ndarray:
    """``(n, n_x)`` states of a free-base model (the port's
    ``MultibodyModel``: the elbow, the polygon cube) at its initial
    parameters: random unit quaternions, the base's xy 0.02 N(0, 1), joint
    angles uniform in (-pi, pi], the base's velocities of
    :func:`states_near_ground`'s spread and the joints' N(0, 1), the base
    lifted so that its lowest witness point (the port's own signed
    distances, float64 on the CPU) sits within (-4, 10) mm of the
    ground."""
    import torch
    from dair_pll_tpu_torch.multibody.soa_terms import soa_multibody_terms
    n_q, n_v = model.n_q, model.n_v
    x = np.zeros((n, n_q + n_v))
    quat = rng.standard_normal((n, 4))
    x[:, :4] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    x[:, 4:6] = 0.02 * rng.standard_normal((n, 2))
    x[:, 7:n_q] = rng.uniform(-np.pi, np.pi, (n, n_q - 7))
    x[:, n_q:n_q + 6] = rng.standard_normal((n, 6)) * \
        [2.0, 2.0, 2.0, 0.3, 0.3, 0.1]
    x[:, n_q + 5] -= 0.5
    x[:, n_q + 6:] = rng.standard_normal((n, n_v - 6))
    rows = list(torch.tensor(x).T)
    with torch.no_grad():
        _, _, phi, _ = soa_multibody_terms(
            model, model.initial_params(torch.float64), rows[:n_q],
            rows[n_q:], [])
    x[:, 6] += -phi.min(dim=0).values.numpy() + rng.uniform(-0.004, 0.01, n)
    return x
