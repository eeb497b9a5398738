r"""Collision geometry specs and their parameters (PyTorch).

Counterpart of ``dair_pll_tpu/geometry.py``: a static, hashable spec per
geometry (:class:`CollisionGeometrySpec`), a learnable parameter
dictionary per geometry (``MultibodyParams.geometry``), and the support
queries and collision functions of the per-sample (vmapped) path, with
the batch written out as leading dimensions: a direction is ``(*, 3)``, a
relative pose ``R_AB (*, 3, 3)``, ``p_AoBo_A (*, 3)``. The fused path
collides plane-vs-convex pairs its own way in ``multibody/soa_terms.py``.

Witness vertices of a polytope are its top ``n_query`` vertices by
support value, ties in vertex order (a stable descending sort, as
``jax.lax.top_k`` orders them). Convex-vs-convex pairs search the contact
direction by 32 steps of gradient ascent on the separation under no
gradient, as the JAX package does, and return one contact.

Type ordering: ``Plane < Polygon < Box < Cylinder < Sphere <
DeepSupportConvex``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from torch import Tensor

from dair_pll_tpu_torch.ops import icnn
from dair_pll_tpu_torch.ops.tensor import rotation_matrix_from_one_vector

GEOMETRY_TYPE_ORDER = (
    "plane", "polygon", "box", "cylinder", "sphere",
    "deep_support_convex")

_POLYGON_DEFAULT_N_QUERY = 4
_DEEP_SUPPORT_DEFAULT_DEPTH = 2
_DEEP_SUPPORT_DEFAULT_WIDTH = 256
_DEEP_SUPPORT_PERTURBATION = 0.4
_MESH_MESH_ITERS = 32

#: Support-direction perturbations of the cylinder, whose support set is
#: degenerate (a disk or a line) along some directions.
_CYLINDER_PERTURBATIONS = np.array([
    [0.0, 0.0, 0.0],
    [0.25, 0.14, 0.22],
    [-0.25, 0.14, -0.22],
    [0.0, -0.28, 0.11],
])


def _cylinder_perturbations(n_query: int) -> np.ndarray:
    """``(n_query, 3)`` perturbations: the table, extended past its length
    by a golden-angle spiral with alternating z."""
    if n_query <= len(_CYLINDER_PERTURBATIONS):
        return _CYLINDER_PERTURBATIONS[:n_query]
    ii = np.arange(n_query - len(_CYLINDER_PERTURBATIONS))
    ang = 2.399963229728653 * ii
    more = np.stack([0.28 * np.cos(ang), 0.28 * np.sin(ang),
                     0.2 * np.where(ii % 2 == 0, 1.0, -1.0)], axis=-1)
    return np.concatenate([_CYLINDER_PERTURBATIONS, more], axis=0)


def _stable_seed(*parts: str) -> int:
    """Process-independent seed from string identifiers (sha256; Python's
    salted ``hash`` differs between interpreter runs)."""
    digest = hashlib.sha256(
        "/".join(str(part) for part in parts).encode()).digest()
    return int.from_bytes(digest[:4], "little")


# Unit cube corner signs, (8, 3); the order decides witness tie-breaks.
_UNIT_BOX_VERTICES = np.array(
    [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
     for sz in (-1.0, 1.0)])


@dataclasses.dataclass(frozen=True)
class CollisionGeometrySpec:
    """Static description of one collision geometry.

    Attributes:
        geom_type: one of :data:`GEOMETRY_TYPE_ORDER`.
        body: body index the geometry is attached to (-1 = world).
        R_BG: (3, 3) rotation of the geometry frame in the body frame.
        p_BG: (3,) geometry origin in the body frame.
        mu: initial friction coefficient.
        n_query: witness points returned per support query.
        half_lengths_init: box initial half lengths.
        radius_init: sphere / cylinder initial radius.
        half_length_init: cylinder initial half length (axis = geometry z).
        vertices_init: polygon / deep-support initial vertex set rows.
        icnn_depth / icnn_width: deep support function network size.
        icnn_negative_slope: its LeakyReLU negative slope.
        name: geometry name for logging.
    """
    geom_type: str
    body: int
    R_BG: Tuple[Tuple[float, ...], ...]
    p_BG: Tuple[float, ...]
    mu: float
    n_query: int = _POLYGON_DEFAULT_N_QUERY
    half_lengths_init: Optional[Tuple[float, ...]] = None
    radius_init: Optional[float] = None
    half_length_init: Optional[float] = None
    vertices_init: Optional[Tuple[Tuple[float, ...], ...]] = None
    icnn_depth: int = _DEEP_SUPPORT_DEFAULT_DEPTH
    icnn_width: int = _DEEP_SUPPORT_DEFAULT_WIDTH
    icnn_negative_slope: float = 0.5
    name: str = ""

    @property
    def n_contacts(self) -> int:
        """Contact points this geometry contributes against a plane."""
        if self.geom_type == "sphere":
            return 1
        if self.geom_type == "plane":
            raise ValueError("plane has no witness points")
        return self.n_query

    def type_rank(self) -> int:
        return GEOMETRY_TYPE_ORDER.index(self.geom_type)


def default_geometry_params(spec: CollisionGeometrySpec,
                            dtype=torch.float32, device=None):
    """Initial learnable parameters for a geometry spec: box half
    lengths, sphere radius, cylinder radius and half length, polygon
    vertices, a deep-support ICNN sized to the initial vertex set with
    its support-direction perturbations (``{"icnn": ..., "perturbations":
    (n_query, 3)}``, the first row zero); ``None`` for a plane.

    The ICNN's weights and the perturbations come from ``torch.Generator``
    seeds that hash the spec's name and body, with the JAX package's
    distributions; the values differ from JAX's, whose generator differs.
    """
    def tensor(value):
        return torch.as_tensor(np.asarray(value, dtype=np.float64),
                               dtype=dtype, device=device)

    if spec.geom_type == "plane":
        return None
    if spec.geom_type == "box":
        return {"half_lengths": tensor(spec.half_lengths_init)}
    if spec.geom_type == "sphere":
        return {"radius": tensor(spec.radius_init)}
    if spec.geom_type == "cylinder":
        return {"radius": tensor(spec.radius_init),
                "half_length": tensor(spec.half_length_init)}
    if spec.geom_type == "polygon":
        return {"vertices": tensor(spec.vertices_init)}
    if spec.geom_type == "deep_support_convex":
        vertices = np.asarray(spec.vertices_init)
        length_scale = float(
            np.linalg.norm(vertices.max(axis=0) - vertices.min(axis=0)) / 2)
        net = icnn.init_homogeneous_icnn(
            torch.Generator().manual_seed(
                _stable_seed(spec.name, spec.body, "icnn")),
            spec.icnn_depth, spec.icnn_width,
            negative_slope=spec.icnn_negative_slope, scale=length_scale,
            dtype=dtype, device=device)
        draw = torch.rand((spec.n_query - 1, 3), dtype=torch.float64,
                          generator=torch.Generator().manual_seed(
                              _stable_seed(spec.name, spec.body, "pert")))
        perturbations = torch.cat((
            torch.zeros((1, 3), dtype=torch.float64),
            _DEEP_SUPPORT_PERTURBATION * (draw - 0.5)))
        return {"icnn": net,
                "perturbations": perturbations.to(dtype=dtype, device=device)}
    raise ValueError(f"unknown geometry type {spec.geom_type}")


# -- support queries ------------------------------------------------------------
def geometry_scalars(spec: CollisionGeometrySpec, params) -> dict:
    """Logging scalars of a geometry (reference ``geometry.py:245-252,
    405-412, 454-456``)."""
    axes = ["x", "y", "z"]

    def host(value) -> np.ndarray:
        return torch.as_tensor(value).detach().cpu().double().numpy()

    if spec.geom_type == "box":
        half = np.abs(host(params["half_lengths"])).reshape(-1)
        return {f"len_{a}": 2.0 * float(v) for a, v in zip(axes, half)}
    if spec.geom_type == "sphere":
        return {"radius": float(np.abs(host(params["radius"])))}
    if spec.geom_type == "cylinder":
        return {"radius": float(np.abs(host(params["radius"]))),
                "length": 2.0 * float(np.abs(host(params["half_length"])))}
    if spec.geom_type == "polygon":
        vertices = host(params["vertices"])
        out = {}
        for axis_i, axis in enumerate(axes):
            for v_i in range(vertices.shape[0]):
                out[f"v{v_i}_{axis}"] = float(vertices[v_i, axis_i])
        return out
    return {}


def _unit(directions: Tensor) -> Tensor:
    return directions / torch.linalg.norm(directions, dim=-1, keepdim=True)


def get_vertices(spec: CollisionGeometrySpec, params) -> Tensor:
    """Vertex set ``(V, 3)`` of a box (``|half_lengths|`` times the unit
    cube's corners) or a polygon."""
    if spec.geom_type == "box":
        half = torch.abs(params["half_lengths"]).reshape(1, 3)
        return torch.as_tensor(_UNIT_BOX_VERTICES, dtype=half.dtype,
                               device=half.device) * half
    if spec.geom_type == "polygon":
        return params["vertices"]
    raise ValueError(f"no vertex set for {spec.geom_type}")


def support_function(spec: CollisionGeometrySpec, params,
                     direction: Tensor) -> Tensor:
    """Support value ``h(d) = max_{s in S} s . d``: ``(*, 3) -> (*)``.
    A polytope's maximum splits its gradient evenly among tied vertices
    (``torch.amax``), as ``jnp.max`` does. At an axial direction the
    cylinder's gradient takes ``|d_xy|``'s subgradient 0, where JAX's
    norm gives NaN."""
    if spec.geom_type in ("box", "polygon"):
        return torch.amax(direction @ get_vertices(spec, params).T, dim=-1)
    if spec.geom_type == "sphere":
        return torch.abs(params["radius"]).expand(direction.shape[:-1])
    if spec.geom_type == "cylinder":
        # |d_z| with JAX's derivative 1 at 0 (torch.abs has 0 there).
        d_z = direction[..., 2]
        return (torch.abs(params["radius"]) *
                torch.linalg.norm(direction[..., :2], dim=-1) +
                torch.abs(params["half_length"]) *
                torch.where(d_z >= 0, d_z, -d_z))
    if spec.geom_type == "deep_support_convex":
        return icnn.icnn_value(params["icnn"], direction,
                               spec.icnn_negative_slope)
    raise ValueError(f"no support function for {spec.geom_type}")


def _cylinder_support_point(params, direction: Tensor) -> Tensor:
    """Support point of a z-axis cylinder, ``(*, 3) -> (*, 3)``, safe at
    axial and radial directions."""
    d_xy = direction[..., :2]
    s = torch.sqrt(torch.clamp(torch.sum(d_xy * d_xy, dim=-1,
                                         keepdim=True), min=1e-18))
    return torch.cat((torch.abs(params["radius"]) * (d_xy / s),
                      torch.abs(params["half_length"]) *
                      torch.sign(direction[..., 2:])), dim=-1)


def _icnn_points(spec: CollisionGeometrySpec, params,
                 directions: Tensor) -> Tensor:
    """ICNN support points of ``(*, 3)`` directions."""
    return icnn.icnn_support_points(
        params["icnn"], directions.reshape(-1, 3),
        spec.icnn_negative_slope).reshape(directions.shape)


def support_points(spec: CollisionGeometrySpec, params,
                   direction: Tensor) -> Tensor:
    """Witness points ``(*, n_contacts, 3)`` of a support direction
    ``(*, 3)`` in the geometry's frame, whose hull contains the argmax
    set."""
    if spec.geom_type in ("box", "polygon"):
        vertices = get_vertices(spec, params)
        dots = direction @ vertices.T                         # (*, V)
        order = torch.sort(dots, dim=-1, descending=True, stable=True)
        return vertices[order.indices[..., :spec.n_query]]
    if spec.geom_type == "sphere":
        return (direction * torch.abs(params["radius"]))[..., None, :]
    if spec.geom_type == "cylinder":
        perturbed = _unit(direction[..., None, :] + torch.as_tensor(
            _cylinder_perturbations(spec.n_query), dtype=direction.dtype,
            device=direction.device))
        return _cylinder_support_point(params, perturbed)
    if spec.geom_type == "deep_support_convex":
        perturbed = _unit(direction[..., None, :] + params["perturbations"])
        return _icnn_points(spec, params, perturbed)
    raise ValueError(f"no support points for {spec.geom_type}")


def icnn_or_support_point(spec: CollisionGeometrySpec, params,
                          direction: Tensor) -> Tensor:
    """One differentiable support point ``(*, 3)`` of a direction: a
    polytope's first vertex of largest support value (``argmax``)."""
    if spec.geom_type == "deep_support_convex":
        return _icnn_points(spec, params, direction)
    if spec.geom_type in ("box", "polygon"):
        vertices = get_vertices(spec, params)
        return vertices[torch.argmax(direction @ vertices.T, dim=-1)]
    if spec.geom_type == "sphere":
        return direction * torch.abs(params["radius"])
    if spec.geom_type == "cylinder":
        return _cylinder_support_point(params, direction)
    raise ValueError(spec.geom_type)


# -- collision --------------------------------------------------------------------
def collide_plane_convex(spec_b: CollisionGeometrySpec, params_b,
                         R_AB: Tensor, p_AoBo_A: Tensor):
    """The z = 0 plane of frame A against convex B: witness points are B's
    support points along A's -z, ``phi`` their A-frame height, and the
    contact frame A's axes.

    Returns:
        phi ``(*, n_c)``, R_AC ``(*, n_c, 3, 3)``, p_AoAc_A ``(*, n_c, 3)``
        (on the plane), p_BoBc_B ``(*, n_c, 3)`` (B frame).
    """
    p_BoBc_B = support_points(spec_b, params_b, -R_AB[..., 2, :])
    p_AoBc_A = p_BoBc_B @ R_AB.transpose(-1, -2) + p_AoBo_A[..., None, :]
    phi = p_AoBc_A[..., 2]
    p_AoAc_A = torch.cat((p_AoBc_A[..., :2], torch.zeros_like(
        p_AoBc_A[..., 2:])), dim=-1)
    eye = torch.eye(3, dtype=R_AB.dtype, device=R_AB.device)
    return phi, eye.expand(phi.shape + (3, 3)), p_AoAc_A, p_BoBc_B


def _detached(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _detached(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(value) for value in tree]
    return tree.detach()


def _contact_direction(spec_a, params_a, spec_b, params_b, R_AB: Tensor,
                       p_AoBo_A: Tensor) -> Tensor:
    """The contact normal in A, ``(*, 3)``: gradient ascent with
    renormalisation on the separation ``-(h_A(d) + h_B(-R_AB^T d) - d .
    p)`` from the center offset, without a gradient."""
    params_a, params_b = _detached(params_a), _detached(params_b)
    R_BA = R_AB.detach().transpose(-1, -2)
    p = p_AoBo_A.detach()
    d = p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True), min=1e-9)
    with torch.enable_grad():
        for _ in range(_MESH_MESH_ITERS):
            d = d.detach().requires_grad_(True)
            d_b = -(R_BA @ d[..., None])[..., 0]
            extent = -(support_function(spec_a, params_a, d) +
                       support_function(spec_b, params_b, d_b) -
                       torch.sum(d * p, dim=-1))
            (g,) = torch.autograd.grad(extent.sum(), d)
            d_new = d + 0.5 * g
            d = d_new / torch.clamp(torch.linalg.norm(d_new, dim=-1,
                                                      keepdim=True), min=1e-9)
    return d.detach()


def collide_convex_convex(spec_a: CollisionGeometrySpec, params_a,
                          spec_b: CollisionGeometrySpec, params_b,
                          R_AB: Tensor, p_AoBo_A: Tensor):
    """Two bounded convex geometries by their support functions, one
    contact; returns as :func:`collide_plane_convex` with ``n_c = 1``.
    The contact direction carries no gradient (the piecewise-constant
    direction model of the reference); the witness points do."""
    direction = _contact_direction(spec_a, params_a, spec_b, params_b,
                                   R_AB, p_AoBo_A)
    R_AC = rotation_matrix_from_one_vector(direction[..., None, :], 2)
    p_AoAc_A = icnn_or_support_point(spec_a, params_a,
                                     direction)[..., None, :]
    d_b = -(R_AB.transpose(-1, -2) @ direction[..., None])[..., 0]
    p_BoBc_B = icnn_or_support_point(spec_b, params_b, d_b)[..., None, :]
    p_BoBc_A = p_BoBc_B @ R_AB.transpose(-1, -2)
    p_AcBc_A = -p_AoAc_A + p_AoBo_A[..., None, :] + p_BoBc_A
    phi = torch.sum(p_AcBc_A * direction[..., None, :], dim=-1)
    return phi, R_AC, p_AoAc_A, p_BoBc_B


def collide(spec_a: CollisionGeometrySpec, params_a,
            spec_b: CollisionGeometrySpec, params_b, R_AB: Tensor,
            p_AoBo_A: Tensor):
    """Dispatch over geometry-pair types; ``spec_a`` must not outrank
    ``spec_b`` in :data:`GEOMETRY_TYPE_ORDER`."""
    if spec_a.type_rank() > spec_b.type_rank():
        raise ValueError("collision pair must be ordered by geometry type")
    if spec_a.geom_type == "plane" and spec_b.geom_type != "plane":
        return collide_plane_convex(spec_b, params_b, R_AB, p_AoBo_A)
    if spec_a.geom_type != "plane" and spec_b.geom_type != "plane":
        return collide_convex_convex(spec_a, params_a, spec_b, params_b,
                                     R_AB, p_AoBo_A)
    raise TypeError(f"unsupported collision pair: {spec_a.geom_type}, "
                    f"{spec_b.geom_type}")


def pair_contact_count(spec_a: CollisionGeometrySpec,
                       spec_b: CollisionGeometrySpec) -> int:
    """Static contact count of a candidate pair."""
    if spec_a.geom_type == "plane":
        return spec_b.n_contacts
    return 1
