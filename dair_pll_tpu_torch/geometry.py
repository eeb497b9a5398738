r"""Collision geometry specs and their parameters (PyTorch).

Counterpart of the plane, box, polygon, sphere and deep-support (ICNN)
parts of ``dair_pll_tpu/geometry.py``: a static, hashable spec per
geometry (:class:`CollisionGeometrySpec`) and a learnable parameter
dictionary per geometry (``MultibodyParams.geometry``). The fused path
collides them in ``multibody/soa_terms.py``. Not ported yet: the
per-sample collision functions (the vmapped path) and convex-vs-convex
collision.

Type ordering: ``Plane < Polygon < Box < Cylinder < Sphere <
DeepSupportConvex``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from dair_pll_tpu_torch.ops import icnn

GEOMETRY_TYPE_ORDER = (
    "plane", "polygon", "box", "cylinder", "sphere",
    "deep_support_convex")

_POLYGON_DEFAULT_N_QUERY = 4
_DEEP_SUPPORT_DEFAULT_DEPTH = 2
_DEEP_SUPPORT_DEFAULT_WIDTH = 256
_DEEP_SUPPORT_PERTURBATION = 0.4


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
