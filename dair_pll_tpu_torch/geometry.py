r"""Collision geometry specs and their parameters (PyTorch).

Counterpart of the plane, box, polygon and sphere parts of
``dair_pll_tpu/geometry.py``: a static, hashable spec per geometry
(:class:`CollisionGeometrySpec`) and a learnable parameter dictionary per
geometry (``MultibodyParams.geometry``). The fused rollout path collides
them in ``multibody/soa_terms.py``. Not ported yet: the per-sample
collision functions (the vmapped path), deep-support (ICNN) geometry and
convex-vs-convex collision.

Type ordering: ``Plane < Polygon < Box < Cylinder < Sphere <
DeepSupportConvex``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

GEOMETRY_TYPE_ORDER = (
    "plane", "polygon", "box", "cylinder", "sphere",
    "deep_support_convex")

_POLYGON_DEFAULT_N_QUERY = 4
_ICNN_NOT_PORTED = (
    "deep-support (ICNN) geometry is not ported to dair_pll_tpu_torch yet "
    "(ROADMAP.md, Queue 1: 'ICNN geometry'); use box, polygon or sphere "
    "collision geometry, or mesh_representation='polygon'")

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
    vertices; ``None`` for a plane."""
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
        raise NotImplementedError(_ICNN_NOT_PORTED)
    raise ValueError(f"unknown geometry type {spec.geom_type}")
