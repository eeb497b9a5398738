r"""Mesh extraction from support functions (host side).

Counterpart of ``dair_pll_tpu/mesh_extraction.py``: sample a grid of
directions on the sphere, evaluate support points, deduplicate,
convex-hull (scipy's qhull) and orient the faces outward; also Wavefront
``.obj`` strings for URDF export and logging. It runs at export and
logging time, not in training, so it is numpy and scipy; a support-point
function of tensors is called on the directions and its result brought to
the host.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
from scipy.spatial import ConvexHull

from dair_pll_tpu_torch.system import MeshSummary

_GRID_STEPS = 8


def _surface_directions() -> np.ndarray:
    """Directions through the surface cells of an 8^3 grid, normalized."""
    lin = np.linspace(-1.0, 1.0, _GRID_STEPS)
    grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    surface = grid[np.abs(grid).max(axis=-1) >= 1.0]
    return surface / np.linalg.norm(surface, axis=-1, keepdims=True)


def extract_outward_normal_hyperplanes(vertices: np.ndarray,
                                       faces: np.ndarray):
    """Outward unit normals ``(F, 3)``, reversed-orientation flags ``(F,)``
    and intercepts ``(F,)`` of the triangle faces of a convex polytope."""
    centroid = vertices.mean(axis=0, keepdims=True)
    v_a = vertices[faces[:, 0]]
    v_b = vertices[faces[:, 1]]
    v_c = vertices[faces[:, 2]]
    normals = np.cross(v_b - v_a, v_c - v_a)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True) + 1e-30
    backwards = np.sum(normals * (v_a - centroid), axis=-1) < 0.0
    normals[backwards] *= -1.0
    extents = np.sum(v_a * normals, axis=-1)
    return normals, backwards, extents


def extract_mesh(support_point_fn: Callable[[np.ndarray], np.ndarray]
                 ) -> MeshSummary:
    """A watertight convex mesh from a support-point function, which maps
    ``(N, 3)`` unit directions (numpy) to ``(N, 3)`` support points (numpy,
    or anything ``np.asarray`` takes)."""
    directions = _surface_directions()
    points = np.asarray(support_point_fn(directions))
    vertices = np.unique(np.round(points, decimals=12), axis=0)
    hull = ConvexHull(vertices)
    faces = np.asarray(hull.simplices, dtype=np.int64)
    _, backwards, _ = extract_outward_normal_hyperplanes(vertices, faces)
    faces[backwards] = faces[backwards][:, ::-1]
    return MeshSummary(vertices=vertices, faces=faces)


def mesh_to_obj(mesh: MeshSummary) -> str:
    """A mesh as a Wavefront ``.obj`` string with per-face normals."""
    normals, _, _ = extract_outward_normal_hyperplanes(
        np.asarray(mesh.vertices), np.asarray(mesh.faces))
    lines = []
    for vertex in np.asarray(mesh.vertices):
        lines.append("v " + " ".join(str(float(c)) for c in vertex))
    lines.append("")
    for normal in normals:
        lines.append("vn " + " ".join(str(float(c)) for c in normal))
    lines.append("")
    for face_index, face in enumerate(np.asarray(mesh.faces)):
        refs = " ".join(f"{int(i) + 1}//{face_index + 1}" for i in face)
        lines.append("f " + refs)
    return "\n".join(lines) + "\n"
