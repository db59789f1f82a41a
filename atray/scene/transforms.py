"""Host-side mesh transforms and bounds.

Capability parity with the reference's model utilities: ``get_AABB``
(model.h:41-61), ``resize_scale`` (model.h:108-121), ``translate_to``
(model.h:136-152). These run once at scene-build time on the host; the
arrays they produce are what the device traces over.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from atray.scene.data import TriMesh, _f32


def get_aabb(mesh: TriMesh) -> Tuple[np.ndarray, np.ndarray]:
    """(min, max) corners over all vertices (reference model.h:41-61)."""
    v = np.asarray(mesh.vertices)
    return v.min(axis=0), v.max(axis=0)


def translate(mesh: TriMesh, offset) -> TriMesh:
    # host numpy: scene authoring stays off the device
    v = np.asarray(mesh.vertices) + np.asarray(offset, np.float32)
    return dataclasses.replace(mesh, vertices=_f32(v))


def translate_to(mesh: TriMesh, position) -> TriMesh:
    """Move the mesh so its AABB center lands on ``position``
    (reference model.h:136-152 recenters by the AABB)."""
    lo, hi = get_aabb(mesh)
    center = (lo + hi) * 0.5
    return translate(mesh, np.asarray(position, np.float32) - center)


def scale(mesh: TriMesh, factor: float) -> TriMesh:
    v = np.asarray(mesh.vertices) * np.float32(factor)
    return dataclasses.replace(mesh, vertices=_f32(v))


def scale_to(mesh: TriMesh, max_extent: float) -> TriMesh:
    """Uniformly scale so the longest AABB edge equals ``max_extent``
    (reference resize_scale, model.h:108-121)."""
    lo, hi = get_aabb(mesh)
    cur = float((hi - lo).max())
    if cur <= 0.0:
        return mesh
    return scale(mesh, max_extent / cur)


def compute_vertex_normals(mesh: TriMesh) -> TriMesh:
    """Area-weighted smooth vertex normals; fills normals/face_normal_idx.

    Gives procedurally generated meshes the smooth-shading path the
    reference only gets from ``vn`` records in the OBJ (renderer.cpp:124-141).
    """
    v = np.asarray(mesh.vertices, np.float64)
    f = np.asarray(mesh.faces)
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    fn = np.cross(e1, e2)  # area-weighted
    acc = np.zeros_like(v)
    for c in range(3):
        np.add.at(acc, f[:, c], fn)
    norm = np.linalg.norm(acc, axis=1, keepdims=True)
    acc = acc / np.maximum(norm, 1e-20)
    return dataclasses.replace(
        mesh,
        normals=_f32(acc.astype(np.float32)),
        face_normal_idx=mesh.faces,
    )
