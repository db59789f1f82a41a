"""Scene representation: a pytree of SoA arrays.

Re-design of the reference's Scene/Model/Material object graph
(scene.h:13-24, model.h:30-71, material.h:4-9): instead of per-model C++
objects with growable DBuffers, the render-facing scene is one fused,
fixed-shape struct-of-arrays pytree. Every differentiable quantity
(vertices, vertex normals, material emission/albedo/scatter) is a leaf, so
``jax.grad`` through the renderer reaches them for free — the capability the
reference lacks entirely.

Conventions:
- material index 0 is the skybox/background (reference convention,
  app.cpp:99, renderer.cpp:154): rays that miss everything pick up
  ``weight * emission[0]`` and terminate.
- ``face_normal_idx`` rows of -1 select flat shading (face cross-product
  normal); otherwise vertex normals are barycentrically interpolated
  (smooth shading, reference renderer.cpp:124-149).
- empty primitive classes are represented by zero-length leading axes;
  shapes are static so the renderer specializes at trace time.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _f32(x):
    """Host-resident f32 leaf. Scene construction stays in numpy end to end
    (no eager device op per step), so upload happens only at jit boundaries
    (or explicitly via ``device_put_scene``)."""
    return np.asarray(x, np.float32)


def _i32(x):
    return np.asarray(x, np.int32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Materials:
    """(M,) materials: emissive color, albedo, and mirror/diffuse blend.

    ``scatter`` in [0, 1]: 0 = pure diffuse bounce, 1 = pure mirror
    (reference material.h:4-9 and the bounce lerp at renderer.cpp:240-248).
    """

    emission: jnp.ndarray  # (M, 3)
    albedo: jnp.ndarray    # (M, 3)
    scatter: jnp.ndarray   # (M,)

    @property
    def count(self) -> int:
        return self.emission.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TriMesh:
    """A triangle mesh in SoA form (reference ModelData, model.h:13-71)."""

    vertices: jnp.ndarray         # (V, 3) f32 — differentiable
    faces: jnp.ndarray            # (T, 3) i32 vertex indices
    normals: jnp.ndarray          # (N, 3) f32 — differentiable; N >= 1
    face_normal_idx: jnp.ndarray  # (T, 3) i32 into normals, or -1 = flat
    tex_coords: jnp.ndarray       # (C, 2) f32; C >= 1
    face_tex_idx: jnp.ndarray     # (T, 3) i32 into tex_coords, or -1
    material_id: jnp.ndarray      # (T,) i32

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Spheres:
    centers: jnp.ndarray      # (S, 3)
    radii: jnp.ndarray        # (S,)
    material_id: jnp.ndarray  # (S,) i32

    @property
    def count(self) -> int:
        return self.centers.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Planes:
    """Infinite planes: dot(normal, x) = offset (reference plane.h:6-10)."""

    normals: jnp.ndarray      # (P, 3) unit
    offsets: jnp.ndarray      # (P,)
    material_id: jnp.ndarray  # (P,) i32

    @property
    def count(self) -> int:
        return self.normals.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    """The fused render-facing scene (reference Scene, scene.h:13-24).

    ``texture`` (round 5, beyond parity — the reference parses tex
    coords but never samples them, model.h:13-28): an optional (H, W, 3)
    f32 image sampled at the hit's UV (nearest-neighbor, wrap) and
    multiplied into the albedo of triangle hits whose faces carry tex
    coords. Differentiable w.r.t. the texels.
    """

    mesh: TriMesh
    spheres: Spheres
    planes: Planes
    materials: Materials
    texture: jnp.ndarray = None

    # -- derived, differentiable triangle SoA ------------------------------
    def triangle_soa(self) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """(p0, e1, e2) each (T, 3): Möller–Trumbore precomputed form,
        derived from vertices so gradients flow back to them."""
        v = self.mesh.vertices
        f = self.mesh.faces
        p0 = v[f[:, 0]]
        e1 = v[f[:, 1]] - p0
        e2 = v[f[:, 2]] - p0
        return p0, e1, e2

    def params(self) -> "SceneParams":
        """Extract the differentiable-parameter subtree."""
        return SceneParams(
            vertices=self.mesh.vertices,
            normals=self.mesh.normals,
            emission=self.materials.emission,
            albedo=self.materials.albedo,
            scatter=self.materials.scatter,
        )

    def with_params(self, p: "SceneParams") -> "Scene":
        """Rebuild the scene with the given differentiable parameters."""
        return dataclasses.replace(
            self,
            mesh=dataclasses.replace(
                self.mesh, vertices=p.vertices, normals=p.normals
            ),
            materials=Materials(
                emission=p.emission, albedo=p.albedo, scatter=p.scatter
            ),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneParams:
    """The leaves the inverse renderer optimizes (BASELINE.json config 5)."""

    vertices: jnp.ndarray
    normals: jnp.ndarray
    emission: jnp.ndarray
    albedo: jnp.ndarray
    scatter: jnp.ndarray


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def make_materials(rows: Sequence[Tuple]) -> Materials:
    """rows: sequence of (emission_rgb, albedo_rgb, scatter). Row 0 = skybox."""
    em = _f32([r[0] for r in rows])
    al = _f32([r[1] for r in rows])
    sc = _f32([r[2] for r in rows])
    return Materials(emission=em, albedo=al, scatter=sc)


def empty_mesh() -> TriMesh:
    return TriMesh(
        vertices=_f32(np.zeros((0, 3))),
        faces=_i32(np.zeros((0, 3))),
        normals=_f32(np.zeros((1, 3))),
        face_normal_idx=_i32(np.zeros((0, 3))),
        tex_coords=_f32(np.zeros((1, 2))),
        face_tex_idx=_i32(np.zeros((0, 3))),
        material_id=_i32(np.zeros((0,))),
    )


def empty_spheres() -> Spheres:
    return Spheres(
        centers=_f32(np.zeros((0, 3))),
        radii=_f32(np.zeros((0,))),
        material_id=_i32(np.zeros((0,))),
    )


def empty_planes() -> Planes:
    return Planes(
        normals=_f32(np.zeros((0, 3))),
        offsets=_f32(np.zeros((0,))),
        material_id=_i32(np.zeros((0,))),
    )


def merge_meshes(meshes: Sequence[TriMesh]) -> TriMesh:
    """Fuse authored meshes into one triangle soup with shifted indices.

    Replaces the reference's per-model loop in get_intersection_data
    (renderer.cpp:44-85) with a single fused array — one traversal covers
    every model.
    """
    if not meshes:
        return empty_mesh()
    if len(meshes) == 1:
        return meshes[0]
    v_off = n_off = c_off = 0
    verts, faces, norms, fnidx, texs, ftidx, mids = [], [], [], [], [], [], []
    for m in meshes:
        verts.append(np.asarray(m.vertices))
        faces.append(np.asarray(m.faces) + v_off)
        norms.append(np.asarray(m.normals))
        fn = np.asarray(m.face_normal_idx)
        fnidx.append(np.where(fn >= 0, fn + n_off, -1))
        texs.append(np.asarray(m.tex_coords))
        ft = np.asarray(m.face_tex_idx)
        ftidx.append(np.where(ft >= 0, ft + c_off, -1))
        mids.append(np.asarray(m.material_id))
        v_off += m.vertices.shape[0]
        n_off += m.normals.shape[0]
        c_off += m.tex_coords.shape[0]
    return TriMesh(
        vertices=_f32(np.concatenate(verts)),
        faces=_i32(np.concatenate(faces)),
        normals=_f32(np.concatenate(norms)),
        face_normal_idx=_i32(np.concatenate(fnidx)),
        tex_coords=_f32(np.concatenate(texs)),
        face_tex_idx=_i32(np.concatenate(ftidx)),
        material_id=_i32(np.concatenate(mids)),
    )


def device_put_scene(scene: "Scene") -> "Scene":
    """Upload every leaf to the default device once (for render loops that
    pass the scene as a jit argument repeatedly)."""
    return jax.device_put(scene)


def build_scene(
    meshes: Sequence[TriMesh] = (),
    spheres: Optional[Spheres] = None,
    planes: Optional[Planes] = None,
    materials: Optional[Materials] = None,
    texture=None,
) -> Scene:
    if materials is None:
        # Minimal default: black skybox + one grey diffuse material.
        materials = make_materials(
            [((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 0.0),
             ((0.0, 0.0, 0.0), (0.7, 0.7, 0.7), 0.0)]
        )
    return Scene(
        mesh=merge_meshes(list(meshes)),
        spheres=spheres if spheres is not None else empty_spheres(),
        planes=planes if planes is not None else empty_planes(),
        materials=materials,
        texture=None if texture is None else _f32(texture),
    )
