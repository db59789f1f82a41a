"""Procedural test/benchmark meshes.

The reference ships binary OBJ assets (Cube 12 tris, Deer 1,570, Monkey 3,936,
Dragon 139k — BASELINE.md asset ladder). This repo generates its own meshes at
matching triangle counts so tests and benchmarks are self-contained and the
scale ladder is continuously adjustable:

- ``cube()``                     — 12 tris  (Cube tier)
- ``uv_sphere(28, 28)``          — ~1.5k    (Deer tier)
- ``uv_sphere(45, 45)``          — ~4k      (Monkey tier)
- ``dragon_proxy()``             — ~139k    (Dragon tier: a displaced sphere
                                    with sinusoidal "scales", deterministic)

Implementation note: everything here runs in HOST numpy and uploads to the
device exactly once at jit entry; generators never round-trip through jnp
(each eager device op would be its own dispatch).
"""

from __future__ import annotations

import numpy as np

from atray.scene.data import TriMesh, _f32, _i32


def _vertex_normals_np(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals (host math)."""
    v64 = v.astype(np.float64)
    e1 = v64[f[:, 1]] - v64[f[:, 0]]
    e2 = v64[f[:, 2]] - v64[f[:, 0]]
    fn = np.cross(e1, e2)
    acc = np.zeros_like(v64)
    for c in range(3):
        np.add.at(acc, f[:, c], fn)
    norm = np.linalg.norm(acc, axis=1, keepdims=True)
    return (acc / np.maximum(norm, 1e-20)).astype(np.float32)


def _mesh(vertices: np.ndarray, faces: np.ndarray, material: int, smooth: bool) -> TriMesh:
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    t = f.shape[0]
    if smooth:
        normals = _vertex_normals_np(v, f)
        fnidx = f
    else:
        normals = np.zeros((1, 3), np.float32)
        fnidx = np.full((t, 3), -1, np.int32)
    return TriMesh(
        vertices=_f32(v),
        faces=_i32(f),
        normals=_f32(normals),
        face_normal_idx=_i32(fnidx),
        tex_coords=_f32(np.zeros((1, 2), np.float32)),
        face_tex_idx=_i32(np.full((t, 3), -1, np.int32)),
        material_id=_i32(np.full((t,), material, np.int32)),
    )


def _cube_np(size: float):
    h = size * 0.5
    v = np.array(
        [
            [-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],  # z = -h
            [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h],      # z = +h
        ],
        np.float64,
    )
    quads = [
        (4, 5, 6, 7),  # +z
        (1, 0, 3, 2),  # -z
        (5, 1, 2, 6),  # +x
        (0, 4, 7, 3),  # -x
        (3, 7, 6, 2),  # +y
        (0, 1, 5, 4),  # -y
    ]
    f = []
    for a, b, c, d in quads:
        f.append((a, b, c))
        f.append((a, c, d))
    return v, np.array(f)


def cube(size: float = 2.0, material: int = 1, smooth: bool = False) -> TriMesh:
    """Axis-aligned cube centered at origin, 12 triangles with outward
    (counter-clockwise) winding so backface culling keeps exteriors visible."""
    v, f = _cube_np(size)
    return _mesh(v, f, material, smooth)


def quad(
    corner00, corner10, corner11, corner01, material: int = 1
) -> TriMesh:
    """A single two-triangle quad (light panels, walls)."""
    v = np.array([corner00, corner10, corner11, corner01], np.float64)
    f = np.array([(0, 1, 2), (0, 2, 3)])
    return _mesh(v, f, material, smooth=False)


def _uv_sphere_np(rows: int, cols: int, radius: float):
    ii = np.arange(rows + 1, dtype=np.float64)
    jj = np.arange(cols, dtype=np.float64)
    theta = ii / rows * np.pi
    phi = jj / cols * 2.0 * np.pi
    st, ct = np.sin(theta), np.cos(theta)
    sp, cp = np.sin(phi), np.cos(phi)
    x = radius * st[:, None] * cp[None, :]
    y = radius * ct[:, None] * np.ones_like(sp)[None, :]
    z = radius * st[:, None] * sp[None, :]
    v = np.stack([x, y, z], axis=-1).reshape(-1, 3)

    # vectorized face construction (python loops cost minutes at 139k tris)
    ii2 = np.arange(rows)[:, None]
    jj2 = np.arange(cols)[None, :]
    a = ii2 * cols + jj2
    b = ii2 * cols + (jj2 + 1) % cols
    c = (ii2 + 1) * cols + (jj2 + 1) % cols
    d = (ii2 + 1) * cols + jj2
    upper = np.stack([a, b, c], axis=-1)[1:].reshape(-1, 3)          # i > 0
    lower = np.stack([a, c, d], axis=-1)[:-1].reshape(-1, 3)         # i < rows-1
    faces = np.concatenate([upper, lower])  # wound outward (CCW from outside)
    return v, faces


def uv_sphere(
    rows: int = 32,
    cols: int = 32,
    radius: float = 1.0,
    material: int = 1,
    smooth: bool = True,
) -> TriMesh:
    """Latitude-longitude sphere: 2*rows*cols - 2*cols triangles."""
    v, f = _uv_sphere_np(rows, cols, radius)
    return _mesh(v, f, material, smooth)


def dragon_proxy(
    target_tris: int = 139_000,
    material: int = 1,
    seed: int = 7,
    smooth: bool = True,
) -> TriMesh:
    """Dragon-tier benchmark mesh: ~``target_tris`` triangles.

    A unit sphere displaced by deterministic multi-frequency sinusoidal noise
    — produces an irregular, high-curvature surface whose BVH has realistic
    depth/overlap characteristics (unlike a plain sphere, whose boxes are
    near-disjoint). Stands in for the reference's Dragon.obj (139k faces,
    README.md:19), which is a missing large blob in the snapshot.
    """
    # 2*r*c - 2*c tris ~= target with r == c  ->  r ~ sqrt(target/2) + 1
    n = int(np.sqrt(target_tris / 2.0)) + 1
    v, f = _uv_sphere_np(n, n, 1.0)
    rng = np.random.default_rng(seed)
    disp = np.zeros(v.shape[0])
    for freq in (3.0, 7.0, 13.0, 29.0):
        k = rng.normal(size=(3, 3)) * freq
        ph = rng.uniform(0, 2 * np.pi, size=3)
        amp = 0.35 / freq
        disp = disp + amp * np.sin(v @ k.T + ph).sum(axis=1)
    v = v * (1.0 + disp)[:, None]
    return _mesh(v, f, material, smooth)
