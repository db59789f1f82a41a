"""Batched intersection math: Möller–Trumbore, sphere, plane, AABB slab.

Everything here is a pure, shape-static, ``jax.jit``-able function over SoA
batches of rays — the batched re-design of the reference's scalar routines:

- triangle:  get_triangle_ray_intersection_culled (reference model.h:75-103)
- sphere:    get_sphere_ray_intersection          (reference sphere.h:12-39)
- plane:     get_plane_ray_intersection           (reference plane.h:12-22)
- AABB slab: check/get_ray_AABB_intersection      (reference aabb.h:29-130)

Conventions:
- rays are (origins (..., 3), dirs (..., 3)); dirs need not be unit length for
  triangles/AABBs, must be unit for sphere/plane ``t`` to be a distance.
- a miss is encoded as ``t = INF`` (the reference uses MAX_FLOAT,
  PL_base_defs.h:72); valid hits satisfy ``t > eps``.
- triangles are SoA (p0, e1, e2): base vertex and two edge vectors, the
  precomputed form of Möller–Trumbore.
"""

from __future__ import annotations

import jax.numpy as jnp

INF = jnp.float32(3.0e38)
# Minimum hit distance: rejects self-intersection of secondary rays
# (the reference uses t > 0 with 'tolerance' checks, model.h:88-101).
T_MIN = jnp.float32(1.0e-4)
_DENOM_EPS = jnp.float32(1.0e-12)


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Row-wise dot product over the trailing axis, keepdims dropped."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def normalize(v: jnp.ndarray, eps: float = 1.0e-20) -> jnp.ndarray:
    """Safe normalize over the trailing axis."""
    return v * jnp.reciprocal(jnp.sqrt(jnp.maximum(dot(v, v), eps)))[..., None]


def reflect(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection of direction ``d`` about normal ``n``.

    Reference: get_reflection (renderer.cpp:4-9).
    """
    return d - 2.0 * dot(d, n)[..., None] * n


# ---------------------------------------------------------------------------
# Triangles: Möller–Trumbore over a (rays x tris) cartesian batch.
# ---------------------------------------------------------------------------

def moller_trumbore(
    orig: jnp.ndarray,   # (..., 3)
    dirn: jnp.ndarray,   # (..., 3)
    p0: jnp.ndarray,     # (..., 3) — broadcast-compatible with orig
    e1: jnp.ndarray,     # (..., 3)
    e2: jnp.ndarray,     # (..., 3)
    backface_cull: bool = True,
):
    """Möller–Trumbore ray-triangle intersection, vectorized.

    Returns (t, u, v, hit_mask); t = INF where ``hit_mask`` is False.
    Capability parity with the reference's culled variant (model.h:75-103):
    backface culling via determinant sign, barycentric + t-range rejection.
    All inputs broadcast: pass orig (R, 1, 3) against p0 (1, T, 3) for an
    (R, T) cartesian test, or aligned (N, 3) rows for paired tests.
    """
    pvec = jnp.cross(dirn, e2)
    det = dot(e1, pvec)
    if backface_cull:
        valid = det > _DENOM_EPS
    else:
        valid = jnp.abs(det) > _DENOM_EPS
    inv_det = jnp.where(valid, 1.0 / jnp.where(valid, det, 1.0), 0.0)
    tvec = orig - p0
    u = dot(tvec, pvec) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = dot(dirn, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = (
        valid
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > T_MIN)
    )
    return jnp.where(hit, t, INF), u, v, hit


def first_triangle_hit(
    orig: jnp.ndarray,        # (R, 3)
    dirn: jnp.ndarray,        # (R, 3)
    tri_p0: jnp.ndarray,      # (T, 3)
    tri_e1: jnp.ndarray,      # (T, 3)
    tri_e2: jnp.ndarray,      # (T, 3)
    backface_cull: bool = True,
):
    """Nearest triangle per ray by brute force over all T triangles.

    The batched equivalent of the reference's ``#else`` brute-force oracle path
    (renderer.cpp:58-81): used for tiny scenes and as the correctness oracle
    for the BVH. Returns (t (R,), u, v, tri_id int32); miss = (INF, 0, 0, -1).
    """
    t, u, v, hit = moller_trumbore(
        orig[:, None, :], dirn[:, None, :],
        tri_p0[None, :, :], tri_e1[None, :, :], tri_e2[None, :, :],
        backface_cull=backface_cull,
    )  # all (R, T)
    tri_id = jnp.argmin(t, axis=1)
    r = jnp.arange(t.shape[0])
    t_best = t[r, tri_id]
    found = t_best < INF
    return (
        t_best,
        u[r, tri_id],
        v[r, tri_id],
        jnp.where(found, tri_id, -1).astype(jnp.int32),
    )


# ---------------------------------------------------------------------------
# Spheres
# ---------------------------------------------------------------------------

def sphere_hits(
    orig: jnp.ndarray,     # (R, 3)
    dirn: jnp.ndarray,     # (R, 3) unit
    centers: jnp.ndarray,  # (S, 3)
    radii: jnp.ndarray,    # (S,)
):
    """Nearest sphere per ray. Returns (t (R,), sphere_id int32).

    Quadratic solve, nearest positive root — capability parity with
    reference sphere.h:12-39 (which assumes unit ray dir so a == 1).
    """
    oc = orig[:, None, :] - centers[None, :, :]          # (R, S, 3)
    b = dot(oc, dirn[:, None, :])                         # (R, S)
    c = dot(oc, oc) - (radii * radii)[None, :]            # (R, S)
    disc = b * b - c
    ok = disc > 0.0
    # where-guard on BOTH sides of the sqrt: sqrt'(0) = inf would turn the
    # zero cotangent of miss lanes into NaN when orig/dirn carry tangents
    # (bounce>=2 rays depend on scene parameters)
    sq = jnp.where(ok, jnp.sqrt(jnp.where(ok, disc, 1.0)), 0.0)
    t0 = -b - sq
    t1 = -b + sq
    t = jnp.where(t0 > T_MIN, t0, t1)
    t = jnp.where(ok & (t > T_MIN), t, INF)
    sid = jnp.argmin(t, axis=1)
    r = jnp.arange(t.shape[0])
    t_best = t[r, sid]
    return t_best, jnp.where(t_best < INF, sid, -1).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Planes
# ---------------------------------------------------------------------------

def plane_hits(
    orig: jnp.ndarray,     # (R, 3)
    dirn: jnp.ndarray,     # (R, 3)
    normals: jnp.ndarray,  # (P, 3) unit
    offsets: jnp.ndarray,  # (P,)  plane: dot(n, x) = offset
):
    """Nearest plane per ray. Returns (t (R,), plane_id int32).

    Reference plane.h:12-22 stores (direction, distance); same encoding here.
    """
    denom = dot(dirn[:, None, :], normals[None, :, :])    # (R, P)
    num = offsets[None, :] - dot(orig[:, None, :], normals[None, :, :])
    ok = jnp.abs(denom) > _DENOM_EPS
    t = jnp.where(ok, num / jnp.where(ok, denom, 1.0), INF)
    t = jnp.where(t > T_MIN, t, INF)
    pid = jnp.argmin(t, axis=1)
    r = jnp.arange(t.shape[0])
    t_best = t[r, pid]
    return t_best, jnp.where(t_best < INF, pid, -1).astype(jnp.int32)


# ---------------------------------------------------------------------------
# AABB slab test
# ---------------------------------------------------------------------------

def aabb_entry_t(
    orig: jnp.ndarray,      # (..., 3)
    inv_dir: jnp.ndarray,   # (..., 3) = 1/dir (inf where dir == 0 is fine)
    box_min: jnp.ndarray,   # (..., 3) broadcastable
    box_max: jnp.ndarray,   # (..., 3)
):
    """Slab test. Returns (t_entry, t_exit, hit_mask).

    ``hit`` is true when the ray segment [0, inf) overlaps the box
    (entry <= exit and exit > 0). A ray starting inside has t_entry < 0;
    callers should clamp with ``max(t_entry, 0)`` for ordering. Reference:
    aabb.h:29-130 (sign-indexed slab test); here the min/max formulation
    handles sign-free and maps to pure elementwise ops.
    """
    t0 = (box_min - orig) * inv_dir
    t1 = (box_max - orig) * inv_dir
    t_near = jnp.minimum(t0, t1)
    t_far = jnp.maximum(t0, t1)
    t_entry = jnp.max(t_near, axis=-1)
    t_exit = jnp.min(t_far, axis=-1)
    hit = (t_entry <= t_exit) & (t_exit > 0.0)
    return t_entry, t_exit, hit


def safe_inv_dir(dirn: jnp.ndarray) -> jnp.ndarray:
    """1/dir with +/-inf for zero components (IEEE semantics keep the slab
    test correct as long as origins are finite)."""
    return jnp.where(
        dirn == 0.0, jnp.copysign(INF, dirn), 1.0 / jnp.where(dirn == 0.0, 1.0, dirn)
    )
