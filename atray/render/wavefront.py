"""Wavefront path tracer: the forward pass.

Re-design of the reference's per-pixel recursive/iterative ``cast_ray``
(renderer.cpp:213-262) and tile scheduler (renderer.cpp:264-471): instead of
8 CPU threads pulling tiles off an atomic queue, ALL rays advance together
through a ``lax.scan`` over bounces — intersect, resolve, shade, respawn —
with masking for terminated paths. Tiling/sharding happens a level up by
slicing the flat ray axis over the device mesh; ``render`` drives both the
single-device and the shard_map path through the SAME trace function.

PRNG discipline (SURVEY.md §7 hard part 5): every random number is a pure
function of (key, global ray id, bounce) — never of the mesh layout, the
chunk split, or any per-thread state (the reference seeds per-thread PCG
streams from ``rdtsc * tid``, pl_utils_win32.cpp:10-15 — the anti-pattern).
Sharded, chunked, and compacted runs are bit-identical to the single-device
whole-frame run.

Differentiation seam (the architecture's key decision): the *discrete* part
of intersection (which primitive is nearest) is non-differentiable — brute
force, or the per-ray BVH hit kernel (kernels/bvh_hit.py). The *continuous*
part (t, barycentrics, normal, material constants recomputed from the chosen
primitive id with one row gather of ``build_face_table``) is differentiable
w.r.t. vertices/normals/materials. The kernel's outputs are named
``"hit_shade"``, and the bounce loop's remat policy saves exactly those
names, so the backward pass replays the cheap resolve and shading math from
the saved face ids and never re-runs traversal (path replay). Gradients
follow the detached-visibility convention (no derivative through silhouette
changes), which the CPU oracle (tests/oracle.py) mirrors exactly.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.ad_checkpoint import checkpoint_name

from atray.config import RenderSettings
from atray.core.camera import Camera, camera_rays
from atray.core.intersect import (
    INF,
    dot,
    first_triangle_hit,
    moller_trumbore,
    normalize,
    plane_hits,
    reflect,
    sphere_hits,
)
from atray.scene.data import Scene

# Primitive type codes in hit records (reference IntersectionData.type,
# renderer.cpp:12-25).
PRIM_NONE = 0
PRIM_TRI = 1
PRIM_SPHERE = 2
PRIM_PLANE = 3


class HitIds(NamedTuple):
    """Discrete outcome of a nearest-hit query. ``t`` is carried for
    diagnostics/compaction but is recomputed differentiably by
    ``resolve_hit``."""

    prim_type: jnp.ndarray  # (R,) i32 in {NONE, TRI, SPHERE, PLANE}
    prim_id: jnp.ndarray    # (R,) i32 index within its class (-1 if none)
    t: jnp.ndarray          # (R,) f32 (INF on miss) — non-differentiable


def nearest_hit_ids(
    scene: Scene,
    orig: jnp.ndarray,
    dirn: jnp.ndarray,
    accel=None,
    alive: Optional[jnp.ndarray] = None,
) -> HitIds:
    """Nearest primitive per ray across all classes.

    Equivalent of the reference's get_intersection_data dispatch
    (renderer.cpp:34-107): triangles (brute force here; the per-ray BVH hit
    kernel when ``accel`` is a ``BVH``), then spheres, then planes, keeping
    the global minimum t. ``alive`` (R,) bool lets dead rays skip the
    kernel's walk (they report a triangle miss). Entirely non-differentiable
    by intent (wrapped in stop_gradient).
    """
    scene = jax.tree_util.tree_map(jnp.asarray, scene)
    orig = jax.lax.stop_gradient(orig)
    dirn = jax.lax.stop_gradient(dirn)
    r = orig.shape[0]
    best_t = jnp.full((r,), INF)
    best_type = jnp.zeros((r,), jnp.int32)
    best_id = jnp.full((r,), -1, jnp.int32)

    if scene.mesh.num_faces > 0:
        if accel is not None:
            from atray.accel.bvh import BVH
            from atray.kernels.bvh_hit import first_hit

            if not isinstance(accel, BVH):
                raise TypeError(f"unknown accel type {type(accel)!r}")
            t, tid = first_hit(accel, orig, dirn, alive)
            # the remat policy of trace_radiance saves these, so the
            # backward pass never re-runs the kernel
            t = checkpoint_name(t, "hit_shade")
            tid = checkpoint_name(tid, "hit_shade")
        else:
            p0, e1, e2 = scene.triangle_soa()
            t, _, _, tid = first_triangle_hit(orig, dirn, p0, e1, e2)
        closer = t < best_t
        best_t = jnp.where(closer, t, best_t)
        best_type = jnp.where(closer, PRIM_TRI, best_type)
        best_id = jnp.where(closer, tid, best_id)

    if scene.spheres.count > 0:
        t, sid = sphere_hits(orig, dirn, scene.spheres.centers, scene.spheres.radii)
        closer = t < best_t
        best_t = jnp.where(closer, t, best_t)
        best_type = jnp.where(closer, PRIM_SPHERE, best_type)
        best_id = jnp.where(closer, sid, best_id)

    if scene.planes.count > 0:
        t, pid = plane_hits(orig, dirn, scene.planes.normals, scene.planes.offsets)
        closer = t < best_t
        best_t = jnp.where(closer, t, best_t)
        best_type = jnp.where(closer, PRIM_PLANE, best_type)
        best_id = jnp.where(closer, pid, best_id)

    best_type = jax.lax.stop_gradient(best_type)
    best_id = jax.lax.stop_gradient(best_id)
    best_t = jax.lax.stop_gradient(best_t)
    return HitIds(best_type, best_id, best_t)


def build_face_table(scene: Scene) -> Optional[jnp.ndarray]:
    """(T, 20) packed per-face shading table, built ONCE per trace:
    [p0(3), e1(3), e2(3), n0(3), n1(3), n2(3), material_id, pad]. Faces
    without smooth normals get the flat (geometric) normal in all three
    slots, so per-ray resolution needs no branch. Material id is stored as
    an exact f32 value (ids < 2^24).

    One contiguous (R, 20) row gather per bounce then replaces ~8
    scattered gathers per ray (faces, three vertices, three normals, ids).
    Gradients still flow to vertices and normals through the table
    construction.
    """
    if scene.mesh.num_faces == 0:
        return None
    scene = jax.tree_util.tree_map(jnp.asarray, scene)
    v = scene.mesh.vertices
    f = scene.mesh.faces
    p0 = v[f[:, 0]]
    e1 = v[f[:, 1]] - p0
    e2 = v[f[:, 2]] - p0
    flat_n = normalize(jnp.cross(e1, e2))
    nidx = scene.mesh.face_normal_idx
    has_smooth = (nidx[:, 0] >= 0)[:, None]
    ncl = jnp.clip(nidx, 0, scene.mesh.normals.shape[0] - 1)
    n0 = jnp.where(has_smooth, scene.mesh.normals[ncl[:, 0]], flat_n)
    n1 = jnp.where(has_smooth, scene.mesh.normals[ncl[:, 1]], flat_n)
    n2 = jnp.where(has_smooth, scene.mesh.normals[ncl[:, 2]], flat_n)
    mat = scene.mesh.material_id.astype(jnp.float32)[:, None]
    return jnp.concatenate(
        [p0, e1, e2, n0, n1, n2, mat, jnp.zeros_like(mat)], axis=1
    )  # (T, 20)


def build_face_uv(scene: Scene) -> Optional[jnp.ndarray]:
    """(T, 8) packed per-face texture coordinates:
    [u0, v0, u1, v1, u2, v2, has_uv, pad] — built once per trace, like
    ``build_face_table``. Faces without tex coords get has_uv = 0."""
    if scene.mesh.num_faces == 0:
        return None
    scene = jax.tree_util.tree_map(jnp.asarray, scene)
    ft = scene.mesh.face_tex_idx
    has = (ft[:, 0] >= 0).astype(jnp.float32)[:, None]
    tcl = jnp.clip(ft, 0, scene.mesh.tex_coords.shape[0] - 1)
    tc = scene.mesh.tex_coords
    uv = jnp.concatenate([tc[tcl[:, 0]], tc[tcl[:, 1]], tc[tcl[:, 2]]],
                         axis=1)
    return jnp.concatenate([uv, has, jnp.zeros_like(has)], axis=1)


def _texture_mod_soa(texture, face_table, face_uv, fid, tri_hit,
                     ox, oy, oz, dx, dy, dz):
    """Per-ray albedo modulation planes (tr, tg, tb) from the scene
    texture at the hit's interpolated UV (round 5, beyond parity —
    the reference stores tex coords but never samples them).

    Nearest-neighbor, wrap addressing; rays that are not triangle hits
    or whose face has no tex coords get 1.0. Differentiable w.r.t. the
    TEXELS (one row gather); the discrete texel choice is detached,
    matching the renderer's detached-visibility convention.
    """
    nf = face_table.shape[0]
    fcl = jnp.clip(fid, 0, nf - 1)
    row = face_table[fcl]
    # recompute barycentrics with the same Möller–Trumbore planes the
    # resolve path uses (cheap elementwise; the winning face is fixed)
    p0x, p0y, p0z = row[:, 0], row[:, 1], row[:, 2]
    e1x, e1y, e1z = row[:, 3], row[:, 4], row[:, 5]
    e2x, e2y, e2z = row[:, 6], row[:, 7], row[:, 8]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = jnp.abs(det) > 1.0e-12
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    w0 = 1.0 - uu - vv
    uvrow = face_uv[fcl]
    ut = w0 * uvrow[:, 0] + uu * uvrow[:, 2] + vv * uvrow[:, 4]
    vt = w0 * uvrow[:, 1] + uu * uvrow[:, 3] + vv * uvrow[:, 5]
    th, tw = texture.shape[0], texture.shape[1]
    # wrap addressing; v = 0 is the image BOTTOM row (OBJ convention)
    ix = jnp.clip((jnp.mod(ut, 1.0) * tw).astype(jnp.int32), 0, tw - 1)
    iy = jnp.clip(((1.0 - jnp.mod(vt, 1.0)) * th).astype(jnp.int32),
                  0, th - 1)
    texel = texture.reshape(-1, 3)[
        jax.lax.stop_gradient(iy * tw + ix)]       # one (R, 3) row gather
    use = tri_hit & (uvrow[:, 6] > 0.5)
    one = jnp.ones_like(ut)
    return (
        jnp.where(use, texel[:, 0], one),
        jnp.where(use, texel[:, 1], one),
        jnp.where(use, texel[:, 2], one),
    )


def resolve_hit(
    scene: Scene,
    orig: jnp.ndarray,
    dirn: jnp.ndarray,
    ids: HitIds,
    face_table: Optional[jnp.ndarray] = None,
):
    """Differentiable recompute of the hit from its discrete ids.

    Returns (t, shading_normal, material_id, hit_mask). The shading normal is
    geometric-flat or smooth-interpolated for triangles (reference
    renderer.cpp:110-149); gradients flow to vertices (via Möller–Trumbore
    partials) and vertex normals. Pass ``face_table`` (build_face_table) to
    replace the 8 scattered gathers with one packed row gather.
    """
    scene = jax.tree_util.tree_map(jnp.asarray, scene)
    r = orig.shape[0]
    t = jnp.full((r,), INF)
    normal = jnp.zeros((r, 3))
    mat = jnp.zeros((r,), jnp.int32)  # 0 = skybox

    is_tri = ids.prim_type == PRIM_TRI
    is_sph = ids.prim_type == PRIM_SPHERE
    is_pln = ids.prim_type == PRIM_PLANE

    if scene.mesh.num_faces > 0:
        fid = jnp.clip(ids.prim_id, 0, scene.mesh.num_faces - 1)
        if face_table is None:
            face_table = build_face_table(scene)
        row = face_table[fid]                          # (R, 20): one gather
        p0 = row[:, 0:3]
        e1 = row[:, 3:6]
        e2 = row[:, 6:9]
        n0 = row[:, 9:12]
        n1 = row[:, 12:15]
        n2 = row[:, 15:18]
        tt, u, vv, _ = moller_trumbore(orig, dirn, p0, e1, e2)
        w0 = (1.0 - u - vv)[:, None]
        tri_n = normalize(w0 * n0 + u[:, None] * n1 + vv[:, None] * n2)
        t = jnp.where(is_tri, tt, t)
        normal = jnp.where(is_tri[:, None], tri_n, normal)
        mat = jnp.where(is_tri, row[:, 18].astype(jnp.int32), mat)

    if scene.spheres.count > 0:
        sid = jnp.clip(ids.prim_id, 0, scene.spheres.count - 1)
        c = scene.spheres.centers[sid]
        rad = scene.spheres.radii[sid]
        oc = orig - c
        b = dot(oc, dirn)
        csq = dot(oc, oc) - rad * rad
        disc = b * b - csq
        # sqrt guarded by where on BOTH sides: sqrt'(0) = inf would turn the
        # zero cotangent of clamped (miss) lanes into NaN in reverse mode
        pos = disc > 0.0
        sq = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)
        t0 = -b - sq
        t1 = -b + sq
        ts = jnp.where(t0 > 1e-4, t0, t1)
        sph_n = normalize(orig + ts[:, None] * dirn - c)
        t = jnp.where(is_sph, ts, t)
        normal = jnp.where(is_sph[:, None], sph_n, normal)
        mat = jnp.where(is_sph, scene.spheres.material_id[sid], mat)

    if scene.planes.count > 0:
        pid = jnp.clip(ids.prim_id, 0, scene.planes.count - 1)
        pn = scene.planes.normals[pid]
        po = scene.planes.offsets[pid]
        denom = dot(dirn, pn)
        safe = jnp.where(jnp.abs(denom) > 1e-12, denom, 1.0)
        tp = (po - dot(orig, pn)) / safe
        t = jnp.where(is_pln, tp, t)
        normal = jnp.where(is_pln[:, None], pn, normal)
        mat = jnp.where(is_pln, scene.planes.material_id[pid], mat)

    hit = ids.prim_type != PRIM_NONE
    # Demote lanes whose differentiable recompute missed (t still INF):
    # kernel-vs-recompute epsilon disagreement on grazing hits, or an accel
    # whose baked triangles are stale w.r.t. moved vertices (optimization
    # loops). Keeping them "hit" would put hit_p at o + INF*d and the INF
    # poisons reverse-mode gradients bounces later.
    hit = hit & (t < 1.0e30)
    return t, normal, jnp.where(hit, mat, 0), hit


# ---------------------------------------------------------------------------
# SoA (plane-major) vector helpers.
#
# The wavefront hot loop keeps EVERY per-ray quantity as a flat (R,) f32
# array: components fuse cleanly into XLA's elementwise kernels, and (R, 3)
# exists only at the public API edges (camera rays in, film out, the
# nearest-hit query and hit_override adapters).
# ---------------------------------------------------------------------------



def _norm3(x, y, z, eps: float = 1.0e-20):
    """Component normalize matching core.intersect.normalize's op order."""
    r = jnp.reciprocal(jnp.sqrt(jnp.maximum(x * x + y * y + z * z, eps)))
    return x * r, y * r, z * r


def _bounce_dir_soa(dx, dy, dz, nx, ny, nz, scatter, u0, u1, u2):
    """SoA twin of ``_bounce_dir`` (identical math per component)."""
    rx, ry, rz = _norm3(nx + u0, ny + u1, nz + u2)
    dn = dx * nx + dy * ny + dz * nz
    px = dx - 2.0 * dn * nx
    py = dy - 2.0 * dn * ny
    pz = dz - 2.0 * dn * nz
    return _norm3(
        rx + (px - rx) * scatter,
        ry + (py - ry) * scatter,
        rz + (pz - rz) * scatter,
    )


def _ray_uniform_cols(key, ray_ids, bounce, channels: int = 3):
    """``ray_uniforms`` returning a TUPLE of flat (R,) columns (the SoA hot
    path consumes columns; stacking to (R, channels) happens only in the
    exported ``ray_uniforms``)."""
    kd = jnp.asarray(key).reshape(-1)
    if kd.dtype != jnp.uint32:
        kd = jax.random.key_data(key).reshape(-1)
    s0 = kd[0].astype(jnp.uint32)
    s1 = kd[-1].astype(jnp.uint32)
    gid = ray_ids.astype(jnp.uint32)
    b = jnp.asarray(bounce).astype(jnp.uint32)
    base = _mix32(gid ^ s0)
    hb = _mix32(base + b * jnp.uint32(0x9E3779B9) + s1)
    cols = []
    for c in range(channels):
        hc = _mix32(hb + jnp.uint32((c + 1) * 0x85EBCA77 & 0xFFFFFFFF))
        u = (hc >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(
            1.0 / 16777216.0
        )
        cols.append(u * 2.0 - 1.0)
    return tuple(cols)


def _sphere_hits_soa(ox, oy, oz, dx, dy, dz, centers, radii):
    """Nearest sphere per ray, SoA: static unrolled loop over the (tiny)
    sphere table. Returns (t, sid) with t = INF / sid = -1 on miss.
    Same math as core.intersect.sphere_hits (sphere.h:12-39)."""
    n = ox.shape[0]
    best_t = jnp.full((n,), INF)
    best_id = jnp.full((n,), -1, jnp.int32)
    for p in range(centers.shape[0]):
        ocx = ox - centers[p, 0]
        ocy = oy - centers[p, 1]
        ocz = oz - centers[p, 2]
        b = ocx * dx + ocy * dy + ocz * dz
        csq = ocx * ocx + ocy * ocy + ocz * ocz - radii[p] * radii[p]
        disc = b * b - csq
        pos = disc > 0.0
        sq = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)
        t0 = -b - sq
        t1 = -b + sq
        ts = jnp.where(t0 > 1.0e-4, t0, jnp.where(t1 > 1.0e-4, t1, INF))
        ts = jnp.where(pos, ts, INF)
        closer = ts < best_t
        best_t = jnp.where(closer, ts, best_t)
        best_id = jnp.where(closer, p, best_id)
    return best_t, best_id


def _plane_hits_soa(ox, oy, oz, dx, dy, dz, normals, offsets):
    """Nearest plane per ray, SoA: static unrolled loop over the (tiny)
    plane table. Returns (t, pid). Same math as core.intersect.plane_hits
    (plane.h:12-22): plane is dot(n, x) = offset."""
    n = ox.shape[0]
    best_t = jnp.full((n,), INF)
    best_id = jnp.full((n,), -1, jnp.int32)
    for p in range(normals.shape[0]):
        denom = dx * normals[p, 0] + dy * normals[p, 1] + dz * normals[p, 2]
        num = offsets[p] - (
            ox * normals[p, 0] + oy * normals[p, 1] + oz * normals[p, 2]
        )
        ok = jnp.abs(denom) > 1.0e-12
        tp = num / jnp.where(ok, denom, 1.0)
        tp = jnp.where(ok & (tp > 1.0e-4), tp, INF)
        closer = tp < best_t
        best_t = jnp.where(closer, tp, best_t)
        best_id = jnp.where(closer, p, best_id)
    return best_t, best_id


def resolve_material_comps(scene, mat: jnp.ndarray, hit: jnp.ndarray):
    """SoA material resolve: 7 flat (R,) planes
    (em_r, em_g, em_b, al_r, al_g, al_b, scatter) for per-ray material
    ids via select chains over the tiny material table; miss lanes 0."""
    em = scene.materials.emission
    al = scene.materials.albedo
    sc = scene.materials.scatter
    out = []
    for tab in (em[:, 0], em[:, 1], em[:, 2], al[:, 0], al[:, 1], al[:, 2],
                sc):
        out.append(jnp.where(hit, onehot_rows(mat, tab), 0.0))
    return tuple(out)


def onehot_rows(idx: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """Row pickup from a SMALL table (material constants) by per-ray index.

    k <= 16: a chain of per-row selects — pure elementwise, fuses into the
    surrounding shade arithmetic. Larger tables take a plain row gather.
    Out-of-range ids (-1 on a miss) pick row 0.
    """
    k = table.shape[0]
    if k <= 16:
        out = jnp.broadcast_to(
            table[0], idx.shape + table.shape[1:]
        ).astype(table.dtype)
        for j in range(1, k):
            pick = idx == j
            if table.ndim > 1:
                pick = pick[:, None]
            out = jnp.where(pick, table[j], out)
        return out
    return table[jnp.where((idx >= 0) & (idx < k), idx, 0)]

def resolve_material_rows(scene, mat: jnp.ndarray, hit: jnp.ndarray):
    """(emission, albedo, scatter) rows for per-ray material ids, with
    miss lanes zeroed (the fused kernel's miss sentinel is mat = 0, which
    would otherwise pick up the skybox row)."""
    h1 = hit[:, None]
    em = jnp.where(h1, onehot_rows(mat, scene.materials.emission), 0.0)
    al = jnp.where(h1, onehot_rows(mat, scene.materials.albedo), 0.0)
    sc = jnp.where(
        hit, onehot_rows(mat, scene.materials.scatter[:, None])[:, 0], 0.0
    )
    return em, al, sc


def _static_tri_lights(scene):
    """Face ids of EMISSIVE triangles (area lights for NEE) — a STATIC
    numpy array, or None.

    The light SET must be static (fixed shapes under jit); it is derived
    from the concrete scene at trace time. Under a transformation where
    the emission values are tracers (e.g. optimizing emission itself),
    the set cannot be derived and area lights are skipped — sphere
    lights and the brute-force light transport still work there.
    """
    import numpy as _np

    try:
        em = _np.asarray(scene.materials.emission)
        mid = _np.asarray(scene.mesh.material_id)
    except Exception:
        return None
    if em.size == 0 or mid.size == 0:
        return None
    ids = _np.flatnonzero(em.max(axis=1)[mid] > 0.0)
    return ids.astype(_np.int32) if ids.size else None


def _bounce_dir(
    dirn: jnp.ndarray,
    normal: jnp.ndarray,
    scatter: jnp.ndarray,   # (R,)
    uni: jnp.ndarray,       # (R, 3) uniforms in [-1, 1]
) -> jnp.ndarray:
    """Next-bounce direction: lerp(diffuse_jitter, mirror, scatter).

    Reference renderer.cpp:240-248: ``random_bounce`` = normalize(normal +
    uniform-cube jitter), ``pure_bounce`` = mirror reflection; blend by the
    material's scatter. (Not cosine-importance sampling — capability parity
    with the reference's BRDF model; the oracle shares the convention.)
    """
    random_bounce = normalize(normal + uni)
    pure_bounce = reflect(dirn, normal)
    return normalize(
        random_bounce + (pure_bounce - random_bounce) * scatter[:, None]
    )


def _mix32(x: jnp.ndarray) -> jnp.ndarray:
    """murmur3 fmix32: a full-avalanche 32-bit finalizer (5 ops)."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def ray_uniforms(
    key: jax.Array, ray_ids: jnp.ndarray, bounce, channels: int = 3
) -> jnp.ndarray:
    """(R, channels) uniforms in [-1, 1] — a pure function of
    (key, global ray id, bounce).

    One counter-based stream per (ray, bounce): layout-invariant under
    sharding, chunking, and compaction permutations (the id travels with
    the ray). This replaces the reference's per-thread ``rdtsc * tid``
    PCG seeding (pl_utils_win32.cpp:10-15) with something a distributed
    run can reproduce bit-exactly on any mesh shape.

    The stream is a chain of murmur3 fmix32 finalizers over
    (key, id, bounce, channel) — the same stateless counter-hash family
    as the reference's PCG (PL_math.h:492-541), ~15 elementwise ops per
    ray, fused into the bounce step.
    """
    return jnp.stack(
        _ray_uniform_cols(key, ray_ids, bounce, channels), axis=1
    )


def draw_bounce_uniforms(
    key: jax.Array, bounces: int, num_rays: int, channels: int = 3
) -> jnp.ndarray:
    """(B, R, channels) uniforms in [-1, 1]: row b, ray i =
    ``ray_uniforms(key, i, b)``. 3 channels for plain path tracing; 6 when
    NEE is on.

    Exported so the CPU oracle can consume the exact numbers the device
    path uses (see ``ray_uniforms`` for the stream discipline).
    """
    ids = jnp.arange(num_rays, dtype=jnp.int32)
    return jnp.stack(
        [ray_uniforms(key, ids, b, channels) for b in range(bounces)]
    )



def trace_radiance(
    scene: Scene,
    orig: jnp.ndarray,         # (R, 3)
    dirn: jnp.ndarray,         # (R, 3) unit
    bounce_limit: int,
    key: Optional[jax.Array] = None,
    uniforms: Optional[jnp.ndarray] = None,   # (B, R, 3|6) in [-1, 1]
    accel=None,
    sort_rays: bool = False,
    nee: bool = False,
    return_stats: bool = False,
    ray_ids: Optional[jnp.ndarray] = None,    # (R,) global ids for PRNG
    remat: bool = True,
    hit_override: Optional[Callable] = None,
    occl_override: Optional[Callable] = None,
    tri_light_ids="auto",
):
    """Path-trace each ray to its radiance (R, 3).

    The bounce loop is a real ``lax.scan`` (reference hot loop 3,
    renderer.cpp:222-259): ONE traced/compiled bounce body regardless of
    ``bounce_limit``. ``sort_rays`` runs the camera bounce as its own
    one-step scan and then compacts the wavefront ONCE (``compact_state``)
    before scanning the rest. ``remat`` wraps the scanned body in
    ``jax.checkpoint`` so reverse-mode differentiation stores only the
    per-bounce ray state (O(B·R)) plus the named hit-kernel outputs, and
    replays the resolve/shading inside each bounce — the path-replay
    backward of SURVEY.md §7.

    ``nee=True`` adds next-event estimation: at every live hit one sphere
    light is picked uniformly, a uniform point on it is sampled, and a
    shadow ray adds ``weight * albedo * light_emission * cos * r^2/d^2 *
    n_lights`` when unoccluded; hit emission then only counts on the
    camera bounce (no double counting). Needs 6 uniform channels per
    bounce (3 jitter + light pick + 2 sphere-point).

    Stochastic jitter comes either from ``uniforms`` (explicit, for oracle
    comparison) or is drawn per bounce as ``ray_uniforms(key, ray_ids, b)``
    — both produce identical numbers for the same key, and both are pure
    functions of the GLOBAL ray id, so sharded/chunked/sorted runs match
    the whole-frame run bit-exactly.

    Shading convention (shared with tests/oracle.py):
    - miss -> color += weight * emission[material 0], terminate;
    - hit  -> attenuation = dot(-d, n), but 0 if the normal had to be
      flipped (backface) — reference renderer.cpp:233-238;
      color += weight * emission[m]; weight *= albedo[m] * attenuation.

    ``hit_override`` replaces the TRIANGLE-class nearest-hit query:
    ``(o, d, alive) -> (t, normal, material_id, hit)`` — used by the
    treelet (geometry-sharded) path, dist/treelet.py, whose query is a
    ppermute ring over per-device sub-BVHs (brute-force or kernel-backed).
    Spheres/planes are still merged here (they are replicated — tiny).
    NEE additionally needs ``occl_override(o, d, live) -> t`` (triangle-
    class nearest t of the shadow rays — the treelet path's leaner second
    ring).
    """
    r = orig.shape[0]
    if uniforms is None and key is None:
        raise ValueError("need key or uniforms for stochastic bounces")
    if ray_ids is None:
        ray_ids = jnp.arange(r, dtype=jnp.int32)
    gid0 = ray_ids[0]  # local base: ids are a contiguous block pre-sort

    # scene leaves are host numpy by construction (see scene/data._f32);
    # promote them here so closed-over scenes become on-device constants
    # (a numpy leaf indexed by a traced id would fail)
    scene = jax.tree_util.tree_map(jnp.asarray, scene)

    em = scene.materials.emission
    sky = em[0]

    face_table = build_face_table(scene)
    has_tex = (
        scene.texture is not None
        and scene.mesh.num_faces > 0
        and scene.mesh.face_tex_idx.shape[0] > 0
        and hit_override is None
    )
    face_uv = build_face_uv(scene) if has_tex else None

    # area lights: emissive TRIANGLES join the NEE light set alongside
    # spheres. The light SET must come from a CONCRETE scene; under
    # shard_map the closed-over leaves are tracers, so render() /
    # _trace_chunked detect the lights OUTSIDE the sharded region and pass
    # them in ("auto" = detect here).
    if isinstance(tri_light_ids, str) and tri_light_ids == "auto":
        tl_ids = _static_tri_lights(scene) if nee else None
    else:
        tl_ids = tri_light_ids
    n_tri_lights = 0 if tl_ids is None else int(tl_ids.shape[0])
    nee_active = nee and (scene.spheres.count > 0 or n_tri_lights > 0)
    if hit_override is not None and nee_active and occl_override is None:
        raise NotImplementedError(
            "NEE with hit_override needs an occl_override occlusion query "
            "(the treelet path passes its shadow-ray ppermute ring)"
        )
    nchan = 6 if nee_active else 3

    def _hit_inputs(ox, oy, oz, dx, dy, dz, alive):
        """SoA nearest hit: returns flat (R,) planes
        (t, nx, ny, nz, hit, em_r, em_g, em_b, al_r, al_g, al_b, scat).

        Discrete ids (the hit kernel, whose outputs the remat policy
        saves), then the differentiable resolve from one face-table row
        gather and the material select chains. ``alive`` lets dead rays
        skip traversal.
        """
        if hit_override is not None:
            # (R,3) adapter for the treelet / override contract
            o3 = jnp.stack([ox, oy, oz], axis=1)
            d3 = jnp.stack([dx, dy, dz], axis=1)
            t, n, mat, hit = hit_override(o3, d3, alive)
            mats = resolve_material_comps(scene, mat, hit)
            return _patch_spheres_planes(
                ox, oy, oz, dx, dy, dz, t,
                n[:, 0], n[:, 1], n[:, 2], hit, *mats,
            )

        o3 = jnp.stack([ox, oy, oz], axis=1)
        d3 = jnp.stack([dx, dy, dz], axis=1)
        ids = nearest_hit_ids(scene, o3, d3, accel=accel, alive=alive)
        t, n, mat, hit = resolve_hit(scene, o3, d3, ids,
                                     face_table=face_table)
        mats = resolve_material_comps(scene, mat, hit)
        if has_tex:
            tr_, tg_, tb_ = _texture_mod_soa(
                scene.texture, face_table, face_uv, ids.prim_id,
                (ids.prim_type == PRIM_TRI) & hit,
                ox, oy, oz, dx, dy, dz,
            )
            mats = (mats[0], mats[1], mats[2], mats[3] * tr_,
                    mats[4] * tg_, mats[5] * tb_, mats[6])
        # material 0 on miss still shades as sky via the miss branch;
        # resolve_material_comps zeroes miss lanes
        return (t, n[:, 0], n[:, 1], n[:, 2], hit, *mats)

    def _patch_spheres_planes(ox, oy, oz, dx, dy, dz, t, nx, ny, nz, hit,
                              emr, emg, emb, alr, alg, alb, scat):
        """Merge the (replicated, tiny) sphere/plane classes into a
        triangle-class nearest hit from ``hit_override``. All flat (R,) planes."""
        if scene.spheres.count > 0:
            cen = scene.spheres.centers
            ts, sid = _sphere_hits_soa(
                ox, oy, oz, dx, dy, dz, cen, scene.spheres.radii
            )
            closer = ts < t
            # miss lanes carry ts = INF; zero them before building the
            # hit point or the INF reaches normalize's VJP as a NaN
            # partial (NaN * zero-cotangent still poisons reverse mode)
            ts_safe = jnp.where(ts < 1.0e30, ts, 0.0)
            nsx, nsy, nsz = _norm3(
                ox + ts_safe * dx - onehot_rows(sid, cen[:, 0]),
                oy + ts_safe * dy - onehot_rows(sid, cen[:, 1]),
                oz + ts_safe * dz - onehot_rows(sid, cen[:, 2]),
            )
            mat_s = onehot_rows(
                sid, scene.spheres.material_id.astype(jnp.float32)
            ).astype(jnp.int32)
            t = jnp.where(closer, ts, t)
            nx = jnp.where(closer, nsx, nx)
            ny = jnp.where(closer, nsy, ny)
            nz = jnp.where(closer, nsz, nz)
            ms = resolve_material_comps(scene, mat_s, closer)
            emr = jnp.where(closer, ms[0], emr)
            emg = jnp.where(closer, ms[1], emg)
            emb = jnp.where(closer, ms[2], emb)
            alr = jnp.where(closer, ms[3], alr)
            alg = jnp.where(closer, ms[4], alg)
            alb = jnp.where(closer, ms[5], alb)
            scat = jnp.where(closer, ms[6], scat)
            hit = hit | (closer & (sid >= 0))
        if scene.planes.count > 0:
            pn = scene.planes.normals
            tp, pid = _plane_hits_soa(
                ox, oy, oz, dx, dy, dz, pn, scene.planes.offsets
            )
            closer = tp < t
            mat_p = onehot_rows(
                pid, scene.planes.material_id.astype(jnp.float32)
            ).astype(jnp.int32)
            t = jnp.where(closer, tp, t)
            nx = jnp.where(closer, onehot_rows(pid, pn[:, 0]), nx)
            ny = jnp.where(closer, onehot_rows(pid, pn[:, 1]), ny)
            nz = jnp.where(closer, onehot_rows(pid, pn[:, 2]), nz)
            ms = resolve_material_comps(scene, mat_p, closer)
            emr = jnp.where(closer, ms[0], emr)
            emg = jnp.where(closer, ms[1], emg)
            emb = jnp.where(closer, ms[2], emb)
            alr = jnp.where(closer, ms[3], alr)
            alg = jnp.where(closer, ms[4], alg)
            alb = jnp.where(closer, ms[5], alb)
            scat = jnp.where(closer, ms[6], scat)
            hit = hit | (closer & (pid >= 0))
        return t, nx, ny, nz, hit, emr, emg, emb, alr, alg, alb, scat

    def _merge_light_check(t, ox, oy, oz, dx, dy, dz, dist, lid):
        """Given the triangle-class nearest t of the shadow rays, fold in
        the (replicated) sphere/plane classes and decide occlusion: blocked
        by anything nearer than ``dist`` that is not the picked light."""
        is_light = jnp.zeros_like(lid, dtype=bool)
        if scene.spheres.count > 0:
            ts, sid = _sphere_hits_soa(
                ox, oy, oz, dx, dy, dz,
                scene.spheres.centers, scene.spheres.radii,
            )
            is_light = (ts < t) & (sid == lid)
            t = jnp.minimum(t, ts)
        if scene.planes.count > 0:
            tp, _ = _plane_hits_soa(
                ox, oy, oz, dx, dy, dz,
                scene.planes.normals, scene.planes.offsets,
            )
            is_light = is_light & ~(tp < t)
            t = jnp.minimum(t, tp)
        return (t < dist - 1.0e-3) & (~is_light)

    def _occlusion(ox, oy, oz, dx, dy, dz, dist, lid, live):
        """True where something other than the picked light blocks the
        shadow ray before ``dist``. Purely discrete — all inputs detached
        (visibility carries no gradient by convention)."""
        sg = jax.lax.stop_gradient
        ox, oy, oz = sg(ox), sg(oy), sg(oz)
        dx, dy, dz = sg(dx), sg(dy), sg(dz)
        dist = sg(dist)
        if occl_override is not None:
            # triangle-class nearest t from the caller's query (the treelet
            # path runs a second, leaner ppermute ring for shadow rays)
            o3 = jnp.stack([ox, oy, oz], axis=1)
            d3 = jnp.stack([dx, dy, dz], axis=1)
            return _merge_light_check(
                occl_override(o3, d3, live), ox, oy, oz, dx, dy, dz,
                dist, lid,
            )
        o3 = jnp.stack([ox, oy, oz], axis=1)
        d3 = jnp.stack([dx, dy, dz], axis=1)
        sids = nearest_hit_ids(scene, o3, d3, accel=accel, alive=live)
        is_light = (sids.prim_type == PRIM_SPHERE) & (sids.prim_id == lid)
        return (sids.t < dist - 1.0e-3) & (~is_light)

    def sort_key(ox, oy, oz, dx, dy, dz, alive):
        """Compaction key: dead rays last; live rays grouped SPATIAL-major
        (MORTON-interleaved origin cell, 6 bits/axis over the mesh
        bounds) with the direction octant as tiebreak. Rays that start in
        one region walk one region of the tree, so a kernel block of such
        rays shares its node fetches; Morton order keeps consecutive keys
        spatially adjacent, where a raster order would wrap across the
        scene."""
        def spread3(x):
            # spread up to 10 bits so bit k lands at position 3k
            x = (x | (x << 16)) & 0x030000FF
            x = (x | (x << 8)) & 0x0300F00F
            x = (x | (x << 4)) & 0x030C30C3
            x = (x | (x << 2)) & 0x09249249
            return x

        if scene.mesh.num_vertices > 0:
            v = scene.mesh.vertices
            lo = jnp.min(v, axis=0)
            hi = jnp.max(v, axis=0)
            span = jnp.maximum(hi - lo, 1e-6)

            def cell(c, k):
                q = jnp.clip((c - lo[k]) / span[k], 0.0, 1.0)
                return (q * 63.0).astype(jnp.int32)

            morton = (
                (spread3(cell(ox, 0)) << 2)
                | (spread3(cell(oy, 1)) << 1)
                | spread3(cell(oz, 2))
            )
        else:
            morton = jnp.zeros_like(alive, jnp.int32)

        octd = (
            (dx > 0).astype(jnp.int32) * 4
            + (dy > 0).astype(jnp.int32) * 2
            + (dz > 0).astype(jnp.int32)
        )
        key_ = (morton << 3) | octd
        return jnp.where(alive, key_, jnp.int32(1) << 30)

    def compact_state(state):
        """One-shot ray-queue compaction (SURVEY.md §5.7) at ROW (128-ray)
        granularity: rows are reordered by the min live ``sort_key`` in the
        row, so live rows densify up front grouped by origin cell and
        all-dead rows sink to the tail, where whole kernel blocks end their
        walk at once. Sorting one key per row instead of per ray keeps the
        sort small, and the apply moves contiguous 512-byte rows; within a
        row the post-bounce rays are already neighbours from one film tile.
        Pays ONCE: the state stays compacted for every later bounce
        (survivors are a subset of the live rows).

        Returns ``(state, restore)`` where ``restore(cr, cg, cb)`` undoes
        the permutation via an INVERSE-permutation GATHER rather than a
        scatter; inverting the row permutation is a second small
        argsort."""
        rc = state[-1]
        alive = state[12]
        keys = sort_key(*state[0:6], alive)
        n = keys.shape[0]
        lane = 128
        if n % lane == 0 and n >= 4 * lane:
            rows = n // lane
            rperm = jnp.argsort(
                jnp.min(keys.reshape(rows, lane), axis=1), stable=True
            )
            inv = jnp.argsort(rperm)

            def take(x, p=rperm):
                return x.reshape(rows, lane)[p].reshape(x.shape)

            def restore(cr, cg, cb):
                return take(cr, p=inv), take(cg, p=inv), take(cb, p=inv)
        else:
            # tiny or ragged wavefronts (tests, small shards): per-ray sort
            perm = jnp.argsort(keys, stable=True)
            inv = jnp.argsort(perm)

            def take(x, p=perm):
                return x[p]

            def restore(cr, cg, cb):
                return cr[inv], cg[inv], cb[inv]

        return tuple(take(x) for x in state[:14]) + (rc,), restore

    def bounce_step(state, b):
        """One wavefront bounce, SoA: every per-ray quantity is a flat
        (R,) plane. ``b`` is the traced scan index."""
        (ox, oy, oz, dx, dy, dz, wr, wg, wb, cr, cg, cb,
         alive, gid, rc) = state
        if uniforms is not None:
            uni = uniforms[b][gid - gid0]
            ucols = tuple(uni[:, k] for k in range(nchan))
        else:
            ucols = _ray_uniform_cols(key, gid, b, nchan)
        # total rays actually cast = live paths entering the bounce (the
        # reference's RenderTile.ray_casts counter, renderer.cpp:345,355,
        # 465-468) — here a reduction, not an atomic.
        rc = rc + jnp.sum(alive.astype(jnp.float32))

        (t, nx, ny, nz, hit, emr, emg, emb, alr, alg, alb,
         scat) = _hit_inputs(ox, oy, oz, dx, dy, dz, alive)

        miss_now = alive & ~hit
        cr = cr + jnp.where(miss_now, wr * sky[0], 0.0)
        cg = cg + jnp.where(miss_now, wg * sky[1], 0.0)
        cb = cb + jnp.where(miss_now, wb * sky[2], 0.0)

        live_hit = alive & hit
        cos_in = -(dx * nx + dy * ny + dz * nz)
        backface = cos_in < 0.0
        nxo = jnp.where(backface, -nx, nx)
        nyo = jnp.where(backface, -ny, ny)
        nzo = jnp.where(backface, -nz, nz)
        atten = jnp.where(backface, 0.0, cos_in)

        # Emitters: with NEE their light arrives via shadow rays, so hit
        # emission is only added on the camera bounce (else every light
        # would be counted twice).
        em_gate = live_hit
        if nee_active:
            em_gate = em_gate & (jnp.asarray(b) == 0)
        cr = cr + jnp.where(em_gate, wr * emr, 0.0)
        cg = cg + jnp.where(em_gate, wg * emg, 0.0)
        cb = cb + jnp.where(em_gate, wb * emb, 0.0)

        # t is INF on misses; zero it before use so the untaken where-branch
        # stays finite (INF * 0 -> NaN would poison reverse-mode grads).
        t_safe = jnp.where(hit, t, 0.0)
        hx = ox + t_safe * dx
        hy = oy + t_safe * dy
        hz = oz + t_safe * dz

        if nee_active:
            # --- next-event estimation (shadow rays to the light set:
            # spheres and, round 5, emissive-TRIANGLE area lights) ------
            ns = scene.spheres.count
            NL = ns + n_tri_lights
            u_pick = (ucols[3] + 1.0) * 0.5                  # [0, 1)
            lid = jnp.minimum((u_pick * NL).astype(jnp.int32), NL - 1)
            is_tri_l = lid >= ns

            if ns > 0:
                cen = scene.spheres.centers
                lem_tab = em[scene.spheres.material_id]      # (S, 3) tiny
                slid = jnp.clip(lid, 0, ns - 1)
                lcx = onehot_rows(slid, cen[:, 0])
                lcy = onehot_rows(slid, cen[:, 1])
                lcz = onehot_rows(slid, cen[:, 2])
                lr = onehot_rows(slid, scene.spheres.radii)
                lemr = onehot_rows(slid, lem_tab[:, 0])
                lemg = onehot_rows(slid, lem_tab[:, 1])
                lemb = onehot_rows(slid, lem_tab[:, 2])
                # uniform point on the light sphere from 2 uniforms
                z = ucols[4]                                  # [-1, 1]
                phi = (ucols[5] + 1.0) * jnp.pi               # [0, 2pi)
                s = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
                px = lcx + lr * (s * jnp.cos(phi))
                py = lcy + lr * (s * jnp.sin(phi))
                pz = lcz + lr * z
                occl_lid = slid
            else:
                zero = jnp.zeros_like(hx)
                px = py = pz = zero
                lr = zero
                lemr = lemg = lemb = zero
                occl_lid = jnp.full_like(lid, -1)

            if n_tri_lights > 0:
                # per-light rows from the face table (differentiable:
                # gradients reach the light geometry through NEE)
                rows_l = face_table[jnp.asarray(tl_ids)]     # (nt, 20)
                lmat = rows_l[:, 18].astype(jnp.int32)
                em_l = em[lmat]                              # (nt, 3)
                cr_l = jnp.cross(rows_l[:, 3:6], rows_l[:, 6:9])
                len_l = jnp.sqrt(jnp.maximum(
                    jnp.sum(cr_l * cr_l, axis=1), 1.0e-20))
                nrm_l = cr_l / len_l[:, None]
                area_l = 0.5 * len_l
                tlid = jnp.clip(lid - ns, 0, n_tri_lights - 1)
                # uniform point on the light triangle from 2 uniforms
                r1 = (ucols[4] + 1.0) * 0.5
                r2 = (ucols[5] + 1.0) * 0.5
                su = jnp.sqrt(jnp.maximum(r1, 0.0))
                b1 = su * (1.0 - r2)
                b2 = su * r2

                def lrow(k):
                    return onehot_rows(tlid, rows_l[:, k])

                ptx = lrow(0) + b1 * lrow(3) + b2 * lrow(6)
                pty = lrow(1) + b1 * lrow(4) + b2 * lrow(7)
                ptz = lrow(2) + b1 * lrow(5) + b2 * lrow(8)
                nlx = onehot_rows(tlid, nrm_l[:, 0])
                nly = onehot_rows(tlid, nrm_l[:, 1])
                nlz = onehot_rows(tlid, nrm_l[:, 2])
                area = onehot_rows(tlid, area_l)
                px = jnp.where(is_tri_l, ptx, px)
                py = jnp.where(is_tri_l, pty, py)
                pz = jnp.where(is_tri_l, ptz, pz)
                lemr = jnp.where(is_tri_l, onehot_rows(tlid, em_l[:, 0]),
                                 lemr)
                lemg = jnp.where(is_tri_l, onehot_rows(tlid, em_l[:, 1]),
                                 lemg)
                lemb = jnp.where(is_tri_l, onehot_rows(tlid, em_l[:, 2]),
                                 lemb)
                occl_lid = jnp.where(is_tri_l, -1, occl_lid)

            tx = px - hx
            ty = py - hy
            tz = pz - hz
            dist = jnp.sqrt(
                jnp.maximum(tx * tx + ty * ty + tz * tz, 1.0e-12)
            )
            ldx = tx / dist
            ldy = ty / dist
            ldz = tz / dist
            cos_l = jnp.maximum(nxo * ldx + nyo * ldy + nzo * ldz, 0.0)
            # occlusion: nearest hit along the shadow ray closer than the
            # light sample point (minus eps to ignore the light's own
            # surface — for an area light the sample point lies ON the
            # face, so its own hit lands at ~dist and the eps excludes
            # it); dead lanes get parked rays
            sox = jnp.where(live_hit, hx, 1.0e7)
            soy = jnp.where(live_hit, hy, 1.0e7)
            soz = jnp.where(live_hit, hz, 1.0e7)
            sdx = jnp.where(live_hit, ldx, 0.0)
            sdy = jnp.where(live_hit, ldy, 0.0)
            sdz = jnp.where(live_hit, ldz, 1.0)
            occluded = _occlusion(
                sox, soy, soz, sdx, sdy, sdz, dist, occl_lid, live_hit,
            )
            geom = (lr * lr) / jnp.maximum(dist * dist, lr * lr)
            gain = cos_l * geom * NL
            if n_tri_lights > 0:
                # area-light geometric term: receiver cosine x |light
                # cosine| (two-sided emitter) x area / squared distance
                cos_lt = jnp.abs(nlx * ldx + nly * ldy + nlz * ldz)
                gain_t = cos_l * cos_lt * area / jnp.maximum(
                    dist * dist, 1.0e-12) * NL
                gain = jnp.where(is_tri_l, gain_t, gain)
            lit = live_hit & ~occluded
            cr = cr + jnp.where(lit, wr * alr * lemr * gain, 0.0)
            cg = cg + jnp.where(lit, wg * alg * lemg * gain, 0.0)
            cb = cb + jnp.where(lit, wb * alb * lemb * gain, 0.0)

        wr = jnp.where(live_hit, wr * alr * atten, wr)
        wg = jnp.where(live_hit, wg * alg * atten, wg)
        wb = jnp.where(live_hit, wb * alb * atten, wb)

        ndx, ndy, ndz = _bounce_dir_soa(
            dx, dy, dz, nxo, nyo, nzo, scat, ucols[0], ucols[1], ucols[2]
        )
        alive = live_hit
        # park dead rays far outside the scene (finite, inert values for
        # the reverse pass); the alive plane keeps them out of traversal
        ox = jnp.where(alive, hx, 1.0e7)
        oy = jnp.where(alive, hy, 1.0e7)
        oz = jnp.where(alive, hz, 1.0e7)
        dx = jnp.where(alive, ndx, 0.0)
        dy = jnp.where(alive, ndy, 0.0)
        dz = jnp.where(alive, ndz, 1.0)
        return (ox, oy, oz, dx, dy, dz, wr, wg, wb, cr, cg, cb,
                alive, gid, rc)

    ones = jnp.ones((r,))
    zeros = jnp.zeros((r,))
    state = (
        orig[:, 0], orig[:, 1], orig[:, 2],
        dirn[:, 0], dirn[:, 1], dirn[:, 2],
        ones, ones, ones,
        zeros, zeros, zeros,
        jnp.ones((r,), bool),
        ray_ids,
        jnp.float32(0.0),
    )

    def scan_body(carry, b):
        return bounce_step(carry, b), None

    if remat:
        # "save only the named kernel outputs": reverse mode stores the
        # per-bounce hit ids (O(B·R)) and replays the cheap resolve and
        # shading math — the traversal kernel runs ONCE per bounce total,
        # not once forward + once per backward replay
        scan_body = jax.checkpoint(
            scan_body,
            policy=jax.checkpoint_policies.save_only_these_names(
                "hit_shade"
            ),
        )

    start = 0
    restore = None
    if sort_rays and bounce_limit > 1:
        # Run the camera bounce at full wavefront, then compact ONCE: its
        # survivors (and all later bounces' — they are subsets) run dense,
        # origin-grouped blocks. The camera bounce runs as a ONE-iteration
        # scan of the SAME body as the main scan, not inlined: an inlined
        # bounce fuses into its surroundings and can round differently from
        # the identical math inside lax.scan, which would break the
        # "bit-identical to the unsorted render" guarantee. Scan bodies are
        # fusion-isolated, so split scan + exact compaction gathers
        # reproduce the single-scan bits.
        state, _ = jax.lax.scan(scan_body, state, jnp.arange(0, 1))
        start = 1
        state, restore = compact_state(state)
    if bounce_limit > start:
        state, _ = jax.lax.scan(
            scan_body, state, jnp.arange(start, bounce_limit)
        )

    cr, cg, cb = state[9], state[10], state[11]
    rays_cast = state[14]
    if restore is not None:
        cr, cg, cb = restore(cr, cg, cb)
    color = jnp.stack([cr, cg, cb], axis=1)
    if return_stats:
        return color, {"rays_cast": rays_cast}
    return color


def _largest_divisor_leq(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def film_tile_shape(width: int, height: int) -> Tuple[int, int]:
    """(tile_h, tile_w) dividing the film, up to 16 x 128 pixels, so
    consecutive rays share a compact 2D frustum — the SPMD analog of the
    reference's square tiles (renderer.cpp:406-411)."""
    return _largest_divisor_leq(height, 16), _largest_divisor_leq(width, 128)


def to_tile_order(x: jnp.ndarray, w: int, h: int, spp: int) -> jnp.ndarray:
    """(spp*h*w, C) sample-major rays -> film-tile-major order.

    Pure reshape/transpose (no gather). Samples of the same tile stay
    adjacent across spp so kernel blocks see a compact pixel footprint.
    """
    th, tw = film_tile_shape(w, h)
    c = x.shape[-1]
    t = x.reshape(spp, h // th, th, w // tw, tw, c)
    return t.transpose(1, 3, 0, 2, 4, 5).reshape(-1, c)


def from_tile_order(x: jnp.ndarray, w: int, h: int, spp: int) -> jnp.ndarray:
    """Inverse of to_tile_order."""
    th, tw = film_tile_shape(w, h)
    c = x.shape[-1]
    t = x.reshape(h // th, w // tw, spp, th, tw, c)
    return t.transpose(2, 0, 3, 1, 4, 5).reshape(-1, c)


def _trace_chunked(
    scene, orig, dirn, ray_ids, settings: RenderSettings, key, accel,
    uniforms=None, progress_cb=None, tri_light_ids="auto",
):
    """Trace a flat ray set, optionally in fixed-size chunks via ``lax.map``
    (ONE traced/compiled chunk body, sequential execution — bounds device
    memory and per-dispatch runtime without re-tracing per chunk).
    Returns (color (N, 3), rays_cast scalar).

    ``progress_cb(live_rays_in_chunk)`` is invoked from the device ONCE
    PER CHUNK via ``jax.debug.callback`` — the in-flight progress signal
    within a single frame dispatch (the headless analog of the
    reference's tiles-done window-title counter, app.cpp:174-181).
    """
    n = orig.shape[0]
    chunk = settings.ray_chunk
    if not chunk or chunk >= n:
        color, stats = trace_radiance(
            scene, orig, dirn, settings.bounce_limit, key=key,
            uniforms=uniforms, accel=accel, sort_rays=settings.sort_bounces,
            nee=settings.nee, return_stats=True, ray_ids=ray_ids,
            tri_light_ids=tri_light_ids,
        )
        return color, stats["rays_cast"]

    pad = (-n) % chunk
    if pad:
        # parked rays: far origin, +z, their radiance is sliced off
        orig = jnp.concatenate([orig, jnp.full((pad, 3), 1.0e7, orig.dtype)])
        dirn = jnp.concatenate(
            [dirn, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], dirn.dtype), (pad, 1))]
        )
        ray_ids = jnp.concatenate(
            [ray_ids, ray_ids[-1] + 1 + jnp.arange(pad, dtype=ray_ids.dtype)]
        )
    nc = orig.shape[0] // chunk

    if uniforms is not None:
        if pad:
            uniforms = jnp.concatenate(
                [uniforms, jnp.zeros(
                    (uniforms.shape[0], pad, uniforms.shape[2]), uniforms.dtype
                )], axis=1,
            )
        un_c = uniforms.reshape(
            uniforms.shape[0], nc, chunk, uniforms.shape[2]
        ).transpose(1, 0, 2, 3)

        def f(args):
            o, d, ids, un = args
            out = trace_radiance(
                scene, o, d, settings.bounce_limit, key=key, uniforms=un,
                accel=accel, sort_rays=settings.sort_bounces,
                nee=settings.nee, return_stats=True, ray_ids=ids,
                tri_light_ids=tri_light_ids,
            )
            if progress_cb is not None:
                jax.debug.callback(progress_cb, out[1]["rays_cast"])
            return out

        xs = (
            orig.reshape(nc, chunk, 3), dirn.reshape(nc, chunk, 3),
            ray_ids.reshape(nc, chunk), un_c,
        )
    else:

        def f(args):
            o, d, ids = args
            out = trace_radiance(
                scene, o, d, settings.bounce_limit, key=key,
                accel=accel, sort_rays=settings.sort_bounces,
                nee=settings.nee, return_stats=True, ray_ids=ids,
                tri_light_ids=tri_light_ids,
            )
            if progress_cb is not None:
                jax.debug.callback(progress_cb, out[1]["rays_cast"])
            return out

        xs = (
            orig.reshape(nc, chunk, 3), dirn.reshape(nc, chunk, 3),
            ray_ids.reshape(nc, chunk),
        )

    color, stats = jax.lax.map(f, xs)
    return color.reshape(-1, 3)[:n], jnp.sum(stats["rays_cast"])


def render(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    key: jax.Array,
    accel=None,
    uniforms: Optional[jnp.ndarray] = None,
    mesh=None,
    axis_name: str = "rays",
    return_stats: bool = False,
    progress_cb=None,
) -> jnp.ndarray:
    """Full forward render -> linear-RGB film (H, W, 3) in [0, 1].

    Equivalent of the reference's start_render_from_camera + per-tile loops
    (renderer.cpp:294-366): camera-ray generation with optional AA jitter,
    spp averaging, clamp. Output is linear (the reference's sRGB conversion
    is commented out, renderer.cpp:361-362; use film.linear_to_srgb).

    ONE renderer for every execution shape: pass ``mesh`` (a 1-D
    ``jax.sharding.Mesh``) and the SAME trace — NEE, compaction, chunking,
    tile ordering included — runs under ``shard_map`` with the flat ray
    axis sharded over the devices. Because every random number is keyed by
    the global ray id (``ray_uniforms``), the sharded film is bit-identical
    to the single-device film for any mesh shape.

    Rays are traced in film-tile order (coherent blocks for the hit
    kernel) and restored to film order for the average. When
    ``settings.ray_chunk`` > 0, rays go through a ``lax.map`` over
    fixed-size chunks — bounding device memory at ONE trace of the chunk
    body.
    """
    w, h = settings.resolution
    spp = settings.samples_per_pixel
    aa_key, bounce_key = jax.random.split(key)
    orig, dirn = camera_rays(
        camera, w, h, spp,
        key=aa_key if settings.anti_aliasing else None,
        anti_aliasing=settings.anti_aliasing,
    )
    orig = to_tile_order(orig, w, h, spp)
    dirn = to_tile_order(dirn, w, h, spp)
    if uniforms is not None:
        uniforms = jax.vmap(
            lambda u: to_tile_order(u, w, h, spp)
        )(uniforms)

    n = orig.shape[0]
    ray_ids = jnp.arange(n, dtype=jnp.int32)

    rays_cast_per_shard = None
    # detect emissive-triangle lights HERE, where the scene is concrete
    # (under shard_map the closure leaves are tracers and detection
    # would silently disable area lights on the sharded path)
    tl_ids = _static_tri_lights(scene) if settings.nee else None

    if mesh is None:
        color, rays_cast = _trace_chunked(
            scene, orig, dirn, ray_ids, settings, bounce_key, accel,
            uniforms=uniforms, progress_cb=progress_cb,
            tri_light_ids=tl_ids,
        )
    else:
        from jax.sharding import PartitionSpec as P

        n_dev = int(mesh.devices.size)
        pad = (-n) % n_dev
        if pad:
            orig = jnp.concatenate(
                [orig, jnp.full((pad, 3), 1.0e7, orig.dtype)]
            )
            dirn = jnp.concatenate(
                [dirn, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], dirn.dtype),
                                (pad, 1))]
            )
            ray_ids = jnp.concatenate(
                [ray_ids, n + jnp.arange(pad, dtype=jnp.int32)]
            )
            if uniforms is not None:
                uniforms = jnp.concatenate(
                    [uniforms, jnp.zeros(
                        (uniforms.shape[0], pad, uniforms.shape[2]),
                        uniforms.dtype,
                    )], axis=1,
                )

        if uniforms is None:
            in_specs = (P(axis_name), P(axis_name), P(axis_name))
            args = (orig, dirn, ray_ids)
        else:
            in_specs = (P(axis_name), P(axis_name), P(axis_name),
                        P(None, axis_name, None))
            args = (orig, dirn, ray_ids, uniforms)

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=in_specs,
            out_specs=(P(axis_name), P(axis_name)),
            check_vma=False,
        )
        def _run(o, d, ids, un=None):
            c, rc = _trace_chunked(
                scene, o, d, ids, settings, bounce_key, accel,
                uniforms=un, tri_light_ids=tl_ids,
            )
            return c, rc[None]

        color, rc_shards = _run(*args)
        color = color[:n]
        rays_cast = jnp.sum(rc_shards)
        # per-shard live-ray counts: the reference's per-tile ray_casts
        # (renderer.cpp:465-468) summed per device — the load-balance /
        # tail-latency signal for the static sharding (telemetry.py)
        rays_cast_per_shard = rc_shards

    color = from_tile_order(color, w, h, spp)
    film = color.reshape(spp, h, w, 3).mean(axis=0)
    film = jnp.clip(film, 0.0, 1.0)
    if return_stats:
        stats = {"rays_cast": rays_cast}
        if rays_cast_per_shard is not None:
            stats["rays_cast_per_shard"] = rays_cast_per_shard
        return film, stats
    return film
