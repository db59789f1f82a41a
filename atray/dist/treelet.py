"""Treelet (geometry-sharded) rendering: rays ride a device ring.

SURVEY.md §5.7's documented scale-out for scenes exceeding one device's
memory —
the ring-attention analog. The triangle set is partitioned spatially into
one treelet per device; each device keeps ONLY its treelet resident (like a
KV shard) while the per-device ray block rotates around the ring via
``jax.lax.ppermute`` (§5.8). After ``n_devices`` hops every ray has been
tested against every treelet, carries its global nearest hit + shading
payload (t, interpolated normal, material id), and is back on its home
device, where shading proceeds exactly as in the replicated-scene path
(render/wavefront.py, via its ``hit_override`` seam).

Contrast with the reference: its only scaling axis is image tiles over
shared-memory threads (renderer.cpp:403-455) — geometry is always fully
resident. This module is the axis it lacks: scene-size scaling over
devices with explicit interconnect collectives.

Determinism: the ray payload includes nothing layout-dependent; PRNG stays
keyed by (key, global ray id, bounce), so the treelet render matches the
single-device render to float tolerance (the only reordering is which
treelet is tested first — ties between equal-t hits may break differently).

The per-hop local query is either the brute-force Möller–Trumbore batch
(core/intersect.py) over the treelet's padded record table — the oracle
path — or the per-ray hit kernel over the treelet's own BVH
(``TreeletAccels``). NEE shadow rays ride a second, leaner ring.

Gradients (sharded path replay): pass a ``TreeletParts`` to
``render_treelet`` and the record tables are built IN-GRAPH from the scene
(``treelet_records``), so they are a differentiable function of
vertices/normals/materials. The discrete ring (which face wins) stays
detached — same convention as the replicated ``nearest_hit_ids`` — and the
continuous recompute gathers each home ray's winning record row through a
SECOND, differentiable ppermute ring (``diff_row_pickup``): the row gather
against the resident shard is the sharded analog of the replicated path's
face-table row gather, and its transpose (a scatter-add into the owning
shard) is derived automatically. NOTE on residency: ``TreeletParts`` is
gradient-correct but its parameters stay REPLICATED (the face table is
gathered from the full scene in the global program — only ray-side work
is sharded). For scenes whose geometry must never be resident on one
device, use ``TreeletShards`` (``build_treelet_shards``): the vertex/normal
slices are born P-sharded, each device builds its record table inside
shard_map from its own slices (``shard_records``), and gradients land on
the per-shard copies (``merge_vertex_grads`` reconciles duplicated
boundary vertices).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from atray.accel.bvh import BVH, build_bvh
from atray.config import RenderSettings
from atray.core.camera import Camera, camera_rays
from atray.core.intersect import INF, moller_trumbore, normalize
from atray.kernels.bvh_hit import first_hit
from atray.render.wavefront import (
    build_face_table,
    from_tile_order,
    to_tile_order,
    trace_radiance,
)
from atray.scene.data import Scene, dataclasses as _dc  # noqa: F401


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TreeletGeom:
    """Spatially partitioned, padded triangle records.

    ``recs``: (P, Tpad, 20) f32 — per part, rows in face-table layout
    [p0(3), e1(3), e2(3), n0(3), n1(3), n2(3), material_id, global_face_id]
    (wavefront.build_face_table with the pad slot carrying the id). Pad
    rows are all-zero: degenerate edges make the Möller–Trumbore
    determinant 0, so they can never register a hit.
    """

    recs: jnp.ndarray

    @property
    def num_parts(self) -> int:
        return self.recs.shape[0]


def partition_faces(vertices: np.ndarray, faces: np.ndarray, n_parts: int):
    """Balanced spatial partition of faces: sort by centroid along the
    longest axis of the centroid bounding box, split into ``n_parts``
    contiguous chunks (sizes differ by <= 1). Host-side numpy.

    Returns a list of int index arrays (a permutation of arange(T) split
    into parts). Spatial contiguity keeps each treelet's bounding volume
    tight, which is what bounds per-hop work for real scenes.
    """
    t = faces.shape[0]
    if t == 0:
        return [np.zeros((0,), np.int64) for _ in range(n_parts)]
    cent = vertices[faces].mean(axis=1)  # (T, 3)
    spread = cent.max(axis=0) - cent.min(axis=0)
    order = np.argsort(cent[:, int(np.argmax(spread))], kind="stable")
    return np.array_split(order, n_parts)


def build_treelets(scene: Scene, n_parts: int) -> TreeletGeom:
    """Partition the scene's mesh into ``n_parts`` padded record tables."""
    ft = build_face_table(scene)
    if ft is None:
        raise ValueError("treelet sharding needs a non-empty mesh")
    ft = np.array(ft)  # writable copy
    ft[:, 19] = np.arange(ft.shape[0], dtype=np.float32)  # global face id
    parts = partition_faces(
        np.asarray(scene.mesh.vertices), np.asarray(scene.mesh.faces), n_parts
    )
    tpad = max(1, max(len(p) for p in parts))
    recs = np.zeros((n_parts, tpad, 20), np.float32)
    for i, idx in enumerate(parts):
        recs[i, : len(idx)] = ft[idx]
        recs[i, len(idx):, 19] = -1.0
    return TreeletGeom(recs=jnp.asarray(recs))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TreeletParts:
    """Static spatial partition of the face set — the DIFFERENTIABLE
    treelet backend's build product. Only indices live here; the actual
    record tables are rebuilt in-graph from the scene every call
    (``treelet_records``), so gradients flow from rendered pixels back to
    vertices/normals/materials. NOTE: this backend is gradient-correct
    under geometry sharding but its PARAMETERS stay replicated (the scene
    pytree is visible on every device); for true sharded parameter
    residency use ``TreeletShards``/``build_treelet_shards``.

    ``idx``: (P, Tpad) i32 — face indices per part, -1 pad.
    ``owner``: (T,) i32 — owning part per global face id.
    ``lrow``: (T,) i32 — local row of that face in its owner's table.
    (Two O(T) arrays instead of a dense (P, T) ownership map — the map
    has only T non-(-1) entries, so O(P*T) storage would dominate the
    very memory budget this path exists to relieve.)
    """

    idx: jnp.ndarray
    owner: jnp.ndarray
    lrow: jnp.ndarray

    @property
    def num_parts(self) -> int:
        return self.idx.shape[0]


def _check_fid_precision(num_faces: int) -> None:
    """Global face ids ride f32 record slots (col 19) — exact only below
    2^24. Fail loudly instead of silently corrupting ownership lookups."""
    if num_faces >= 2 ** 24:
        raise ValueError(
            f"treelet face ids ride f32 record slots, exact only below "
            f"2^24; scene has {num_faces} faces — carry fid in a separate "
            f"i32 plane before going this large"
        )


def build_treelet_parts(scene: Scene, n_parts: int) -> TreeletParts:
    """Host-side spatial partition (indices only) for the differentiable
    treelet path."""
    _check_fid_precision(int(scene.mesh.num_faces))
    parts = partition_faces(
        np.asarray(scene.mesh.vertices), np.asarray(scene.mesh.faces), n_parts
    )
    t = int(scene.mesh.num_faces)
    tpad = max(1, max(len(p) for p in parts))
    idx = np.full((n_parts, tpad), -1, np.int32)
    owner = np.zeros((max(1, t),), np.int32)
    lrow = np.zeros((max(1, t),), np.int32)
    for i, p in enumerate(parts):
        idx[i, : len(p)] = p
        owner[p] = i
        lrow[p] = np.arange(len(p), dtype=np.int32)
    return TreeletParts(
        idx=jnp.asarray(idx), owner=jnp.asarray(owner), lrow=jnp.asarray(lrow)
    )


def treelet_records(scene: Scene, parts: TreeletParts) -> jnp.ndarray:
    """(P, Tpad, 20) per-part record tables built IN-GRAPH: a jnp gather of
    ``build_face_table(scene)`` rows by the static partition indices, so the
    result is a differentiable function of the scene parameters (the
    backward scatters row cotangents into d(vertices)/d(normals)). Pad
    rows are zero (degenerate — can never hit) with face id -1; real rows
    carry their GLOBAL face id in the pad slot (col 19)."""
    ft = build_face_table(scene)
    if ft is None:
        raise ValueError("treelet sharding needs a non-empty mesh")
    t = ft.shape[0]
    _check_fid_precision(t)
    ft = ft.at[:, 19].set(jnp.arange(t, dtype=jnp.float32))
    safe = jnp.clip(parts.idx, 0, t - 1)
    recs = ft[safe]                                    # (P, Tpad, 20)
    pad = (parts.idx < 0)[:, :, None]
    pad_row = jnp.zeros((20,), jnp.float32).at[19].set(-1.0)
    return jnp.where(pad, pad_row, recs)


def diff_row_pickup(
    recs_local: jnp.ndarray,   # (1, Tpad, 20) — THIS device's record shard
    owner: jnp.ndarray,        # (T,) i32 — owning part per global face id
    lrow: jnp.ndarray,         # (T,) i32 — local row in the owner's table
    fid: jnp.ndarray,          # (R,) i32 global winning face ids (detached)
    n_parts: int,
    axis_name: str = "rays",
) -> jnp.ndarray:
    """DIFFERENTIABLE gather of each home ray's winning record row from
    whichever device owns the face: (fid, row) ride the ring; at each hop
    the resident device fills in rows it owns (``owner[f] == my part``,
    local row ``lrow[f]`` — two O(T) replicated index arrays, not a dense
    (P, T) map). After ``n_parts`` hops every ray is home carrying its
    row. ``ppermute`` and the per-hop shard gather are both linear, so
    reverse-mode derives the exact transpose: row cotangents ride the
    ring back and scatter-add into the owning shard's ``recs`` — the
    sharded face-table gather of the replicated path (resolve_hit). Rays
    with fid < 0 keep a zero row.
    """
    r = fid.shape[0]
    tpad = recs_local.shape[1]
    t = owner.shape[0]
    me = jax.lax.axis_index(axis_name)
    perm = [(i, (i + 1) % n_parts) for i in range(n_parts)]

    def hop(_, st):
        f, row = st
        fc = jnp.clip(f, 0, t - 1)
        own = (f >= 0) & (owner[fc] == me)
        mine = recs_local[0, jnp.clip(lrow[fc], 0, tpad - 1)]
        row = jnp.where(own[:, None], mine, row)
        f = jax.lax.ppermute(f, axis_name, perm)
        row = jax.lax.ppermute(row, axis_name, perm)
        return f, row

    _, row = jax.lax.fori_loop(
        0, n_parts, hop, (fid, jnp.zeros((r, 20), recs_local.dtype))
    )
    return row


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TreeletShards:
    """Geometry parameters BORN SHARDED: per-part local vertex/normal
    slices plus locally-indexed faces. Unlike ``TreeletParts`` (whose
    record tables are gathered in-graph from a REPLICATED scene, so every
    device still holds the full geometry), each device's record table here
    is built inside shard_map from ITS OWN (P-sharded) slices — no device
    ever materializes another part's vertices, in the primal or in the
    cotangent. This is the true beyond-device-memory residency path.

    Differentiable leaves: ``vertices`` (P, Vpad, 3) and ``normals``
    (P, Npad, 3) — optimize these directly. Vertices shared by faces in
    different parts are DUPLICATED across shards; their gradients arrive
    per-copy and ``merge_vertex_grads``/``merge_normal_grads`` scatter-add
    them back to the global arrays (for parity tests or synchronized
    updates).

    Index planes (non-differentiable): ``faces``/``fnidx`` (P, Tpad, 3)
    local vertex/normal indices (fnidx -1 = flat shading), ``matid``/
    ``fid`` (P, Tpad) material + global face ids (-1 pad), ``v_gid``/
    ``n_gid`` (P, Vpad)/(P, Npad) global ids of each local slot (-1 pad),
    ``owner``/``lrow`` (T,) the O(T) ownership maps for the row-pickup
    ring.
    """

    vertices: jnp.ndarray
    normals: jnp.ndarray
    faces: jnp.ndarray
    fnidx: jnp.ndarray
    matid: jnp.ndarray
    fid: jnp.ndarray
    v_gid: jnp.ndarray
    n_gid: jnp.ndarray
    owner: jnp.ndarray
    lrow: jnp.ndarray

    @property
    def num_parts(self) -> int:
        return self.faces.shape[0]


def build_treelet_shards(scene: Scene, n_parts: int) -> TreeletShards:
    """Host-side build of the sharded-residency treelet parameters: spatial
    face partition (``partition_faces``), then per part the referenced
    vertices/normals are sliced out and faces re-indexed locally. All
    tables pad to the max size across parts (static shapes for pjit)."""
    _check_fid_precision(int(scene.mesh.num_faces))
    v = np.asarray(scene.mesh.vertices)
    nrm = np.asarray(scene.mesh.normals)
    f = np.asarray(scene.mesh.faces)
    fn = np.asarray(scene.mesh.face_normal_idx)
    mid = np.asarray(scene.mesh.material_id)
    parts = partition_faces(v, f, n_parts)

    loc = []
    for i, p in enumerate(parts):
        pf = f[p]                                     # (n_i, 3) global vids
        vu, vinv = np.unique(pf, return_inverse=True)
        lf = vinv.reshape(pf.shape).astype(np.int32)
        pfn = fn[p] if fn.size else np.full((len(p), 3), -1, np.int64)
        used = pfn[pfn >= 0]
        nu = np.unique(used) if used.size else np.zeros((0,), np.int64)
        remap = np.full((nrm.shape[0] + 1,), -1, np.int32)
        remap[nu] = np.arange(len(nu), dtype=np.int32)
        lfn = np.where(pfn >= 0, remap[np.clip(pfn, 0, nrm.shape[0])], -1)
        loc.append((p, vu, lf, nu, lfn.astype(np.int32)))

    vpad = max(1, max(len(x[1]) for x in loc))
    npad = max(1, max(len(x[3]) for x in loc))
    tpad = max(1, max(len(x[0]) for x in loc))
    t = int(scene.mesh.num_faces)

    verts = np.zeros((n_parts, vpad, 3), np.float32)
    norms = np.zeros((n_parts, npad, 3), np.float32)
    faces = np.zeros((n_parts, tpad, 3), np.int32)
    fnidx = np.full((n_parts, tpad, 3), -1, np.int32)
    matid = np.zeros((n_parts, tpad), np.int32)
    fid = np.full((n_parts, tpad), -1, np.int32)
    v_gid = np.full((n_parts, vpad), -1, np.int32)
    n_gid = np.full((n_parts, npad), -1, np.int32)
    owner = np.zeros((max(1, t),), np.int32)
    lrow = np.zeros((max(1, t),), np.int32)
    for i, (p, vu, lf, nu, lfn) in enumerate(loc):
        k = len(p)
        verts[i, : len(vu)] = v[vu]
        if len(nu):
            norms[i, : len(nu)] = nrm[nu]
        faces[i, :k] = lf
        fnidx[i, :k] = lfn
        matid[i, :k] = mid[p]
        fid[i, :k] = p
        v_gid[i, : len(vu)] = vu
        n_gid[i, : len(nu)] = nu
        owner[p] = i
        lrow[p] = np.arange(k, dtype=np.int32)
    return TreeletShards(
        vertices=jnp.asarray(verts), normals=jnp.asarray(norms),
        faces=jnp.asarray(faces), fnidx=jnp.asarray(fnidx),
        matid=jnp.asarray(matid), fid=jnp.asarray(fid),
        v_gid=jnp.asarray(v_gid), n_gid=jnp.asarray(n_gid),
        owner=jnp.asarray(owner), lrow=jnp.asarray(lrow),
    )


def shard_records(v, nrm, f, fnidx, matid, fid) -> jnp.ndarray:
    """(Tpad, 20) record table of ONE part, built in-graph from that
    part's LOCAL slices — the per-shard analog of
    ``wavefront.build_face_table`` (same layout, global fid in col 19).
    Differentiable w.r.t. ``v`` and ``nrm``; call inside shard_map so the
    build (and its transpose) touches only the resident shard."""
    p0 = v[f[:, 0]]
    e1 = v[f[:, 1]] - p0
    e2 = v[f[:, 2]] - p0
    flat_n = normalize(jnp.cross(e1, e2))
    has_smooth = (fnidx[:, 0] >= 0)[:, None]
    ncl = jnp.clip(fnidx, 0, nrm.shape[0] - 1)
    n0 = jnp.where(has_smooth, nrm[ncl[:, 0]], flat_n)
    n1 = jnp.where(has_smooth, nrm[ncl[:, 1]], flat_n)
    n2 = jnp.where(has_smooth, nrm[ncl[:, 2]], flat_n)
    recs = jnp.concatenate(
        [p0, e1, e2, n0, n1, n2,
         matid.astype(jnp.float32)[:, None],
         fid.astype(jnp.float32)[:, None]], axis=1,
    )
    pad_row = jnp.zeros((20,), jnp.float32).at[19].set(-1.0)
    return jnp.where((fid < 0)[:, None], pad_row, recs)


def merge_vertex_grads(
    shards: TreeletShards, g_vertices: jnp.ndarray, num_vertices: int
) -> jnp.ndarray:
    """Scatter-add per-copy vertex cotangents (P, Vpad, 3) back to the
    global (V, 3) array — boundary vertices duplicated across parts sum,
    matching the replicated path's gradients exactly."""
    gid = shards.v_gid.reshape(-1)
    w = (gid >= 0).astype(g_vertices.dtype)[:, None]
    flat = g_vertices.reshape(-1, 3) * w
    safe = jnp.clip(gid, 0, max(num_vertices - 1, 0))
    return jnp.zeros((num_vertices, 3), g_vertices.dtype).at[safe].add(flat)


def merge_normal_grads(
    shards: TreeletShards, g_normals: jnp.ndarray, num_normals: int
) -> jnp.ndarray:
    """Normals analog of ``merge_vertex_grads``."""
    gid = shards.n_gid.reshape(-1)
    w = (gid >= 0).astype(g_normals.dtype)[:, None]
    flat = g_normals.reshape(-1, 3) * w
    safe = jnp.clip(gid, 0, max(num_normals - 1, 0))
    return jnp.zeros((num_normals, 3), g_normals.dtype).at[safe].add(flat)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TreeletAccels:
    """Per-treelet BVHs, padded to COMMON static shapes and stacked on a
    leading parts axis so they shard over the device mesh with
    ``P(axis_name)`` — the kernel-backed treelet backend (the brute-force
    ``TreeletGeom`` path is the oracle). ``tri_orig_id`` holds GLOBAL face
    ids, so hit ids are layout-invariant. Pad nodes are never linked and
    pad triangle slots can never hit.
    """

    bvh: BVH   # every array leaf has a leading (P,) parts axis

    @property
    def num_parts(self) -> int:
        return self.bvh.node_min.shape[0]


def build_treelet_accels(scene: Scene, n_parts: int, config=None):
    """Spatially partition the mesh (``partition_faces``) and build one
    skip-link BVH per part, padded to the max node / slot counts across
    parts, with face ids remapped to global indices."""
    from atray.config import KDTreeConfig

    cfg = config or KDTreeConfig()
    v = np.asarray(scene.mesh.vertices)
    faces = np.asarray(scene.mesh.faces)
    if faces.shape[0] < n_parts:
        raise ValueError(
            f"treelet accels need >= {n_parts} faces, got {faces.shape[0]}"
        )
    parts = partition_faces(v, faces, n_parts)
    bvhs = [build_bvh(v, faces[idx], cfg) for idx in parts]
    k = max(b.num_nodes for b in bvhs)
    slots = max(b.tri_orig_id.shape[0] for b in bvhs)
    node_min = np.full((n_parts, k, 3), 3.0e38, np.float32)
    node_max = np.full((n_parts, k, 3), -3.0e38, np.float32)
    node_miss = np.full((n_parts, k), -1, np.int32)
    leaf_start = np.full((n_parts, k), -1, np.int32)
    tri_p0 = np.full((n_parts, slots, 3), 1.0e30, np.float32)
    tri_e1 = np.zeros((n_parts, slots, 3), np.float32)
    tri_e2 = np.zeros((n_parts, slots, 3), np.float32)
    tri_id = np.full((n_parts, slots), -1, np.int32)
    for i, (idx, b) in enumerate(zip(parts, bvhs)):
        nk, ns = b.num_nodes, b.tri_orig_id.shape[0]
        node_min[i, :nk] = np.asarray(b.node_min)
        node_max[i, :nk] = np.asarray(b.node_max)
        node_miss[i, :nk] = np.asarray(b.node_miss)
        leaf_start[i, :nk] = np.asarray(b.leaf_start)
        tri_p0[i, :ns] = np.asarray(b.tri_p0)
        tri_e1[i, :ns] = np.asarray(b.tri_e1)
        tri_e2[i, :ns] = np.asarray(b.tri_e2)
        oid = np.asarray(b.tri_orig_id)
        tri_id[i, :ns] = np.where(oid >= 0, np.asarray(idx)[oid], -1)
    return TreeletAccels(bvh=BVH(
        node_min=node_min, node_max=node_max, node_miss=node_miss,
        leaf_start=leaf_start, tri_p0=tri_p0, tri_e1=tri_e1,
        tri_e2=tri_e2, tri_orig_id=tri_id, leaf_size=int(cfg.leaf_size),
        max_depth=max(b.max_depth for b in bvhs),
    ))


def _replay_row(o, d, row, fid):
    """Continuous hit record of each ray from its winning face-table row:
    (t, normal, material id, hit), with the same Möller–Trumbore recompute
    and normal interpolation as ``wavefront.resolve_hit``. Rays whose
    recompute misses (grazing-hit epsilon disagreement) are demoted to
    misses — keeping them "hit" would poison reverse mode with INF * 0."""
    tt, u, v, _ = moller_trumbore(o, d, row[:, 0:3], row[:, 3:6], row[:, 6:9])
    w0 = (1.0 - u - v)[:, None]
    nrm = normalize(
        w0 * row[:, 9:12] + u[:, None] * row[:, 12:15]
        + v[:, None] * row[:, 15:18]
    )
    mat = jax.lax.stop_gradient(row[:, 18]).astype(jnp.int32)
    hit = (fid >= 0) & (tt < 1.0e30)
    return (
        jnp.where(hit, tt, INF),
        jnp.where(hit[:, None], nrm, 0.0),
        jnp.where(hit, mat, 0),
        hit,
    )


def _local_first_hit(recs: jnp.ndarray, o: jnp.ndarray, d: jnp.ndarray):
    """Nearest hit of each ray against ONE treelet's records.

    Returns (t, n, mat, fid): (R,), (R,3), (R,) i32, (R,) i32 — miss is
    (INF, 0, 0, -1). Brute-force MT batch; the normal is barycentrically
    interpolated from the record's vertex normals (smooth/flat pre-baked,
    reference renderer.cpp:124-149 semantics via build_face_table).
    """
    p0, e1, e2 = recs[:, 0:3], recs[:, 3:6], recs[:, 6:9]
    t, u, v, hit = moller_trumbore(
        o[:, None, :], d[:, None, :], p0[None], e1[None], e2[None]
    )  # (R, T)
    j = jnp.argmin(t, axis=1)
    rr = jnp.arange(t.shape[0])
    t_b = t[rr, j]
    found = t_b < INF
    row = recs[j]  # (R, 20)
    w0 = (1.0 - u[rr, j] - v[rr, j])[:, None]
    n = normalize(
        w0 * row[:, 9:12]
        + u[rr, j][:, None] * row[:, 12:15]
        + v[rr, j][:, None] * row[:, 15:18]
    )
    mat = jnp.where(found, row[:, 18].astype(jnp.int32), 0)
    fid = jnp.where(found, row[:, 19].astype(jnp.int32), -1)
    return t_b, jnp.where(found[:, None], n, 0.0), mat, fid


def _local_min_t(recs: jnp.ndarray, o: jnp.ndarray, d: jnp.ndarray):
    """Nearest-hit distance only (shadow-ray query) vs ONE treelet: (R,).
    Leaner than ``_local_first_hit`` — no normal interpolation, no record
    pickup; occlusion needs just t."""
    p0, e1, e2 = recs[:, 0:3], recs[:, 3:6], recs[:, 6:9]
    t, _, _, _ = moller_trumbore(
        o[:, None, :], d[:, None, :], p0[None], e1[None], e2[None]
    )
    return jnp.min(t, axis=1)


def _local_first_fid(recs: jnp.ndarray, o: jnp.ndarray, d: jnp.ndarray):
    """(t, fid) of the nearest hit vs ONE treelet — the lean discrete
    query for the differentiable path's first pass: no normal
    interpolation, no shading payload (those are replayed differentiably
    from the winning row afterwards)."""
    p0, e1, e2 = recs[:, 0:3], recs[:, 3:6], recs[:, 6:9]
    t, _, _, _ = moller_trumbore(
        o[:, None, :], d[:, None, :], p0[None], e1[None], e2[None]
    )  # (R, T)
    j = jnp.argmin(t, axis=1)
    rr = jnp.arange(t.shape[0])
    t_b = t[rr, j]
    fid = jnp.where(t_b < INF, recs[j, 19].astype(jnp.int32), -1)
    return t_b, fid


def ring_first_fid(
    recs_local: jnp.ndarray,   # (1, Tpad, 20) — THIS device's treelet
    orig: jnp.ndarray,
    dirn: jnp.ndarray,
    n_parts: int,
    axis_name: str = "rays",
):
    """Global (t, fid) via ``n_parts`` ring hops — the fid-only discrete
    ring for the differentiable path. Rotates only (o, d, t, fid): half
    the payload of ``ring_first_hit``, whose interpolated normals and
    material constants the diff path would immediately discard."""
    r = orig.shape[0]
    perm = [(i, (i + 1) % n_parts) for i in range(n_parts)]
    state = (orig, dirn, jnp.full((r,), INF), jnp.full((r,), -1, jnp.int32))

    def hop(_, st):
        o, d, t_b, f_b = st
        t, fid = _local_first_fid(recs_local[0], o, d)
        upd = t < t_b
        st = (o, d, jnp.where(upd, t, t_b), jnp.where(upd, fid, f_b))
        return jax.tree_util.tree_map(
            lambda x: jax.lax.ppermute(x, axis_name, perm), st
        )

    _, _, t_b, f_b = jax.lax.fori_loop(0, n_parts, hop, state)
    return t_b, f_b


def ring_occlusion_t(
    recs_local: jnp.ndarray,   # (1, Tpad, 20) — THIS device's treelet
    orig: jnp.ndarray,         # (R, 3) shadow rays
    dirn: jnp.ndarray,
    n_parts: int,
    axis_name: str = "rays",
):
    """Triangle-class nearest t via ``n_parts`` ring hops (inside
    shard_map) — the shadow-ray companion of ``ring_first_hit``; plugs
    into ``trace_radiance``'s ``occl_override`` seam so NEE works with
    geometry sharding."""
    r = orig.shape[0]
    perm = [(i, (i + 1) % n_parts) for i in range(n_parts)]

    def hop(_, st):
        o, d, t_b = st
        t_b = jnp.minimum(t_b, _local_min_t(recs_local[0], o, d))
        return jax.tree_util.tree_map(
            lambda x: jax.lax.ppermute(x, axis_name, perm), (o, d, t_b)
        )

    _, _, t_b = jax.lax.fori_loop(
        0, n_parts, hop, (orig, dirn, jnp.full((r,), INF))
    )
    return t_b


def ring_first_hit(
    recs_local: jnp.ndarray,   # (1, Tpad, 20) — THIS device's treelet
    orig: jnp.ndarray,         # (R, 3) local ray block
    dirn: jnp.ndarray,
    n_parts: int,
    axis_name: str = "rays",
):
    """Global nearest hit via ``n_parts`` ring hops (call INSIDE shard_map).

    Each hop tests the resident treelet, merges strictly-closer hits into
    the carried best record, then rotates (rays + best) one step around the
    ring; after a full cycle the state is home. Returns
    (t, normal, mat, hit, fid) for the local rays.
    """
    r = orig.shape[0]
    perm = [(i, (i + 1) % n_parts) for i in range(n_parts)]
    state = (
        orig, dirn,
        jnp.full((r,), INF),
        jnp.zeros((r, 3)),
        jnp.zeros((r,), jnp.int32),
        jnp.full((r,), -1, jnp.int32),
    )

    def hop(_, st):
        o, d, t_b, n_b, m_b, f_b = st
        t, n, mat, fid = _local_first_hit(recs_local[0], o, d)
        upd = t < t_b
        st = (
            o, d,
            jnp.where(upd, t, t_b),
            jnp.where(upd[:, None], n, n_b),
            jnp.where(upd, mat, m_b),
            jnp.where(upd, fid, f_b),
        )
        return jax.tree_util.tree_map(
            lambda x: jax.lax.ppermute(x, axis_name, perm), st
        )

    _, _, t_b, n_b, m_b, f_b = jax.lax.fori_loop(0, n_parts, hop, state)
    return t_b, n_b, m_b, f_b >= 0, f_b


def ring_first_hit_accel(
    bvh_local: BVH,            # THIS device's treelet BVH (no parts axis)
    orig: jnp.ndarray,
    dirn: jnp.ndarray,
    alive: jnp.ndarray,        # (R,) bool live mask (rides the ring)
    n_parts: int,
    axis_name: str = "rays",
):
    """Kernel-backed global nearest hit: per hop, the per-ray hit kernel
    (kernels/bvh_hit.py) answers the query against the resident treelet;
    only (t, face id) ride the ring with the rays. The home device
    resolves normal and material from the replicated face table. Returns
    (t, fid) for the home rays after n_parts hops."""
    r = orig.shape[0]
    perm = [(i, (i + 1) % n_parts) for i in range(n_parts)]
    state = (orig, dirn, alive, jnp.full((r,), INF),
             jnp.full((r,), -1, jnp.int32))

    def hop(_, st):
        o, d, a, t_b, f_b = st
        t, fid = first_hit(bvh_local, o, d, a)
        upd = t < t_b
        st = (o, d, a, jnp.where(upd, t, t_b), jnp.where(upd, fid, f_b))
        return jax.tree_util.tree_map(
            lambda x: jax.lax.ppermute(x, axis_name, perm), st
        )

    _, _, _, t_b, f_b = jax.lax.fori_loop(0, n_parts, hop, state)
    return t_b, f_b


def ring_occlusion_t_accel(
    bvh_local: BVH,
    orig: jnp.ndarray,
    dirn: jnp.ndarray,
    live: jnp.ndarray,
    n_parts: int,
    axis_name: str = "rays",
):
    """Shadow-ray companion of ``ring_first_hit_accel``: nearest t only."""
    r = orig.shape[0]
    perm = [(i, (i + 1) % n_parts) for i in range(n_parts)]

    def hop(_, st):
        o, d, a, t_b = st
        t, _ = first_hit(bvh_local, o, d, a)
        return jax.tree_util.tree_map(
            lambda x: jax.lax.ppermute(x, axis_name, perm),
            (o, d, a, jnp.minimum(t_b, t)),
        )

    _, _, _, t_b = jax.lax.fori_loop(
        0, n_parts, hop, (orig, dirn, live, jnp.full((r,), INF))
    )
    return t_b


def render_treelet(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    key: jax.Array,
    mesh: Mesh,
    treelets: Optional[TreeletGeom] = None,
    axis_name: str = "rays",
    return_stats: bool = False,
):
    """Geometry-sharded forward render -> (H, W, 3) film.

    Mirrors ``wavefront.render`` (tile-ordered rays, spp average, clamp)
    but shards the TRIANGLES over the mesh instead of replicating them:
    per-bounce nearest-hit queries run as ppermute rings through
    ``trace_radiance``'s ``hit_override`` seam, so shading, PRNG
    discipline, compaction, and the rays-cast counter are the exact same
    code as the replicated path. Spheres/planes/materials are replicated
    (tiny). ``settings.ray_chunk`` is ignored (ray memory per device is
    already 1/n_devices). NEE runs its shadow rays through a second, leaner
    occlusion ring.

    ``treelets`` selects the local-query backend: a ``TreeletAccels``
    (from ``build_treelet_accels``) runs each hop through the per-ray hit
    kernel over the treelet's BVH — the production path; a ``TreeletGeom`` (or
    None, the default) brute-forces Möller–Trumbore over the treelet's
    records — the oracle path; a ``TreeletParts`` rebuilds the record
    tables in-graph and is DIFFERENTIABLE w.r.t. the scene parameters
    (sharded-parameter path replay — inverse rendering at treelet scale).
    """
    n_dev = int(mesh.devices.size)
    if treelets is None:
        treelets = build_treelets(scene, n_dev)
    if treelets.num_parts != n_dev:
        raise ValueError(
            f"treelets built for {treelets.num_parts} parts, mesh has {n_dev}"
        )
    if isinstance(treelets, TreeletAccels):
        return _render_treelet_accel(
            scene, camera, settings, key, mesh, treelets, axis_name,
            return_stats,
        )
    if isinstance(treelets, TreeletShards):
        return _render_treelet_shards(
            scene, camera, settings, key, mesh, treelets, axis_name,
            return_stats,
        )
    if isinstance(treelets, TreeletParts):
        return _render_treelet_diff(
            scene, camera, settings, key, mesh, treelets, axis_name,
            return_stats,
        )

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
    n = orig.shape[0]
    ray_ids = jnp.arange(n, dtype=jnp.int32)

    pad = (-n) % n_dev
    if pad:
        orig = jnp.concatenate([orig, jnp.full((pad, 3), 1.0e7, orig.dtype)])
        dirn = jnp.concatenate(
            [dirn, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], dirn.dtype), (pad, 1))]
        )
        ray_ids = jnp.concatenate([ray_ids, n + jnp.arange(pad, dtype=jnp.int32)])

    # the sharded scene: triangles ride as the recs shard; the rest of the
    # scene (spheres/planes/materials + an EMPTY mesh) is replicated
    from atray.scene.data import empty_mesh

    lean = dataclasses.replace(scene, mesh=empty_mesh())

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P(axis_name)),
        check_vma=False,
    )
    def _run(o, d, ids, recs):
        def override(o_, d_, alive):
            o_ = jax.lax.stop_gradient(o_)
            d_ = jax.lax.stop_gradient(d_)
            t, nrm, mat, hit, _ = ring_first_hit(
                recs, o_, d_, n_parts=n_dev, axis_name=axis_name
            )
            return t, nrm, mat, hit

        def occl(o_, d_, live):
            return ring_occlusion_t(
                recs, o_, d_, n_parts=n_dev, axis_name=axis_name
            )

        color, stats = trace_radiance(
            lean, o, d, settings.bounce_limit, key=bounce_key,
            sort_rays=settings.sort_bounces, nee=settings.nee,
            return_stats=True, ray_ids=ids, hit_override=override,
            occl_override=occl,
        )
        return color, stats["rays_cast"][None]

    color, rc_shards = _run(orig, dirn, ray_ids, treelets.recs)
    color = color[:n]
    color = from_tile_order(color, w, h, spp)
    film = color.reshape(spp, h, w, 3).mean(axis=0)
    film = jnp.clip(film, 0.0, 1.0)
    if return_stats:
        return film, {
            "rays_cast": jnp.sum(rc_shards),
            "rays_cast_per_shard": rc_shards,
        }
    return film


def _render_treelet_diff(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    key: jax.Array,
    mesh: Mesh,
    parts: TreeletParts,
    axis_name: str,
    return_stats: bool,
):
    """Differentiable variant of ``render_treelet``: the record tables are
    a jnp function of the scene (``treelet_records``), the discrete ring
    answers WHICH face wins (detached), and each ray's continuous
    (t, normal, material) is replayed from its winning row fetched by the
    differentiable ``diff_row_pickup`` ring — so ``jax.grad`` through this
    render reaches vertices/normals/materials that are sharded over the
    device mesh and never resident on any single device."""
    n_dev = int(mesh.devices.size)
    recs = treelet_records(scene, parts)           # in-graph: (P, Tpad, 20)

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
    n = orig.shape[0]
    ray_ids = jnp.arange(n, dtype=jnp.int32)

    pad = (-n) % n_dev
    if pad:
        orig = jnp.concatenate([orig, jnp.full((pad, 3), 1.0e7, orig.dtype)])
        dirn = jnp.concatenate(
            [dirn, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], dirn.dtype),
                            (pad, 1))]
        )
        ray_ids = jnp.concatenate(
            [ray_ids, n + jnp.arange(pad, dtype=jnp.int32)]
        )

    from atray.scene.data import empty_mesh

    lean = dataclasses.replace(scene, mesh=empty_mesh())

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name),
                  P(None), P(None)),
        out_specs=(P(axis_name), P(axis_name)),
        check_vma=False,
    )
    def _run(o, d, ids, recs_l, owner, lrow):
        def override(o_, d_, alive):
            # discrete: which face wins (detached — visibility convention);
            # the fid-only ring rotates half the payload of ring_first_hit
            _, fid = ring_first_fid(
                jax.lax.stop_gradient(recs_l),
                jax.lax.stop_gradient(o_), jax.lax.stop_gradient(d_),
                n_parts=n_dev, axis_name=axis_name,
            )
            fid = jax.lax.stop_gradient(fid)
            # continuous: replay from the winning row (differentiable ring
            # gather — the sharded face-table row pickup)
            row = diff_row_pickup(
                recs_l, owner, lrow, fid, n_parts=n_dev, axis_name=axis_name
            )
            return _replay_row(o_, d_, row, fid)

        def occl(o_, d_, live):
            return ring_occlusion_t(
                jax.lax.stop_gradient(recs_l), o_, d_,
                n_parts=n_dev, axis_name=axis_name,
            )

        color, stats = trace_radiance(
            lean, o, d, settings.bounce_limit, key=bounce_key,
            sort_rays=settings.sort_bounces, nee=settings.nee,
            return_stats=True, ray_ids=ids, hit_override=override,
            occl_override=occl,
        )
        return color, stats["rays_cast"][None]

    color, rc_shards = _run(orig, dirn, ray_ids, recs, parts.owner, parts.lrow)
    color = color[:n]
    color = from_tile_order(color, w, h, spp)
    film = color.reshape(spp, h, w, 3).mean(axis=0)
    film = jnp.clip(film, 0.0, 1.0)
    if return_stats:
        return film, {
            "rays_cast": jnp.sum(rc_shards),
            "rays_cast_per_shard": rc_shards,
        }
    return film


def _render_treelet_shards(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    key: jax.Array,
    mesh: Mesh,
    shards: TreeletShards,
    axis_name: str,
    return_stats: bool,
):
    """Sharded-residency variant of ``render_treelet``: every geometry
    array arrives P-sharded over the mesh and the per-device record table
    is built INSIDE shard_map from the resident slices (``shard_records``)
    — no device holds another part's vertices, forward or backward.
    ``jax.grad`` w.r.t. ``shards.vertices``/``shards.normals`` yields
    per-copy cotangents on each shard; ``merge_vertex_grads`` reconciles
    duplicated boundary vertices with the replicated path's grads."""
    n_dev = int(mesh.devices.size)

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
    n = orig.shape[0]
    ray_ids = jnp.arange(n, dtype=jnp.int32)

    pad = (-n) % n_dev
    if pad:
        orig = jnp.concatenate([orig, jnp.full((pad, 3), 1.0e7, orig.dtype)])
        dirn = jnp.concatenate(
            [dirn, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], dirn.dtype),
                            (pad, 1))]
        )
        ray_ids = jnp.concatenate(
            [ray_ids, n + jnp.arange(pad, dtype=jnp.int32)]
        )

    from atray.scene.data import empty_mesh

    lean = dataclasses.replace(scene, mesh=empty_mesh())
    pp = P(axis_name)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(pp, pp, pp, pp, pp, pp, pp, pp, pp, P(None), P(None)),
        out_specs=(pp, pp),
        check_vma=False,
    )
    def _run(o, d, ids, v_l, n_l, f_l, fn_l, mat_l, fid_l, owner, lrow):
        # THIS device's record table, built from its resident slices only
        recs_l = shard_records(
            v_l[0], n_l[0], f_l[0], fn_l[0], mat_l[0], fid_l[0]
        )[None]

        def override(o_, d_, alive):
            _, fid = ring_first_fid(
                jax.lax.stop_gradient(recs_l),
                jax.lax.stop_gradient(o_), jax.lax.stop_gradient(d_),
                n_parts=n_dev, axis_name=axis_name,
            )
            fid = jax.lax.stop_gradient(fid)
            row = diff_row_pickup(
                recs_l, owner, lrow, fid, n_parts=n_dev, axis_name=axis_name
            )
            return _replay_row(o_, d_, row, fid)

        def occl(o_, d_, live):
            return ring_occlusion_t(
                jax.lax.stop_gradient(recs_l), o_, d_,
                n_parts=n_dev, axis_name=axis_name,
            )

        color, stats = trace_radiance(
            lean, o, d, settings.bounce_limit, key=bounce_key,
            sort_rays=settings.sort_bounces, nee=settings.nee,
            return_stats=True, ray_ids=ids, hit_override=override,
            occl_override=occl,
        )
        return color, stats["rays_cast"][None]

    color, rc_shards = _run(
        orig, dirn, ray_ids,
        shards.vertices, shards.normals, shards.faces, shards.fnidx,
        shards.matid, shards.fid, shards.owner, shards.lrow,
    )
    color = color[:n]
    color = from_tile_order(color, w, h, spp)
    film = color.reshape(spp, h, w, 3).mean(axis=0)
    film = jnp.clip(film, 0.0, 1.0)
    if return_stats:
        return film, {
            "rays_cast": jnp.sum(rc_shards),
            "rays_cast_per_shard": rc_shards,
        }
    return film


def _render_treelet_accel(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    key: jax.Array,
    mesh: Mesh,
    ta: TreeletAccels,
    axis_name: str,
    return_stats: bool,
):
    """Kernel-backed variant of ``render_treelet``: the treelet BVHs shard
    over the mesh on their leading parts axis; each ring hop runs the
    per-ray hit kernel on the resident treelet, and the home device
    resolves the winning face from the replicated face table."""
    n_dev = int(mesh.devices.size)
    face_table = build_face_table(scene)

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
    n = orig.shape[0]
    ray_ids = jnp.arange(n, dtype=jnp.int32)

    pad = (-n) % n_dev
    if pad:
        orig = jnp.concatenate([orig, jnp.full((pad, 3), 1.0e7, orig.dtype)])
        dirn = jnp.concatenate(
            [dirn, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], dirn.dtype),
                            (pad, 1))]
        )
        ray_ids = jnp.concatenate(
            [ray_ids, n + jnp.arange(pad, dtype=jnp.int32)]
        )

    from atray.scene.data import empty_mesh

    lean = dataclasses.replace(scene, mesh=empty_mesh())
    rayspec = P(axis_name)
    partspec = P(axis_name)   # leading parts axis sharded over same devices

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(rayspec, rayspec, rayspec, partspec, P()),
        out_specs=(rayspec, rayspec),
        check_vma=False,
    )
    def _run(o, d, ids, bvh_shard, ft):
        local = jax.tree_util.tree_map(lambda x: x[0], bvh_shard)

        def override(o_, d_, alive):
            o_ = jax.lax.stop_gradient(o_)
            d_ = jax.lax.stop_gradient(d_)
            _, fid = ring_first_hit_accel(
                local, o_, d_, alive, n_parts=n_dev, axis_name=axis_name
            )
            row = ft[jnp.clip(fid, 0, ft.shape[0] - 1)]
            return _replay_row(o_, d_, row, fid)

        def occl(o_, d_, live):
            return ring_occlusion_t_accel(
                local, o_, d_, live, n_parts=n_dev, axis_name=axis_name
            )

        color, stats = trace_radiance(
            lean, o, d, settings.bounce_limit, key=bounce_key,
            sort_rays=settings.sort_bounces, nee=settings.nee,
            return_stats=True, ray_ids=ids, hit_override=override,
            occl_override=occl,
        )
        return color, stats["rays_cast"][None]

    color, rc_shards = _run(orig, dirn, ray_ids, ta.bvh, face_table)
    color = color[:n]
    color = from_tile_order(color, w, h, spp)
    film = color.reshape(spp, h, w, 3).mean(axis=0)
    film = jnp.clip(film, 0.0, 1.0)
    if return_stats:
        return film, {
            "rays_cast": jnp.sum(rc_shards),
            "rays_cast_per_shard": rc_shards,
        }
    return film
