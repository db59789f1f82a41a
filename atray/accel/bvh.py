"""Acceleration structure: SAH binary BVH flattened to skip-link arrays.

Replacement for the reference's 8-way octree (kd_tree.cpp:67-288).
Two deliberate departures from the reference design, both motivated by
data-parallel hardware (SURVEY.md §7 "hard parts" #1 and #6):

1. **Object partitioning (BVH), not spatial subdivision**: every triangle
   lives in exactly one leaf, so there is no duplication and no
   vertex-in-box misclassification hazard (the reference classifies a
   triangle into children by vertex containment, kd_tree.cpp:10-17, and can
   drop triangles that span a child with no vertex inside — SURVEY.md §2
   quirk list). Split quality comes from binned SAH, the real version of
   the reference's "SAH" centroid heuristic (kd_tree.cpp:83-118).

2. **Stackless skip-link flattening**: nodes are laid out in DFS preorder;
   an interior hit advances to ``node+1`` (first child), any miss or
   finished leaf jumps to ``miss[node]`` (the next node after this subtree,
   -1 = done). Per-ray traversal state is a single int32 — no per-ray stack
   (the reference needs caller-allocated hit/leaf stacks sized to the tree,
   renderer.cpp:380-392), which is what lets the hit kernel
   (kernels/bvh_hit.py) keep a ray's whole walk in one GPU lane's registers.

Leaves hold exactly ``leaf_size`` triangle slots, padded with degenerate
triangles (zero-area at infinity, can never hit), so the traversal loop's
leaf phase is shape-static. Triangles are reordered into leaf order;
``tri_orig_id`` maps back to scene face indices for shading/materials.

The build runs once on the host in numpy (an optional C++ builder for large
scenes lives in atray/native). Determinism: same mesh -> same tree.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from atray.config import KDTreeConfig

_FAR = 1.0e30


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BVH:
    """Flattened skip-link BVH (device-resident pytree).

    K nodes in DFS preorder; L = num_leaves * leaf_size triangle slots.
    ``leaf_size`` is static metadata so jitted traversal specializes on it.
    """

    node_min: jnp.ndarray     # (K, 3) f32
    node_max: jnp.ndarray     # (K, 3) f32
    node_miss: jnp.ndarray    # (K,) i32 skip link; -1 = traversal done
    leaf_start: jnp.ndarray   # (K,) i32 into tri arrays; -1 = interior node
    tri_p0: jnp.ndarray       # (L, 3) f32 — leaf-ordered, padded
    tri_e1: jnp.ndarray       # (L, 3)
    tri_e2: jnp.ndarray       # (L, 3)
    tri_orig_id: jnp.ndarray  # (L,) i32 original face index; -1 = pad slot
    leaf_size: int = dataclasses.field(metadata=dict(static=True))
    max_depth: int = dataclasses.field(metadata=dict(static=True))

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


def _surface(mn: np.ndarray, mx: np.ndarray) -> np.ndarray:
    d = np.maximum(mx - mn, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


def _sah_split(
    tri_mins: np.ndarray,
    tri_maxs: np.ndarray,
    centroids: np.ndarray,
    idx: np.ndarray,
    bins: int,
) -> Optional[Tuple[int, float]]:
    """Binned SAH over centroids: returns (axis, split_pos) or None.

    Cost model: C = A_left * N_left + A_right * N_right (constants that are
    equal across candidate splits cancel for selection purposes).
    """
    cmin = centroids[idx].min(axis=0)
    cmax = centroids[idx].max(axis=0)
    ext = cmax - cmin
    axis = int(np.argmax(ext))
    if ext[axis] <= 0.0:
        return None
    lo = cmin[axis]
    scale = bins / ext[axis]
    b = np.minimum(((centroids[idx, axis] - lo) * scale).astype(np.int64), bins - 1)

    counts = np.bincount(b, minlength=bins)
    bmin = np.full((bins, 3), np.inf)
    bmax = np.full((bins, 3), -np.inf)
    np.minimum.at(bmin, b, tri_mins[idx])
    np.maximum.at(bmax, b, tri_maxs[idx])

    lmin = np.minimum.accumulate(bmin, axis=0)
    lmax = np.maximum.accumulate(bmax, axis=0)
    rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
    rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
    lcnt = np.cumsum(counts)
    rcnt = np.cumsum(counts[::-1])[::-1]

    k = np.arange(bins - 1)
    valid = (lcnt[k] > 0) & (rcnt[k + 1] > 0)
    cost = np.where(
        valid,
        _surface(lmin[k], lmax[k]) * lcnt[k]
        + _surface(rmin[k + 1], rmax[k + 1]) * rcnt[k + 1],
        np.inf,
    )
    best = int(np.argmin(cost))
    if not valid[best]:
        return None
    return axis, lo + (best + 1) / scale


def build_bvh(
    vertices, faces, config: KDTreeConfig = KDTreeConfig(),
    backend: str = "auto",
) -> BVH:
    """Build the flattened skip-link BVH from (V,3) vertices, (T,3) faces.

    ``backend``: "auto" uses the native C++ builder when available (~30x
    faster at Dragon scale; same algorithm — see native/atray_native.cpp)
    and falls back to numpy; "numpy" forces the reference python build;
    "native" requires the native library.
    """
    f_np = np.asarray(faces)
    if backend in ("auto", "native") and f_np.shape[0] > 0:
        from atray.native import build_bvh_native

        nat = build_bvh_native(
            vertices, faces, int(config.leaf_size), int(config.sah_bins),
            int(config.max_depth),
        )
        if nat is not None:
            # BVH leaves stay host numpy; they upload at the jit boundary
            return BVH(
                node_min=nat["node_min"],
                node_max=nat["node_max"],
                node_miss=nat["node_miss"],
                leaf_start=nat["leaf_start"],
                tri_p0=nat["tri_p0"],
                tri_e1=nat["tri_e1"],
                tri_e2=nat["tri_e2"],
                tri_orig_id=nat["tri_orig_id"],
                leaf_size=int(config.leaf_size),
                max_depth=int(config.max_depth),
            )
        if backend == "native":
            raise RuntimeError("native BVH builder unavailable")

    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    t = f.shape[0]
    if t == 0:
        raise ValueError("cannot build BVH over zero triangles")
    leaf_size = int(config.leaf_size)

    tri = v[f]                       # (T, 3, 3)
    tri_mins = tri.min(axis=1)
    tri_maxs = tri.max(axis=1)
    centroids = tri.mean(axis=1)

    # --- recursive top-down build ----------------------------------------
    # node record: (bmin, bmax, left_id, right_id, leaf_tri_idx or None)
    nodes: list = []
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 100_000))

    def rec(idx: np.ndarray, depth: int) -> int:
        me = len(nodes)
        nodes.append(None)
        bmin = tri_mins[idx].min(axis=0)
        bmax = tri_maxs[idx].max(axis=0)
        if idx.size <= leaf_size or depth >= config.max_depth:
            nodes[me] = (bmin, bmax, -1, -1, idx)
            return me
        split = _sah_split(tri_mins, tri_maxs, centroids, idx, config.sah_bins)
        if split is not None:
            axis, pos = split
            sel = centroids[idx, axis] < pos
            li, ri = idx[sel], idx[~sel]
        else:
            li = ri = np.empty(0, np.int64)
        if li.size == 0 or ri.size == 0:
            # degenerate centroids: median split on the widest axis
            axis = int(np.argmax(bmax - bmin))
            order = np.argsort(centroids[idx, axis], kind="stable")
            half = idx.size // 2
            li, ri = idx[order[:half]], idx[order[half:]]
        left = rec(li, depth + 1)
        right = rec(ri, depth + 1)
        nodes[me] = (bmin, bmax, left, right, None)
        return me

    rec(np.arange(t), 0)
    k = len(nodes)

    # --- DFS preorder + subtree sizes for skip links ----------------------
    size = np.ones(k, np.int64)

    def subtree_size(nid: int) -> int:
        _, _, left, right, idx = nodes[nid]
        if idx is None:
            size[nid] = 1 + subtree_size(left) + subtree_size(right)
        return int(size[nid])

    subtree_size(0)

    order: list = []

    def dfs(nid: int):
        order.append(nid)
        _, _, left, right, idx = nodes[nid]
        if idx is None:
            dfs(left)
            dfs(right)

    dfs(0)

    node_min = np.zeros((k, 3), np.float32)
    node_max = np.zeros((k, 3), np.float32)
    node_miss = np.full(k, -1, np.int32)
    leaf_start = np.full(k, -1, np.int32)
    cursor = 0
    tri_order: list = []
    for pos, nid in enumerate(order):
        bmin, bmax, left, right, idx = nodes[nid]
        node_min[pos] = bmin
        node_max[pos] = bmax
        after = pos + size[nid]
        node_miss[pos] = after if after < k else -1
        if idx is not None:
            leaf_start[pos] = cursor
            tri_order.append(idx)
            cursor += leaf_size

    # --- leaf-ordered, padded triangle arrays -----------------------------
    lcap = len(tri_order) * leaf_size
    p0 = np.full((lcap, 3), _FAR, np.float32)
    e1 = np.zeros((lcap, 3), np.float32)
    e2 = np.zeros((lcap, 3), np.float32)
    oid = np.full(lcap, -1, np.int32)
    base = 0
    for idx in tri_order:
        n = idx.size
        tv = v[f[idx]]
        p0[base : base + n] = tv[:, 0]
        e1[base : base + n] = tv[:, 1] - tv[:, 0]
        e2[base : base + n] = tv[:, 2] - tv[:, 0]
        oid[base : base + n] = idx
        base += leaf_size

    return BVH(
        node_min=node_min,
        node_max=node_max,
        node_miss=node_miss,
        leaf_start=leaf_start,
        tri_p0=p0,
        tri_e1=e1,
        tri_e2=e2,
        tri_orig_id=oid,
        leaf_size=leaf_size,
        max_depth=int(config.max_depth),
    )


def refit_bvh(bvh: BVH, vertices, faces) -> BVH:
    """Device-side refit for moving geometry inside a jitted step.

    Topology (node order, skip links, leaf slots) stays as built; only the
    data is recomputed in XLA, so there is no host rebuild and no
    recompilation. Leaf triangles are rebuilt from the CURRENT ``vertices``
    through ``tri_orig_id``, and every node box grows by the largest vertex
    displacement since the triangles ``bvh`` holds, which keeps every
    triangle inside every box on its root path for any move. Culling loosens
    in proportion to the largest move, the right trade for small
    optimisation steps; rebuild when geometry changes wholesale. Refits
    chain: each one expands the boxes of the BVH it is given.

    The displacement is read from the triangles' corners (p0, p0+e1,
    p0+e2), so vertices no face uses do not loosen the boxes. Outputs are
    detached: the tables drive the discrete hit choice only, and the
    differentiable recompute (render.wavefront.resolve_hit) reads the live
    scene.
    """
    b = jax.tree_util.tree_map(jnp.asarray, bvh)
    v = jax.lax.stop_gradient(jnp.asarray(vertices, jnp.float32))
    f = jnp.asarray(faces)
    oid = b.tri_orig_id
    real = (oid >= 0)[:, None]
    fr = f[jnp.clip(oid, 0, max(f.shape[0] - 1, 0))]
    p0 = v[fr[:, 0]]
    e1 = v[fr[:, 1]] - p0
    e2 = v[fr[:, 2]] - p0
    old = jnp.stack([b.tri_p0, b.tri_p0 + b.tri_e1, b.tri_p0 + b.tri_e2])
    new = jnp.stack([p0, p0 + e1, p0 + e2])
    moved = jnp.max(jnp.where(real[None], jnp.abs(new - old), 0.0))
    # a few f32 ulps of the scene's extent cover the rounding of p0 + e
    # (|old| <= max|v| + moved); read from the live vertices, so XLA has
    # no constant table to fold at compile time
    scale = jnp.max(jnp.abs(v)) + moved
    delta = moved + 4.0 * jnp.finfo(jnp.float32).eps * scale
    return dataclasses.replace(
        bvh,
        node_min=b.node_min - delta,
        node_max=b.node_max + delta,
        tri_p0=jnp.where(real, p0, b.tri_p0),
        tri_e1=jnp.where(real, e1, b.tri_e1),
        tri_e2=jnp.where(real, e2, b.tri_e2),
        node_miss=b.node_miss,
        leaf_start=b.leaf_start,
        tri_orig_id=oid,
    )


def validate_bvh(bvh: BVH, num_faces: int) -> None:
    """Structural invariants, host-side (the analog of the reference's
    build-time asserts, kd_tree.cpp:254-256)."""
    miss = np.asarray(bvh.node_miss)
    ls = np.asarray(bvh.leaf_start)
    k = miss.shape[0]
    assert miss[0] == -1, "root's skip must terminate traversal"
    pos = np.nonzero(miss >= 0)[0]
    assert np.all(miss[pos] > pos), "miss links must jump strictly forward"
    oid = np.asarray(bvh.tri_orig_id)
    real = oid[oid >= 0]
    assert real.size == num_faces, "face count mismatch"
    assert np.array_equal(
        np.sort(real), np.arange(num_faces)
    ), "every face must appear exactly once"
    starts = ls[ls >= 0]
    assert np.all(starts % bvh.leaf_size == 0)
    assert starts.size == 0 or starts.max() + bvh.leaf_size <= oid.size
    # interior nodes' boxes contain their children's boxes
    nmin = np.asarray(bvh.node_min)
    nmax = np.asarray(bvh.node_max)
    interior = ls < 0
    for posn in np.nonzero(interior)[0]:
        end = miss[posn] if miss[posn] >= 0 else k
        for child in range(posn + 1, end):
            assert np.all(nmin[posn] <= nmin[child] + 1e-6)
            assert np.all(nmax[posn] >= nmax[child] - 1e-6)
