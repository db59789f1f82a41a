"""Vectorized stackless BVH traversal (pure jnp reference path).

The jnp counterpart of the reference's explicit-stack octree walk
(kd_tree.cpp:337-465), re-designed for SIMD: every ray's traversal state is
one int32 node cursor; each ``while_loop`` step performs, for ALL rays at
once,

  1. a gather of the current node's AABB + links,
  2. a slab test (pruned against the ray's current best t),
  3. a ``leaf_size``-wide Möller–Trumbore block for rays sitting on a leaf
     (interior rays gather leaf slot 0 harmlessly and mask the result),
  4. the skip-link state update: interior hit -> node+1, else miss[node].

No per-ray stacks, no divergence beyond masking — the "divergent traversal
on a SIMD machine" problem (SURVEY.md §7 hard part #1) is resolved in the
data structure rather than fought in the kernel. The per-ray hit kernel
(kernels/bvh_hit.py) runs this same walk one GPU lane per ray; this jnp
version is its plain reference.

Front-to-back ordering is NOT maintained (skip-link order is DFS order);
correctness comes from testing every reachable leaf, and efficiency from
``t_entry < best_t`` subtree pruning — unlike the reference, whose
sorted-leaf early-exit is an approximation that can return a non-nearest
hit (kd_tree.cpp:457-460, SURVEY.md §2 quirks). Ours is exact: it always
returns the true nearest intersection.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from atray.accel.bvh import BVH
from atray.core.intersect import INF, aabb_entry_t, moller_trumbore, safe_inv_dir


def bvh_first_hit(
    bvh: BVH,
    scene,  # unused; kept for call-signature parity with nearest_hit_ids
    orig: jnp.ndarray,   # (R, 3)
    dirn: jnp.ndarray,   # (R, 3)
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Nearest triangle hit via the skip-link BVH.

    Returns (t, u, v, face_id) with face_id = -1 / t = INF on miss —
    same contract as core.intersect.first_triangle_hit (its brute-force
    oracle).
    """
    bvh = jax.tree_util.tree_map(jnp.asarray, bvh)  # host-built leaves
    r = orig.shape[0]
    ls = bvh.leaf_size
    inv = safe_inv_dir(dirn)
    lane = jnp.arange(ls, dtype=jnp.int32)[None, :]         # (1, ls)

    def cond(state):
        node = state[0]
        return jnp.any(node >= 0)

    def body(state):
        node, best_t, best_u, best_v, best_id = state
        live = node >= 0
        nidx = jnp.maximum(node, 0)

        bmin = bvh.node_min[nidx]
        bmax = bvh.node_max[nidx]
        t_entry, _, bhit = aabb_entry_t(orig, inv, bmin, bmax)
        bhit = bhit & live & (t_entry < best_t)

        start = bvh.leaf_start[nidx]                        # (R,)
        is_leaf = start >= 0
        do_leaf = bhit & is_leaf

        # Leaf phase: gather this leaf's triangle block and intersect.
        slot = jnp.maximum(start, 0)[:, None] + lane        # (R, ls)
        p0 = bvh.tri_p0[slot]                               # (R, ls, 3)
        e1 = bvh.tri_e1[slot]
        e2 = bvh.tri_e2[slot]
        t, u, v, hit = moller_trumbore(
            orig[:, None, :], dirn[:, None, :], p0, e1, e2
        )                                                   # (R, ls)
        t = jnp.where(do_leaf[:, None] & hit, t, INF)
        kbest = jnp.argmin(t, axis=1)
        rr = jnp.arange(r)
        t_leaf = t[rr, kbest]
        closer = t_leaf < best_t
        best_t = jnp.where(closer, t_leaf, best_t)
        best_u = jnp.where(closer, u[rr, kbest], best_u)
        best_v = jnp.where(closer, v[rr, kbest], best_v)
        best_id = jnp.where(
            closer, bvh.tri_orig_id[slot[rr, kbest]], best_id
        )

        # Skip-link advance: descend only into hit interior nodes.
        descend = bhit & ~is_leaf
        nxt = jnp.where(descend, nidx + 1, bvh.node_miss[nidx])
        node = jnp.where(live, nxt, node)
        return node, best_t, best_u, best_v, best_id

    init = (
        jnp.zeros((r,), jnp.int32),
        jnp.full((r,), INF),
        jnp.zeros((r,)),
        jnp.zeros((r,)),
        jnp.full((r,), -1, jnp.int32),
    )
    node, best_t, best_u, best_v, best_id = jax.lax.while_loop(cond, body, init)
    return best_t, best_u, best_v, best_id
