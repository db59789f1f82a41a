"""Debug visualizations — the realized version of the reference's empty
Debugger scaffold (tools/debugger.h, SURVEY.md §2 #24) plus its interactive
per-tile cost inspection (app.cpp:218-234) as heatmap images.

All outputs are plain (H, W, 3) float films written with render/film.py —
no plotting dependencies.
"""

from __future__ import annotations

import numpy as np

from atray.render.film import save_png


def traversal_depth_map(accel, scene, camera, width: int, height: int):
    """Per-pixel BVH leaf-visit/intersection-cost proxy: the number of
    triangle tests the jnp reference traversal performs per primary ray,
    normalized to [0, 1]. The SPMD analog of clicking a tile in the
    reference UI to see its cost."""
    import jax.numpy as jnp

    from atray.accel.bvh import BVH
    from atray.core.camera import camera_rays
    from atray.core.intersect import INF, aabb_entry_t, safe_inv_dir

    if not isinstance(accel, BVH):
        raise TypeError("traversal_depth_map expects the jnp BVH accel")
    orig, dirn = camera_rays(camera, width, height, spp=1)
    o = np.asarray(orig)
    d = np.asarray(dirn)
    nmin = np.asarray(accel.node_min)
    nmax = np.asarray(accel.node_max)
    miss = np.asarray(accel.node_miss)
    lstart = np.asarray(accel.leaf_start)
    with np.errstate(all="ignore"):
        inv = 1.0 / d
        counts = np.zeros(o.shape[0], np.int64)
        node = np.zeros(o.shape[0], np.int64)
        active = np.ones(o.shape[0], bool)
        # per-ray skip-link walk counting node visits (bounded for safety)
        for _ in range(nmin.shape[0] * 2):
            if not active.any():
                break
            n = np.maximum(node, 0)
            t0 = (nmin[n] - o) * inv
            t1 = (nmax[n] - o) * inv
            tn = np.minimum(t0, t1).max(axis=1)
            tf = np.maximum(t0, t1).min(axis=1)
            hit = (tn <= tf) & (tf > 0) & active
            counts += hit
            is_leaf = lstart[n] >= 0
            nxt = np.where(hit & ~is_leaf, n + 1, miss[n])
            node = np.where(active, nxt, node)
            active = node >= 0
    img = counts.reshape(height, width).astype(np.float64)
    img = img / max(img.max(), 1)
    # blue (cheap) -> red (expensive)
    film = np.stack([img, 0.2 * img, 1.0 - img], axis=-1)
    return film.astype(np.float32)


def bvh_level_boxes(accel, level: int = 3):
    """(K, 2, 3) world-space AABBs of the BVH cut at ``level`` (for external
    plotting or box overlays)."""
    nmin = np.asarray(accel.node_min)
    nmax = np.asarray(accel.node_max)
    miss = np.asarray(accel.node_miss)
    lstart = np.asarray(accel.leaf_start)
    boxes = []

    def walk(n, depth):
        if depth == level or lstart[n] >= 0:
            boxes.append((nmin[n], nmax[n]))
            return
        # children: n+1 and miss[n+1]
        left = n + 1
        walk(left, depth + 1)
        right = miss[left]
        if right >= 0 and right != miss[n]:
            walk(right, depth + 1)

    walk(0, 0)
    return np.asarray(boxes)


def save_cost_heatmap(path, accel, scene, camera, width=320, height=180):
    film = traversal_depth_map(accel, scene, camera, width, height)
    return save_png(path, film)
