"""Per-ray nearest-triangle kernel: Pallas through Triton, one lane per ray.

The hot query of the renderer (every camera ray, bounce ray and NEE shadow
ray) over the skip-link BVH of ``accel/bvh.py``. It runs the same stackless
walk as the XLA reference ``accel.traverse.bvh_first_hit``:

- the ray's whole traversal state is one int32 node cursor, so origin,
  inverse direction, best t, best slot and the cursor stay in registers;
- node boxes, skip links and leaf triangles are gathered from device memory
  by per-lane index (at Dragon scale the tables are ~8 MB and sit in L2);
- the leaf phase is a static loop over the ``leaf_size`` slots.

A block of ``BLOCK`` rays loops until its own slowest ray finishes, so
with a one-warp block each warp stops on its own, not when the slowest ray
of the whole wavefront does (the XLA walk pays one wavefront-wide
``while_loop`` step per node visit of the slowest ray).

The math is the f32 elementwise slab test and Möller–Trumbore of
``core/intersect.py`` in the same operation order; no dot product reaches
a tensor core. The compiler may contract a multiply-add into an FMA, so ``t``
can differ from the reference in the last bits, and equal-t ties between
faces may resolve to another face.

``first_hit`` is the one place that chooses how the kernel runs: compiled
by Triton on a GPU, interpreted on the CPU (the test platform). Any other
backend is an error.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from atray.accel.bvh import BVH

INF = 3.0e38
T_MIN = 1.0e-4
_DENOM_EPS = 1.0e-12
# rays per program: one warp, so every warp ends its walk on its own
BLOCK = 32
NUM_WARPS = 1
NUM_STAGES = 1
# node table row: min xyz, max xyz (f32); skip link, leaf start (i32)
_NODE_F = 6
_NODE_I = 2
# triangle row: p0, e1, e2 (f32)
_TRI_F = 9


def kernel_mode() -> bool:
    """Whether the hit kernel runs interpreted, from ``jax.default_backend()``:
    False (compiled through Triton) on ``gpu``, True on ``cpu``. Raises on
    any other backend: there is no silent fallback to the XLA walk."""
    backend = jax.default_backend()
    if backend == "gpu":
        return False
    if backend == "cpu":
        return True
    raise NotImplementedError(
        f"no nearest-hit kernel for backend {backend!r} (gpu or cpu only)"
    )


def pack_tables(bvh: BVH):
    """Flat gather tables of the kernel: (K*6,) f32 node boxes, (K*2,) i32
    links, (L*9,) f32 triangles, (L,) i32 face ids. Built in XLA from the
    BVH's own arrays, so a refit BVH (``accel.bvh.refit_bvh``) packs the
    same way."""
    b = jax.tree_util.tree_map(jnp.asarray, bvh)
    nodes_f = jnp.concatenate([b.node_min, b.node_max], axis=1).reshape(-1)
    nodes_i = jnp.stack([b.node_miss, b.leaf_start], axis=1).reshape(-1)
    tris = jnp.concatenate([b.tri_p0, b.tri_e1, b.tri_e2], axis=1).reshape(-1)
    return (
        nodes_f.astype(jnp.float32),
        nodes_i.astype(jnp.int32),
        tris.astype(jnp.float32),
        b.tri_orig_id.astype(jnp.int32),
    )


def _inv(d):
    # core.intersect.safe_inv_dir, componentwise
    zero = d == 0.0
    sgn = jnp.where(d < 0.0, -INF, INF)
    return jnp.where(zero, sgn, 1.0 / jnp.where(zero, 1.0, d))


def _make_kernel(leaf_size: int):
    def kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, alive_ref,
               nf_ref, ni_ref, tri_ref, oid_ref, t_ref, id_ref):
        ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
        dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
        ix, iy, iz = _inv(dx), _inv(dy), _inv(dz)
        node0 = jnp.where(alive_ref[...] != 0, 0, -1).astype(jnp.int32)
        t0 = jnp.full(ox.shape, INF, jnp.float32)
        s0 = jnp.full(ox.shape, -1, jnp.int32)

        def cond(st):
            # jnp.any has no Triton lowering; max >= 0 says the same
            return jnp.max(st[0]) >= 0

        def body(st):
            node, best_t, best_s = st
            live = node >= 0
            n = jnp.maximum(node, 0)
            fb = n * _NODE_F
            ib = n * _NODE_I
            # slab test (core.intersect.aabb_entry_t)
            ax = (nf_ref[fb + 0] - ox) * ix
            bx = (nf_ref[fb + 3] - ox) * ix
            ay = (nf_ref[fb + 1] - oy) * iy
            by = (nf_ref[fb + 4] - oy) * iy
            az = (nf_ref[fb + 2] - oz) * iz
            bz = (nf_ref[fb + 5] - oz) * iz
            t_entry = jnp.maximum(
                jnp.maximum(jnp.minimum(ax, bx), jnp.minimum(ay, by)),
                jnp.minimum(az, bz),
            )
            t_exit = jnp.minimum(
                jnp.minimum(jnp.maximum(ax, bx), jnp.maximum(ay, by)),
                jnp.maximum(az, bz),
            )
            bhit = (live & (t_entry <= t_exit) & (t_exit > 0.0)
                    & (t_entry < best_t))
            miss = ni_ref[ib + 0]
            start = ni_ref[ib + 1]
            is_leaf = start >= 0
            do_leaf = bhit & is_leaf
            base = jnp.maximum(start, 0)
            for k in range(leaf_size):
                # Möller–Trumbore, culled (core.intersect.moller_trumbore)
                s = base + k
                tb = s * _TRI_F
                p0x, p0y, p0z = tri_ref[tb + 0], tri_ref[tb + 1], tri_ref[tb + 2]
                e1x, e1y, e1z = tri_ref[tb + 3], tri_ref[tb + 4], tri_ref[tb + 5]
                e2x, e2y, e2z = tri_ref[tb + 6], tri_ref[tb + 7], tri_ref[tb + 8]
                pvx = dy * e2z - dz * e2y
                pvy = dz * e2x - dx * e2z
                pvz = dx * e2y - dy * e2x
                det = e1x * pvx + e1y * pvy + e1z * pvz
                valid = det > _DENOM_EPS
                inv_det = jnp.where(valid, 1.0 / jnp.where(valid, det, 1.0),
                                    0.0)
                tvx = ox - p0x
                tvy = oy - p0y
                tvz = oz - p0z
                u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
                qvx = tvy * e1z - tvz * e1y
                qvy = tvz * e1x - tvx * e1z
                qvz = tvx * e1y - tvy * e1x
                v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
                t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
                hit = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                       & (t > T_MIN))
                closer = do_leaf & hit & (t < best_t)
                best_t = jnp.where(closer, t, best_t)
                best_s = jnp.where(closer, s, best_s)
            nxt = jnp.where(bhit & ~is_leaf, n + 1, miss)
            node = jnp.where(live, nxt, node)
            return node, best_t, best_s

        _, best_t, best_s = jax.lax.while_loop(cond, body, (node0, t0, s0))
        fid = oid_ref[jnp.maximum(best_s, 0)]
        t_ref[...] = best_t
        id_ref[...] = jnp.where(best_s >= 0, fid, -1)

    return kernel


def bvh_hit_pallas(
    bvh: BVH,
    orig: jnp.ndarray,                  # (R, 3)
    dirn: jnp.ndarray,                  # (R, 3)
    alive: Optional[jnp.ndarray] = None,  # (R,) bool; dead rays never walk
    *,
    interpret: bool,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Nearest triangle per ray: (t (R,) f32, face_id (R,) i32), with
    (INF, -1) on a miss or a dead ray. ``face_id`` indexes the scene's
    faces (``bvh.tri_orig_id``). Rays are padded to a whole block; pad lanes
    start dead. Not differentiable: the hit is a discrete choice."""
    orig = jax.lax.stop_gradient(orig)
    dirn = jax.lax.stop_gradient(dirn)
    r = orig.shape[0]
    if alive is None:
        alive = jnp.ones((r,), bool)
    rp = -(-max(r, 1) // BLOCK) * BLOCK
    pad = rp - r

    def plane(x, fill):
        return jnp.pad(x.astype(jnp.float32), (0, pad), constant_values=fill)

    cols = (plane(orig[:, 0], 0.0), plane(orig[:, 1], 0.0),
            plane(orig[:, 2], 0.0), plane(dirn[:, 0], 0.0),
            plane(dirn[:, 1], 0.0), plane(dirn[:, 2], 1.0))
    alive_p = jnp.pad(jax.lax.stop_gradient(alive).astype(jnp.int32),
                      (0, pad))
    tables = pack_tables(bvh)

    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    tab_spec = pl.BlockSpec(memory_space=pl.ANY)
    t, fid = pl.pallas_call(
        _make_kernel(int(bvh.leaf_size)),
        out_shape=(
            jax.ShapeDtypeStruct((rp,), jnp.float32),
            jax.ShapeDtypeStruct((rp,), jnp.int32),
        ),
        grid=(rp // BLOCK,),
        in_specs=[ray_spec] * 7 + [tab_spec] * 4,
        out_specs=(ray_spec, ray_spec),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        name="bvh_hit",
    )(*cols, alive_p, *tables)
    return t[:r], fid[:r]


def first_hit(
    bvh: BVH,
    orig: jnp.ndarray,
    dirn: jnp.ndarray,
    alive: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The renderer's nearest-triangle query: ``bvh_hit_pallas`` compiled
    for the GPU, or interpreted on the CPU (``kernel_mode``)."""
    return bvh_hit_pallas(bvh, orig, dirn, alive, interpret=kernel_mode())
