"""AOV (arbitrary-output-variable) passes — beyond parity.

One deterministic primary-ray pass produces the standard compositing /
denoising feature films: depth, world-space shading normal, albedo
(texture-modulated when the scene carries one), emission, material id and
hit mask. The reference ships only an empty debug-visualizer stub
(Source/engine/tools/debug_visualizer.h); atray realizes that stub as
``utils/debugviz.py`` (traversal-cost heatmaps) and adds these production
AOVs on top.

Design notes: the pass reuses the exact production hit path —
``nearest_hit_ids`` (the per-ray hit kernel when an accel is given) and the
differentiable ``resolve_hit`` recompute — so AOVs are guaranteed
consistent with what the beauty render saw. Rays are center-pixel, spp=1,
no RNG: the pass is bit-deterministic and jit-cacheable by (scene, camera,
resolution) alone.
"""
from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from atray.core.camera import Camera, camera_rays
from atray.render.wavefront import (
    PRIM_TRI,
    build_face_table,
    build_face_uv,
    nearest_hit_ids,
    resolve_hit,
    resolve_material_rows,
    _texture_mod_soa,
)
from atray.scene.data import Scene


def render_aovs(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    accel=None,
) -> Dict[str, jnp.ndarray]:
    """Render the AOV films for one camera at (width, height).

    Returns a dict of films in the same top-left-origin layout as the
    beauty film:

    - ``depth``       (H, W)    hit distance t; misses 0.0
    - ``normal``      (H, W, 3) world-space shading normal (smooth for
                                meshes with vertex normals); misses 0
    - ``albedo``      (H, W, 3) material albedo at the hit, modulated by
                                the scene texture when one is attached
                                (same sampling as the beauty pass);
                                misses 0
    - ``emission``    (H, W, 3) material emission at the hit; misses 0
    - ``material_id`` (H, W)    int32 material index; misses -1
    - ``hit``         (H, W)    float mask, 1.0 where a primitive was hit

    The pass is differentiable where the beauty pass is: gradients flow
    from depth/normal/albedo to vertices, vertex normals, material tables
    and texels through the same ``resolve_hit`` seam (the discrete hit
    choice is detached, matching the renderer's detached-visibility
    convention).
    """
    scene = jax.tree_util.tree_map(jnp.asarray, scene)
    orig, dirn = camera_rays(camera, width, height, 1)
    ids = nearest_hit_ids(scene, orig, dirn, accel=accel)
    ft = build_face_table(scene) if scene.mesh.num_faces > 0 else None
    t, normal, mat, hit = resolve_hit(scene, orig, dirn, ids, face_table=ft)
    em, al, _sc = resolve_material_rows(scene, mat, hit)

    if scene.texture is not None and ft is not None:
        fuv = build_face_uv(scene)
        tri_hit = hit & (ids.prim_type == PRIM_TRI)
        tr, tg, tb = _texture_mod_soa(
            scene.texture, ft, fuv, ids.prim_id, tri_hit,
            orig[:, 0], orig[:, 1], orig[:, 2],
            dirn[:, 0], dirn[:, 1], dirn[:, 2],
        )
        al = al * jnp.stack([tr, tg, tb], axis=-1)

    hw = (height, width)
    hitf = hit.astype(jnp.float32)
    return {
        "depth": jnp.where(hit, t, 0.0).reshape(hw),
        "normal": jnp.where(hit[:, None], normal, 0.0).reshape(hw + (3,)),
        "albedo": al.reshape(hw + (3,)),
        "emission": em.reshape(hw + (3,)),
        "material_id": jnp.where(hit, mat, -1).reshape(hw),
        "hit": hitf.reshape(hw),
    }


def aov_preview_films(aovs: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
    """Map raw AOVs to displayable (H, W, 3) films in [0, 1].

    depth is divided by twice the mean depth of the hit pixels and clamped
    (far = bright; misses stay black), normals are
    remapped from [-1, 1] to [0, 1] (the standard normal-map encoding),
    albedo/emission are clamped.
    """
    out = {}
    d = aovs["depth"]
    hitf = aovs["hit"]
    # robust scale: 2x the mean HIT depth (a ground plane's horizon tail
    # would crush a max-normalized film toward black); misses stay 0
    dref = jnp.sum(d * hitf) / jnp.maximum(jnp.sum(hitf), 1.0)
    dmax = jnp.maximum(2.0 * dref, 1.0e-8)
    out["depth"] = jnp.clip((d / dmax)[..., None], 0.0, 1.0).repeat(3, -1)
    out["normal"] = jnp.clip(aovs["normal"] * 0.5 + 0.5, 0.0, 1.0) * (
        aovs["hit"][..., None]
    )
    out["albedo"] = jnp.clip(aovs["albedo"], 0.0, 1.0)
    out["emission"] = jnp.clip(aovs["emission"], 0.0, 1.0)
    return out
