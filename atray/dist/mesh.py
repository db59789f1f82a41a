"""SPMD execution over a device mesh: tile/ray sharding + collectives.

Replacement for the reference's entire parallelism story
(SURVEY.md §2 #25): where the reference spawns 8 OS threads that claim image
tiles off an atomic work queue (renderer.cpp:403-455, work_queue.h), we
shard the flat ray axis over a 1-D device mesh with ``shard_map``. Load
balance needs no dynamic queue: every shard traces the same number of rays
through the same bounce loop, and intra-shard variance (sky rays vs dragon
rays) is absorbed by the hit kernel's per-lane walk and by masking — the
SPMD analog of the reference's many-tiles-per-thread heuristic.

Every card reaches every other at the same rate (NVLink), so the mesh is a
plain 1-D list of devices. Collectives: film assembly is the out-sharding (an implicit
all_gather only if the host asks for the full film), and gradient reduction
in dist/train.py is an explicit ``psum`` over the mesh axis.

PRNG discipline (SURVEY.md §7 hard part #5): every random number is a pure
function of (key, GLOBAL ray id, bounce) — see ``wavefront.ray_uniforms`` —
so the sharded result is bit-identical to the single-device result for ANY
mesh shape (layout-invariant), never per-thread wall-clock seeding like the
reference's ``rdtsc * tid`` (pl_utils_win32.cpp:10-15).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from atray.config import RenderSettings
from atray.core.camera import Camera, camera_rays
from atray.render.wavefront import render as _render, trace_radiance


def make_device_mesh(
    num_devices: int = 0, axis_name: str = "rays", devices=None
) -> Mesh:
    """1-D mesh over the ray/tile axis (SURVEY.md §5.7)."""
    devs = list(devices if devices is not None else jax.devices())
    if num_devices:
        devs = devs[:num_devices]
    return Mesh(np.array(devs), (axis_name,))


def trace_sharded(
    scene,
    orig: jnp.ndarray,
    dirn: jnp.ndarray,
    bounce_limit: int,
    key: jax.Array,
    mesh: Mesh,
    accel=None,
    axis_name: str = "rays",
) -> jnp.ndarray:
    """Path-trace with rays sharded over the mesh; scene/BVH replicated.

    The number of rays must divide the mesh size (callers pad; the renderer
    below guarantees it). Random streams are keyed by the GLOBAL ray id
    (``axis_index * shard_len + lane``), so the result is bit-identical to
    the unsharded ``trace_radiance`` on the same rays — for any mesh shape.
    """

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis_name), P(axis_name), P()),
        out_specs=P(axis_name),
        check_vma=False,
    )
    def _run(scene_, o, d, k):
        shard = jax.lax.axis_index(axis_name)
        gids = shard * o.shape[0] + jnp.arange(o.shape[0], dtype=jnp.int32)
        return trace_radiance(
            scene_, o, d, bounce_limit, key=k, accel=accel, ray_ids=gids
        )

    return _run(scene, orig, dirn, key)


def render_sharded(
    scene,
    camera: Camera,
    settings: RenderSettings,
    key: jax.Array,
    mesh: Mesh,
    accel=None,
    axis_name: str = "rays",
) -> jnp.ndarray:
    """Full sharded forward render -> film (H, W, 3) on the host layout.

    Thin wrapper over the ONE unified renderer: ``wavefront.render`` with a
    mesh runs the full feature set (NEE, compaction, chunking, tile order)
    under shard_map and is bit-identical to the single-device render.
    """
    return _render(
        scene, camera, settings, key, accel=accel, mesh=mesh,
        axis_name=axis_name,
    )
