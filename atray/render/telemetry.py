"""Runtime cost telemetry: per-chunk wall times + per-shard ray counts.

The reference exposes per-tile render ms and ray counts interactively from
its ATP multi-timers (app.cpp:218-234, renderer.cpp:293-308,447-450). The
SPMD analog (SURVEY.md §7 hard part 4 — "measure tail latency per shard"):

- ``render_telemetry`` renders the frame chunk-by-chunk through ONE traced
  chunk body, wall-timing every dispatch into the ``Phase("chunk")``
  registry — a tail-latency sample over spatially coherent ray blocks
  (film-tile order), the direct analog of per-tile ms. The film is
  bit-identical to ``render()`` with the same chunking because ray ids
  (and so all PRNG streams) are global.
- per-shard live-ray counts come back from the sharded render's stats
  (``rays_cast_per_shard``) — the reference's per-tile ``ray_casts``
  counter, summed per device instead of per tile.
- ``tail_report`` formats both into the min/p50/p90/max + imbalance table.

Caveat: each chunk is its own dispatch, so absolute per-chunk times
include the fixed dispatch overhead; the SPREAD (imbalance) is the signal.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from atray.config import RenderSettings
from atray.core.camera import Camera, camera_rays
from atray.render.wavefront import (
    from_tile_order,
    to_tile_order,
    trace_radiance,
)
from atray.utils.profiling import Phase


def render_telemetry(
    scene,
    camera: Camera,
    settings: RenderSettings,
    key: jax.Array,
    accel=None,
    n_chunks: int = 16,
) -> Tuple[jnp.ndarray, dict]:
    """Frame rendered as ``n_chunks`` host-dispatched chunks, each timed.

    Returns (film (H, W, 3), report dict). The chunk body is traced ONCE
    (fixed chunk shape); chunks are film-tile-ordered ray blocks, so their
    cost spread mirrors the reference's per-tile cost spread (sky tiles
    cheap, model tiles expensive).
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
    n = orig.shape[0]
    chunk = -(-n // n_chunks)
    pad = (-n) % chunk
    if pad:
        orig = jnp.concatenate([orig, jnp.full((pad, 3), 1.0e7, orig.dtype)])
        dirn = jnp.concatenate(
            [dirn, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], dirn.dtype),
                            (pad, 1))]
        )
    nc = orig.shape[0] // chunk

    @jax.jit
    def chunk_trace(o, d, ids):
        return trace_radiance(
            scene, o, d, settings.bounce_limit, key=bounce_key, accel=accel,
            sort_rays=settings.sort_bounces, nee=settings.nee,
            return_stats=True, ray_ids=ids,
        )

    # warm the compile outside the timed loop
    ids0 = jnp.arange(chunk, dtype=jnp.int32)
    chunk_trace.lower(orig[:chunk], dirn[:chunk], ids0).compile()

    colors = []
    times_s = []
    rays = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        ids = c * chunk + ids0
        t0 = time.perf_counter()
        with Phase("chunk"):
            color, stats = chunk_trace(orig[sl], dirn[sl], ids)
            jax.block_until_ready(color)
        times_s.append(time.perf_counter() - t0)
        colors.append(color)
        rays.append(float(stats["rays_cast"]))

    color = jnp.concatenate(colors)[:n]
    color = from_tile_order(color, w, h, spp)
    film = jnp.clip(color.reshape(spp, h, w, 3).mean(axis=0), 0.0, 1.0)

    report = {
        "n_chunks": nc,
        "chunk_rays": chunk,
        "chunk_s": times_s,
        "chunk_live_rays": rays,
    }
    return film, report


def _spread(xs) -> dict:
    a = np.asarray(xs, np.float64)
    return {
        "min": float(a.min()),
        "p50": float(np.percentile(a, 50)),
        "p90": float(np.percentile(a, 90)),
        "max": float(a.max()),
        "imbalance": float(a.max() / max(a.mean(), 1e-12)),
    }


def tail_report(
    report: dict,
    rays_per_shard: Optional[np.ndarray] = None,
    file=None,
) -> str:
    """min/p50/p90/max + imbalance table over chunk times (and per-shard
    ray counts when a sharded run provides them). ``imbalance`` =
    max/mean — 1.0 is a perfectly balanced static partition."""
    rows = [("chunk wall (s)", _spread(report["chunk_s"])),
            ("chunk live rays", _spread(report["chunk_live_rays"]))]
    if rays_per_shard is not None:
        rows.append(("shard live rays", _spread(rays_per_shard)))
    lines = [
        f"{'telemetry':<18}{'min':>11}{'p50':>11}{'p90':>11}{'max':>11}"
        f"{'imbal':>8}"
    ]
    for name, s in rows:
        lines.append(
            f"{name:<18}{s['min']:>11.4g}{s['p50']:>11.4g}{s['p90']:>11.4g}"
            f"{s['max']:>11.4g}{s['imbalance']:>8.2f}"
        )
    text = "\n".join(lines)
    if file is not None:
        print(text, file=file)
    return text
