"""Typed runtime configuration.

The reference hardcodes every knob as C++ literals (Source/engine/app.cpp:16-88,
Source/engine/renderer/settings.h:4-10) plus one compile-time toggle
(``#define USE_KD_TREE``, Source/engine/renderer/renderer.h:8). Here every knob
is a runtime dataclass so each BASELINE.json config is expressible without code
edits, and a TOML/CLI front-end (atray/cli.py) maps onto it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Mirror of the reference's RenderSettings (settings.h:4-10), extended.

    resolution: (width, height) of the film.
    samples_per_pixel: stochastic samples averaged per pixel.
    bounce_limit: max path length (camera ray = bounce 0).
    anti_aliasing: jitter the film point uniformly within the pixel.
    use_accel: traverse the BVH instead of brute-force all-primitives
        (the runtime equivalent of the reference's USE_KD_TREE compile flag).
    ray_chunk: process rays in chunks of this many to bound device memory;
        0 means a single chunk (all rays at once).
    sort_bounces: one-shot ray-queue compaction (SURVEY.md §5.7): after
        the first diffuse bounce, rays are stably re-ordered dead-last and
        live rays grouped by origin cell — later bounces run dense,
        origin-coherent kernel blocks and fully-dead blocks end at once.
        Bit-identical to the unsorted render (PRNG streams are keyed by
        global ray id).
    nee: next-event estimation — explicit shadow rays to sphere lights at
        every hit (BASELINE config 2 'shadow rays'); cuts variance from
        small bright emitters dramatically.
    """

    resolution: Tuple[int, int] = (1280, 720)
    samples_per_pixel: int = 5
    bounce_limit: int = 5
    anti_aliasing: bool = False
    use_accel: bool = True
    ray_chunk: int = 0
    sort_bounces: bool = True
    nee: bool = False

    @property
    def width(self) -> int:
        return self.resolution[0]

    @property
    def height(self) -> int:
        return self.resolution[1]


@dataclasses.dataclass(frozen=True)
class KDTreeConfig:
    """Acceleration-structure build options.

    The reference's octree takes {max_no_faces_per_node, division_method}
    (kd_tree.h:38-47). Our BVH equivalent: leaf_size is the fixed padded
    triangle count per leaf; branching selects 2-wide SAH BVH; sah_bins
    controls split-search resolution.
    """

    leaf_size: int = 4
    sah_bins: int = 16
    max_depth: int = 40


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh shape for SPMD execution.

    Parsed from the scene TOML's ``[mesh]`` table (num_devices = N,
    axis_name = "rays") and built by the CLI via
    ``dist.mesh.make_device_mesh``; the ``--mesh`` flag overrides it.
    ``num_devices`` 0 means single-device (no shard_map); -1 means all
    visible devices.
    """

    num_devices: int = 0
    axis_name: str = "rays"
