"""Pinhole camera and batched camera-ray generation.

Re-design of the reference camera (camera.h:9-45) and per-pixel ray
setup (renderer.cpp:314-343): instead of a scalar loop over pixels, one
broadcasted jnp expression produces the whole (spp, H, W) ray batch at once.

Conventions (matching the reference's capability):
- right-handed basis built from eye/look_dir with world up (0, 1, 0)
  (camera.h:23-34);
- ``h_fov`` is the film half-width scale; film half-height = h_fov / aspect
  (camera.h:36-45);
- film coordinates span [-1, 1] in x and y (renderer.cpp:317, 329);
- AA jitter is uniform within a pixel via half-pixel extents
  (camera.h:43-44, renderer.cpp:340-341).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from atray.core.intersect import normalize

_WORLD_UP = jnp.array([0.0, 1.0, 0.0], dtype=jnp.float32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera basis + film geometry. All leaves are jnp scalars/vec3s so the
    camera is a differentiable pytree (e.g. for pose optimization)."""

    eye: jnp.ndarray        # (3,)
    right: jnp.ndarray      # (3,) unit
    up: jnp.ndarray         # (3,) unit
    forward: jnp.ndarray    # (3,) unit
    half_width: jnp.ndarray   # () film half-width  (= h_fov)
    half_height: jnp.ndarray  # () film half-height (= h_fov / aspect)


def make_camera(
    eye,
    look_dir,
    h_fov: float = 1.0,
    aspect: float = 16.0 / 9.0,
) -> Camera:
    """Build the right-handed camera basis (reference set_camera, camera.h:23-45).

    The basis math runs in host numpy: every eager jnp op would be its own
    device dispatch, so scene/camera authoring stays off the device.
    """
    import numpy as np

    eye = np.asarray(eye, np.float64)
    fw = np.asarray(look_dir, np.float64)
    fw = fw / max(np.linalg.norm(fw), 1e-20)
    up_w = np.array([0.0, 1.0, 0.0])
    right = np.cross(fw, up_w)
    right = right / max(np.linalg.norm(right), 1e-20)
    up = np.cross(right, fw)
    return Camera(
        eye=jnp.asarray(eye, jnp.float32),
        right=jnp.asarray(right, jnp.float32),
        up=jnp.asarray(up, jnp.float32),
        forward=jnp.asarray(fw, jnp.float32),
        half_width=jnp.float32(h_fov),
        half_height=jnp.float32(h_fov / aspect),
    )


def look_at_camera(eye, target, h_fov: float = 1.0, aspect: float = 16.0 / 9.0) -> Camera:
    import numpy as np

    eye_np = np.asarray(eye, np.float64)
    return make_camera(eye_np, np.asarray(target, np.float64) - eye_np, h_fov, aspect)


def camera_rays(
    cam: Camera,
    width: int,
    height: int,
    spp: int,
    key: jax.Array | None = None,
    anti_aliasing: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Generate the full camera-ray batch.

    Returns (origins, dirs) each of shape (spp * height * width, 3); dirs are
    unit length. Ray order is sample-major then row-major so a reshape to
    (spp, H, W, 3) recovers the film layout. Pixel (0, 0) is the top-left
    (film y = +1), matching the reference's loop order (renderer.cpp:314-329).
    """
    xs = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0
    ys = 1.0 - (jnp.arange(height, dtype=jnp.float32) + 0.5) / height * 2.0
    fx = jnp.broadcast_to(xs[None, None, :], (spp, height, width))
    fy = jnp.broadcast_to(ys[None, :, None], (spp, height, width))
    if anti_aliasing:
        if key is None:
            raise ValueError("anti_aliasing=True requires a PRNG key")
        jit = jax.random.uniform(
            key, (spp, height, width, 2), jnp.float32, -1.0, 1.0
        )
        fx = fx + jit[..., 0] / width    # half-pixel extent in film units
        fy = fy + jit[..., 1] / height
    dirs = (
        fx[..., None] * (cam.right * cam.half_width)
        + fy[..., None] * (cam.up * cam.half_height)
        + cam.forward
    )
    dirs = normalize(dirs).reshape(-1, 3)
    origins = jnp.broadcast_to(cam.eye, dirs.shape)
    return origins, dirs
