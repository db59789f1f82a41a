"""End-to-end demo: build a scene, render a beauty frame + AOV films.

Run from the repo root (CPU or GPU):

    python examples/render_demo.py [--res 640x360] [--spp 8] [--out demo]

Produces ``<out>.png`` (beauty, sRGB) plus ``<out>_depth/normal/albedo/
emission.png`` AOV films. This is the canonical library-surface flow the
reference drives from its app loop (Source/engine/app.cpp): scene -> accel
-> camera -> render -> image, here through the public atray API.
"""
import argparse
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from atray.accel.bvh import build_bvh
from atray.config import RenderSettings
from atray.core.camera import look_at_camera
from atray.render import (
    aov_preview_films,
    render,
    render_aovs,
    save_png,
)
from atray.render.film import linear_to_srgb  # noqa: F401 (see --srgb)
from atray.scene import build_scene, procedural
from atray.scene.data import Planes, Spheres, make_materials
from atray.scene.transforms import translate


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--res", default="640x360")
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--tris", type=int, default=20000)
    ap.add_argument("--out", default="demo")
    args = ap.parse_args()
    w, h = (int(v) for v in args.res.split("x"))

    mats = make_materials([
        ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),   # 0: sky
        ((0.0, 0.0, 0.0), (0.7, 0.7, 0.7), 0.0),      # 1: grey diffuse
        ((0.0, 0.0, 0.0), (0.8, 0.2, 0.2), 0.7),      # 2: red glossy
        ((4.0, 3.5, 3.0), (0.0, 0.0, 0.0), 0.0),      # 3: warm light
        ((0.0, 0.0, 0.0), (0.95, 0.95, 0.95), 1.0),   # 4: mirror
    ])
    mesh = translate(
        procedural.dragon_proxy(target_tris=args.tris, material=2),
        (0.0, -0.5, -4.0),
    )
    spheres = Spheres(
        centers=jnp.asarray([[1.8, 0.4, -5.0], [-1.8, 0.2, -4.5]], jnp.float32),
        radii=jnp.asarray([0.8, 0.7], jnp.float32),
        material_id=jnp.asarray([3, 4], jnp.int32),
    )
    planes = Planes(
        normals=jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32),
        offsets=jnp.asarray([-1.5], jnp.float32),
        material_id=jnp.asarray([1], jnp.int32),
    )
    scene = build_scene([mesh], spheres=spheres, planes=planes, materials=mats)
    accel = build_bvh(scene.mesh.vertices, scene.mesh.faces)
    cam = look_at_camera((0.0, 0.8, 1.2), (0.0, 0.0, -4.0),
                         h_fov=0.9, aspect=w / h)
    settings = RenderSettings(
        resolution=(w, h), samples_per_pixel=args.spp,
        bounce_limit=args.bounces, anti_aliasing=True,
    )

    jrender = jax.jit(lambda k: render(scene, cam, settings, k, accel=accel))
    t0 = time.perf_counter()
    film = np.asarray(jrender(jax.random.PRNGKey(0)))
    print(f"beauty {w}x{h}x{args.spp}spp: {time.perf_counter() - t0:.1f}s "
          f"(compile + render, backend={jax.default_backend()})")
    print(save_png(f"{args.out}.png", film, srgb=True))

    aovs = jax.jit(lambda s: render_aovs(s, cam, w, h, accel=accel))(scene)
    for name, f in aov_preview_films(aovs).items():
        print(save_png(f"{args.out}_{name}.png", np.asarray(f)))


if __name__ == "__main__":
    main()
