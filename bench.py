"""Headline benchmark: live rays/s on the Dragon-tier scene, on the GPU.

Prints ONE JSON line on stdout:
  {"metric": "live_rays_per_sec", "value": N, "unit": "rays/s",
   "device": {"platform": ..., "kind": ..., "count": ..., "card": ...}}
and a detail line on stderr. ``card`` is ``nvidia-smi``'s name and power
limit: a card set below its maximum power runs slower under load, so every
number is kept beside it. Timing refuses to run on any platform but ``gpu``.

Ray accounting:
- live rays ("rays_cast"): paths actually alive entering each bounce — the
  reference's RenderTile.ray_casts counter semantics (renderer.cpp:345,355).
  This is the HEADLINE number.
- work rays: W*H*spp*bounces — every lane at every bounce, dead or alive;
  reported as ``work_rays_per_sec`` for lane-efficiency context.

Configuration defaults to the BASELINE config-4 headline (1920x1080, 64 spp,
5 bounces, 139k-tri dragon proxy over a floor plane): one jitted frame in
one dispatch, rays chunked through ``lax.map`` to bound device memory.

Env knobs: ATRAY_BENCH_SPP, ATRAY_BENCH_RES, ATRAY_BENCH_TRIS,
ATRAY_BENCH_REPS, ATRAY_BENCH_BOUNCES, ATRAY_BENCH_LEAF, ATRAY_BENCH_CHUNK,
ATRAY_BENCH_SORT, ATRAY_BENCH_BWD. ``python bench.py --ladder [N ...]``
renders BASELINE.md's configs 1-4 instead.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import jax
import jax.numpy as jnp

HEADLINE_CHUNK = 2 * 1920 * 1080


def device_info() -> dict:
    """The device the numbers were taken on, as JAX and nvidia-smi see it."""
    from atray.utils.profiling import gpu_card

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": gpu_card()}


def require_gpu() -> None:
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"bench times the GPU only; JAX found {platform!r}")


def headline_scene(tris: int = 139_000):
    """(scene, camera_for(w, h)): the dragon proxy at ``tris`` triangles over
    a floor plane — BASELINE config 4's scene."""
    from atray.core.camera import look_at_camera
    from atray.scene import build_scene, procedural
    from atray.scene.data import Planes, make_materials
    from atray.scene.transforms import translate

    mats = make_materials([
        ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.75, 0.55, 0.35), 0.15),
        ((0.0, 0.0, 0.0), (0.6, 0.6, 0.65), 0.0),
    ])
    dragon = translate(
        procedural.dragon_proxy(target_tris=tris, material=1), (0.0, 0.0, -4.0)
    )
    planes = Planes(
        normals=jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32),
        offsets=jnp.asarray([-1.8], jnp.float32),
        material_id=jnp.asarray([2], jnp.int32),
    )
    scene = build_scene([dragon], planes=planes, materials=mats)

    def camera_for(w, h):
        return look_at_camera((0.0, 1.0, 0.8), (0.0, 0.0, -4.0), h_fov=0.9,
                              aspect=w / h)

    return scene, camera_for


def _timed(fn, reps):
    """Wall times of ``reps`` calls of ``fn(i)``, each ended by
    block_until_ready."""
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(i))
        times.append(time.perf_counter() - t0)
    return times


def run_ladder(configs=None, out_path="results/ladder.json") -> None:
    """Render the BASELINE config ladder (BASELINE.md configs 1-4) and write
    one regenerable artifact (``results/`` is not committed).

    1. Cube.obj,   256x256,  1 spp, single bounce, FLAT intersect (no tree)
    2. Monkey.obj, 512x512,  4 spp, tree traversal + NEE shadow rays
    3. Deer.obj,  1280x720, 16 spp, 3-bounce path trace + compaction
    4. Dragon(139k proxy), 1920x1080, 64 spp, 5 bounces — the headline

    Real assets are used where the reference ships them (Cube/Deer/
    Monkey); Dragon.obj is a missing blob upstream, so config 4 uses the
    139k-tri procedural proxy. Timing: jitted full-frame dispatches, median
    of ``ATRAY_BENCH_REPS``.
    """
    from atray.accel.bvh import build_bvh
    from atray.config import RenderSettings
    from atray.core.camera import look_at_camera
    from atray.render.wavefront import render
    from atray.scene import build_scene, load_obj, procedural
    from atray.scene.data import Planes, Spheres, make_materials
    from atray.scene.transforms import scale_to, translate, translate_to
    from atray.utils.compile_cache import enable_compile_cache

    require_gpu()
    enable_compile_cache()
    device = device_info()
    assets = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "assets")
    reps = int(os.environ.get("ATRAY_BENCH_REPS", "3"))
    mats = make_materials([
        ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),   # sky
        ((0.0, 0.0, 0.0), (0.75, 0.55, 0.35), 0.15),  # body
        ((0.0, 0.0, 0.0), (0.6, 0.6, 0.65), 0.0),     # floor
        ((9.0, 8.5, 7.0), (0.0, 0.0, 0.0), 0.0),      # light
    ])
    floor = Planes(
        normals=jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32),
        offsets=jnp.asarray([-1.8], jnp.float32),
        material_id=jnp.asarray([2], jnp.int32),
    )
    light = Spheres(
        centers=jnp.asarray([[2.5, 3.0, -2.5]], jnp.float32),
        radii=jnp.asarray([0.6], jnp.float32),
        material_id=jnp.asarray([3], jnp.int32),
    )

    def place(mesh):
        return translate_to(scale_to(mesh, 2.4), (0.0, -0.3, -4.0))

    def cfg_scene(n):
        if n == 1:
            mesh = place(load_obj(os.path.join(assets, "Cube.obj")))
            scene = build_scene([mesh], materials=mats)
            st = RenderSettings(resolution=(256, 256), samples_per_pixel=1,
                                bounce_limit=1, sort_bounces=False)
            return scene, st, False, "Cube.obj"
        if n == 2:
            mesh = place(load_obj(os.path.join(assets, "Monkey.obj")))
            scene = build_scene([mesh], planes=floor, spheres=light,
                                materials=mats)
            st = RenderSettings(resolution=(512, 512), samples_per_pixel=4,
                                bounce_limit=3, nee=True)
            return scene, st, True, "Monkey.obj"
        if n == 3:
            mesh = place(load_obj(os.path.join(assets, "Deer.obj")))
            scene = build_scene([mesh], planes=floor, materials=mats)
            st = RenderSettings(resolution=(1280, 720), samples_per_pixel=16,
                                bounce_limit=3, sort_bounces=True)
            return scene, st, True, "Deer.obj"
        if n == 4:
            mesh = translate(
                procedural.dragon_proxy(target_tris=139_000, material=1),
                (0.0, 0.0, -4.0),
            )
            scene = build_scene([mesh], planes=floor, materials=mats)
            st = RenderSettings(
                resolution=(1920, 1080), samples_per_pixel=64,
                bounce_limit=5, ray_chunk=HEADLINE_CHUNK, sort_bounces=True,
            )
            return scene, st, True, "dragon_proxy(139k)"
        raise ValueError(n)

    results = []
    for n in configs or (1, 2, 3, 4):
        scene, st, use_accel, asset = cfg_scene(n)
        accel = (build_bvh(scene.mesh.vertices, scene.mesh.faces)
                 if use_accel else None)
        w, h = st.resolution
        cam = look_at_camera((0.0, 1.0, 0.8), (0.0, -0.2, -4.0),
                             h_fov=0.9, aspect=w / h)
        jf = jax.jit(lambda key, s=scene, c=cam, t=st, a=accel: render(
            s, c, t, key, accel=a, return_stats=True))
        _, stats = jax.block_until_ready(jf(jax.random.PRNGKey(0)))
        live_rays = float(stats["rays_cast"])
        times = _timed(lambda i: jf(jax.random.PRNGKey(i + 1)), reps)
        med = statistics.median(times)
        row = {
            "config": n,
            "asset": asset,
            "tris": int(scene.mesh.num_faces),
            "resolution": [w, h],
            "spp": st.samples_per_pixel,
            "bounces": st.bounce_limit,
            "nee": bool(st.nee),
            "compaction": bool(st.sort_bounces),
            "accel": "bvh" if use_accel else "none (flat)",
            "frame_s_median": med,
            "frame_s": times,
            "live_rays": live_rays,
            "live_rays_per_sec": live_rays / med,
            "device": device,
        }
        results.append(row)
        print(json.dumps(row))

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump({"command": "python bench.py --ladder", "device": device,
                   "configs": results}, fh, indent=1)
    print(f"wrote {out_path}", file=sys.stderr)


def main() -> None:
    from atray.accel.bvh import build_bvh
    from atray.config import KDTreeConfig, RenderSettings
    from atray.render.wavefront import render
    from atray.utils.compile_cache import enable_compile_cache

    require_gpu()
    enable_compile_cache()
    device = device_info()
    print(f"device: {device}", file=sys.stderr)

    spp = int(os.environ.get("ATRAY_BENCH_SPP", "64"))
    res = os.environ.get("ATRAY_BENCH_RES", "1920x1080")
    tris = int(os.environ.get("ATRAY_BENCH_TRIS", "139000"))
    reps = int(os.environ.get("ATRAY_BENCH_REPS", "3"))
    bounces = int(os.environ.get("ATRAY_BENCH_BOUNCES", "5"))
    leaf = int(os.environ.get("ATRAY_BENCH_LEAF",
                              str(KDTreeConfig().leaf_size)))
    chunk = int(os.environ.get("ATRAY_BENCH_CHUNK", str(HEADLINE_CHUNK)))
    sort = os.environ.get("ATRAY_BENCH_SORT", "1") == "1"
    w, h = (int(x) for x in res.split("x"))

    t0 = time.perf_counter()
    scene, camera_for = headline_scene(tris)
    cam = camera_for(w, h)
    t_mesh = time.perf_counter() - t0

    t0 = time.perf_counter()
    accel = build_bvh(scene.mesh.vertices, scene.mesh.faces,
                      KDTreeConfig(leaf_size=leaf))
    t_build = time.perf_counter() - t0

    settings = RenderSettings(
        resolution=(w, h), samples_per_pixel=spp, bounce_limit=bounces,
        ray_chunk=chunk, sort_bounces=sort,
    )
    jframe = jax.jit(
        lambda key: render(
            scene, cam, settings, key, accel=accel, return_stats=True
        )
    )

    # compile_s is COMPILE ONLY; every timed call then runs the executable
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    jframe_c = jframe.lower(key).compile()
    t_compile = time.perf_counter() - t0

    _, stats = jax.block_until_ready(jframe_c(key))
    live_rays = float(stats["rays_cast"])
    times = _timed(lambda i: jframe_c(jax.random.PRNGKey(i + 1)), reps)
    med = statistics.median(times)

    work_rays = w * h * spp * bounces
    live_per_sec = live_rays / med / jax.device_count()

    # backward/forward time ratio (BASELINE metric) at the dragon tier:
    # 960x540 x 4spp x 3 bounces, remat'd scan
    bw_settings = RenderSettings(
        resolution=(960, 540), samples_per_pixel=4, bounce_limit=3,
    )
    bkey = jax.random.PRNGKey(3)

    def fwd(params, k):
        sc = scene.with_params(params)
        return jnp.sum(render(sc, cam, bw_settings, k, accel=accel))

    t_f = t_b = bwd_fwd_ratio = float("nan")
    if os.environ.get("ATRAY_BENCH_BWD", "1") == "1":
        params = scene.params()
        jf = jax.jit(fwd)
        jg = jax.jit(jax.grad(fwd))
        jax.block_until_ready(jf(params, bkey))
        jax.block_until_ready(jg(params, bkey))
        t_f = statistics.median(
            _timed(lambda i: jf(params, jax.random.fold_in(bkey, i)), reps))
        t_b = statistics.median(
            _timed(lambda i: jg(params, jax.random.fold_in(bkey, i)), reps))
        bwd_fwd_ratio = t_b / t_f

    print(json.dumps({
        "metric": "live_rays_per_sec",
        "value": live_per_sec,
        "unit": "rays/s",
        "device": device,
    }))
    print(json.dumps({"detail": {
        "resolution": [w, h],
        "spp": spp,
        "bounces": bounces,
        "tris": int(scene.mesh.num_faces),
        "bvh_nodes": int(accel.num_nodes),
        "leaf_size": leaf,
        "sort_bounces": sort,
        "mesh_gen_s": t_mesh,
        "bvh_build_s": t_build,
        "compile_s": t_compile,
        "frame_s_median": med,
        "frame_s": times,
        "live_rays": live_rays,
        "work_rays": work_rays,
        "work_rays_per_sec": work_rays / med,
        "backward_forward_ratio": bwd_fwd_ratio,
        "forward_s_960x540x4spp": t_f,
        "backward_s_960x540x4spp": t_b,
        "device": device,
    }}), file=sys.stderr)


if __name__ == "__main__":
    if "--ladder" in sys.argv:
        cfgs = [int(a) for a in sys.argv[1:] if a.isdigit()] or None
        run_ladder(cfgs)
    else:
        main()
