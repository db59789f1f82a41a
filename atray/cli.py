"""Command-line driver: config-file scene authoring + rendering.

Replaces the reference's hardcoded in-code scene authoring and Win32 UI
(app.cpp:59-262, SURVEY.md §2 #22): scenes are TOML files, every
RenderSettings/KDTreeConfig knob is a flag, progress streams to stderr,
output is PNG. Subcommands:

  atray render scene.toml [-o out.png] [--spp N] [--res WxH]
        [--progressive TOTAL_SPP --checkpoint ck.npz] [--srgb] [--seed S]
  atray info
  atray bench

Scene TOML (see examples/cornell.toml):
  [render]    resolution/samples_per_pixel/bounce_limit/anti_aliasing/...
  [accel]     leaf_size / sah_bins / max_depth
  [camera]    eye / look_at / h_fov
  [[materials]]  name + emission + albedo + scatter  (first entry = skybox)
  [[meshes]]     obj = path  OR  procedural = cube|uv_sphere|dragon|quad
                 + material, translate_to, scale_to, smooth, rows/cols/
                 tris, corners (quad — emissive quads become NEE area
                 lights)
  [[spheres]]    center + radius + material
  [[planes]]     normal + offset + material
  [texture]      image = path (PNG/JPG via PIL)  OR  checker = [H, W]
                 + color_a/color_b — sampled at UV-mapped faces (albedo
                 modulation); meshes need tex coords (OBJ vt records)
"""

from __future__ import annotations

import argparse
import sys
import time
import tomllib
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np


def load_scene_file(path: str):
    """Parse a scene TOML into (scene, camera, settings, accel_cfg)."""
    from atray.config import KDTreeConfig, MeshConfig, RenderSettings
    from atray.core.camera import look_at_camera
    from atray.scene import build_scene, load_obj, procedural
    from atray.scene.data import Planes, Spheres, make_materials
    from atray.scene.transforms import scale_to, translate_to

    with open(path, "rb") as fh:
        doc = tomllib.load(fh)

    import dataclasses as _dc

    rcfg = dict(doc.get("render", {}))
    known = {f.name for f in _dc.fields(RenderSettings)}
    unknown = set(rcfg) - known
    if unknown:
        raise ValueError(
            f"unknown [render] keys {sorted(unknown)}; valid: {sorted(known)}"
        )
    if "resolution" in rcfg:
        rcfg["resolution"] = tuple(rcfg["resolution"])
    settings = RenderSettings(**rcfg)

    acfg = dict(doc.get("accel", {}))
    aknown = {f.name for f in _dc.fields(KDTreeConfig)}
    aunknown = set(acfg) - aknown
    if aunknown:
        raise ValueError(
            f"unknown [accel] keys {sorted(aunknown)}; valid: {sorted(aknown)}"
        )
    accel_cfg = KDTreeConfig(**acfg)

    mcfg = dict(doc.get("mesh", {}))
    mknown = {f.name for f in _dc.fields(MeshConfig)}
    munknown = set(mcfg) - mknown
    if munknown:
        raise ValueError(
            f"unknown [mesh] keys {sorted(munknown)}; valid: {sorted(mknown)}"
        )
    mesh_cfg = MeshConfig(**mcfg)

    mat_rows = []
    mat_index: Dict[str, int] = {}
    for i, m in enumerate(doc.get("materials", [])):
        mat_index[m.get("name", f"material_{i}")] = i
        mat_rows.append(
            (
                tuple(m.get("emission", (0.0, 0.0, 0.0))),
                tuple(m.get("albedo", (0.0, 0.0, 0.0))),
                float(m.get("scatter", 0.0)),
            )
        )
    if not mat_rows:
        mat_rows = [((0.3, 0.4, 0.6), (0, 0, 0), 0.0),
                    ((0.0, 0.0, 0.0), (0.7, 0.7, 0.7), 0.0)]
        mat_index = {"sky": 0, "default": 1}
    materials = make_materials(mat_rows)

    def mat_id(name, default=1):
        return mat_index.get(name, default)

    meshes = []
    for m in doc.get("meshes", []):
        mid = mat_id(m.get("material", ""), 1)
        if "obj" in m:
            mesh = load_obj(m["obj"], default_material=mid)
        else:
            kind = m.get("procedural", "cube")
            if kind == "cube":
                mesh = procedural.cube(
                    size=float(m.get("size", 2.0)), material=mid,
                    smooth=bool(m.get("smooth", False)),
                )
            elif kind == "uv_sphere":
                mesh = procedural.uv_sphere(
                    rows=int(m.get("rows", 32)), cols=int(m.get("cols", 32)),
                    radius=float(m.get("radius", 1.0)), material=mid,
                    smooth=bool(m.get("smooth", True)),
                )
            elif kind == "dragon":
                mesh = procedural.dragon_proxy(
                    target_tris=int(m.get("tris", 139000)), material=mid,
                    smooth=bool(m.get("smooth", True)),
                )
            elif kind == "quad":
                # a two-triangle panel (area lights, walls): corners
                # counter-clockwise; emissive material -> NEE area light
                mesh = procedural.quad(
                    m["corners"][0], m["corners"][1],
                    m["corners"][2], m["corners"][3], material=mid,
                )
            else:
                raise ValueError(f"unknown procedural mesh {kind!r}")
        if "scale_to" in m:
            mesh = scale_to(mesh, float(m["scale_to"]))
        if "translate_to" in m:
            mesh = translate_to(mesh, m["translate_to"])
        meshes.append(mesh)

    sph = doc.get("spheres", [])
    spheres = None
    if sph:
        from atray.scene.data import Spheres

        spheres = Spheres(
            centers=jnp.asarray([s["center"] for s in sph], jnp.float32),
            radii=jnp.asarray([s["radius"] for s in sph], jnp.float32),
            material_id=jnp.asarray(
                [mat_id(s.get("material", "")) for s in sph], jnp.int32
            ),
        )
    pln = doc.get("planes", [])
    planes = None
    if pln:
        from atray.scene.data import Planes

        normals = np.asarray([p["normal"] for p in pln], np.float32)
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        planes = Planes(
            normals=jnp.asarray(normals),
            offsets=jnp.asarray([p["offset"] for p in pln], jnp.float32),
            material_id=jnp.asarray(
                [mat_id(p.get("material", "")) for p in pln], jnp.int32
            ),
        )

    texture = None
    tcfg = doc.get("texture", {})
    if "image" in tcfg:
        from PIL import Image

        img = Image.open(tcfg["image"]).convert("RGB")
        texture = np.asarray(img, np.float32) / 255.0
    elif "checker" in tcfg:
        th, tw = (int(x) for x in tcfg["checker"])
        ca = np.asarray(tcfg.get("color_a", (1.0, 1.0, 1.0)), np.float32)
        cb = np.asarray(tcfg.get("color_b", (0.2, 0.2, 0.2)), np.float32)
        yy, xx = np.mgrid[0:th, 0:tw]
        m = ((xx + yy) % 2).astype(np.float32)[..., None]
        texture = m * ca + (1.0 - m) * cb

    scene = build_scene(meshes, spheres=spheres, planes=planes,
                        materials=materials, texture=texture)

    ccfg = doc.get("camera", {})
    w, h = settings.resolution
    camera = look_at_camera(
        ccfg.get("eye", (0.0, 1.0, 1.0)),
        ccfg.get("look_at", (0.0, 0.0, -4.0)),
        h_fov=float(ccfg.get("h_fov", 0.9)),
        aspect=w / h,
    )
    return scene, camera, settings, accel_cfg, mesh_cfg


def cmd_render(args) -> int:
    import dataclasses

    from atray.accel.bvh import build_bvh
    from atray.render.film import save_png
    from atray.render.progressive import render_progressive
    from atray.render.wavefront import render
    from atray.utils.profiling import Phase, phase_report

    with Phase("load"):
        scene, camera, settings, accel_cfg, mesh_cfg = load_scene_file(
            args.scene
        )
        if args.spp:
            settings = dataclasses.replace(settings, samples_per_pixel=args.spp)
        if args.res:
            w, h = (int(x) for x in args.res.split("x"))
            settings = dataclasses.replace(settings, resolution=(w, h))
        if args.bounces:
            settings = dataclasses.replace(settings, bounce_limit=args.bounces)
        if args.nee:
            settings = dataclasses.replace(settings, nee=True)
        if args.sort_bounces is not None:
            settings = dataclasses.replace(
                settings, sort_bounces=args.sort_bounces
            )
        if args.chunk is not None:
            settings = dataclasses.replace(settings, ray_chunk=args.chunk)
        if args.no_accel:
            settings = dataclasses.replace(settings, use_accel=False)
    print(
        f"scene: {scene.mesh.num_faces} tris, {scene.spheres.count} spheres, "
        f"{scene.planes.count} planes; {settings.width}x{settings.height} "
        f"@ {settings.samples_per_pixel}spp x{settings.bounce_limit} bounces",
        file=sys.stderr,
    )
    with Phase("accel_build"):
        accel = (
            build_bvh(scene.mesh.vertices, scene.mesh.faces, accel_cfg)
            if scene.mesh.num_faces > 0 and settings.use_accel
            else None
        )

    dmesh = None
    mesh_n = args.mesh or mesh_cfg.num_devices  # CLI overrides [mesh] TOML
    if mesh_n:
        from atray.dist.mesh import make_device_mesh

        n_dev = None if mesh_n < 0 else mesh_n
        dmesh = make_device_mesh(num_devices=n_dev)
        print(f"device mesh: {dmesh.devices.size} device(s)", file=sys.stderr)

    if args.progressive:
        # live progress: in-flight preview PNG + stderr line per batch —
        # the headless analog of the reference's window blit + title-bar
        # tile counter (app.cpp:160-186)
        preview = args.preview or (args.output + ".preview.png")

        def on_batch(state):
            print(
                f"  batch {state.batches_done}: {state.spp_total} spp total",
                file=sys.stderr,
            )
            save_png(preview, state.film(), srgb=args.srgb)

        rfn = None
        if dmesh is not None:
            rfn = lambda sc, cam, st, key, acc: render(  # noqa: E731
                sc, cam, st, key, accel=acc, mesh=dmesh
            )
        with Phase("render", block=True):
            state = render_progressive(
                scene, camera, settings, total_spp=args.progressive,
                accel=accel, seed=args.seed,
                checkpoint_path=args.checkpoint, on_batch=on_batch,
                render_fn=rfn,
            )
        film = state.film()
    elif args.telemetry:
        # per-chunk cost table — the reference's interactive per-tile ms +
        # ray-count inspection (app.cpp:218-234), batch-mode
        from atray.render.telemetry import render_telemetry, tail_report

        key = jax.random.PRNGKey(args.seed)
        with Phase("render", block=True):
            film_d, report = render_telemetry(
                scene, camera, settings, key, accel=accel,
                n_chunks=args.telemetry,
            )
        film = np.asarray(film_d)
        per_shard = None
        if dmesh is not None:
            # shard balance probe through the sharded renderer's stats
            _, st = jax.jit(
                lambda k: render(
                    scene, camera, settings, k, accel=accel, mesh=dmesh,
                    return_stats=True,
                )
            )(key)
            per_shard = np.asarray(st["rays_cast_per_shard"])
        tail_report(report, rays_per_shard=per_shard, file=sys.stderr)
    elif args.treelet:
        # geometry-sharded render: triangles partitioned over the mesh,
        # rays ride ppermute rings (dist/treelet.py) — for scenes larger
        # than one device's memory
        from atray.dist.treelet import build_treelet_accels, render_treelet

        if dmesh is None:
            from atray.dist.mesh import make_device_mesh

            dmesh = make_device_mesh()
        n_dev = dmesh.devices.size
        print(f"treelet sharding over {n_dev} device(s)", file=sys.stderr)
        # kernel-backed per-treelet BVHs when the mesh is big enough to
        # partition; tiny scenes brute-force (the oracle backend)
        ta = None
        if scene.mesh.num_faces >= n_dev * accel_cfg.leaf_size:
            with Phase("bvh_build"):
                ta = build_treelet_accels(scene, n_dev, accel_cfg)
        key = jax.random.PRNGKey(args.seed)
        with Phase("render", block=True):
            film = np.asarray(
                render_treelet(scene, camera, settings, key, dmesh,
                               treelets=ta)
            )
    else:
        key = jax.random.PRNGKey(args.seed)
        # IN-FLIGHT progress within the single frame dispatch: a device
        # callback ticks once per ray chunk (the headless analog of the
        # reference's tiles-done title counter updating DURING the
        # render, app.cpp:174-181); chunked single-device renders only
        # (under shard_map the callback would fire per shard).
        n_chunks = (
            -(-settings.width * settings.height
              * settings.samples_per_pixel // settings.ray_chunk)
            if settings.ray_chunk else 1
        )
        done = [0]

        def _tick(live):
            done[0] += 1
            print(f"  chunk {done[0]}/{n_chunks}: "
                  f"{float(live)/1e6:.2f}M live rays traced",
                  file=sys.stderr, flush=True)

        cb = _tick if (dmesh is None and n_chunks > 1) else None
        with Phase("compile"):
            jrender = jax.jit(
                lambda k: render(
                    scene, camera, settings, k, accel=accel, mesh=dmesh,
                    progress_cb=cb,
                )
            )
            jrender.lower(key).compile()
        with Phase("render", block=True):
            film = np.asarray(jrender(key))

    with Phase("save"):
        path = save_png(args.output, film, srgb=args.srgb)
    if getattr(args, "aov", None):
        from atray.render.aov import aov_preview_films, render_aovs

        with Phase("aov"):
            films = aov_preview_films(jax.jit(
                lambda s: render_aovs(
                    s, camera, settings.width, settings.height, accel=accel
                )
            )(scene))
            for name, f in films.items():
                apath = save_png(f"{args.aov}_{name}.png", np.asarray(f))
                print(apath)
    rays = (
        settings.width * settings.height * settings.samples_per_pixel
        * settings.bounce_limit
    )
    print(phase_report(rays=rays), file=sys.stderr)
    print(path)
    return 0


def cmd_info(args) -> int:
    print(f"jax {jax.__version__}, backend {jax.default_backend()}")
    for d in jax.devices():
        print(f"  {d}")
    print(f"process {jax.process_index()} / {jax.process_count()}")
    return 0


def cmd_bench(args) -> int:
    import bench

    bench.main()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="atray", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a TOML scene to PNG")
    pr.add_argument("scene")
    pr.add_argument("-o", "--output", default="out.png")
    pr.add_argument("--spp", type=int, default=0)
    pr.add_argument("--res", default="")
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--srgb", action="store_true")
    pr.add_argument("--bounces", type=int, default=0)
    pr.add_argument("--nee", action="store_true",
                    help="next-event estimation (explicit shadow rays)")
    pr.add_argument("--sort-bounces", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="ray-queue compaction after the first diffuse "
                         "bounce (ON by default; --no-sort-bounces disables)")
    pr.add_argument("--chunk", type=int, default=None,
                    help="trace rays in chunks of this many (device memory bound)")
    pr.add_argument("--no-accel", action="store_true",
                    help="brute-force intersect (the reference's #else oracle path)")
    pr.add_argument("--mesh", type=int, default=0,
                    help="shard rays over N devices (-1 = all visible)")
    pr.add_argument("--progressive", type=int, default=0,
                    help="total spp rendered in batches of render.samples_per_pixel")
    pr.add_argument("--checkpoint", default=None,
                    help="npz checkpoint path for progressive resume")
    pr.add_argument("--preview", default=None,
                    help="in-flight preview PNG path (progressive mode)")
    pr.add_argument("--telemetry", type=int, default=0, metavar="N",
                    help="render as N timed chunks and print the per-chunk "
                         "cost / tail-latency table (per-tile ms analog)")
    pr.add_argument("--treelet", action="store_true",
                    help="shard GEOMETRY over the device mesh (rays ride "
                         "ppermute rings) — for scenes exceeding one "
                         "device's memory; combines with --mesh N")
    pr.add_argument("--aov", default=None, metavar="PREFIX",
                    help="also write AOV films (depth/normal/albedo/"
                         "emission) as PREFIX_<name>.png from one "
                         "deterministic primary pass")
    pr.set_defaults(fn=cmd_render)

    pi = sub.add_parser("info", help="show devices / runtime info")
    pi.set_defaults(fn=cmd_info)

    pb = sub.add_parser("bench", help="run the headline benchmark")
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    from atray.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
