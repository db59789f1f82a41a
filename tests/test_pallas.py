"""Renders through the per-ray hit kernel (interpret mode on CPU) vs brute
force (the A/B pattern of SURVEY.md §4), plus ray-ordering round trips."""

import jax
import jax.numpy as jnp
import numpy as np

from atray.accel.bvh import build_bvh
from atray.accel.traverse import bvh_first_hit
from atray.config import KDTreeConfig, RenderSettings
from atray.core.camera import camera_rays, look_at_camera
from atray.kernels.bvh_hit import first_hit
from atray.render.wavefront import (
    from_tile_order,
    render,
    to_tile_order,
)
from atray.scene import build_scene, procedural
from atray.scene.data import make_materials
from atray.scene.transforms import translate


def _rays(rng, n):
    orig = jnp.asarray(rng.uniform(-3, 3, (n, 3)), jnp.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return orig, jnp.asarray(d, jnp.float32)


def test_pad_slots_never_hit(rng):
    # leaf_size larger than the triangle count forces pad slots everywhere
    v = jnp.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], jnp.float32)
    f = jnp.asarray([[0, 1, 2]], jnp.int32)
    bvh = build_bvh(v, f, KDTreeConfig(leaf_size=8))
    orig, dirn = _rays(rng, 1024)
    t1, _, _, i1 = bvh_first_hit(bvh, None, orig, dirn)
    t2, i2 = first_hit(bvh, orig, dirn)
    np.testing.assert_array_equal(np.asarray(i2), np.asarray(i1))
    assert set(np.unique(np.asarray(i2))) <= {-1, 0}


def test_tile_order_round_trip():
    w, h, spp = 48, 36, 3
    x = jnp.arange(spp * h * w * 3, dtype=jnp.float32).reshape(-1, 3)
    y = from_tile_order(to_tile_order(x, w, h, spp), w, h, spp)
    np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


def test_render_with_pallas_accel_matches_brute():
    mats = make_materials([
        ((0.4, 0.5, 0.7), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.8, 0.6, 0.4), 0.2),
    ])
    mesh = translate(procedural.uv_sphere(rows=10, cols=10, material=1), (0, 0, -4))
    scene = build_scene([mesh], materials=mats)
    bvh = build_bvh(scene.mesh.vertices, scene.mesh.faces, KDTreeConfig(leaf_size=8))
    cam = look_at_camera((0, 0.4, 0.5), (0, 0, -4), h_fov=0.8, aspect=1.0)
    s = RenderSettings(resolution=(24, 24), samples_per_pixel=1, bounce_limit=2)
    key = jax.random.PRNGKey(5)
    film_bf = render(scene, cam, s, key, accel=None)
    film_pl = render(scene, cam, s, key, accel=bvh)
    np.testing.assert_allclose(
        np.asarray(film_pl), np.asarray(film_bf), atol=2e-5
    )


def test_render_chunked_matches_unchunked_shape():
    mats = make_materials([
        ((0.4, 0.5, 0.7), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.8, 0.6, 0.4), 0.2),
    ])
    mesh = translate(procedural.cube(material=1), (0, 0, -4))
    scene = build_scene([mesh], materials=mats)
    cam = look_at_camera((0, 0.4, 0.5), (0, 0, -4), h_fov=0.8, aspect=1.0)
    import dataclasses

    s = RenderSettings(resolution=(16, 16), samples_per_pixel=2, bounce_limit=1)
    sc = dataclasses.replace(s, ray_chunk=100)
    # bounce_limit=1 is deterministic -> chunked == unchunked exactly
    f1 = render(scene, cam, s, jax.random.PRNGKey(0))
    f2 = render(scene, cam, sc, jax.random.PRNGKey(0))
    np.testing.assert_allclose(np.asarray(f2), np.asarray(f1), atol=1e-6)


def test_sorted_bounces_identical_with_explicit_uniforms():
    # compaction is a pure permutation: with explicit uniforms (permuted
    # alongside the rays) the image must be EXACTLY the unsorted one
    import dataclasses

    from atray.render.wavefront import draw_bounce_uniforms

    mats = make_materials([
        ((0.4, 0.5, 0.7), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.8, 0.6, 0.4), 0.3),
    ])
    mesh = translate(procedural.uv_sphere(rows=10, cols=10, material=1), (0, 0, -4))
    scene = build_scene([mesh], materials=mats)
    cam = look_at_camera((0, 0.4, 0.5), (0, 0, -4), h_fov=0.8, aspect=1.0)
    s = RenderSettings(resolution=(16, 16), samples_per_pixel=2, bounce_limit=4)
    ss = dataclasses.replace(s, sort_bounces=True)
    n = 2 * 16 * 16
    uni = draw_bounce_uniforms(jax.random.PRNGKey(11), 4, n)
    key = jax.random.PRNGKey(0)
    f1 = render(scene, cam, s, key, uniforms=uni)
    f2 = render(scene, cam, ss, key, uniforms=uni)
    np.testing.assert_allclose(np.asarray(f2), np.asarray(f1), atol=1e-6)


def test_rays_cast_counter():
    # parity with the reference's total-rays metric: counts live paths
    # entering each bounce; sky-only scene -> exactly R (all die at bounce 0)
    from atray.core.camera import camera_rays
    from atray.render.wavefront import trace_radiance

    mats = make_materials([((0.3, 0.4, 0.6), (0, 0, 0), 0.0),
                           ((0, 0, 0), (0.7, 0.7, 0.7), 0.0)])
    empty = build_scene([], materials=mats)
    cam = look_at_camera((0, 0, 0), (0, 0, -4), h_fov=0.8, aspect=1.0)
    orig, dirn = camera_rays(cam, 8, 8, spp=1)
    _, stats = trace_radiance(
        empty, orig, dirn, 4, key=jax.random.PRNGKey(0), return_stats=True
    )
    assert float(stats["rays_cast"]) == 64.0

    cube_scene = build_scene(
        [translate(procedural.cube(material=1), (0, 0, -4))], materials=mats
    )
    _, stats2 = trace_radiance(
        cube_scene, orig, dirn, 4, key=jax.random.PRNGKey(0), return_stats=True
    )
    # hitting rays survive into later bounces -> more casts than sky-only
    assert float(stats2["rays_cast"]) > 64.0


def test_fused_shaded_render_matches_standard():
    # the hit kernel + face-table resolve must reproduce the brute-force
    # image to fp tolerance on a mixed scene (smooth mesh, sphere, plane)
    from atray.scene.data import Planes, Spheres

    mats = make_materials([
        ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.8, 0.5, 0.3), 0.2),
        ((2.0, 1.5, 1.0), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.5, 0.6, 0.7), 0.0),
    ])
    mesh = translate(
        procedural.uv_sphere(rows=12, cols=12, material=1, smooth=True),
        (0, 0, -4),
    )
    spheres = Spheres(
        centers=np.asarray([[1.5, 1.0, -3.5]], np.float32),
        radii=np.asarray([0.5], np.float32),
        material_id=np.asarray([2], np.int32),
    )
    planes = Planes(
        normals=np.asarray([[0.0, 1.0, 0.0]], np.float32),
        offsets=np.asarray([-1.4], np.float32),
        material_id=np.asarray([3], np.int32),
    )
    scene = build_scene([mesh], spheres=spheres, planes=planes, materials=mats)
    bvh = build_bvh(scene.mesh.vertices, scene.mesh.faces,
                    KDTreeConfig(leaf_size=8))
    cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
    s = RenderSettings(resolution=(24, 24), samples_per_pixel=2, bounce_limit=3)
    key = jax.random.PRNGKey(5)
    f_std = render(scene, cam, s, key, accel=None)
    f_fused = render(scene, cam, s, key, accel=bvh)
    np.testing.assert_allclose(
        np.asarray(f_fused), np.asarray(f_std), atol=5e-5
    )


def test_fused_shaded_nee_matches_standard():
    # NEE shadow rays take the hit kernel too
    from atray.scene.data import Planes, Spheres

    mats = make_materials([
        ((0.05, 0.05, 0.08), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.7, 0.7, 0.7), 0.0),
        ((20.0, 18.0, 15.0), (0.0, 0.0, 0.0), 0.0),
    ])
    mesh = translate(procedural.cube(material=1), (0, 0, -4))
    spheres = Spheres(
        centers=np.asarray([[0.0, 2.5, -4.0]], np.float32),
        radii=np.asarray([0.3], np.float32),
        material_id=np.asarray([2], np.int32),
    )
    planes = Planes(
        normals=np.asarray([[0.0, 1.0, 0.0]], np.float32),
        offsets=np.asarray([-1.2], np.float32),
        material_id=np.asarray([1], np.int32),
    )
    scene = build_scene([mesh], spheres=spheres, planes=planes, materials=mats)
    bvh = build_bvh(scene.mesh.vertices, scene.mesh.faces,
                    KDTreeConfig(leaf_size=8))
    cam = look_at_camera((0, 0.6, 0.8), (0, 0, -4), h_fov=0.9, aspect=1.0)
    s = RenderSettings(resolution=(20, 20), samples_per_pixel=1,
                       bounce_limit=3, nee=True)
    key = jax.random.PRNGKey(2)
    f_std = render(scene, cam, s, key, accel=None)
    f_fused = render(scene, cam, s, key, accel=bvh)
    np.testing.assert_allclose(
        np.asarray(f_fused), np.asarray(f_std), atol=5e-5
    )
