"""Device renderer vs CPU numpy oracle (SURVEY.md §4 item 2): image allclose
on small configs of every primitive class and shading mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from atray.config import RenderSettings
from atray.core.camera import look_at_camera, camera_rays
from atray.render.wavefront import draw_bounce_uniforms, render
from atray.scene import build_scene, procedural
from atray.scene.data import Planes, Spheres, make_materials
from atray.scene.transforms import translate


MATS = make_materials([
    # 0: skybox — soft blue ambient emission
    ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),
    # 1: grey diffuse
    ((0.0, 0.0, 0.0), (0.7, 0.7, 0.7), 0.0),
    # 2: red glossy
    ((0.0, 0.0, 0.0), (0.8, 0.2, 0.2), 0.7),
    # 3: warm area light
    ((4.0, 3.5, 3.0), (0.0, 0.0, 0.0), 0.0),
    # 4: mirror
    ((0.0, 0.0, 0.0), (0.95, 0.95, 0.95), 1.0),
])


def _scene_full():
    cube = translate(procedural.cube(size=1.5, material=2), (0.0, -0.5, -4.0))
    spheres = Spheres(
        centers=jnp.asarray([[1.6, 0.2, -5.0], [-1.5, 2.0, -4.0]], jnp.float32),
        radii=jnp.asarray([0.8, 0.6], jnp.float32),
        material_id=jnp.asarray([4, 3], jnp.int32),
    )
    planes = Planes(
        normals=jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32),
        offsets=jnp.asarray([-1.5], jnp.float32),
        material_id=jnp.asarray([1], jnp.int32),
    )
    return build_scene([cube], spheres=spheres, planes=planes, materials=MATS)


def _compare(scene, w=48, h=36, spp=2, bounces=3, tol=2e-5):
    cam = look_at_camera((0.0, 0.5, 1.0), (0.0, 0.0, -4.0), h_fov=0.9, aspect=w / h)
    key = jax.random.PRNGKey(42)
    settings = RenderSettings(
        resolution=(w, h), samples_per_pixel=spp, bounce_limit=bounces,
        anti_aliasing=False, use_accel=False,
    )
    n_rays = spp * h * w
    uni = draw_bounce_uniforms(jax.random.PRNGKey(7), bounces, n_rays)

    film_dev = jax.jit(
        lambda s: render(s, cam, settings, key, uniforms=uni)
    )(scene)

    orig, dirn = camera_rays(cam, w, h, spp)
    film_ref = oracle.render_film(
        scene, orig, dirn, bounces, np.asarray(uni), spp, h, w
    )
    np.testing.assert_allclose(np.asarray(film_dev), film_ref, atol=tol)
    return np.asarray(film_dev)


def test_full_scene_matches_oracle():
    # Slightly wider tolerance: after 3 stochastic bounces XLA's fusion/fma
    # ordering shifts a handful of f32 ulps, which grows through the path.
    film = _compare(_scene_full(), tol=1e-3)
    # sanity: the image is not a constant field
    assert film.std() > 0.01


def test_mesh_only_flat_shading():
    cube = translate(procedural.cube(size=1.5, material=1), (0.0, 0.0, -4.0))
    scene = build_scene([cube], materials=MATS)
    _compare(scene)


def test_mesh_smooth_shading():
    sph = translate(
        procedural.uv_sphere(rows=12, cols=12, material=2, smooth=True),
        (0.0, 0.0, -4.0),
    )
    scene = build_scene([sph], materials=MATS)
    _compare(scene)


def test_sky_only():
    scene = build_scene([], materials=MATS)
    film = _compare(scene, bounces=2)
    np.testing.assert_allclose(film[0, 0], [0.35, 0.45, 0.65], atol=1e-6)


def test_single_bounce_deterministic():
    # bounce_limit=1: no stochastic jitter affects the image (first
    # intersection + emission only), so two different keys must agree.
    scene = _scene_full()
    cam = look_at_camera((0.0, 0.5, 1.0), (0.0, 0.0, -4.0), h_fov=0.9, aspect=4 / 3)
    s = RenderSettings(resolution=(32, 24), samples_per_pixel=1, bounce_limit=1,
                       use_accel=False)
    f1 = render(scene, cam, s, jax.random.PRNGKey(0))
    f2 = render(scene, cam, s, jax.random.PRNGKey(99))
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f2), atol=1e-7)


def test_spp_averaging_reduces_variance():
    scene = _scene_full()
    cam = look_at_camera((0.0, 0.5, 1.0), (0.0, 0.0, -4.0), h_fov=0.9, aspect=1.0)
    lo = RenderSettings(resolution=(24, 24), samples_per_pixel=2, bounce_limit=4,
                        use_accel=False)
    hi = RenderSettings(resolution=(24, 24), samples_per_pixel=32, bounce_limit=4,
                        use_accel=False)
    films_lo = [
        np.asarray(render(scene, cam, lo, jax.random.PRNGKey(k))) for k in range(4)
    ]
    films_hi = [
        np.asarray(render(scene, cam, hi, jax.random.PRNGKey(k))) for k in range(4)
    ]
    var_lo = np.var(np.stack(films_lo), axis=0).mean()
    var_hi = np.var(np.stack(films_hi), axis=0).mean()
    assert var_hi < var_lo


def test_nee_matches_oracle():
    # shadow-ray path (BASELINE config 2): device NEE vs the numpy oracle,
    # same 6-channel uniforms
    import dataclasses

    scene = _scene_full()
    w, h, spp, bounces = 32, 24, 2, 3
    cam = look_at_camera((0.0, 0.5, 1.0), (0.0, 0.0, -4.0), h_fov=0.9, aspect=w / h)
    settings = RenderSettings(
        resolution=(w, h), samples_per_pixel=spp, bounce_limit=bounces, nee=True,
    )
    n_rays = spp * h * w
    from atray.render.wavefront import draw_bounce_uniforms

    uni = draw_bounce_uniforms(jax.random.PRNGKey(7), bounces, n_rays, channels=6)
    film_dev = render(scene, cam, settings, jax.random.PRNGKey(1), uniforms=uni)
    orig, dirn = camera_rays(cam, w, h, spp)
    film_ref = oracle.render_film(
        scene, orig, dirn, bounces, np.asarray(uni), spp, h, w, nee=True
    )
    # Tight tolerance with a small OUTLIER ALLOWANCE (ADVICE r4): discrete
    # boundary flips (occlusion t < dist-eps, light pick) where the
    # oracle's numpy math promotes to f64 and rounds the opposite way from
    # the device's f32 flip a handful of pixels by up to a single
    # spp-averaged direct-light term (round 4: 3/2304 pixels with the
    # murmur-hash stream). A loosened global atol would also have admitted
    # a SYSTEMATIC ~5e-4 shading error anywhere in the film; counting
    # outliers keeps boundary flips passing while drift still fails.
    diff = np.abs(np.asarray(film_dev) - film_ref)
    assert (diff > 2e-4).sum() <= 3 * 5, (
        f"{(diff > 2e-4).sum()} channel values beyond atol=2e-4 "
        f"(max |diff| = {diff.max():.3e})"
    )
    assert diff.max() <= 1e-2


def test_nee_reduces_variance_of_small_light():
    # A small bright emitter: NEE images across keys must agree with each
    # other far better than brute-force path tracing does (shadow rays
    # collapse the light-sampling variance).
    import dataclasses

    mats = make_materials([
        ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 0.0),      # black sky
        ((0.0, 0.0, 0.0), (0.7, 0.7, 0.7), 0.0),      # diffuse floor
        ((60.0, 60.0, 60.0), (0.0, 0.0, 0.0), 0.0),   # small bright light
    ])
    planes = Planes(
        normals=jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32),
        offsets=jnp.asarray([-1.0], jnp.float32),
        material_id=jnp.asarray([1], jnp.int32),
    )
    spheres = Spheres(
        centers=jnp.asarray([[0.0, 2.5, -4.0]], jnp.float32),
        radii=jnp.asarray([0.15], jnp.float32),
        material_id=jnp.asarray([2], jnp.int32),
    )
    scene = build_scene([], spheres=spheres, planes=planes, materials=mats)
    cam = look_at_camera((0.0, 0.5, 0.0), (0.0, -0.2, -4.0), h_fov=0.8, aspect=1.0)
    base = RenderSettings(resolution=(16, 16), samples_per_pixel=4, bounce_limit=3)
    nee_s = dataclasses.replace(base, nee=True)

    def spread(settings):
        films = [
            np.asarray(render(scene, cam, settings, jax.random.PRNGKey(k)))
            for k in range(4)
        ]
        return np.var(np.stack(films), axis=0).mean()

    v_pt = spread(base)
    v_nee = spread(nee_s)
    assert v_nee < v_pt * 0.5, (v_nee, v_pt)


def _area_light_scene():
    # a cube receiver on a floor, lit by an emissive QUAD panel (two
    # triangles) — the round-5 area-light NEE configuration
    mats = make_materials([
        ((0.02, 0.02, 0.03), (0.0, 0.0, 0.0), 0.0),   # dim sky
        ((0.0, 0.0, 0.0), (0.7, 0.6, 0.5), 0.1),      # cube
        ((0.0, 0.0, 0.0), (0.6, 0.6, 0.6), 0.0),      # floor (plane)
        ((25.0, 22.0, 18.0), (0.0, 0.0, 0.0), 0.0),   # light panel
    ])
    from atray.scene.transforms import translate

    cube = translate(procedural.cube(size=1.2, material=1), (0.0, -0.4, -4.0))
    panel = procedural.quad(
        (-0.6, 1.6, -4.6), (0.6, 1.6, -4.6), (0.6, 1.6, -3.4),
        (-0.6, 1.6, -3.4), material=3,
    )
    planes = Planes(
        normals=jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32),
        offsets=jnp.asarray([-1.0], jnp.float32),
        material_id=jnp.asarray([2], jnp.int32),
    )
    return build_scene([cube, panel], planes=planes, materials=mats)


def test_nee_area_light_matches_oracle():
    # emissive-TRIANGLE lights (round 5): device NEE vs the numpy
    # oracle, same 6-channel uniforms — the oracle-parity test VERDICT
    # r4 next #7 asks for
    scene = _area_light_scene()
    w, h, spp, bounces = 32, 24, 2, 3
    cam = look_at_camera((0.0, 0.6, 0.2), (0.0, -0.2, -4.0), h_fov=0.9,
                         aspect=w / h)
    settings = RenderSettings(
        resolution=(w, h), samples_per_pixel=spp, bounce_limit=bounces,
        nee=True,
    )
    n_rays = spp * h * w
    from atray.render.wavefront import draw_bounce_uniforms

    uni = draw_bounce_uniforms(jax.random.PRNGKey(9), bounces, n_rays,
                               channels=6)
    film_dev = render(scene, cam, settings, jax.random.PRNGKey(1),
                      uniforms=uni)
    orig, dirn = camera_rays(cam, w, h, spp)
    film_ref = oracle.render_film(
        scene, orig, dirn, bounces, np.asarray(uni), spp, h, w, nee=True
    )
    diff = np.abs(np.asarray(film_dev) - film_ref)
    assert (diff > 2e-4).sum() <= 3 * 5, (
        f"{(diff > 2e-4).sum()} channel values beyond 2e-4 "
        f"(max {diff.max():.3e})"
    )
    assert diff.max() <= 2e-2
    # the light actually contributes (shadowed floor vs lit floor)
    assert np.asarray(film_dev).max() > 0.05


def test_nee_area_light_reduces_variance():
    # NEE to a SMALL bright triangle must collapse light-sampling
    # variance vs brute-force path tracing (the area-light twin of
    # test_nee_reduces_variance_of_small_light)
    import dataclasses

    mats = make_materials([
        ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.7, 0.7, 0.7), 0.0),
        ((400.0, 400.0, 400.0), (0.0, 0.0, 0.0), 0.0),
    ])
    panel = procedural.quad(
        (-0.15, 2.5, -4.15), (0.15, 2.5, -4.15), (0.15, 2.5, -3.85),
        (-0.15, 2.5, -3.85), material=2,
    )
    planes = Planes(
        normals=jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32),
        offsets=jnp.asarray([-1.0], jnp.float32),
        material_id=jnp.asarray([1], jnp.int32),
    )
    scene = build_scene([panel], planes=planes, materials=mats)
    cam = look_at_camera((0.0, 0.5, 0.0), (0.0, -0.2, -4.0), h_fov=0.8,
                         aspect=1.0)
    base = RenderSettings(resolution=(24, 24), samples_per_pixel=2,
                          bounce_limit=3)

    def films(nee):
        s = dataclasses.replace(base, nee=nee)
        return np.stack([
            np.asarray(render(scene, cam, s, jax.random.PRNGKey(k)))
            for k in range(4)
        ])

    f_nee = films(True)
    f_pt = films(False)
    var_nee = np.var(f_nee, axis=0).mean()
    var_pt = np.var(f_pt, axis=0).mean()
    assert f_nee.mean() > 1e-3          # light reaches the floor
    assert var_nee < var_pt * 0.5       # and variance collapses


def _textured_scene():
    # a UV-mapped quad floor patch with a checker texture (round 5,
    # beyond parity: the reference stores tex coords and never samples
    # them — model.h:13-28)
    from atray.scene.data import TriMesh

    v = np.asarray([[-2.0, -1.0, -2.5], [2.0, -1.0, -2.5],
                    [2.0, -1.0, -6.5], [-2.0, -1.0, -6.5]], np.float32)
    f = np.asarray([(0, 1, 2), (0, 2, 3)], np.int32)
    uv = np.asarray([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]],
                    np.float32)
    fuv = np.asarray([(0, 1, 2), (0, 2, 3)], np.int32)
    mesh = TriMesh(
        vertices=v, faces=f,
        normals=np.zeros((1, 3), np.float32),
        face_normal_idx=np.full((2, 3), -1, np.int32),
        tex_coords=uv, face_tex_idx=fuv,
        material_id=np.ones((2,), np.int32),
    )
    yy, xx = np.mgrid[0:8, 0:8]
    checker = ((xx + yy) % 2).astype(np.float32)
    tex = np.stack([checker, 0.5 * checker + 0.25,
                    1.0 - checker], axis=-1)
    mats = make_materials([
        ((0.4, 0.45, 0.6), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.9, 0.9, 0.9), 0.0),
    ])
    return build_scene([mesh], materials=mats, texture=tex)


def test_textured_albedo_matches_oracle():
    scene = _textured_scene()
    film = _compare(scene, bounces=2, tol=1e-4)
    # the checker actually shows up: strong spatial variance on the quad
    assert film.std() > 0.05


def test_textured_albedo_with_accel_matches_brute():
    # textured scenes take the hit kernel too; the texture lookup rides
    # the same face-table resolve
    from atray.accel.bvh import build_bvh
    from atray.config import KDTreeConfig

    scene = _textured_scene()
    cam = look_at_camera((0.0, 0.5, 1.0), (0.0, 0.0, -4.0), h_fov=0.9,
                         aspect=4 / 3)
    st = RenderSettings(resolution=(48, 36), samples_per_pixel=1,
                        bounce_limit=2, sort_bounces=False)
    accel = build_bvh(scene.mesh.vertices, scene.mesh.faces,
                      KDTreeConfig(leaf_size=4))
    key = jax.random.PRNGKey(3)
    f_brute = np.asarray(render(scene, cam, st, key))
    f_accel = np.asarray(render(scene, cam, st, key, accel=accel))
    np.testing.assert_allclose(f_accel, f_brute, atol=1e-6)


def test_texture_gradient_flows_to_texels():
    scene = _textured_scene()
    cam = look_at_camera((0.0, 0.5, 1.0), (0.0, 0.0, -4.0), h_fov=0.9,
                         aspect=1.0)
    st = RenderSettings(resolution=(24, 24), samples_per_pixel=1,
                        bounce_limit=2)
    key = jax.random.PRNGKey(0)
    import dataclasses

    def loss(tex):
        sc = dataclasses.replace(scene, texture=tex)
        return jnp.sum(render(sc, cam, st, key))

    g = jax.grad(loss)(scene.texture)
    assert float(jnp.abs(g).max()) > 1e-4     # texels receive gradient
    assert bool(jnp.all(jnp.isfinite(g)))
