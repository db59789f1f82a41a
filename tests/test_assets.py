"""Real-asset end-to-end validation (VERDICT r1 missing #1).

The reference renders actual OBJ files from its Assets/ directory
(app.cpp:65-66; Cube 12 tris, Deer 1,570 tris, Monkey 3,936 tris). These
tests load the SAME files through both OBJ parsers and push them through
the full device render path — accel kernels against the brute-force numpy
oracle — so the parsers and the traversal are validated on geometry they
did not write themselves.
"""

import os

import jax
import numpy as np
import pytest

import oracle
from atray.config import KDTreeConfig, RenderSettings
from atray.core.camera import camera_rays, look_at_camera
from atray.render.wavefront import draw_bounce_uniforms, render
from atray.scene import build_scene, load_obj
from atray.scene.data import make_materials
from atray.scene.transforms import get_aabb, scale_to, translate_to

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")

MATS = make_materials([
    ((0.45, 0.55, 0.75), (0.0, 0.0, 0.0), 0.0),   # skybox
    ((0.0, 0.0, 0.0), (0.75, 0.6, 0.45), 0.25),   # body
])


def _asset(name):
    path = os.path.join(ASSETS, name)
    if not os.path.exists(path):
        pytest.skip(f"asset {name} not present")
    return path


@pytest.mark.parametrize(
    "name,tris,verts",
    [("Cube.obj", 12, 8), ("Deer.obj", 1570, 832), ("Monkey.obj", 3936, 2012)],
)
def test_reference_assets_load(name, tris, verts):
    # Face/vertex counts from the reference snapshot (BASELINE.md ladder).
    mesh = load_obj(_asset(name), backend="python")
    assert int(mesh.faces.shape[0]) == tris
    assert int(mesh.vertices.shape[0]) == verts
    f = np.asarray(mesh.faces)
    assert f.min() >= 0 and f.max() < verts
    lo, hi = get_aabb(mesh)
    assert np.all(np.asarray(hi) > np.asarray(lo))


@pytest.mark.parametrize("name", ["Cube.obj", "Deer.obj", "Monkey.obj"])
def test_native_parser_matches_python_on_real_assets(name):
    path = _asset(name)
    py = load_obj(path, backend="python")
    from atray.native import parse_obj_native

    nat = parse_obj_native(path)
    if nat is None:
        pytest.skip("native parser unavailable")
    np.testing.assert_allclose(
        nat["vertices"], np.asarray(py.vertices), rtol=1e-6
    )
    np.testing.assert_array_equal(nat["faces"], np.asarray(py.faces))
    np.testing.assert_array_equal(
        nat["face_normal_idx"], np.asarray(py.face_normal_idx)
    )
    if nat["normals"].shape[0]:
        np.testing.assert_allclose(
            nat["normals"], np.asarray(py.normals), rtol=1e-6
        )


def _monkey_scene():
    mesh = load_obj(_asset("Monkey.obj"), default_material=1)
    mesh = translate_to(scale_to(mesh, 2.0), (0.0, 0.0, -4.0))
    return build_scene([mesh], materials=MATS)


def _render_config(w=40, h=30, spp=1, bounces=2):
    cam = look_at_camera(
        (0.0, 0.6, 0.2), (0.0, 0.0, -4.0), h_fov=0.9, aspect=w / h
    )
    settings = RenderSettings(
        resolution=(w, h), samples_per_pixel=spp, bounce_limit=bounces,
        anti_aliasing=False,
    )
    uni = draw_bounce_uniforms(jax.random.PRNGKey(7), bounces, spp * h * w)
    return cam, settings, uni


@pytest.mark.parametrize("leaf_size", [4, 16])
def test_monkey_oracle_parity_bvh(leaf_size):
    """Full pipeline on the reference's own Monkey geometry: the per-ray
    hit kernel (interpret on CPU) over the BVH == brute-force numpy
    oracle, at the default and a wide leaf."""
    from atray.accel.bvh import build_bvh

    scene = _monkey_scene()
    cam, settings, uni = _render_config()
    accel = build_bvh(
        scene.mesh.vertices, scene.mesh.faces,
        KDTreeConfig(leaf_size=leaf_size),
    )
    film_dev = np.asarray(
        render(scene, cam, settings, jax.random.PRNGKey(0),
               accel=accel, uniforms=uni)
    )
    w, h = settings.resolution
    orig, dirn = camera_rays(cam, w, h, settings.samples_per_pixel)
    film_ref = oracle.render_film(
        scene, np.asarray(orig), np.asarray(dirn),
        settings.bounce_limit, np.asarray(uni),
        settings.samples_per_pixel, h, w,
    )
    np.testing.assert_allclose(film_dev, film_ref, atol=2e-5)
    assert film_dev.std() > 0.01  # the monkey is actually in frame


def test_deer_accel_matches_bruteforce():
    """Deer.obj: accel traversal == brute-force device render (the
    reference's own USE_KD_TREE A/B correctness trick, renderer.h:8)."""
    from atray.accel.bvh import build_bvh

    mesh = load_obj(_asset("Deer.obj"), default_material=1)
    mesh = translate_to(scale_to(mesh, 2.5), (0.0, 0.0, -4.0))
    scene = build_scene([mesh], materials=MATS)
    cam, settings, uni = _render_config(w=32, h=24, bounces=2)
    accel = build_bvh(scene.mesh.vertices, scene.mesh.faces, KDTreeConfig())
    f_acc = np.asarray(
        render(scene, cam, settings, jax.random.PRNGKey(0),
               accel=accel, uniforms=uni)
    )
    f_bf = np.asarray(
        render(scene, cam, settings, jax.random.PRNGKey(0),
               accel=None, uniforms=uni)
    )
    np.testing.assert_allclose(f_acc, f_bf, atol=2e-5)
