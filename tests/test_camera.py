"""Camera basis and ray-generation tests (reference camera.h:9-45,
renderer.cpp:314-343)."""

import jax
import numpy as np

from atray.core.camera import camera_rays, look_at_camera, make_camera


def test_basis_right_handed():
    cam = make_camera((0, 0, 0), (0, 0, -1), h_fov=1.0, aspect=1.0)
    r, u, f = (np.asarray(x) for x in (cam.right, cam.up, cam.forward))
    np.testing.assert_allclose(f, [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose(r, [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(u, [0, 1, 0], atol=1e-6)
    # right x up = -forward (right-handed with forward into the screen)
    np.testing.assert_allclose(np.cross(r, u), -f, atol=1e-6)
    for v in (r, u, f):
        np.testing.assert_allclose(np.linalg.norm(v), 1.0, rtol=1e-6)


def test_center_ray_is_forward():
    w, h = 64, 64
    cam = look_at_camera((1.0, 2.0, 3.0), (1.0, 2.0, -10.0), h_fov=1.0, aspect=1.0)
    orig, dirn = camera_rays(cam, w, h, spp=1)
    d = np.asarray(dirn).reshape(h, w, 3)
    # average of the four center pixels ~ forward
    center = d[h // 2 - 1 : h // 2 + 1, w // 2 - 1 : w // 2 + 1].mean(axis=(0, 1))
    center /= np.linalg.norm(center)
    np.testing.assert_allclose(center, np.asarray(cam.forward), atol=1e-3)
    np.testing.assert_allclose(np.asarray(orig)[0], [1.0, 2.0, 3.0], atol=1e-6)


def test_rays_unit_length():
    cam = look_at_camera((0, 0, 0), (3, -1, -2), h_fov=1.2, aspect=16 / 9)
    _, dirn = camera_rays(cam, 32, 18, spp=2)
    norms = np.linalg.norm(np.asarray(dirn), axis=1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)


def test_film_orientation():
    # pixel (0,0) is top-left: its ray must point more up and more left
    # than pixel (H-1, W-1).
    w, h = 16, 16
    cam = make_camera((0, 0, 0), (0, 0, -1), h_fov=1.0, aspect=1.0)
    _, dirn = camera_rays(cam, w, h, spp=1)
    d = np.asarray(dirn).reshape(h, w, 3)
    up = np.asarray(cam.up)
    right = np.asarray(cam.right)
    assert d[0, 0] @ up > d[h - 1, 0] @ up
    assert d[0, 0] @ right < d[0, w - 1] @ right


def test_aa_jitter_stays_in_pixel():
    w, h = 8, 8
    cam = make_camera((0, 0, 0), (0, 0, -1), h_fov=1.0, aspect=1.0)
    _, d0 = camera_rays(cam, w, h, spp=1)
    _, dj = camera_rays(
        cam, w, h, spp=1, key=jax.random.PRNGKey(3), anti_aliasing=True
    )
    # jittered dirs differ but stay within a pixel's angular footprint
    d0 = np.asarray(d0)
    dj = np.asarray(dj)
    assert not np.allclose(d0, dj)
    cos = np.sum(d0 * dj, axis=1)
    # one pixel spans ~2/w film units; generous bound on angular deviation
    assert np.all(cos > np.cos(4.0 / w))


def test_spp_layout_sample_major():
    w, h, spp = 8, 4, 3
    cam = make_camera((0, 0, 0), (0, 0, -1), h_fov=1.0, aspect=2.0)
    _, dirn = camera_rays(cam, w, h, spp=spp)
    d = np.asarray(dirn).reshape(spp, h, w, 3)
    # without AA, all samples of a pixel are identical
    np.testing.assert_allclose(d[0], d[1], atol=0)
    np.testing.assert_allclose(d[0], d[2], atol=0)
