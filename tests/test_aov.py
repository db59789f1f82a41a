"""AOV pass tests (round 5, beyond parity).

The AOV films must agree with the production hit machinery exactly: depth
is the nearest-hit t, normals are the resolve_hit shading normals, albedo
carries the beauty pass's texture modulation, and the accel path produces
the same films as brute force.
"""
import jax
import jax.numpy as jnp
import numpy as np

from atray.accel.bvh import build_bvh
from atray.core.camera import camera_rays, look_at_camera
from atray.render.aov import aov_preview_films, render_aovs
from atray.render.wavefront import nearest_hit_ids
from atray.scene import build_scene, procedural
from atray.scene.data import Planes, Spheres, make_materials
from atray.scene.transforms import translate

MATS = make_materials([
    ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),   # 0: skybox
    ((0.0, 0.0, 0.0), (0.7, 0.7, 0.7), 0.0),       # 1: grey diffuse
    ((0.0, 0.0, 0.0), (0.8, 0.2, 0.2), 0.7),       # 2: red glossy
    ((4.0, 3.5, 3.0), (0.0, 0.0, 0.0), 0.0),       # 3: warm light
])

W, H = 48, 36


def _scene():
    cube = translate(procedural.cube(size=1.5, material=2), (0.0, -0.5, -4.0))
    spheres = Spheres(
        centers=jnp.asarray([[1.6, 0.2, -5.0]], jnp.float32),
        radii=jnp.asarray([0.8], jnp.float32),
        material_id=jnp.asarray([3], jnp.int32),
    )
    planes = Planes(
        normals=jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32),
        offsets=jnp.asarray([-1.5], jnp.float32),
        material_id=jnp.asarray([1], jnp.int32),
    )
    return build_scene([cube], spheres=spheres, planes=planes, materials=MATS)


def _cam():
    return look_at_camera(
        (0.0, 0.5, 1.0), (0.0, 0.0, -4.0), h_fov=0.9, aspect=W / H
    )


def test_aov_depth_matches_nearest_hit():
    scene, cam = _scene(), _cam()
    aovs = jax.jit(lambda s: render_aovs(s, cam, W, H))(scene)
    orig, dirn = camera_rays(cam, W, H, 1)
    ids = nearest_hit_ids(scene, orig, dirn)
    t = np.asarray(ids.t).reshape(H, W)
    hit = np.asarray(ids.prim_id).reshape(H, W) >= 0
    d = np.asarray(aovs["depth"])
    assert hit.any() and (~hit).any()
    np.testing.assert_allclose(d[hit], t[hit], rtol=1e-4, atol=1e-4)
    assert (d[~hit] == 0.0).all()
    np.testing.assert_array_equal(np.asarray(aovs["hit"]) > 0.5, hit)


def test_aov_normals_unit_and_materials_consistent():
    scene, cam = _scene(), _cam()
    aovs = render_aovs(scene, cam, W, H)
    n = np.asarray(aovs["normal"])
    hit = np.asarray(aovs["hit"]) > 0.5
    ln = np.linalg.norm(n[hit], axis=-1)
    np.testing.assert_allclose(ln, 1.0, atol=1e-4)
    assert (np.linalg.norm(n[~hit], axis=-1) == 0.0).all()

    mid = np.asarray(aovs["material_id"])
    assert (mid[~hit] == -1).all()
    al = np.asarray(aovs["albedo"])
    alb_table = np.asarray(scene.materials.albedo)
    # every hit pixel's albedo is exactly its material row (untextured scene)
    np.testing.assert_allclose(
        al[hit], alb_table[mid[hit]], atol=1e-6
    )
    # the emissive sphere shows up in the emission AOV
    em = np.asarray(aovs["emission"])
    assert em[mid == 3].max() > 3.0


def test_aov_accel_matches_brute():
    scene, cam = _scene(), _cam()
    accel = build_bvh(scene.mesh.vertices, scene.mesh.faces)
    a0 = render_aovs(scene, cam, W, H)
    a1 = render_aovs(scene, cam, W, H, accel=accel)
    for k in a0:
        np.testing.assert_allclose(
            np.asarray(a0[k]), np.asarray(a1[k]), atol=1e-5,
            err_msg=f"AOV {k} differs between brute force and accel",
        )


def test_aov_albedo_textured():
    # reuse the oracle suite's textured quad scene: the albedo AOV must
    # carry the same checker modulation the beauty pass samples
    from test_render_oracle import _textured_scene

    scene = _textured_scene()
    cam = look_at_camera(
        (0.0, 2.5, 0.5), (0.0, 0.0, -3.0), h_fov=0.9, aspect=W / H
    )
    aovs = render_aovs(scene, cam, W, H)
    hit = np.asarray(aovs["hit"]) > 0.5
    al = np.asarray(aovs["albedo"])[hit]
    assert hit.sum() > 20
    # the checker produces at least two distinct albedo values on the quad
    assert np.unique(al.round(4), axis=0).shape[0] >= 2


def test_aov_preview_films_displayable():
    scene, cam = _scene(), _cam()
    films = aov_preview_films(render_aovs(scene, cam, W, H))
    for k in ("depth", "normal", "albedo", "emission"):
        f = np.asarray(films[k])
        assert f.shape == (H, W, 3)
        assert np.isfinite(f).all() and f.min() >= 0.0 and f.max() <= 1.0


def test_aov_depth_gradient_flows_to_vertices():
    # depth is differentiable through resolve_hit: moving the cube closer
    # must register in d(mean depth)/d(vertices)
    scene, cam = _scene(), _cam()

    def loss(verts):
        import dataclasses
        mesh = dataclasses.replace(scene.mesh, vertices=verts)
        s = dataclasses.replace(scene, mesh=mesh)
        a = render_aovs(s, cam, W, H)
        return jnp.sum(a["depth"])

    g = jax.grad(loss)(scene.mesh.vertices)
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).max() > 0.0
