"""BVH build + traversal tests: structural invariants, and traversal vs the
brute-force path — the reference's own USE_KD_TREE A/B oracle trick
(renderer.cpp:49-82, SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from atray.accel.bvh import build_bvh, validate_bvh
from atray.accel.traverse import bvh_first_hit
from atray.config import KDTreeConfig, RenderSettings
from atray.core.camera import look_at_camera
from atray.core.intersect import INF, first_triangle_hit
from atray.render.wavefront import render
from atray.scene import build_scene, procedural
from atray.scene.data import make_materials
from atray.scene.transforms import translate


MESHES = {
    "cube": lambda: procedural.cube(size=2.0),
    "sphere_coarse": lambda: procedural.uv_sphere(rows=9, cols=9),
    "sphere_fine": lambda: procedural.uv_sphere(rows=24, cols=24),
}


@pytest.mark.parametrize("name", list(MESHES))
def test_build_invariants(name):
    mesh = MESHES[name]()
    bvh = build_bvh(mesh.vertices, mesh.faces, KDTreeConfig(leaf_size=4))
    validate_bvh(bvh, mesh.num_faces)


@pytest.mark.parametrize("leaf_size", [1, 4, 8])
def test_leaf_size_variants(leaf_size):
    mesh = procedural.uv_sphere(rows=12, cols=12)
    bvh = build_bvh(mesh.vertices, mesh.faces, KDTreeConfig(leaf_size=leaf_size))
    validate_bvh(bvh, mesh.num_faces)


def _random_rays(rng, n, box=3.0):
    orig = rng.uniform(-box, box, (n, 3)).astype(np.float32)
    dirn = rng.normal(size=(n, 3)).astype(np.float32)
    dirn /= np.linalg.norm(dirn, axis=1, keepdims=True)
    return jnp.asarray(orig), jnp.asarray(dirn)


@pytest.mark.parametrize("name", list(MESHES))
def test_traversal_matches_brute_force(name, rng):
    mesh = MESHES[name]()
    bvh = build_bvh(mesh.vertices, mesh.faces, KDTreeConfig(leaf_size=4))
    orig, dirn = _random_rays(rng, 512)

    v = mesh.vertices
    f = mesh.faces
    p0 = v[f[:, 0]]
    e1 = v[f[:, 1]] - p0
    e2 = v[f[:, 2]] - p0
    t_bf, u_bf, v_bf, id_bf = first_triangle_hit(orig, dirn, p0, e1, e2)
    t_tr, u_tr, v_tr, id_tr = jax.jit(
        lambda o, d: bvh_first_hit(bvh, None, o, d)
    )(orig, dirn)

    t_bf, t_tr = np.asarray(t_bf), np.asarray(t_tr)
    hit_bf = t_bf < float(INF)
    hit_tr = t_tr < float(INF)
    np.testing.assert_array_equal(hit_bf, hit_tr)
    np.testing.assert_allclose(t_tr[hit_tr], t_bf[hit_bf], rtol=1e-5)
    # Same face wins except for exact shared-edge ties; t equality above
    # already guarantees a correct nearest hit, so only check ids where the
    # brute-force winner is strictly unique... by comparing t of both ids.
    same_id = np.asarray(id_tr) == np.asarray(id_bf)
    if not same_id.all():
        # disagreeing ids must still have identical t (tie on an edge)
        disagree = hit_tr & ~same_id
        np.testing.assert_allclose(
            t_tr[disagree], t_bf[disagree], rtol=1e-6
        )


def test_rays_from_inside_mesh(rng):
    mesh = procedural.uv_sphere(rows=16, cols=16)
    bvh = build_bvh(mesh.vertices, mesh.faces, KDTreeConfig(leaf_size=4))
    # origins inside the sphere: culled backfaces -> expect misses mostly,
    # but traversal and brute force must agree exactly.
    orig = jnp.asarray(rng.uniform(-0.3, 0.3, (128, 3)), jnp.float32)
    dirn = rng.normal(size=(128, 3)).astype(np.float32)
    dirn /= np.linalg.norm(dirn, axis=1, keepdims=True)
    dirn = jnp.asarray(dirn)
    v, f = mesh.vertices, mesh.faces
    p0 = v[f[:, 0]]
    t_bf, _, _, _ = first_triangle_hit(orig, dirn, p0, v[f[:, 1]] - p0, v[f[:, 2]] - p0)
    t_tr, _, _, _ = bvh_first_hit(bvh, None, orig, dirn)
    np.testing.assert_allclose(np.asarray(t_tr), np.asarray(t_bf), rtol=1e-5)


def test_render_with_accel_matches_brute(rng):
    mats = make_materials([
        ((0.4, 0.5, 0.7), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.8, 0.6, 0.4), 0.2),
    ])
    mesh = translate(procedural.uv_sphere(rows=14, cols=14, material=1), (0, 0, -4))
    scene = build_scene([mesh], materials=mats)
    bvh = build_bvh(scene.mesh.vertices, scene.mesh.faces, KDTreeConfig(leaf_size=4))
    cam = look_at_camera((0, 0.4, 0.5), (0, 0, -4), h_fov=0.8, aspect=1.0)
    s = RenderSettings(resolution=(32, 32), samples_per_pixel=2, bounce_limit=3)
    key = jax.random.PRNGKey(5)
    film_bf = render(scene, cam, s, key, accel=None)
    film_tr = render(scene, cam, s, key, accel=bvh)
    np.testing.assert_allclose(
        np.asarray(film_tr), np.asarray(film_bf), atol=2e-5
    )


def test_single_triangle_bvh():
    v = jnp.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], jnp.float32)
    f = jnp.asarray([[0, 1, 2]], jnp.int32)
    bvh = build_bvh(v, f, KDTreeConfig(leaf_size=4))
    validate_bvh(bvh, 1)
    orig = jnp.asarray([[0.2, 0.2, 1.0], [5.0, 5.0, 1.0]], jnp.float32)
    dirn = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], jnp.float32)
    t, u, v_, fid = bvh_first_hit(bvh, None, orig, dirn)
    np.testing.assert_allclose(float(t[0]), 1.0, rtol=1e-6)
    assert int(fid[0]) == 0
    assert int(fid[1]) == -1


def _moved_sphere(rng):
    mesh = procedural.uv_sphere(rows=12, cols=12)
    bvh = build_bvh(mesh.vertices, mesh.faces, KDTreeConfig(leaf_size=4))
    v_new = jnp.asarray(mesh.vertices) + jnp.asarray(
        rng.normal(0.0, 0.02, np.asarray(mesh.vertices).shape), jnp.float32
    )
    n = 256
    orig = jnp.asarray(rng.normal(0, 3.0, (n, 3)), jnp.float32)
    dirn = orig / jnp.linalg.norm(orig, axis=1, keepdims=True)
    orig, dirn = -3.0 * dirn, dirn  # aim at the origin-centred sphere
    f = jnp.asarray(mesh.faces)
    p0 = v_new[f[:, 0]]
    t_b, _, _, id_b = first_triangle_hit(
        orig, dirn, p0, v_new[f[:, 1]] - p0, v_new[f[:, 2]] - p0)
    return mesh, bvh, v_new, orig, dirn, t_b, id_b


def test_refit_bvh_matches_bruteforce_after_vertex_move(rng):
    # Device-side refit (accel.bvh.refit_bvh): move the vertices, refit in
    # jit, and both the hit kernel and the XLA walk must match brute force
    # on the MOVED geometry (stale boxes would miss silhouettes).
    from atray.accel.bvh import refit_bvh
    from atray.kernels.bvh_hit import first_hit

    mesh, bvh, v_new, orig, dirn, t_b, id_b = _moved_sphere(rng)

    @jax.jit
    def refit_hit(v):
        acc = refit_bvh(bvh, v, mesh.faces)
        validate = (acc.node_min, acc.node_max)
        t_k, id_k = first_hit(acc, orig, dirn)
        t_w, _, _, id_w = bvh_first_hit(acc, None, orig, dirn)
        return t_k, id_k, t_w, id_w, validate

    t_k, id_k, t_w, id_w, (nmin, nmax) = refit_hit(v_new)
    for t, i in ((t_k, id_k), (t_w, id_w)):
        np.testing.assert_allclose(np.asarray(t), np.asarray(t_b), rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(i), np.asarray(id_b))
    assert int(np.sum(np.asarray(id_b) >= 0)) > 100  # most rays hit
    # every moved vertex lies inside the refit root box
    assert np.all(np.asarray(v_new) >= np.asarray(nmin)[0])
    assert np.all(np.asarray(v_new) <= np.asarray(nmax)[0])


def test_refit_bvh_under_grad_and_chained(rng):
    # the refit runs inside a differentiated program (its outputs are
    # detached, so the grad program's primal ids equal the forward ones),
    # and refits chain: refitting a refit BVH stays exact
    from atray.accel.bvh import refit_bvh
    from atray.kernels.bvh_hit import first_hit

    mesh, bvh, v_new, orig, dirn, t_b, id_b = _moved_sphere(rng)

    def hitsum(v):
        acc = refit_bvh(bvh, v, mesh.faces)
        _, ids = first_hit(acc, orig, dirn)
        return jnp.sum(v), ids

    (_, ids_grad), g = jax.value_and_grad(hitsum, has_aux=True)(v_new)
    np.testing.assert_array_equal(np.asarray(ids_grad), np.asarray(id_b))
    np.testing.assert_allclose(np.asarray(g), 1.0)

    half = 0.5 * (jnp.asarray(mesh.vertices) + v_new)
    acc2 = refit_bvh(refit_bvh(bvh, half, mesh.faces), v_new, mesh.faces)
    t2, id2 = first_hit(acc2, orig, dirn)
    np.testing.assert_allclose(np.asarray(t2), np.asarray(t_b), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(id2), np.asarray(id_b))
