"""Treelet (geometry-sharded) path: ppermute ring over per-device treelets
(SURVEY.md §5.7 scale-out / §5.8 collective plan; dist/treelet.py)."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from atray.config import RenderSettings
from atray.core.camera import look_at_camera
from atray.core.intersect import first_triangle_hit
from atray.dist.mesh import make_device_mesh
from atray.dist.treelet import (
    build_treelet_accels,
    build_treelet_parts,
    build_treelets,
    partition_faces,
    render_treelet,
    ring_first_hit,
)
from atray.render.wavefront import render
from atray.scene import build_scene, procedural
from atray.scene.data import make_materials
from atray.scene.transforms import translate

MATS = make_materials([
    ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),
    ((0.0, 0.0, 0.0), (0.8, 0.5, 0.3), 0.2),
])


def _scene(rows=12, cols=12):
    mesh = translate(
        procedural.uv_sphere(rows=rows, cols=cols, material=1, smooth=True),
        (0, 0, -4),
    )
    return build_scene([mesh], materials=MATS)


def test_partition_is_balanced_and_exact():
    scene = _scene()
    v = np.asarray(scene.mesh.vertices)
    f = np.asarray(scene.mesh.faces)
    parts = partition_faces(v, f, 8)
    sizes = [len(p) for p in parts]
    assert max(sizes) - min(sizes) <= 1
    allidx = np.sort(np.concatenate(parts))
    np.testing.assert_array_equal(allidx, np.arange(f.shape[0]))


def test_ring_first_hit_matches_brute_force(devices, rng):
    scene = _scene()
    mesh = make_device_mesh()
    n_dev = mesh.devices.size
    treelets = build_treelets(scene, n_dev)

    r = 8 * n_dev
    orig = jnp.asarray(rng.normal(0, 0.3, (r, 3)), jnp.float32) + jnp.asarray(
        [0.0, 0.0, 0.5]
    )
    dirn = jnp.asarray(rng.normal(size=(r, 3)), jnp.float32)
    dirn = dirn / jnp.linalg.norm(dirn, axis=1, keepdims=True)
    # aim half the rays at the mesh so hits occur
    aim = jnp.asarray([0.0, 0.0, -4.0]) - orig[: r // 2]
    dirn = dirn.at[: r // 2].set(aim / jnp.linalg.norm(aim, axis=1, keepdims=True))

    from functools import partial

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("rays"), P("rays"), P("rays")),
        out_specs=(P("rays"), P("rays"), P("rays"), P("rays")),
        check_vma=False,
    )
    def run(o, d, recs):
        t, n, mat, hit, fid = ring_first_hit(recs, o, d, n_parts=n_dev)
        return t, n, mat, fid

    t, n, mat, fid = run(orig, dirn, treelets.recs)

    p0, e1, e2 = scene.triangle_soa()
    t_ref, _, _, tid_ref = first_triangle_hit(orig, dirn, p0, e1, e2)
    np.testing.assert_allclose(np.asarray(t), np.asarray(t_ref), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(fid), np.asarray(tid_ref))
    assert int(np.sum(np.asarray(fid) >= 0)) > r // 4


def test_treelet_render_matches_single_device(devices):
    # geometry sharded 8 ways + ppermute ring == replicated single-device
    # render (same PRNG: key = f(global ray id, bounce))
    scene = _scene()
    cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
    s = RenderSettings(resolution=(16, 16), samples_per_pixel=2, bounce_limit=3)
    mesh = make_device_mesh()
    film_tl = render_treelet(scene, cam, s, jax.random.PRNGKey(0), mesh)
    film_lo = render(scene, cam, s, jax.random.PRNGKey(0))
    np.testing.assert_allclose(
        np.asarray(film_tl), np.asarray(film_lo), atol=1e-5
    )
    assert np.asarray(film_lo).std() > 0.01


def test_treelet_nee_matches_single_device(devices):
    # NEE shadow rays ride the second ring (ring_occlusion_t): the treelet
    # render with an emissive sphere light must match the replicated path
    from atray.scene.data import Spheres

    mats = make_materials([
        ((0.2, 0.25, 0.35), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.8, 0.5, 0.3), 0.2),
        ((5.0, 4.5, 4.0), (0.0, 0.0, 0.0), 0.0),
    ])
    mesh_g = translate(
        procedural.uv_sphere(rows=10, cols=10, material=1, smooth=True),
        (0, 0, -4),
    )
    spheres = Spheres(
        centers=jnp.asarray([[1.5, 2.0, -3.0]]),
        radii=jnp.asarray([0.6]),
        material_id=jnp.asarray([2], jnp.int32),
    )
    scene = build_scene([mesh_g], spheres=spheres, materials=mats)
    cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
    s = RenderSettings(
        resolution=(16, 16), samples_per_pixel=1, bounce_limit=2, nee=True
    )
    mesh = make_device_mesh()
    film_tl = render_treelet(scene, cam, s, jax.random.PRNGKey(2), mesh)
    film_lo = render(scene, cam, s, jax.random.PRNGKey(2))
    np.testing.assert_allclose(
        np.asarray(film_tl), np.asarray(film_lo), atol=1e-5
    )
    assert np.asarray(film_lo).max() > 0.05


def test_treelet_accel_render_matches_replicated(devices):
    # the PRODUCTION treelet backend: per-treelet BVHs sharded over the
    # mesh, the per-ray hit kernel per ring hop — must match the
    # replicated kernel render (same PRNG streams)
    from atray.accel.bvh import build_bvh
    from atray.config import KDTreeConfig

    scene = _scene(rows=14, cols=14)
    cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
    s = RenderSettings(resolution=(16, 16), samples_per_pixel=2, bounce_limit=3)
    mesh = make_device_mesh()
    ta = build_treelet_accels(scene, mesh.devices.size,
                              KDTreeConfig(leaf_size=8))
    film_tl = render_treelet(scene, cam, s, jax.random.PRNGKey(0), mesh,
                             treelets=ta)
    accel = build_bvh(scene.mesh.vertices, scene.mesh.faces,
                      KDTreeConfig(leaf_size=8))
    film_lo = render(scene, cam, s, jax.random.PRNGKey(0), accel=accel)
    np.testing.assert_allclose(
        np.asarray(film_tl), np.asarray(film_lo), atol=1e-5
    )
    assert np.asarray(film_lo).std() > 0.01


def test_treelet_accel_nee_matches_replicated(devices):
    from atray.config import KDTreeConfig
    from atray.scene.data import Spheres

    mats = make_materials([
        ((0.2, 0.25, 0.35), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.8, 0.5, 0.3), 0.2),
        ((5.0, 4.5, 4.0), (0.0, 0.0, 0.0), 0.0),
    ])
    mesh_g = translate(
        procedural.uv_sphere(rows=10, cols=10, material=1, smooth=True),
        (0, 0, -4),
    )
    spheres = Spheres(
        centers=jnp.asarray([[1.5, 2.0, -3.0]]),
        radii=jnp.asarray([0.6]),
        material_id=jnp.asarray([2], jnp.int32),
    )
    scene = build_scene([mesh_g], spheres=spheres, materials=mats)
    cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
    s = RenderSettings(
        resolution=(12, 12), samples_per_pixel=1, bounce_limit=2, nee=True
    )
    mesh = make_device_mesh()
    ta = build_treelet_accels(scene, mesh.devices.size,
                              KDTreeConfig(leaf_size=8))
    film_tl = render_treelet(scene, cam, s, jax.random.PRNGKey(2), mesh,
                             treelets=ta)
    film_ref = render_treelet(scene, cam, s, jax.random.PRNGKey(2), mesh)
    np.testing.assert_allclose(
        np.asarray(film_tl), np.asarray(film_ref), atol=1e-5
    )
    assert np.asarray(film_ref).max() > 0.05


def test_treelet_render_with_compaction_and_stats(devices):
    scene = _scene()
    cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
    s = RenderSettings(
        resolution=(16, 16), samples_per_pixel=1, bounce_limit=2,
        sort_bounces=True,
    )
    mesh = make_device_mesh()
    film, stats = render_treelet(
        scene, cam, s, jax.random.PRNGKey(1), mesh, return_stats=True
    )
    s0 = RenderSettings(
        resolution=(16, 16), samples_per_pixel=1, bounce_limit=2
    )
    film_ref = render(scene, cam, s0, jax.random.PRNGKey(1))
    np.testing.assert_allclose(
        np.asarray(film), np.asarray(film_ref), atol=1e-5
    )
    assert stats["rays_cast_per_shard"].shape == (8,)
    assert float(stats["rays_cast"]) >= 16 * 16  # every primary counted


def test_treelet_diff_forward_matches_replicated(devices):
    # TreeletParts backend (in-graph record tables) must render the same
    # image as the replicated single-device path
    scene = _scene(rows=8, cols=8)
    cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
    s = RenderSettings(
        resolution=(16, 16), samples_per_pixel=1, bounce_limit=2,
        sort_bounces=False,
    )
    mesh = make_device_mesh()
    parts = build_treelet_parts(scene, mesh.devices.size)
    film_tl = render_treelet(
        scene, cam, s, jax.random.PRNGKey(0), mesh, treelets=parts
    )
    film_lo = render(scene, cam, s, jax.random.PRNGKey(0))
    np.testing.assert_allclose(
        np.asarray(film_tl), np.asarray(film_lo), atol=1e-5
    )
    assert np.asarray(film_lo).std() > 0.01


def test_treelet_diff_grads_match_replicated(devices):
    # Sharded-parameter path replay: jax.grad through the geometry-sharded
    # render (records built in-graph, winning rows fetched by the
    # differentiable ppermute ring) must equal the replicated path's
    # gradients for every parameter leaf — vertices, normals, materials.
    scene = _scene(rows=8, cols=8)
    cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
    s = RenderSettings(
        resolution=(16, 16), samples_per_pixel=1, bounce_limit=2,
        sort_bounces=False,
    )
    mesh = make_device_mesh()
    parts = build_treelet_parts(scene, mesh.devices.size)
    key = jax.random.PRNGKey(0)

    def loss_rep(p):
        return jnp.sum(render(scene.with_params(p), cam, s, key))

    def loss_tl(p):
        return jnp.sum(
            render_treelet(
                scene.with_params(p), cam, s, key, mesh, treelets=parts
            )
        )

    f1, g1 = jax.jit(jax.value_and_grad(loss_rep))(scene.params())
    f2, g2 = jax.jit(jax.value_and_grad(loss_tl))(scene.params())
    np.testing.assert_allclose(float(f1), float(f2), rtol=1e-5)
    leaves1 = jax.tree_util.tree_leaves(g1)
    leaves2 = jax.tree_util.tree_leaves(g2)
    assert len(leaves1) == len(leaves2) == 5
    for a, b in zip(leaves1, leaves2):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=1e-4, rtol=1e-3
        )
    # gradients are nontrivial (vertices move pixels)
    assert max(
        float(jnp.max(jnp.abs(leaf))) for leaf in leaves2
    ) > 1e-4


def test_treelet_inverse_albedo_recovers(devices):
    # BASELINE config 5 at treelet scale: recover a material albedo by
    # gradient descent THROUGH the geometry-sharded renderer — the scene
    # parameters are never resident on a single device during the hit
    # queries, yet jax.grad drives them toward the truth.
    import optax

    scene = _scene(rows=8, cols=8)
    cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
    s = RenderSettings(
        resolution=(16, 16), samples_per_pixel=1, bounce_limit=2,
        sort_bounces=False,
    )
    mesh = make_device_mesh()
    parts = build_treelet_parts(scene, mesh.devices.size)
    key = jax.random.PRNGKey(7)

    target = render_treelet(scene, cam, s, key, mesh, treelets=parts)

    import dataclasses as _dc

    p0 = scene.params()
    true_albedo = jnp.asarray(p0.albedo)[1]

    def loss(a1):
        p = _dc.replace(
            p0, albedo=jnp.asarray(p0.albedo).at[1].set(a1)
        )
        f = render_treelet(
            scene.with_params(p), cam, s, key, mesh, treelets=parts
        )
        return jnp.mean((f - target) ** 2)

    a1 = jnp.asarray([0.2, 0.7, 0.6])
    opt = optax.adam(0.05)
    st = opt.init(a1)

    @jax.jit
    def step(a, st_):
        lv, g = jax.value_and_grad(loss)(a)
        updates, st_ = opt.update(g, st_, a)
        return optax.apply_updates(a, updates), st_, lv

    l0 = None
    for _ in range(40):
        a1, st, lv = step(a1, st)
        if l0 is None:
            l0 = float(lv)
    l1 = float(lv)
    assert l1 < l0 * 0.2, (l0, l1)
    err = float(jnp.abs(a1 - true_albedo).max())
    assert err < 0.15, err


def test_treelet_shards_forward_matches_replicated(devices):
    # TreeletShards backend: record tables built INSIDE shard_map from
    # per-part vertex/normal slices (true sharded parameter residency)
    # must render the same image as the replicated single-device path
    from atray.dist.treelet import build_treelet_shards

    scene = _scene(rows=8, cols=8)
    cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
    s = RenderSettings(
        resolution=(16, 16), samples_per_pixel=1, bounce_limit=2,
        sort_bounces=False,
    )
    mesh = make_device_mesh()
    shards = build_treelet_shards(scene, mesh.devices.size)
    film_tl = render_treelet(
        scene, cam, s, jax.random.PRNGKey(0), mesh, treelets=shards
    )
    film_lo = render(scene, cam, s, jax.random.PRNGKey(0))
    np.testing.assert_allclose(
        np.asarray(film_tl), np.asarray(film_lo), atol=1e-5
    )
    assert np.asarray(film_lo).std() > 0.01


def test_treelet_shards_grads_match_replicated(devices):
    # Gradients land on the PER-SHARD vertex/normal copies; scatter-adding
    # duplicated boundary copies back (merge_vertex_grads) must equal the
    # replicated path's gradients. No device ever builds another part's
    # records: the only cross-device traffic is the ppermute rings.
    import dataclasses as _dc

    from atray.dist.treelet import (
        build_treelet_shards,
        merge_normal_grads,
        merge_vertex_grads,
    )

    scene = _scene(rows=8, cols=8)
    cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
    s = RenderSettings(
        resolution=(16, 16), samples_per_pixel=1, bounce_limit=2,
        sort_bounces=False,
    )
    mesh = make_device_mesh()
    shards = build_treelet_shards(scene, mesh.devices.size)
    key = jax.random.PRNGKey(0)

    def loss_rep(p):
        return jnp.sum(render(scene.with_params(p), cam, s, key))

    def loss_sh(vn):
        sh = _dc.replace(shards, vertices=vn[0], normals=vn[1])
        return jnp.sum(render_treelet(scene, cam, s, key, mesh, treelets=sh))

    f1, g1 = jax.jit(jax.value_and_grad(loss_rep))(scene.params())
    f2, g2 = jax.jit(jax.value_and_grad(loss_sh))(
        (shards.vertices, shards.normals)
    )
    np.testing.assert_allclose(float(f1), float(f2), rtol=1e-5)
    gv = merge_vertex_grads(shards, g2[0], int(scene.mesh.num_vertices))
    gn = merge_normal_grads(shards, g2[1], scene.mesh.normals.shape[0])
    np.testing.assert_allclose(
        np.asarray(gv), np.asarray(g1.vertices), atol=1e-4, rtol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(gn), np.asarray(g1.normals), atol=1e-4, rtol=1e-3
    )
    assert float(jnp.max(jnp.abs(gv))) > 1e-4
