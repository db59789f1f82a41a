"""Dragon-SCALE OBJ file validation (VERDICT r4 missing #2).

The reference's demo is a 139k-triangle OBJ *file* (README.md:19,
app.cpp:65-66) whose blob is missing from the snapshot; the smaller
assets validate the parsers only up to Monkey (3,936 tris). Here the
procedural dragon proxy is dumped to a real ``.obj`` and round-tripped
through BOTH parsers at full 139k scale, the native and numpy BVH
builders are compared on the parsed mesh, and a frame renders from the
file-loaded scene bit-identically to the in-memory mesh.

``save_obj`` prints f32 values with 9 significant digits, which
round-trips binary32 exactly — so every parity check below is exact
equality, not tolerance.
"""

import jax
import numpy as np
import pytest

from atray.config import KDTreeConfig, RenderSettings
from atray.core.camera import look_at_camera
from atray.render.wavefront import render
from atray.scene import build_scene, load_obj, procedural
from atray.scene.data import make_materials
from atray.scene.objio import save_obj
from atray.scene.transforms import scale_to, translate_to

TARGET = 139_000


@pytest.fixture(scope="module")
def dragon_file(tmp_path_factory):
    mesh = procedural.dragon_proxy(target_tris=TARGET, material=1)
    path = tmp_path_factory.mktemp("dragon") / "Dragon.obj"
    save_obj(str(path), mesh)
    return mesh, str(path)


def test_dragon_file_scale(dragon_file):
    mesh, path = dragon_file
    assert int(mesh.num_faces) >= 0.95 * TARGET  # genuinely dragon-tier
    import os

    assert os.path.getsize(path) > 5_000_000    # a real multi-MB file


def test_dragon_file_parser_parity(dragon_file):
    mesh, path = dragon_file
    m_py = load_obj(path, backend="python")
    m_nat = load_obj(path, backend="native")
    if m_nat is None:
        pytest.skip("native library unavailable")

    for m in (m_py, m_nat):
        # exact round trip vs the in-memory source mesh
        np.testing.assert_array_equal(
            np.asarray(m.vertices), np.asarray(mesh.vertices)
        )
        np.testing.assert_array_equal(
            np.asarray(m.faces), np.asarray(mesh.faces)
        )
        np.testing.assert_array_equal(
            np.asarray(m.normals), np.asarray(mesh.normals)
        )
        np.testing.assert_array_equal(
            np.asarray(m.face_normal_idx), np.asarray(mesh.face_normal_idx)
        )


def test_dragon_file_builder_parity(dragon_file):
    # native vs numpy BVH builder on a >=100k-tri parsed FILE mesh:
    # identical split decisions -> identical flattened trees
    from atray.accel.bvh import build_bvh, validate_bvh
    from atray.native import build_bvh_native

    _, path = dragon_file
    m = load_obj(path, backend="python")
    cfg = KDTreeConfig(leaf_size=16)
    if build_bvh_native(m.vertices, m.faces, 16, 16, 64) is None:
        pytest.skip("native library unavailable")
    b_nat = build_bvh(m.vertices, m.faces, cfg, backend="native")
    b_np = build_bvh(m.vertices, m.faces, cfg, backend="numpy")
    validate_bvh(b_nat, int(m.num_faces))
    validate_bvh(b_np, int(m.num_faces))
    # identical split decisions -> identical topology and node boxes; the
    # WITHIN-leaf triangle order may differ (the partition routines are
    # not stable at equal centroids), so leaves compare as SETS
    assert b_nat.num_nodes == b_np.num_nodes
    np.testing.assert_array_equal(
        np.asarray(b_nat.node_miss), np.asarray(b_np.node_miss)
    )
    np.testing.assert_array_equal(
        np.asarray(b_nat.leaf_start), np.asarray(b_np.leaf_start)
    )
    np.testing.assert_allclose(
        np.asarray(b_nat.node_min), np.asarray(b_np.node_min), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(b_nat.node_max), np.asarray(b_np.node_max), rtol=1e-6
    )
    ids_nat = np.sort(
        np.asarray(b_nat.tri_orig_id).reshape(-1, cfg.leaf_size), axis=1
    )
    ids_np = np.sort(
        np.asarray(b_np.tri_orig_id).reshape(-1, cfg.leaf_size), axis=1
    )
    np.testing.assert_array_equal(ids_nat, ids_np)


def test_dragon_file_renders_like_memory_mesh(dragon_file):
    # same placement applied to the file-loaded and the in-memory mesh
    # must give the SAME film bits (geometry equality end to end)
    from atray.accel.bvh import build_bvh

    mesh, path = dragon_file
    mats = make_materials([
        ((0.45, 0.55, 0.75), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.7, 0.55, 0.4), 0.2),
    ])

    def film_of(m):
        m = translate_to(scale_to(m, 2.0), (0.0, 0.0, -4.0))
        scene = build_scene([m], materials=mats)
        accel = build_bvh(
            scene.mesh.vertices, scene.mesh.faces, KDTreeConfig(leaf_size=16)
        )
        cam = look_at_camera(
            (0.0, 0.6, 0.0), (0.0, 0.0, -4.0), h_fov=0.9, aspect=4 / 3
        )
        st = RenderSettings(
            resolution=(64, 48), samples_per_pixel=1, bounce_limit=2,
            sort_bounces=False,
        )
        return np.asarray(render(scene, cam, st, jax.random.PRNGKey(0),
                                 accel=accel))

    f_file = film_of(load_obj(path, backend="auto"))
    f_mem = film_of(mesh)
    np.testing.assert_array_equal(f_file, f_mem)
    assert f_mem.std() > 0.01  # a real image, not a constant
