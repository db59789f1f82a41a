"""OBJ loader tests: all face forms, negative indices, n-gons, round-trip
(reference capability: tools/OBJ_loader.cpp:32-176, 229-267)."""

import numpy as np

from atray.scene import load_obj, save_obj, procedural

OBJ_ALL_FORMS = """
# comment line
v 0.0 0.0 0.0
v 1.0 0.0 0.0
v 0.0 1.0 0.0
v 1.0 1.0 0.0
vt 0.0 0.0
vt 1.0 0.0
vt 0.0 1.0
vn 0.0 0.0 1.0
f 1 2 3
f 1/1 2/2 3/3
f 1//1 2//1 3//1
f 1/1/1 2/2/1 3/3/1
f -4 -3 -2
"""

OBJ_QUAD = """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f 1 2 3 4
"""


def test_all_face_forms(tmp_path):
    p = tmp_path / "forms.obj"
    p.write_text(OBJ_ALL_FORMS)
    m = load_obj(str(p))
    assert m.num_vertices == 4
    assert m.num_faces == 5
    f = np.asarray(m.faces)
    # plain, textured, normal-only, full, negative forms all -> (0,1,2)
    for row in f:
        np.testing.assert_array_equal(row, [0, 1, 2])
    fn = np.asarray(m.face_normal_idx)
    np.testing.assert_array_equal(fn[0], [-1, -1, -1])    # f v
    np.testing.assert_array_equal(fn[1], [-1, -1, -1])    # f v/vt
    np.testing.assert_array_equal(fn[2], [0, 0, 0])       # f v//vn
    np.testing.assert_array_equal(fn[3], [0, 0, 0])       # f v/vt/vn
    ft = np.asarray(m.face_tex_idx)
    np.testing.assert_array_equal(ft[1], [0, 1, 2])
    np.testing.assert_array_equal(ft[2], [-1, -1, -1])


def test_quad_fan_triangulation(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text(OBJ_QUAD)
    m = load_obj(str(p))
    assert m.num_faces == 2
    f = np.asarray(m.faces)
    np.testing.assert_array_equal(f[0], [0, 1, 2])
    np.testing.assert_array_equal(f[1], [0, 2, 3])


def test_usemtl_mapping(tmp_path):
    src = """
v 0 0 0
v 1 0 0
v 0 1 0
usemtl red
f 1 2 3
usemtl blue
f 1 2 3
usemtl unknown
f 1 2 3
"""
    p = tmp_path / "mats.obj"
    p.write_text(src)
    m = load_obj(str(p), material_map={"red": 2, "blue": 3}, default_material=1)
    np.testing.assert_array_equal(np.asarray(m.material_id), [2, 3, 1])


def test_roundtrip_preserves_geometry(tmp_path):
    mesh = procedural.uv_sphere(rows=8, cols=8, smooth=True)
    p = tmp_path / "rt.obj"
    save_obj(str(p), mesh)
    back = load_obj(str(p))
    np.testing.assert_allclose(
        np.asarray(back.vertices), np.asarray(mesh.vertices), rtol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(back.faces), np.asarray(mesh.faces))
    np.testing.assert_allclose(
        np.asarray(back.normals), np.asarray(mesh.normals), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_array_equal(
        np.asarray(back.face_normal_idx), np.asarray(mesh.face_normal_idx)
    )
