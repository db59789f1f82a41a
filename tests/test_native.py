"""Native C++ components vs their numpy oracles (builder + OBJ parser).

The reference runs these host paths natively (kd_tree.cpp, OBJ_loader.cpp);
ours must produce results interchangeable with the python implementations.
Skipped when no C++ toolchain is available.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from atray.native import available

pytestmark = pytest.mark.skipif(
    not available(), reason="native toolchain unavailable"
)


def test_bvh_builder_traversal_parity(rng):
    from atray.accel.bvh import build_bvh, validate_bvh
    from atray.accel.traverse import bvh_first_hit
    from atray.config import KDTreeConfig
    from atray.scene import procedural

    mesh = procedural.dragon_proxy(target_tris=3000, smooth=False)
    cfg = KDTreeConfig(leaf_size=8)
    b_nat = build_bvh(mesh.vertices, mesh.faces, cfg, backend="native")
    b_np = build_bvh(mesh.vertices, mesh.faces, cfg, backend="numpy")
    validate_bvh(b_nat, mesh.num_faces)
    assert b_nat.num_nodes == b_np.num_nodes  # identical split decisions

    orig = jnp.asarray(rng.uniform(-3, 3, (1500, 3)), jnp.float32)
    d = rng.normal(size=(1500, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dirn = jnp.asarray(d, jnp.float32)
    t1, _, _, i1 = bvh_first_hit(b_nat, None, orig, dirn)
    t2, _, _, i2 = bvh_first_hit(b_np, None, orig, dirn)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_obj_parser_matches_python(tmp_path):
    from atray.scene import procedural, save_obj
    from atray.scene.objio import load_obj

    mesh = procedural.uv_sphere(rows=10, cols=10, smooth=True)
    p = tmp_path / "m.obj"
    save_obj(str(p), mesh)
    m_nat = load_obj(str(p), backend="native")
    m_py = load_obj(str(p), backend="python")
    np.testing.assert_allclose(
        np.asarray(m_nat.vertices), np.asarray(m_py.vertices), rtol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(m_nat.faces), np.asarray(m_py.faces))
    np.testing.assert_array_equal(
        np.asarray(m_nat.face_normal_idx), np.asarray(m_py.face_normal_idx)
    )
    np.testing.assert_allclose(
        np.asarray(m_nat.normals), np.asarray(m_py.normals), rtol=1e-5
    )


def test_obj_parser_face_forms(tmp_path):
    from atray.scene.objio import load_obj

    src = """
v 0.0 0.0 0.0
v 1.0 0.0 0.0
v 0.0 1.0 0.0
v 1.0 1.0 0.0
vt 0.0 0.0
vt 1.0 0.0
vn 0.0 0.0 1.0
f 1 2 3
f 1/1 2/2 3/1
f 1//1 2//1 3//1
f 1/1/1 2/2/1 3/1/1
f -4 -3 -2
f 1 2 3 4
"""
    p = tmp_path / "forms.obj"
    p.write_text(src)
    m_nat = load_obj(str(p), backend="native")
    m_py = load_obj(str(p), backend="python")
    np.testing.assert_array_equal(np.asarray(m_nat.faces), np.asarray(m_py.faces))
    np.testing.assert_array_equal(
        np.asarray(m_nat.face_tex_idx), np.asarray(m_py.face_tex_idx)
    )
    np.testing.assert_array_equal(
        np.asarray(m_nat.face_normal_idx), np.asarray(m_py.face_normal_idx)
    )
    assert m_nat.num_faces == 7  # 5 tris + quad fan (2)
