"""Procedural mesh invariants: outward winding, normal orientation,
triangle-count tiers (the self-contained replacement for the reference's
Assets/ ladder, BASELINE.md)."""

import numpy as np
import pytest

from atray.scene import procedural
from atray.scene.transforms import compute_vertex_normals, get_aabb


def _outward_fraction(mesh, center):
    v = np.asarray(mesh.vertices)
    f = np.asarray(mesh.faces)
    p0 = v[f[:, 0]]
    fn = np.cross(v[f[:, 1]] - p0, v[f[:, 2]] - p0)
    tri_c = (v[f[:, 0]] + v[f[:, 1]] + v[f[:, 2]]) / 3.0 - np.asarray(center)
    return float((np.sum(fn * tri_c, axis=1) > 0).mean())


@pytest.mark.parametrize(
    "make",
    [
        lambda: procedural.cube(),
        lambda: procedural.uv_sphere(rows=12, cols=12),
        lambda: procedural.dragon_proxy(target_tris=3000, smooth=False),
    ],
    ids=["cube", "uv_sphere", "dragon_proxy"],
)
def test_faces_wound_outward(make):
    mesh = make()
    # every (or for the displaced dragon proxy, nearly every) face normal
    # must point away from the centroid — otherwise backface culling makes
    # exteriors invisible.
    frac = _outward_fraction(mesh, (0.0, 0.0, 0.0))
    assert frac > 0.95, f"only {frac:.2%} of faces wound outward"


def test_smooth_normals_point_outward():
    mesh = procedural.uv_sphere(rows=16, cols=16, smooth=True)
    v = np.asarray(mesh.vertices)
    n = np.asarray(mesh.normals)
    # on a sphere centered at origin the smooth normal ~ vertex direction
    vn = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
    cos = np.sum(vn * n, axis=1)
    assert cos.min() > 0.9


def test_tier_triangle_counts():
    assert procedural.cube().num_faces == 12
    deer_tier = procedural.uv_sphere(rows=28, cols=28)
    assert 1_200 <= deer_tier.num_faces <= 2_000
    monkey_tier = procedural.uv_sphere(rows=45, cols=45)
    assert 3_000 <= monkey_tier.num_faces <= 5_000
    dragon = procedural.dragon_proxy(target_tris=139_000, smooth=False)
    assert 130_000 <= dragon.num_faces <= 150_000


def test_dragon_proxy_deterministic():
    a = procedural.dragon_proxy(target_tris=2000, smooth=False)
    b = procedural.dragon_proxy(target_tris=2000, smooth=False)
    np.testing.assert_array_equal(np.asarray(a.vertices), np.asarray(b.vertices))


def test_dragon_proxy_is_irregular():
    d = procedural.dragon_proxy(target_tris=2000, smooth=False)
    v = np.asarray(d.vertices)
    radii = np.linalg.norm(v, axis=1)
    assert radii.std() > 0.02, "displacement should break the sphere"


def test_aabb():
    lo, hi = get_aabb(procedural.cube(size=2.0))
    np.testing.assert_allclose(lo, [-1, -1, -1], atol=1e-6)
    np.testing.assert_allclose(hi, [1, 1, 1], atol=1e-6)
