"""Unit tests: intersection math vs closed-form cases (SURVEY.md §4 item 1)."""

import jax.numpy as jnp
import numpy as np
import pytest

from atray.core import intersect as ix


def _arr(*rows):
    return jnp.asarray(np.array(rows, np.float32))


class TestMollerTrumbore:
    def test_direct_hit_center(self):
        # Unit triangle in z=0 plane, ray from z=+1 shooting -z at centroid.
        p0 = _arr([0.0, 0.0, 0.0])
        e1 = _arr([1.0, 0.0, 0.0])
        e2 = _arr([0.0, 1.0, 0.0])
        orig = _arr([1 / 3, 1 / 3, 1.0])
        dirn = _arr([0.0, 0.0, -1.0])
        t, u, v, hit = ix.moller_trumbore(orig, dirn, p0, e1, e2)
        # winding: e1 x e2 = +z, det = dot(cross(d, e2), e1)... front face
        # for a ray coming along -z.
        assert bool(hit[0])
        np.testing.assert_allclose(t[0], 1.0, rtol=1e-6)
        np.testing.assert_allclose(u[0], 1 / 3, rtol=1e-5)
        np.testing.assert_allclose(v[0], 1 / 3, rtol=1e-5)

    def test_backface_culled(self):
        p0 = _arr([0.0, 0.0, 0.0])
        e1 = _arr([1.0, 0.0, 0.0])
        e2 = _arr([0.0, 1.0, 0.0])
        orig = _arr([1 / 3, 1 / 3, -1.0])   # behind, shooting +z
        dirn = _arr([0.0, 0.0, 1.0])
        t, u, v, hit = ix.moller_trumbore(orig, dirn, p0, e1, e2)
        assert not bool(hit[0])
        assert float(t[0]) >= float(ix.INF)
        # same ray with culling off must hit
        t2, _, _, hit2 = ix.moller_trumbore(
            orig, dirn, p0, e1, e2, backface_cull=False
        )
        assert bool(hit2[0])
        np.testing.assert_allclose(t2[0], 1.0, rtol=1e-6)

    def test_outside_barycentric_misses(self):
        p0 = _arr([0.0, 0.0, 0.0])
        e1 = _arr([1.0, 0.0, 0.0])
        e2 = _arr([0.0, 1.0, 0.0])
        orig = _arr([0.9, 0.9, 1.0])  # u+v > 1 region
        dirn = _arr([0.0, 0.0, -1.0])
        _, _, _, hit = ix.moller_trumbore(orig, dirn, p0, e1, e2)
        assert not bool(hit[0])

    def test_parallel_ray_misses(self):
        p0 = _arr([0.0, 0.0, 0.0])
        e1 = _arr([1.0, 0.0, 0.0])
        e2 = _arr([0.0, 1.0, 0.0])
        orig = _arr([0.2, 0.2, 1.0])
        dirn = _arr([1.0, 0.0, 0.0])  # parallel to the plane
        _, _, _, hit = ix.moller_trumbore(orig, dirn, p0, e1, e2)
        assert not bool(hit[0])

    def test_t_min_rejects_self_hit(self):
        p0 = _arr([0.0, 0.0, 0.0])
        e1 = _arr([1.0, 0.0, 0.0])
        e2 = _arr([0.0, 1.0, 0.0])
        orig = _arr([1 / 3, 1 / 3, 1e-6])  # sitting on the surface
        dirn = _arr([0.0, 0.0, -1.0])
        _, _, _, hit = ix.moller_trumbore(orig, dirn, p0, e1, e2)
        assert not bool(hit[0])

    def test_first_hit_picks_nearest(self):
        # Two parallel triangles at z=0 and z=-2; nearest is z=0 (t=1).
        tri_p0 = _arr([0.0, 0.0, 0.0], [0.0, 0.0, -2.0])
        tri_e1 = _arr([2.0, 0.0, 0.0], [2.0, 0.0, 0.0])
        tri_e2 = _arr([0.0, 2.0, 0.0], [0.0, 2.0, 0.0])
        orig = _arr([0.5, 0.5, 1.0])
        dirn = _arr([0.0, 0.0, -1.0])
        t, u, v, tid = ix.first_triangle_hit(orig, dirn, tri_p0, tri_e1, tri_e2)
        assert int(tid[0]) == 0
        np.testing.assert_allclose(t[0], 1.0, rtol=1e-6)


class TestSphere:
    def test_head_on(self):
        t, sid = ix.sphere_hits(
            _arr([0.0, 0.0, 5.0]), _arr([0.0, 0.0, -1.0]),
            _arr([0.0, 0.0, 0.0]), jnp.asarray([1.0], jnp.float32),
        )
        np.testing.assert_allclose(t[0], 4.0, rtol=1e-6)
        assert int(sid[0]) == 0

    def test_from_inside_hits_far_wall(self):
        t, sid = ix.sphere_hits(
            _arr([0.0, 0.0, 0.0]), _arr([0.0, 0.0, -1.0]),
            _arr([0.0, 0.0, 0.0]), jnp.asarray([1.0], jnp.float32),
        )
        np.testing.assert_allclose(t[0], 1.0, rtol=1e-6)

    def test_miss(self):
        t, sid = ix.sphere_hits(
            _arr([0.0, 3.0, 5.0]), _arr([0.0, 0.0, -1.0]),
            _arr([0.0, 0.0, 0.0]), jnp.asarray([1.0], jnp.float32),
        )
        assert int(sid[0]) == -1

    def test_nearest_of_two(self):
        t, sid = ix.sphere_hits(
            _arr([0.0, 0.0, 5.0]), _arr([0.0, 0.0, -1.0]),
            _arr([0.0, 0.0, 0.0], [0.0, 0.0, 3.0]),
            jnp.asarray([1.0, 0.5], jnp.float32),
        )
        assert int(sid[0]) == 1
        np.testing.assert_allclose(t[0], 1.5, rtol=1e-6)


class TestPlane:
    def test_floor(self):
        # plane y = -2: normal (0,1,0), offset -2
        t, pid = ix.plane_hits(
            _arr([0.0, 0.0, 0.0]),
            ix.normalize(_arr([0.0, -1.0, -1.0])),
            _arr([0.0, 1.0, 0.0]), jnp.asarray([-2.0], jnp.float32),
        )
        np.testing.assert_allclose(t[0], 2.0 * np.sqrt(2.0), rtol=1e-6)

    def test_parallel_misses(self):
        t, pid = ix.plane_hits(
            _arr([0.0, 0.0, 0.0]), _arr([1.0, 0.0, 0.0]),
            _arr([0.0, 1.0, 0.0]), jnp.asarray([-2.0], jnp.float32),
        )
        assert int(pid[0]) == -1


class TestAABB:
    def test_through_box(self):
        o = _arr([0.0, 0.0, 5.0])
        d = _arr([0.0, 0.0, -1.0])
        te, tx, hit = ix.aabb_entry_t(
            o, ix.safe_inv_dir(d), _arr([-1.0, -1.0, -1.0]), _arr([1.0, 1.0, 1.0])
        )
        assert bool(hit[0])
        np.testing.assert_allclose(te[0], 4.0, rtol=1e-6)
        np.testing.assert_allclose(tx[0], 6.0, rtol=1e-6)

    def test_miss(self):
        o = _arr([5.0, 5.0, 5.0])
        d = _arr([0.0, 0.0, -1.0])
        _, _, hit = ix.aabb_entry_t(
            o, ix.safe_inv_dir(d), _arr([-1.0, -1.0, -1.0]), _arr([1.0, 1.0, 1.0])
        )
        assert not bool(hit[0])

    def test_inside_box(self):
        o = _arr([0.0, 0.0, 0.0])
        d = _arr([1.0, 0.0, 0.0])
        te, tx, hit = ix.aabb_entry_t(
            o, ix.safe_inv_dir(d), _arr([-1.0, -1.0, -1.0]), _arr([1.0, 1.0, 1.0])
        )
        assert bool(hit[0])
        assert float(te[0]) <= 0.0

    def test_axis_aligned_zero_component(self):
        # dir has a zero component; IEEE inf handling must stay correct
        o = _arr([0.0, 0.5, 5.0])
        d = _arr([0.0, 0.0, -1.0])
        _, _, hit = ix.aabb_entry_t(
            o, ix.safe_inv_dir(d), _arr([-1.0, 0.0, -1.0]), _arr([1.0, 1.0, 1.0])
        )
        assert bool(hit[0])
        # shifted outside the slab in y -> miss
        o2 = _arr([0.0, 2.0, 5.0])
        _, _, hit2 = ix.aabb_entry_t(
            o2, ix.safe_inv_dir(d), _arr([-1.0, 0.0, -1.0]), _arr([1.0, 1.0, 1.0])
        )
        assert not bool(hit2[0])


class TestVectorOps:
    def test_reflect(self):
        d = ix.normalize(_arr([1.0, -1.0, 0.0]))
        n = _arr([0.0, 1.0, 0.0])
        r = ix.reflect(d, n)
        np.testing.assert_allclose(
            np.asarray(r[0]), np.asarray(ix.normalize(_arr([1.0, 1.0, 0.0]))[0]),
            atol=1e-6,
        )

    def test_normalize_zero_safe(self):
        v = ix.normalize(_arr([0.0, 0.0, 0.0]))
        assert np.all(np.isfinite(np.asarray(v)))
