"""The per-ray hit kernel (kernels/bvh_hit.py) on the CPU test platform:
interpret mode against the XLA walk ``bvh_first_hit`` and brute force, the
wrapper's padding, the backend choice, CUDA cross-lowering, and the
no-replay backward."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from atray.accel.bvh import build_bvh
from atray.accel.traverse import bvh_first_hit
from atray.config import KDTreeConfig, RenderSettings
from atray.core.camera import camera_rays, look_at_camera
from atray.core.intersect import first_triangle_hit
from atray.kernels.bvh_hit import (BLOCK, bvh_hit_pallas, first_hit,
                                   kernel_mode)
from atray.kernels.hit_check import compare_hits, count_hit_kernels
from atray.render.wavefront import render
from atray.scene import build_scene, load_obj, procedural
from atray.scene.data import Spheres, make_materials
from atray.scene.transforms import scale_to, translate, translate_to

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _asset(name):
    return load_obj(os.path.join(REPO, "assets", name), default_material=1)


MESHES = {
    "cube": lambda: procedural.cube(size=2.0),
    "uv_sphere": lambda: procedural.uv_sphere(rows=16, cols=16, smooth=True),
    "dragon2k": lambda: procedural.dragon_proxy(target_tris=2000),
    "monkey": lambda: translate_to(scale_to(_asset("Monkey.obj"), 2.5),
                                   (0.0, 0.0, 0.0)),
    "deer": lambda: translate_to(scale_to(_asset("Deer.obj"), 2.5),
                                 (0.0, 0.0, 0.0)),
}


def _soa(mesh):
    v = np.asarray(mesh.vertices)
    f = np.asarray(mesh.faces)
    p0 = v[f[:, 0]]
    return p0, v[f[:, 1]] - p0, v[f[:, 2]] - p0


def _rays(kind, rng):
    """(orig, dirn, alive) for one of the test's ray kinds."""
    if kind == "incoherent":
        n = 512
        o = rng.uniform(-3.0, 3.0, (n, 3))
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return (jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
                np.ones(n, bool))
    cam = look_at_camera((0.3, 0.8, 4.0), (0.0, 0.0, 0.0), h_fov=0.35,
                         aspect=1.0)
    o, d = camera_rays(cam, 24, 24, spp=1)
    alive = np.ones(o.shape[0], bool)
    if kind == "partly_dead":
        alive = rng.uniform(size=o.shape[0]) < 0.6
    return o, d, alive


def _check(mesh, bvh, o, d, alive):
    """Kernel vs the XLA walk and brute force, live rays; dead rays miss."""
    t_k, id_k = jax.jit(
        lambda o_, d_, a_: first_hit(bvh, o_, d_, a_)
    )(o, d, jnp.asarray(alive))
    t_k, id_k = np.asarray(t_k), np.asarray(id_k)
    assert np.all(id_k[~alive] == -1)
    assert np.all(t_k[~alive] > 1.0e30)
    p0, e1, e2 = _soa(mesh)
    t_w, _, _, id_w = jax.jit(lambda o_, d_: bvh_first_hit(bvh, None, o_, d_))(
        o, d)
    t_b, _, _, id_b = first_triangle_hit(o, d, jnp.asarray(p0),
                                         jnp.asarray(e1), jnp.asarray(e2))
    o_l, d_l = np.asarray(o)[alive], np.asarray(d)[alive]
    for t_r, id_r in ((t_w, id_w), (t_b, id_b)):
        counts = compare_hits(
            t_k[alive], id_k[alive], np.asarray(t_r)[alive],
            np.asarray(id_r)[alive], o_l, d_l, p0, e1, e2,
        )
    return counts


@pytest.mark.parametrize("rays", ["camera", "incoherent", "partly_dead"])
@pytest.mark.parametrize("name", list(MESHES))
def test_kernel_matches_walk_and_brute_force(name, rays, rng):
    mesh = MESHES[name]()
    bvh = build_bvh(mesh.vertices, mesh.faces, KDTreeConfig(leaf_size=4))
    o, d, alive = _rays(rays, rng)
    counts = _check(mesh, bvh, o, d, alive)
    if rays != "incoherent":
        assert counts["hits"] > 20       # the mesh is actually in view


@pytest.mark.parametrize("n", [1, 127, 129, 1000])
def test_kernel_pads_ray_count(n, rng):
    # the ray count is padded to whole blocks; pad lanes start dead and are
    # sliced off, so any count gives exactly the reference's answer
    mesh = procedural.uv_sphere(rows=12, cols=12)
    bvh = build_bvh(mesh.vertices, mesh.faces, KDTreeConfig(leaf_size=4))
    o = -3.0 * np.ones((n, 3)) + rng.uniform(-0.5, 0.5, (n, 3))
    d = -o + rng.uniform(-0.3, 0.3, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)
    t_k, id_k = first_hit(bvh, o, d)
    assert t_k.shape == (n,) and id_k.shape == (n,)
    t_w, _, _, id_w = bvh_first_hit(bvh, None, o, d)
    p0, e1, e2 = _soa(mesh)
    compare_hits(t_k, id_k, t_w, id_w, o, d, p0, e1, e2)
    assert int(np.sum(np.asarray(id_k) >= 0)) >= max(1, n // 2)


@pytest.mark.parametrize("n", [BLOCK - 1, BLOCK + 1])
def test_kernel_partial_block_keeps_dead_rays_dead(n, rng):
    # a partial last block: live rays match the walk, dead rays and the
    # pad lanes beside them miss, and the output has exactly n rays
    mesh = procedural.dragon_proxy(target_tris=1000)
    bvh = build_bvh(mesh.vertices, mesh.faces)
    o, d, _ = _rays("camera", rng)
    sel = np.linspace(0, o.shape[0] - 1, n).astype(np.int64)
    o, d = o[sel], d[sel]
    alive = np.arange(n) % 3 != 0
    t_k, id_k = first_hit(bvh, o, d, jnp.asarray(alive))
    t_k, id_k = np.asarray(t_k), np.asarray(id_k)
    assert t_k.shape == (n,) and id_k.shape == (n,)
    assert np.all(id_k[~alive] == -1) and np.all(t_k[~alive] > 1.0e30)
    t_w, _, _, id_w = bvh_first_hit(bvh, None, o, d)
    p0, e1, e2 = _soa(mesh)
    counts = compare_hits(t_k[alive], id_k[alive], np.asarray(t_w)[alive],
                          np.asarray(id_w)[alive], np.asarray(o)[alive],
                          np.asarray(d)[alive], p0, e1, e2)
    assert counts["hits"] > 0


@pytest.mark.parametrize("backend,interpret", [
    ("cpu", True), ("gpu", False), ("rocm", None), ("metal", None),
])
def test_kernel_mode_follows_backend(backend, interpret, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if interpret is None:
        with pytest.raises(NotImplementedError):
            kernel_mode()
    else:
        assert kernel_mode() is interpret


@pytest.mark.parametrize("leaf_size", [4, 8])
def test_kernel_lowers_for_cuda(leaf_size, rng):
    # the compiled (non-interpret) kernel lowers to a Triton call for CUDA
    # without a card; what the GPU compiler then says shows on the card
    mesh = procedural.uv_sphere(rows=8, cols=8)
    bvh = build_bvh(mesh.vertices, mesh.faces,
                    KDTreeConfig(leaf_size=leaf_size))
    o, d, alive = _rays("partly_dead", rng)
    lowered = jax.jit(
        lambda o_, d_, a_: bvh_hit_pallas(bvh, o_, d_, a_, interpret=False)
    ).trace(o, d, jnp.asarray(alive)).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "triton" in text.lower()
    assert "bvh_hit" in text


@pytest.mark.parametrize("nee", [False, True])
def test_grad_program_runs_kernel_once_per_bounce(nee):
    # the remat policy saves the kernel's named outputs, so the backward
    # replays shading from the saved ids and never calls the kernel again
    mats = make_materials([
        ((0.3, 0.4, 0.6), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.7, 0.6, 0.5), 0.2),
        ((4.0, 4.0, 4.0), (0.0, 0.0, 0.0), 0.0),
    ])
    mesh = translate(procedural.uv_sphere(rows=8, cols=8, material=1),
                     (0, 0, -4))
    spheres = Spheres(centers=np.asarray([[1.0, 1.5, -3.5]], np.float32),
                      radii=np.asarray([0.4], np.float32),
                      material_id=np.asarray([2], np.int32))
    scene = build_scene([mesh], spheres=spheres, materials=mats)
    bvh = build_bvh(scene.mesh.vertices, scene.mesh.faces)
    cam = look_at_camera((0, 0.4, 0.5), (0, 0, -4), h_fov=0.8, aspect=1.0)
    s = RenderSettings(resolution=(8, 8), samples_per_pixel=1,
                       bounce_limit=3, nee=nee)
    key = jax.random.PRNGKey(0)
    params = scene.params()

    def film(p):
        return render(scene.with_params(p), cam, s, key, accel=bvh)

    fwd = count_hit_kernels(jax.make_jaxpr(film)(params))
    grad = count_hit_kernels(
        jax.make_jaxpr(jax.grad(lambda p: jnp.sum(film(p))))(params)
    )
    # camera bounce scan + main scan; NEE adds one shadow query to each
    assert fwd == (4 if nee else 2)
    assert grad == fwd


@pytest.mark.gpu
def test_kernel_on_gpu_matches_references():
    # card-only: the compiled kernel against the XLA walk and brute force,
    # through the same check chip_smoke.py runs at full width
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; `python chip_smoke.py` runs this "
                    "check on the card")
    sys.path.insert(0, REPO)
    import chip_smoke

    chip_smoke.check_kernel(tris=20_000, n_rays=65_536, n_brute=2_048)
