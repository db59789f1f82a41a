"""Drive the renderer and the inverse-rendering step once on one GPU.

    python chip_smoke.py                # phases 1-5 on one card
    python chip_smoke.py --four-cards   # only the multi-card phase, 4 cards

Phases (any failure exits non-zero; nothing is caught and passed):

1. device: JAX's first device must be a GPU;
2. kernel: the per-ray hit kernel at the headline width (139k-tri dragon
   proxy over a floor) against the XLA walk on 1M camera and 1M
   random-direction rays and against brute force on 16k rays, plus the
   kernel's and the walk's time on one 4,147,200-ray chunk of camera and of
   first-diffuse-bounce rays;
3. render: the headline frame (1920x1080, 8 spp, 5 bounces) in one
   dispatch, and an oracle-matched small scene against tests/oracle.py;
4. backward: jax.grad of a pixel loss at 960x540x4spp x3 bounces, with the
   hit kernel once per bounce in the grad program;
5. inverse rendering: three refit training steps on the dragon proxy.

``--four-cards`` instead compares the ray-sharded render, the psum'd
training gradients and the treelet render on four cards with one card.

Numbers go on earlier lines, each beside the card's name and power limit;
the last line is the JSON result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CARD = "?"


def log(msg: str) -> None:
    print(msg, flush=True)


def num(name: str, value, unit: str = "") -> None:
    log(f"  {name}: {value}{(' ' + unit) if unit else ''}  [{CARD}]")


def _timed(fn, reps: int = 3, per: int = 1):
    """Median and list of ``reps`` samples; each sample dispatches ``per``
    calls back to back and waits once, so for ``per`` > 1 the host's
    dispatch and sync (about 0.3 ms a call) hides behind device work."""
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready([fn(i * per + j) for j in range(per)])
        times.append((time.perf_counter() - t0) / per)
    return statistics.median(times), times


def phase_device(count: int) -> None:
    global CARD
    from atray.utils.profiling import gpu_card

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {devs[0].platform!r}")
    if len(devs) < count:
        raise SystemExit(f"need {count} GPUs, JAX sees {len(devs)}")
    CARD = gpu_card()
    log(f"phase 1 device: {devs[0].device_kind} x{len(devs)}, jax "
        f"{jax.__version__}")
    log(CARD)


def _brute_force(orig, dirn, p0, e1, e2, chunk=256):
    """core.intersect.first_triangle_hit in ray chunks (it builds (R, T)
    arrays, so a whole wavefront at 139k triangles would not fit)."""
    from atray.core.intersect import first_triangle_hit

    n = orig.shape[0]
    assert n % chunk == 0

    def one(od):
        t, _, _, i = first_triangle_hit(od[0], od[1], p0, e1, e2)
        return t, i

    t, i = jax.jit(lambda o, d: jax.lax.map(
        one, (o.reshape(-1, chunk, 3), d.reshape(-1, chunk, 3))))(orig, dirn)
    return t.reshape(-1), i.reshape(-1)


def _random_rays(rng, n, lo, hi):
    o = rng.uniform(lo, hi, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def _bounce_rays(scene, bvh, orig, dirn, seed=0):
    """First-diffuse-bounce rays of a camera wavefront: from each camera
    hit (mesh or floor), a jittered direction around the oriented shading
    normal (the renderer's diffuse lobe); rays that missed are dead."""
    from atray.render.wavefront import nearest_hit_ids, resolve_hit

    ids = nearest_hit_ids(scene, orig, dirn, accel=bvh)
    t, n, _, hit = resolve_hit(scene, orig, dirn, ids)
    n = jnp.where(jnp.sum(n * dirn, axis=1, keepdims=True) > 0, -n, n)
    jit_ = jax.random.uniform(jax.random.PRNGKey(seed), n.shape,
                              minval=-1.0, maxval=1.0)
    d = n + jit_
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    o = orig + jnp.where(hit, t, 0.0)[:, None] * dirn
    return o, d, hit


def check_kernel(tris: int = 139_000, n_rays: int = 1 << 20,
                 n_brute: int = 16_384, chunk: int = 0):
    """Phase 2: the compiled hit kernel against the XLA walk and brute
    force (``kernels.hit_check.compare_hits``); with ``chunk`` > 0 also
    time kernel and walk on one chunk of camera and bounce rays."""
    import bench
    from atray.accel.bvh import build_bvh
    from atray.accel.traverse import bvh_first_hit
    from atray.core.camera import camera_rays
    from atray.kernels.bvh_hit import first_hit
    from atray.kernels.hit_check import compare_hits

    t0 = time.perf_counter()
    scene, camera_for = bench.headline_scene(tris)
    bvh = build_bvh(scene.mesh.vertices, scene.mesh.faces)
    num("bvh build (host)", f"{time.perf_counter() - t0:.3f}", "s")
    num("bvh nodes / slots / leaf_size",
        f"{bvh.num_nodes} / {bvh.tri_orig_id.shape[0]} / {bvh.leaf_size}")
    v = np.asarray(scene.mesh.vertices)
    f = np.asarray(scene.mesh.faces)
    p0 = v[f[:, 0]]
    e1, e2 = v[f[:, 1]] - p0, v[f[:, 2]] - p0
    lo, hi = v.min(axis=0) - 0.5, v.max(axis=0) + 0.5

    side = int(np.sqrt(n_rays))
    cam_o, cam_d = camera_rays(camera_for(side, side), side, side, spp=1)
    rng = np.random.default_rng(0)
    rnd_o, rnd_d = _random_rays(rng, n_rays, lo, hi)

    hit = jax.jit(lambda o, d: first_hit(bvh, o, d))
    walk = jax.jit(lambda o, d: bvh_first_hit(bvh, None, o, d)[::3])
    t0 = time.perf_counter()
    hit.lower(cam_o, cam_d).compile()
    num("hit kernel compile", f"{time.perf_counter() - t0:.3f}", "s")

    for name, o, d in (("camera", cam_o, cam_d), ("random", rnd_o, rnd_d)):
        t_k, id_k = hit(o, d)
        t_w, id_w = walk(o, d)
        c = compare_hits(t_k, id_k, t_w, id_w, o, d, p0, e1, e2)
        num(f"kernel vs walk, {name} rays", c)
        sel = np.linspace(0, o.shape[0] - 1, n_brute // 2).astype(np.int64)
        ob, db = o[sel], d[sel]
        t_b, id_b = _brute_force(ob, db, jnp.asarray(p0), jnp.asarray(e1),
                                 jnp.asarray(e2))
        c = compare_hits(np.asarray(t_k)[sel], np.asarray(id_k)[sel], t_b,
                         id_b, ob, db, p0, e1, e2)
        num(f"kernel vs brute force, {name} rays", c)

    if chunk:
        # one chunk of the headline frame: 1920x1080 camera rays, chunk
        # // (1920 * 1080) samples per pixel
        w, h = 1920, 1080
        co, cd = camera_rays(camera_for(w, h), w, h, spp=chunk // (w * h))
        bo, bd, alive = _bounce_rays(scene, bvh, co, cd)
        hit_a = jax.jit(lambda o, d, a: first_hit(bvh, o, d, a))
        walk_a = jax.jit(
            lambda o, d, a: bvh_first_hit(
                bvh, None, jnp.where(a[:, None], o, 1.0e7),
                jnp.where(a[:, None], d, jnp.asarray([0.0, 0.0, 1.0])))[::3])
        ones = jnp.ones((co.shape[0],), bool)
        for name, o, d, a in (("camera", co, cd, ones),
                              ("bounce-1", bo, bd, alive)):
            jax.block_until_ready(hit_a(o, d, a))
            jax.block_until_ready(walk_a(o, d, a))
            tk1, _ = _timed(lambda i: hit_a(o, d, a), per=10)
            tw1, _ = _timed(lambda i: walk_a(o, d, a))
            tw2, _ = _timed(lambda i: walk_a(o, d, a))
            tk2, _ = _timed(lambda i: hit_a(o, d, a), per=10)
            live = int(np.sum(np.asarray(a)))
            num(f"{name} chunk of {o.shape[0]} rays ({live} live): kernel "
                f"median of 10-call batches", f"{tk1:.5f} / {tk2:.5f}", "s")
            num(f"{name} chunk: XLA walk median", f"{tw1:.5f} / {tw2:.5f}",
                "s")
    return scene, camera_for, bvh


def phase_render(scene, camera_for, bvh, w=1920, h=1080, spp=8) -> None:
    from atray.config import RenderSettings
    from atray.render.wavefront import render

    st = RenderSettings(resolution=(w, h), samples_per_pixel=spp,
                        bounce_limit=5, ray_chunk=2 * w * h,
                        sort_bounces=True)
    cam = camera_for(w, h)
    jframe = jax.jit(lambda k: render(scene, cam, st, k, accel=bvh,
                                      return_stats=True))
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    comp = jframe.lower(key).compile()
    num("frame compile", f"{time.perf_counter() - t0:.3f}", "s")
    log(f"  frame memory_analysis: {comp.memory_analysis()}")
    film, stats = jax.block_until_ready(comp(key))
    med, times = _timed(lambda i: comp(jax.random.PRNGKey(i + 1)))
    live = float(stats["rays_cast"])
    film = np.asarray(film)
    num(f"frame {w}x{h}x{spp}spp x5 bounces median", f"{med:.4f}", "s")
    num("frame times", [round(t, 4) for t in times], "s")
    num("live rays per frame / live rays/s", f"{live:.0f} / {live / med:.4g}")
    num("film mean / std", f"{film.mean():.4f} / {film.std():.4f}")
    assert film.shape == (h, w, 3) and np.all(np.isfinite(film))
    assert 0.05 < film.mean() < 0.95 and film.std() > 0.01, film.mean()
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    num("peak device bytes in use after frame", peak)

    # oracle-matched small config (tests/test_render_oracle.py's full scene
    # through the hit kernel, explicit uniforms, that test's tolerance)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import oracle
    from test_render_oracle import _scene_full

    from atray.accel.bvh import build_bvh
    from atray.core.camera import camera_rays, look_at_camera
    from atray.render.wavefront import draw_bounce_uniforms

    small = _scene_full()
    sw, sh, sspp, sb = 48, 36, 2, 3
    scam = look_at_camera((0.0, 0.5, 1.0), (0.0, 0.0, -4.0), h_fov=0.9,
                          aspect=sw / sh)
    sbvh = build_bvh(small.mesh.vertices, small.mesh.faces)
    sset = RenderSettings(resolution=(sw, sh), samples_per_pixel=sspp,
                          bounce_limit=sb)
    uni = draw_bounce_uniforms(jax.random.PRNGKey(7), sb, sspp * sh * sw)
    f_dev = np.asarray(jax.jit(lambda s: render(
        s, scam, sset, jax.random.PRNGKey(42), accel=sbvh, uniforms=uni))(
            small))
    o, d = camera_rays(scam, sw, sh, sspp)
    f_ref = oracle.render_film(small, np.asarray(o), np.asarray(d), sb,
                               np.asarray(uni), sspp, sh, sw)
    err = float(np.abs(f_dev - f_ref).max())
    num("oracle scene max |film - oracle| (tolerance 1e-3)", f"{err:.3g}")
    np.testing.assert_allclose(f_dev, f_ref, atol=1e-3)


def phase_backward(scene, camera_for, bvh, w=960, h=540, spp=4) -> None:
    from atray.config import RenderSettings
    from atray.kernels.hit_check import count_hit_kernels
    from atray.render.wavefront import render

    st = RenderSettings(resolution=(w, h), samples_per_pixel=spp,
                        bounce_limit=3)
    cam = camera_for(w, h)
    params = scene.params()

    def loss(p, k):
        return jnp.mean(render(scene.with_params(p), cam, st, k, accel=bvh))

    key = jax.random.PRNGKey(3)
    n_fwd = count_hit_kernels(jax.make_jaxpr(loss)(params, key))
    n_grad = count_hit_kernels(jax.make_jaxpr(jax.grad(loss))(params, key))
    num("hit kernel calls in forward / grad program", f"{n_fwd} / {n_grad}")
    assert n_fwd == 2 and n_grad == n_fwd, (n_fwd, n_grad)

    jf = jax.jit(loss)
    jg = jax.jit(jax.grad(loss))
    t0 = time.perf_counter()
    jax.block_until_ready(jf(params, key))
    num("forward compile + first run", f"{time.perf_counter() - t0:.3f}", "s")
    t0 = time.perf_counter()
    g = jax.block_until_ready(jg(params, key))
    num("backward compile + first run", f"{time.perf_counter() - t0:.3f}",
        "s")
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.all(np.isfinite(np.asarray(leaf))), "grads must be finite"
    assert float(jnp.abs(g.albedo).max()) > 0.0
    t_f, _ = _timed(lambda i: jf(params, jax.random.fold_in(key, i)))
    t_b, _ = _timed(lambda i: jg(params, jax.random.fold_in(key, i)))
    num(f"forward {w}x{h}x{spp}spp x3 median", f"{t_f:.4f}", "s")
    num(f"backward (grad) {w}x{h}x{spp}spp x3 median", f"{t_b:.4f}", "s")
    num("backward/forward", f"{t_b / t_f:.3f}")


def _inverse_problem(scene, camera_for, views=2, res=256):
    from atray.core.camera import camera_rays, look_at_camera

    origs, dirns = [], []
    for v in range(views):
        ang = 2 * np.pi * v / views
        eye = (2.5 * np.sin(ang), 0.8, -4 + 2.5 * np.cos(ang))
        o, d = camera_rays(look_at_camera(eye, (0, 0, -4), h_fov=0.8,
                                          aspect=1.0), res, res, spp=1)
        origs.append(o)
        dirns.append(d)
    p_true = scene.params()
    rng = np.random.default_rng(3)
    p0 = dataclasses.replace(
        p_true,
        albedo=p_true.albedo * 0.4 + 0.2,
        vertices=p_true.vertices + jnp.asarray(
            rng.normal(0, 0.002, p_true.vertices.shape), jnp.float32),
    )
    return jnp.concatenate(origs), jnp.concatenate(dirns), p_true, p0


def _optimizer():
    import optax

    from atray.scene.data import SceneParams

    labels = SceneParams(vertices="geo", normals="frozen", emission="frozen",
                         albedo="mat", scatter="frozen")
    return optax.multi_transform(
        {"mat": optax.adam(3e-2), "geo": optax.adam(5e-4),
         "frozen": optax.set_to_zero()}, labels)


def phase_inverse(scene, camera_for, bvh, res=256) -> None:
    from atray.dist.mesh import make_device_mesh, trace_sharded
    from atray.dist.train import make_train_step

    mesh = make_device_mesh(num_devices=1)
    orig, dirn, p_true, p = _inverse_problem(scene, camera_for, res=res)
    bounces = 2
    key = jax.random.PRNGKey(0)
    target = trace_sharded(scene, orig, dirn, bounces, key, mesh, accel=bvh)
    opt = _optimizer()
    step = jax.jit(make_train_step(scene, bounces, opt, mesh, accel=bvh,
                                   refit=True))
    # replicated over the mesh from the start, as the step returns them,
    # so only the first step compiles
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    p = jax.device_put(p, rep)
    state = jax.device_put(opt.init(p), rep)
    losses, times = [], []
    for s in range(3):
        # the target's key: the loss is then a deterministic function of
        # the parameters (0 at the true ones), free of sampling noise
        t0 = time.perf_counter()
        p, state, loss = step(p, state, orig, dirn, target, key)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    num(f"inverse step losses ({orig.shape[0]} rays, refit)", losses)
    num("inverse step times (first includes compile)",
        [round(t, 4) for t in times], "s")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    for leaf in jax.tree_util.tree_leaves(p):
        assert np.all(np.isfinite(np.asarray(leaf))), "params must be finite"


def phase_four_cards(tris=139_000, w=1920, h=1080, spp=4, res=128,
                     tw=480, th=270) -> None:
    """Four cards against one: ray-sharded render, psum'd training loss and
    grads, and the treelet render over 4 parts."""
    import bench
    from atray.accel.bvh import build_bvh
    from atray.config import RenderSettings
    from atray.dist.mesh import make_device_mesh
    from atray.dist.train import make_loss_and_grad
    from atray.dist.treelet import build_treelet_accels, render_treelet
    from atray.render.wavefront import render

    scene, camera_for = bench.headline_scene(tris)
    bvh = build_bvh(scene.mesh.vertices, scene.mesh.faces)
    mesh4 = make_device_mesh(num_devices=4)
    mesh1 = make_device_mesh(num_devices=1)
    key = jax.random.PRNGKey(0)

    # 1) ray-sharded render vs one card, same key
    st = RenderSettings(resolution=(w, h), samples_per_pixel=spp,
                        bounce_limit=5, ray_chunk=w * h, sort_bounces=True)
    cam = camera_for(w, h)
    f1 = jax.jit(lambda k: render(scene, cam, st, k, accel=bvh))
    f4 = jax.jit(lambda k: render(scene, cam, st, k, accel=bvh, mesh=mesh4))
    a = np.asarray(f1(key))
    b = np.asarray(f4(key))
    t1, _ = _timed(lambda i: f1(jax.random.PRNGKey(i + 1)))
    t4, _ = _timed(lambda i: f4(jax.random.PRNGKey(i + 1)))
    diff = np.abs(a - b)
    num(f"sharded render {w}x{h}x{spp}spp x5: 1 card / 4 cards median",
        f"{t1:.4f} / {t4:.4f}", "s")
    num("sharded vs one card: bit-identical / max |diff| / pixels > 1e-5",
        f"{bool(np.array_equal(a, b))} / {diff.max():.3g} / "
        f"{int(np.sum(diff.max(axis=-1) > 1e-5))}")
    assert np.all(np.isfinite(b))
    # GPU tolerance: the same per-ray math runs on every card; only XLA's
    # choices for the shard shape may move last bits, which a path can
    # carry to a few pixels
    assert diff.mean() < 1e-5 and np.mean(diff.max(axis=-1) > 1e-5) < 1e-3

    # 2) training loss and grads: 4 cards vs 1 card
    orig, dirn, p_true, p = _inverse_problem(scene, camera_for, views=2,
                                             res=res)
    target = jnp.zeros_like(orig)
    lg1 = jax.jit(make_loss_and_grad(scene, 2, mesh1, accel=bvh, refit=True))
    lg4 = jax.jit(make_loss_and_grad(scene, 2, mesh4, accel=bvh, refit=True))
    l1, g1 = lg1(p, orig, dirn, target, key)
    l4, g4 = lg4(p, orig, dirn, target, key)
    num("train loss 1 card / 4 cards", f"{float(l1):.8g} / {float(l4):.8g}")
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-5)
    for name in ("albedo", "vertices"):
        x1 = np.asarray(getattr(g1, name))
        x4 = np.asarray(getattr(g4, name))
        scale = float(np.abs(x1).max())
        rel = float(np.abs(x4 - x1).max()) / max(scale, 1e-30)
        num(f"grad {name}: max |1| / max |4 - 1| over max |1|",
            f"{scale:.3g} / {rel:.3g}")
        assert scale > 0.0, f"{name} grads are all zero"
        # rtol 1e-5 of the leaf's scale: psum adds 4 partial sums in
        # another order than one card's single sum
        np.testing.assert_allclose(x4, x1, rtol=1e-5,
                                   atol=1e-5 * np.abs(x1).max())

    # 3) treelet render over 4 parts vs the replicated render
    tst = RenderSettings(resolution=(tw, th), samples_per_pixel=2,
                         bounce_limit=3, sort_bounces=True)
    tcam = camera_for(tw, th)
    ta = build_treelet_accels(scene, 4)
    ft = np.asarray(jax.jit(lambda k: render_treelet(
        scene, tcam, tst, k, mesh4, treelets=ta))(key))
    fr = np.asarray(jax.jit(lambda k: render(
        scene, tcam, tst, k, accel=bvh))(key))
    tdiff = np.abs(ft - fr)
    n_off = int(np.sum(tdiff.max(axis=-1) > 1e-5))
    num("treelet (4 parts) vs replicated: mean / max |diff| / pixels > 1e-5",
        f"{tdiff.mean():.3g} / {tdiff.max():.3g} / {n_off}")
    # equal-t ties between parts may pick another face of a shared edge,
    # whose flat normal differs: a few paths diverge, the film does not
    assert np.all(np.isfinite(ft))
    assert tdiff.mean() < 1e-4 and n_off / (tw * th) < 2e-3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1
    phase_device(count)
    if args.four_cards:
        log("phase 6 four cards")
        phase_four_cards()
    else:
        log("phase 2 kernel at real width")
        scene, camera_for, bvh = check_kernel(chunk=2 * 1920 * 1080)
        log("phase 3 render")
        phase_render(scene, camera_for, bvh)
        log("phase 4 backward")
        phase_backward(scene, camera_for, bvh)
        log("phase 5 inverse rendering")
        phase_inverse(scene, camera_for, bvh)
    d = jax.devices()[0]
    log(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
