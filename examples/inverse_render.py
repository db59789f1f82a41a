"""Inverse rendering demo (BASELINE config 5, scaled to the hardware at
hand): recover material albedos and refine vertex positions of a dragon
proxy from rendered target views, with rays + targets sharded over the
device mesh and gradients psum-reduced over the device interconnect.

Run:  python examples/inverse_render.py [--views 4] [--steps 60]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from atray.accel.bvh import build_bvh
from atray.config import KDTreeConfig
from atray.core.camera import camera_rays, look_at_camera
from atray.dist.mesh import make_device_mesh, trace_sharded
from atray.dist.train import make_train_step, run_training
from atray.scene import build_scene, procedural
from atray.scene.data import SceneParams, make_materials
from atray.scene.transforms import translate


def build_problem(views: int, res: int, tris: int):
    mats = make_materials([
        ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.8, 0.45, 0.25), 0.2),   # TRUE albedo (recover it)
    ])
    body = translate(
        procedural.dragon_proxy(target_tris=tris, material=1), (0, 0, -4)
    )
    scene = build_scene([body], materials=mats)
    accel = build_bvh(scene.mesh.vertices, scene.mesh.faces, KDTreeConfig())

    # one camera orbit -> `views` viewpoints; rays of ALL views concatenated
    # and sharded together over the mesh
    origs, dirns = [], []
    for v in range(views):
        ang = 2 * np.pi * v / views
        eye = (2.5 * np.sin(ang), 0.8, -4 + 2.5 * np.cos(ang))
        cam = look_at_camera(eye, (0, 0, -4), h_fov=0.8, aspect=1.0)
        o, d = camera_rays(cam, res, res, spp=1)
        origs.append(o)
        dirns.append(d)
    orig = jnp.concatenate(origs)
    dirn = jnp.concatenate(dirns)
    return scene, accel, orig, dirn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--tris", type=int, default=5000)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--bounces", type=int, default=2)
    ap.add_argument("--checkpoint", default=None,
                    help="npz train-state path; resumes if present "
                         "(params + optimizer state + step + seed)")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    args = ap.parse_args(argv)

    scene, accel, orig, dirn = build_problem(args.views, args.res, args.tris)
    mesh = make_device_mesh()
    key = jax.random.PRNGKey(0)
    n = orig.shape[0]
    pad = (-n) % mesh.devices.size
    if pad:
        orig = jnp.concatenate([orig, jnp.tile(orig[-1:], (pad, 1))])
        dirn = jnp.concatenate([dirn, jnp.tile(dirn[-1:], (pad, 1))])

    print(f"{args.views} views x {args.res}^2 px = {orig.shape[0]} rays "
          f"over {mesh.devices.size} device(s); {scene.mesh.num_faces} tris")

    # targets from the TRUE parameters through the same sharded pipeline
    target = trace_sharded(scene, orig, dirn, args.bounces, key, mesh,
                           accel=accel)

    # corrupt: wrong albedo + vertex noise
    p_true = scene.params()
    rng = np.random.default_rng(3)
    p = dataclasses.replace(
        p_true,
        albedo=p_true.albedo * 0.4 + 0.2,
        vertices=p_true.vertices
        + jnp.asarray(rng.normal(0, 0.004, p_true.vertices.shape), jnp.float32),
    )

    labels = SceneParams(vertices="geo", normals="frozen", emission="frozen",
                         albedo="mat", scatter="frozen")
    opt = optax.multi_transform(
        {"mat": optax.adam(3e-2), "geo": optax.adam(5e-4),
         "frozen": optax.set_to_zero()},
        labels,
    )
    # refit=True: leaf triangles + boxes recomputed from the live vertices
    # on-device each step, so the traversal tracks the moving geometry
    step = jax.jit(make_train_step(scene, args.bounces, opt, mesh,
                                   accel=accel, refit=True))
    opt_state = opt.init(p)

    def on_step(i, loss):
        if i % 10 == 0 or i == args.steps - 1:
            # material 1 only: the skybox row never affects the image
            alb_err = float(jnp.abs(p_box[0].albedo[1] - p_true.albedo[1]).max())
            v_err = float(jnp.abs(p_box[0].vertices - p_true.vertices).mean())
            print(f"step {i:4d}  loss {loss:.3e}  "
                  f"albedo_err {alb_err:.4f}  vert_err {v_err:.2e}")

    # box so on_step sees the live params as training advances
    p_box = [p]

    def step_track(p_, o_, *rest):
        out = step(p_, o_, *rest)
        p_box[0] = out[0]
        return out

    t0 = time.perf_counter()
    p, opt_state, losses = run_training(
        step_track, opt, p, opt_state, orig, dirn, target,
        num_steps=args.steps, seed=0,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        on_step=on_step,
    )
    dt = time.perf_counter() - t0
    steps_run = len(losses)
    print(f"{steps_run} steps in {dt:.1f}s "
          f"({steps_run * orig.shape[0] * args.bounces / max(dt, 1e-9) / 1e6:.2f} "
          f"Mray-steps/s incl. backward)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
