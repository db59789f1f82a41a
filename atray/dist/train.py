"""Inverse rendering: sharded pixel-loss gradient steps (BASELINE config 5).

The capability the reference lacks entirely (it has no differentiation):
optimize scene parameters (vertex positions, normals, material
emission/albedo/scatter) from target images by gradient descent. SPMD
layout: rays + target pixels sharded over the mesh axis, parameters
replicated, per-shard gradients all-reduced with an explicit ``psum`` over
the device interconnect — the gradient-reduction design from SURVEY.md §5.8.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, PartitionSpec as P

from atray.render.wavefront import trace_radiance
from atray.scene.data import Scene, SceneParams


def make_loss_and_grad(
    scene_template: Scene,
    bounce_limit: int,
    mesh: Mesh,
    accel=None,
    axis_name: str = "rays",
    refit: bool = False,
) -> Callable:
    """Returns f(params, orig, dirn, target, key) -> (loss, grads).

    orig/dirn/target are flat (N, 3) arrays sharded over ``axis_name``;
    params replicated. Loss = mean squared pixel error over all N rays;
    grads arrive fully psum-reduced (identical on every shard).

    ``refit=True`` (vertex optimization): the BVH's leaf triangles and
    node boxes are recomputed from the CURRENT vertices on-device every
    evaluation (accel.bvh.refit_bvh), so the traversal never goes stale as
    geometry moves — no host rebuild, no recompile.
    """

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis_name), P(axis_name), P(axis_name), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def _loss_grad(params: SceneParams, orig, dirn, target, key):
        shard = jax.lax.axis_index(axis_name)
        gids = shard * orig.shape[0] + jnp.arange(
            orig.shape[0], dtype=jnp.int32
        )
        n_total = orig.shape[0] * jax.lax.axis_size(axis_name)

        def local_loss(p):
            scene = scene_template.with_params(p)
            accel_ = accel
            if refit and accel is not None:
                from atray.accel.bvh import refit_bvh

                accel_ = refit_bvh(
                    accel, scene.mesh.vertices, scene.mesh.faces
                )
            color = trace_radiance(
                scene, orig, dirn, bounce_limit, key=key, accel=accel_,
                ray_ids=gids,
            )
            return jnp.sum((color - target) ** 2) / (3.0 * n_total)

        loss, grads = jax.value_and_grad(local_loss)(params)
        loss = jax.lax.psum(loss, axis_name)
        grads = jax.lax.psum(grads, axis_name)
        return loss, grads

    return _loss_grad


def make_train_step(
    scene_template: Scene,
    bounce_limit: int,
    optimizer: optax.GradientTransformation,
    mesh: Mesh,
    accel=None,
    axis_name: str = "rays",
    refit: bool = False,
) -> Callable:
    """Returns step(params, opt_state, orig, dirn, target, key) ->
    (params, opt_state, loss). Jit-compatible; rays/target sharded,
    params/opt_state replicated, gradient psum inside."""
    loss_grad = make_loss_and_grad(
        scene_template, bounce_limit, mesh, accel=accel, axis_name=axis_name,
        refit=refit,
    )

    def step(params, opt_state, orig, dirn, target, key):
        loss, grads = loss_grad(params, orig, dirn, target, key)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def save_train_state(
    path: str,
    params: SceneParams,
    opt_state,
    step: int,
    seed: int,
) -> None:
    """Checkpoint the FULL optimization state — scene params, optimizer
    state (Adam moments etc.), step counter, base PRNG seed — so a
    preempted inverse-rendering job resumes bit-exactly (SURVEY.md §5.4;
    the per-step key is fold_in(seed, step), counter-based).

    Pytrees are flattened to indexed npz leaves; structure is re-derived on
    load from a template, so no pickle and no custom tags. Atomic replace
    (the reference's analog is the collision-safe BMP writer,
    texture.cpp:95-113 — here the concern is a kill mid-write).
    """
    leaves_p = jax.tree_util.tree_leaves(params)
    leaves_o = jax.tree_util.tree_leaves(opt_state)
    payload = {f"p{i}": np.asarray(x) for i, x in enumerate(leaves_p)}
    payload.update({f"o{i}": np.asarray(x) for i, x in enumerate(leaves_o)})
    payload["step"] = np.int64(step)
    payload["seed"] = np.int64(seed)
    tmp = path + ".tmp"
    np.savez(tmp, **payload)
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load_train_state(
    path: str,
    params_template: SceneParams,
    optimizer: optax.GradientTransformation,
):
    """Restore (params, opt_state, step, seed) from ``save_train_state``.

    Returns None when no checkpoint exists. Tree structures come from the
    template (``optimizer.init(params_template)`` for the optimizer), so a
    checkpoint only matches the run that created it — shape mismatches
    raise instead of silently mixing states.
    """
    if not os.path.exists(path):
        return None
    z = np.load(path)
    pdef = jax.tree_util.tree_structure(params_template)
    odef = jax.tree_util.tree_structure(optimizer.init(params_template))
    n_p = pdef.num_leaves
    n_o = odef.num_leaves
    leaves_p = [jnp.asarray(z[f"p{i}"]) for i in range(n_p)]
    leaves_o = [jnp.asarray(z[f"o{i}"]) for i in range(n_o)]
    tmpl_p = jax.tree_util.tree_leaves(params_template)
    for i, (got, want) in enumerate(zip(leaves_p, tmpl_p)):
        if got.shape != jnp.shape(want):
            raise ValueError(
                f"checkpoint param leaf {i} shape {got.shape} != "
                f"template {jnp.shape(want)}"
            )
    params = jax.tree_util.tree_unflatten(pdef, leaves_p)
    opt_state = jax.tree_util.tree_unflatten(odef, leaves_o)
    return params, opt_state, int(z["step"]), int(z["seed"])


def run_training(
    step_fn: Callable,
    optimizer: optax.GradientTransformation,
    params: SceneParams,
    opt_state,
    orig,
    dirn,
    target,
    num_steps: int,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
    on_step: Optional[Callable] = None,
):
    """Drive ``step_fn`` for ``num_steps``, checkpointing train state every
    ``checkpoint_every`` steps and resuming from ``checkpoint_path`` if it
    exists. Per-step keys are fold_in(PRNGKey(seed), step) — pure counter
    streams, so kill + resume reproduces the uninterrupted run exactly.

    Returns (params, opt_state, losses list for the steps run here).
    """
    start = 0
    if checkpoint_path:
        got = load_train_state(checkpoint_path, params, optimizer)
        if got is not None:
            params, opt_state, start, seed = got
    base = jax.random.PRNGKey(seed)
    losses = []
    for s in range(start, num_steps):
        key = jax.random.fold_in(base, s)
        params, opt_state, loss = step_fn(
            params, opt_state, orig, dirn, target, key
        )
        losses.append(float(loss))
        if checkpoint_path and (s + 1) % checkpoint_every == 0:
            save_train_state(checkpoint_path, params, opt_state, s + 1, seed)
        if on_step is not None:
            on_step(s, float(loss))
    if checkpoint_path and num_steps > start:
        save_train_state(checkpoint_path, params, opt_state, num_steps, seed)
    return params, opt_state, losses
