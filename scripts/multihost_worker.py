"""Worker for the 2-process multi-host test (tests/test_multihost.py).

Each process: 4 virtual CPU devices, jax.distributed over a localhost
coordinator — the collective legs between the two processes are the
cross-host plane of SURVEY.md §5.8, carried by gRPC but exercising the same multi-controller code paths (global mesh, global
arrays, cross-process psum, film assembly).

Usage: multihost_worker.py <coordinator> <num_procs> <pid>
Prints PASS lines; the pytest wrapper asserts on them.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402


def main() -> None:
    coord, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    # initialize the multi-process runtime BEFORE importing atray:
    # package import materializes module-level jnp constants, which
    # initializes the XLA backend and closes the distributed-init window
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )

    from atray.dist.multihost import (
        assemble_film,
        global_ray_mesh,
        host_local_slice,
        process_info,
    )
    assert process_info() == (pid, nproc), process_info()
    mesh = global_ray_mesh()
    n_dev = int(mesh.devices.size)
    assert n_dev == 4 * nproc, f"global mesh has {n_dev} devices"
    print(f"PASS mesh {n_dev} devices", flush=True)

    # cross-process psum over the global mesh (the DCN collective leg)
    from functools import partial

    @partial(jax.shard_map, mesh=mesh, in_specs=P("rays"), out_specs=P())
    def total(x):
        return jax.lax.psum(jnp.sum(x), "rays")

    n = 8 * n_dev
    xs = np.arange(n, dtype=np.float32)
    sharding = NamedSharding(mesh, P("rays"))
    xg = jax.make_array_from_process_local_data(sharding, xs[
        host_local_slice(n)
    ], global_shape=(n,))
    out = jax.jit(total)(xg)
    expect = float(xs.sum())
    got = float(np.asarray(jax.device_get(out)))
    assert got == expect, (got, expect)
    print("PASS psum", flush=True)

    # host_local_slice partitions exactly
    slices = [host_local_slice(10)] if nproc == 1 else None
    lo = host_local_slice(10)
    assert 0 <= lo.start <= lo.stop <= 10
    print("PASS slice", flush=True)

    # a real multi-process sharded render: global ray array in, film out,
    # assembled identically on every host and equal to the local render
    from atray.config import RenderSettings
    from atray.core.camera import camera_rays, look_at_camera
    from atray.render.wavefront import to_tile_order, trace_radiance
    from atray.scene import build_scene, procedural
    from atray.scene.data import make_materials
    from atray.scene.transforms import translate

    mats = make_materials([
        ((0.3, 0.4, 0.6), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.7, 0.5, 0.3), 0.1),
    ])
    mesh_g = translate(procedural.cube(size=1.5, material=1), (0, 0, -4))
    scene = build_scene([mesh_g], materials=mats)
    cam = look_at_camera((0, 0.3, 0.5), (0, 0, -4), h_fov=0.9, aspect=1.0)
    w = h = 8
    orig, dirn = camera_rays(cam, w, h, 1)
    orig = to_tile_order(orig, w, h, 1)
    dirn = to_tile_order(dirn, w, h, 1)
    nrays = orig.shape[0]
    ids = np.arange(nrays, dtype=np.int32)
    key = jax.random.PRNGKey(0)

    sl = host_local_slice(nrays)
    og = jax.make_array_from_process_local_data(
        sharding, np.asarray(orig)[sl], global_shape=(nrays, 3)
    )
    dg = jax.make_array_from_process_local_data(
        sharding, np.asarray(dirn)[sl], global_shape=(nrays, 3)
    )
    ig = jax.make_array_from_process_local_data(
        sharding, ids[sl], global_shape=(nrays,)
    )

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("rays"), P("rays"), P("rays")),
        out_specs=P("rays"),
        check_vma=False,
    )
    def run(o, d, i):
        return trace_radiance(scene, o, d, 2, key=key, ray_ids=i)

    color_g = jax.jit(run)(og, dg, ig)
    film = assemble_film(color_g)
    assert film.shape == (nrays, 3)

    color_lo = np.asarray(
        trace_radiance(scene, orig, dirn, 2, key=key,
                       ray_ids=jnp.asarray(ids))
    )
    np.testing.assert_allclose(film, color_lo, atol=1e-5)
    assert color_lo.std() > 0.01
    print("PASS render", flush=True)


if __name__ == "__main__":
    main()
