"""Auxiliary subsystems: profiling phases, progressive checkpoint/resume,
multihost helpers, CLI scene loading (SURVEY.md §5.1/§5.4/§5.8, §2 #22)."""

import os

import jax
import numpy as np
import pytest

from atray.config import RenderSettings
from atray.core.camera import look_at_camera
from atray.render.progressive import (
    FilmState,
    load_checkpoint,
    render_progressive,
    save_checkpoint,
)
from atray.scene import build_scene, procedural
from atray.scene.data import make_materials
from atray.scene.transforms import translate
from atray.utils.profiling import Phase, metrics_json, phase_report, reset_phases


def _scene():
    mats = make_materials([
        ((0.4, 0.5, 0.7), (0, 0, 0), 0.0),
        ((0.0, 0.0, 0.0), (0.8, 0.6, 0.4), 0.2),
    ])
    return build_scene(
        [translate(procedural.cube(material=1), (0, 0, -4))], materials=mats
    )


class TestProfiling:
    def test_phase_registry_and_report(self):
        reset_phases()
        with Phase("load"):
            pass
        with Phase("render"):
            pass
        with Phase("render"):
            pass
        rep = phase_report(rays=1000)
        assert "load" in rep and "render" in rep and "rays/s" in rep
        import json

        m = json.loads(metrics_json(extra={"x": 1}))
        assert m["phases"]["render"]["runs"] == 2
        assert m["x"] == 1


class TestProgressive:
    def test_checkpoint_roundtrip(self, tmp_path):
        p = str(tmp_path / "ck.npz")
        st = FilmState(
            film_sum=np.ones((4, 4, 3), np.float32) * 2.0,
            batches_done=3, spp_per_batch=2, seed=7,
        )
        save_checkpoint(p, st)
        st2 = load_checkpoint(p)
        assert st2.batches_done == 3 and st2.spp_per_batch == 2 and st2.seed == 7
        np.testing.assert_array_equal(st2.film_sum, st.film_sum)
        np.testing.assert_allclose(st2.film(), np.clip(st.film_sum / 3, 0, 1))

    def test_resume_bit_identical(self, tmp_path):
        scene = _scene()
        cam = look_at_camera((0, 0.4, 0.5), (0, 0, -4), h_fov=0.8, aspect=1.0)
        s = RenderSettings(resolution=(12, 12), samples_per_pixel=2, bounce_limit=2)
        # uninterrupted: 3 batches
        full = render_progressive(scene, cam, s, total_spp=6, seed=5)
        # interrupted after 1 batch, then resumed from checkpoint
        p = str(tmp_path / "ck.npz")
        stops = []

        def stop_after_one(state):
            stops.append(state.batches_done)
            if state.batches_done == 1:
                raise KeyboardInterrupt

        try:
            render_progressive(
                scene, cam, s, total_spp=6, seed=5,
                checkpoint_path=p, on_batch=stop_after_one,
            )
        except KeyboardInterrupt:
            pass
        resumed = render_progressive(
            scene, cam, s, total_spp=6, seed=5, checkpoint_path=p,
        )
        assert resumed.batches_done == 3
        np.testing.assert_array_equal(resumed.film_sum, full.film_sum)


class TestMultihost:
    def test_single_process_helpers(self):
        from atray.dist.multihost import (
            assemble_film,
            global_ray_mesh,
            host_local_slice,
            init_distributed,
            process_info,
        )

        init_distributed()  # no-op single process
        assert process_info() == (0, 1)
        assert host_local_slice(100) == slice(0, 100)
        m = global_ray_mesh()
        assert m.devices.size == len(jax.devices())
        f = np.ones((4, 4, 3), np.float32)
        np.testing.assert_array_equal(assemble_film(f), f)


class TestCLI:
    def test_scene_toml_loading(self, tmp_path):
        toml = """
[render]
resolution = [32, 24]
samples_per_pixel = 2
bounce_limit = 3

[camera]
eye = [0.0, 0.5, 1.0]
look_at = [0.0, 0.0, -4.0]
h_fov = 0.8

[[materials]]
name = "sky"
emission = [0.3, 0.4, 0.6]

[[materials]]
name = "red"
albedo = [0.8, 0.2, 0.2]
scatter = 0.5

[[meshes]]
procedural = "cube"
material = "red"
translate_to = [0.0, 0.0, -4.0]

[[spheres]]
center = [1.0, 0.0, -4.0]
radius = 0.5
material = "red"

[[planes]]
normal = [0.0, 2.0, 0.0]
offset = -1.5
material = "red"

[mesh]
num_devices = 8
"""
        p = tmp_path / "scene.toml"
        p.write_text(toml)
        from atray.cli import load_scene_file

        scene, camera, settings, accel_cfg, mesh_cfg = load_scene_file(str(p))
        assert settings.resolution == (32, 24)
        assert settings.samples_per_pixel == 2
        assert mesh_cfg.num_devices == 8
        assert scene.mesh.num_faces == 12
        assert scene.spheres.count == 1
        assert scene.planes.count == 1
        # plane normal got normalized
        np.testing.assert_allclose(
            np.linalg.norm(np.asarray(scene.planes.normals)[0]), 1.0, rtol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(scene.materials.emission)[0], [0.3, 0.4, 0.6]
        )

    def test_cli_render_end_to_end(self, tmp_path):
        toml = """
[render]
resolution = [24, 16]
samples_per_pixel = 1
bounce_limit = 2

[[materials]]
name = "sky"
emission = [0.3, 0.4, 0.6]

[[materials]]
name = "grey"
albedo = [0.7, 0.7, 0.7]

[[meshes]]
procedural = "cube"
material = "grey"
translate_to = [0.0, 0.0, -4.0]
"""
        sp = tmp_path / "scene.toml"
        sp.write_text(toml)
        out = tmp_path / "img.png"
        from atray.cli import main

        rc = main(["render", str(sp), "-o", str(out)])
        assert rc == 0
        data = out.read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n"

    def test_cli_render_treelet(self, tmp_path, devices):
        toml = """
[render]
resolution = [16, 16]
samples_per_pixel = 1
bounce_limit = 2

[[materials]]
name = "sky"
emission = [0.3, 0.4, 0.6]

[[materials]]
name = "grey"
albedo = [0.7, 0.7, 0.7]

[[meshes]]
procedural = "cube"
material = "grey"
translate_to = [0.0, 0.0, -4.0]
"""
        sp = tmp_path / "scene.toml"
        sp.write_text(toml)
        out = tmp_path / "img_tl.png"
        ref = tmp_path / "img_ref.png"
        from atray.cli import main

        assert main(["render", str(sp), "-o", str(out), "--treelet"]) == 0
        assert main(["render", str(sp), "-o", str(ref)]) == 0
        # geometry-sharded CLI render matches the replicated one exactly
        assert out.read_bytes()[8:] == ref.read_bytes()[8:]


class TestDebugViz:
    def test_cost_heatmap_and_boxes(self, tmp_path):
        from atray.accel.bvh import build_bvh
        from atray.config import KDTreeConfig
        from atray.core.camera import look_at_camera
        from atray.scene.transforms import translate
        from atray.scene import procedural
        from atray.utils.debugviz import bvh_level_boxes, save_cost_heatmap

        mesh = translate(procedural.uv_sphere(rows=10, cols=10, material=1),
                         (0, 0, -4))
        scene = build_scene([mesh])
        bvh = build_bvh(scene.mesh.vertices, scene.mesh.faces, KDTreeConfig())
        cam = look_at_camera((0, 0.4, 0.5), (0, 0, -4), h_fov=0.8, aspect=1.0)
        p = save_cost_heatmap(str(tmp_path / "cost.png"), bvh, scene, cam,
                              width=48, height=32)
        assert (tmp_path / "cost.png").exists()
        boxes = bvh_level_boxes(bvh, level=2)
        assert boxes.shape[1:] == (2, 3) and boxes.shape[0] >= 1
        assert (boxes[:, 1] >= boxes[:, 0]).all()


class TestBMP:
    def test_bmp_roundtrip_header(self, tmp_path):
        from atray.render.film import save_bmp

        film = np.random.default_rng(0).uniform(0, 1, (7, 5, 3)).astype(np.float32)
        p = save_bmp(str(tmp_path / "img.bmp"), film)
        data = open(p, "rb").read()
        assert data[:2] == b"BM"
        import struct as st

        w = st.unpack("<i", data[18:22])[0]
        h = st.unpack("<i", data[22:26])[0]
        assert (w, h) == (5, 7)


class TestTrainCheckpoint:
    """SURVEY.md §5.4 second half: optimizer/training-state persistence
    (the film accumulator half is TestProgressive above)."""

    def _problem(self):
        import jax.numpy as jnp

        from atray.accel.bvh import build_bvh
        from atray.config import KDTreeConfig
        from atray.core.camera import camera_rays

        mats = make_materials([
            ((0.3, 0.4, 0.6), (0.0, 0.0, 0.0), 0.0),
            ((0.0, 0.0, 0.0), (0.8, 0.45, 0.25), 0.2),
        ])
        mesh = translate(procedural.uv_sphere(rows=6, cols=6, material=1),
                         (0, 0, -4))
        scene = build_scene([mesh], materials=mats)
        bvh = build_bvh(scene.mesh.vertices, scene.mesh.faces, KDTreeConfig())
        cam = look_at_camera((0, 0.3, 0.5), (0, 0, -4), h_fov=0.9, aspect=1.0)
        orig, dirn = camera_rays(cam, 8, 8, spp=1)
        target = jnp.zeros_like(orig)
        return scene, bvh, orig, dirn, target

    def test_save_load_roundtrip(self, tmp_path):
        import optax

        from atray.dist.train import load_train_state, save_train_state

        scene, _, _, _, _ = self._problem()
        p = scene.params()
        opt = optax.adam(1e-2)
        st = opt.init(p)
        path = str(tmp_path / "train.npz")
        save_train_state(path, p, st, step=7, seed=42)
        got = load_train_state(path, p, opt)
        assert got is not None
        p2, st2, step, seed = got
        assert (step, seed) == (7, 42)
        for a, b in zip(jax.tree_util.tree_leaves(p),
                        jax.tree_util.tree_leaves(p2)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree_util.tree_leaves(st),
                        jax.tree_util.tree_leaves(st2)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert load_train_state(str(tmp_path / "none.npz"), p, opt) is None

    def test_kill_resume_reproduces_uninterrupted_run(self, tmp_path, devices):
        # 6 optimization steps straight through vs 3 steps -> "kill" ->
        # resume from the checkpoint for the rest: params and optimizer
        # state must match BIT-EXACTLY (per-step keys are fold_in(seed,
        # step) counters, so the resumed stream continues the original).
        import optax

        from atray.dist.mesh import make_device_mesh
        from atray.dist.train import make_train_step, run_training

        scene, bvh, orig, dirn, target = self._problem()
        dmesh = make_device_mesh()
        opt = optax.adam(2e-2)
        step = jax.jit(make_train_step(scene, 2, opt, dmesh, accel=bvh))
        p0 = scene.params()
        s0 = opt.init(p0)

        p_full, s_full, losses_full = run_training(
            step, opt, p0, s0, orig, dirn, target, num_steps=6, seed=9,
        )

        path = str(tmp_path / "ckpt.npz")
        run_training(  # first half, checkpoints at step 3
            step, opt, p0, s0, orig, dirn, target, num_steps=3, seed=9,
            checkpoint_path=path, checkpoint_every=3,
        )
        # "kill": fresh params/opt_state; resume must come from the file
        p_res, s_res, losses_res = run_training(
            step, opt, p0, s0, orig, dirn, target, num_steps=6, seed=9,
            checkpoint_path=path, checkpoint_every=3,
        )
        assert len(losses_res) == 3  # only steps 3..5 re-run
        for a, b in zip(jax.tree_util.tree_leaves(p_full),
                        jax.tree_util.tree_leaves(p_res)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree_util.tree_leaves(s_full),
                        jax.tree_util.tree_leaves(s_res)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestTelemetry:
    def test_chunked_telemetry_matches_render_and_reports(self, devices):
        # film from the per-chunk timed path must equal the whole-frame
        # render bit-for-bit (global ray ids -> same PRNG streams), and the
        # tail table must cover every chunk.
        import jax.numpy as jnp

        from atray.render.telemetry import render_telemetry, tail_report
        from atray.render.wavefront import render

        mats = make_materials([
            ((0.3, 0.4, 0.6), (0.0, 0.0, 0.0), 0.0),
            ((0.0, 0.0, 0.0), (0.8, 0.45, 0.25), 0.2),
        ])
        mesh = translate(procedural.uv_sphere(rows=8, cols=8, material=1),
                         (0, 0, -4))
        scene = build_scene([mesh], materials=mats)
        cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
        s = RenderSettings(resolution=(16, 16), samples_per_pixel=2,
                           bounce_limit=3)
        key = jax.random.PRNGKey(0)
        film, report = render_telemetry(scene, cam, s, key, n_chunks=4)
        film_ref = render(scene, cam, s, key)
        np.testing.assert_array_equal(np.asarray(film), np.asarray(film_ref))
        assert report["n_chunks"] == 4
        assert len(report["chunk_s"]) == 4
        assert sum(report["chunk_live_rays"]) > 0
        text = tail_report(report)
        assert "imbal" in text and "chunk wall" in text

    def test_sharded_stats_expose_per_shard_rays(self, devices):
        from atray.dist.mesh import make_device_mesh
        from atray.render.wavefront import render

        mats = make_materials([
            ((0.3, 0.4, 0.6), (0.0, 0.0, 0.0), 0.0),
            ((0.0, 0.0, 0.0), (0.8, 0.45, 0.25), 0.2),
        ])
        mesh = translate(procedural.uv_sphere(rows=8, cols=8, material=1),
                         (0, 0, -4))
        scene = build_scene([mesh], materials=mats)
        cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
        s = RenderSettings(resolution=(16, 16), samples_per_pixel=2,
                           bounce_limit=3)
        dmesh = make_device_mesh()
        film, stats = render(scene, cam, s, jax.random.PRNGKey(0),
                             mesh=dmesh, return_stats=True)
        per_shard = np.asarray(stats["rays_cast_per_shard"])
        assert per_shard.shape == (8,)
        assert per_shard.sum() == float(stats["rays_cast"])
        assert (per_shard > 0).all()  # every shard saw live primaries


def test_progress_callback_ticks_per_chunk():
    # in-flight frame progress (VERDICT r4 next #8): the per-chunk
    # device callback must fire once per ray chunk with the chunk's
    # live-ray count
    import dataclasses

    import jax

    from atray.config import RenderSettings
    from atray.core.camera import look_at_camera
    from atray.render.wavefront import render
    from atray.scene import build_scene, procedural
    from atray.scene.data import make_materials
    from atray.scene.transforms import translate

    mats = make_materials([
        ((0.3, 0.4, 0.6), (0, 0, 0), 0.0),
        ((0.0, 0.0, 0.0), (0.7, 0.7, 0.7), 0.0),
    ])
    cube = translate(procedural.cube(size=1.5, material=1), (0, 0, -4))
    scene = build_scene([cube], materials=mats)
    cam = look_at_camera((0, 0.5, 1), (0, 0, -4), h_fov=0.9, aspect=4 / 3)
    st = RenderSettings(resolution=(64, 48), samples_per_pixel=2,
                        bounce_limit=2, ray_chunk=2048, sort_bounces=False)
    ticks = []

    film = jax.jit(lambda k: render(
        scene, cam, st, k,
        progress_cb=lambda live: ticks.append(float(live)),
    ))(jax.random.PRNGKey(0))
    jax.block_until_ready(film)
    assert len(ticks) == 3            # 6144 rays / 2048 per chunk
    assert all(t > 0 for t in ticks)


def test_cli_parses_quad_area_light_scene():
    # the shipped area-light example must parse: quads + emissive panel
    # materials (round-5 CLI authoring for NEE area lights)
    import os

    from atray.cli import load_scene_file

    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "arealight.toml")
    scene, camera, settings, accel_cfg, mesh_cfg = load_scene_file(path)
    assert settings.nee
    assert int(scene.mesh.num_faces) > 138_000  # dragon + 2 quads
    import numpy as np

    em = np.asarray(scene.materials.emission)
    mid = np.asarray(scene.mesh.material_id)
    assert (em.max(axis=1)[mid] > 0).sum() == 4  # 4 emissive faces


def test_cli_parses_checker_texture(tmp_path):
    import numpy as np

    from atray.cli import load_scene_file

    toml = tmp_path / "tex.toml"
    toml.write_text(
        "[render]\nresolution = [32, 24]\n"
        "[texture]\nchecker = [4, 4]\ncolor_a = [1.0, 0.0, 0.0]\n"
        "[[materials]]\nname = \"sky\"\nemission = [0.2, 0.2, 0.2]\n"
        "[[materials]]\nname = \"m\"\nalbedo = [0.8, 0.8, 0.8]\n"
        "[[meshes]]\nprocedural = \"cube\"\nmaterial = \"m\"\n"
    )
    scene, *_ = load_scene_file(str(toml))
    assert scene.texture is not None
    assert np.asarray(scene.texture).shape == (4, 4, 3)
