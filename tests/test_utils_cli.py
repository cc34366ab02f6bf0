"""utils/profiling + CLI argument plumbing."""

import os
import sys

import numpy as np
import pytest

from raytpu.utils.profiling import PhaseTimer, render_stats


class TestPhaseTimer:
    def test_phases_and_report(self):
        t = PhaseTimer()
        with t.phase("a"):
            sum(range(1000))
        with t.phase("b"):
            pass
        names = [n for n, _ in t.phases]
        assert names == ["a", "b"]
        assert t.total() >= 0
        rep = t.report(rays=1000)
        assert "a" in rep and "throughput" in rep


class TestRenderStats:
    def test_stats_shape(self):
        import jax
        import jax.numpy as jnp

        f = jax.jit(lambda x: x * 2.0)
        s = render_stats(f, (jnp.ones((8, 3)),), rays=8, reps=2)
        assert set(s) == {"compile_s", "best_s", "median_s", "rays_per_s"}
        assert s["rays_per_s"] > 0


class TestCliPlumbing:
    def test_render_command_end_to_end(self, tmp_path):
        from raytpu.cli.main import main

        out = str(tmp_path / "r.png")
        rc = main([
            "render", "--scene", "spheres", "--out", out,
            "--width", "16", "--height", "16", "--max-reflections", "0",
            "--intersector", "brute", "--progress",
        ])
        assert rc == 0
        assert os.path.exists(out)
        assert os.path.exists(str(tmp_path / "r.config.json"))

    def test_animate_command_writes_avi_and_frames(self, tmp_path):
        from raytpu.cli.main import main

        out = str(tmp_path / "t.avi")
        rc = main([
            "animate", "--scene", "spheres", "--out", out,
            "--frames", "2", "--width", "16", "--height", "16",
            "--max-reflections", "0", "--intersector", "brute",
        ])
        assert rc == 0
        assert os.path.exists(out)
        fdir = str(tmp_path / "t_frames")
        assert sorted(os.listdir(fdir)) == ["frame_0000.png",
                                            "frame_0001.png"]

    def test_config_round_trip(self):
        from raytpu.config import Intersector, RenderConfig

        cfg = RenderConfig(width=99, intersector=Intersector.PALLAS)
        back = RenderConfig.from_json(cfg.to_json())
        assert back == cfg


class TestSceneToml:
    """TOML scene files (scene/sceneformat.py, the .contentproj per-asset
    material-params analog) + the shipped assets/ bundle."""

    def test_demo_toml_matches_builtin_demo(self):
        """assets/demo.toml reproduces the reference's 4-sphere demo scene
        (Game1.cs:98-138): identical render to the builtin via the CLI
        builder."""
        import numpy as np

        from raytpu.cli.main import _build_scene
        from raytpu.config import Intersector, RenderConfig
        from raytpu.render import render_image
        from raytpu.scene.sceneformat import load_scene_toml

        scene, cam = load_scene_toml(
            os.path.join(os.path.dirname(__file__), "..", "assets",
                         "demo.toml"))
        assert cam is not None and tuple(cam.position) == (0.0, 16.0, 32.0)
        builtin = _build_scene("demo", reflect=0.5, transparent=False)
        cfg = RenderConfig(width=32, height=32, max_reflections=1,
                           intersector=Intersector.BRUTE, tile_pixels=1024)
        import dataclasses

        cam = dataclasses.replace(cam, aspect=1.0)
        img_t = np.asarray(render_image(scene.flatten(build_octree=False),
                                        cfg, cam))
        img_b = np.asarray(render_image(builtin.flatten(build_octree=False),
                                        cfg, cam))
        np.testing.assert_allclose(img_t, img_b, atol=2e-3)

    def test_obj_assets_load_and_render(self):
        """The shipped OBJ bundle parses and hits (crate.toml)."""
        import numpy as np

        from raytpu.config import Intersector, RenderConfig
        from raytpu.render import render_image
        from raytpu.scene.sceneformat import load_scene_toml

        scene, cam = load_scene_toml(
            os.path.join(os.path.dirname(__file__), "..", "assets",
                         "crate.toml"))
        cfg = RenderConfig(width=32, height=32, max_reflections=0,
                           intersector=Intersector.BRUTE, tile_pixels=1024)
        import dataclasses

        cam = dataclasses.replace(cam, aspect=1.0)
        img = np.asarray(render_image(scene.flatten(build_octree=False),
                                      cfg, cam))
        assert img.any(axis=-1).mean() > 0.2  # crate + plane visible

    def test_material_params_parse(self, tmp_path):
        """Byte-RGBA colors, transparency, refraction, rotation_degrees —
        the contentproj parameter set."""
        from raytpu.scene.sceneformat import load_scene_toml

        p = tmp_path / "s.toml"
        p.write_text("""
[[lights]]
type = "directional"
direction = [0.0, -1.0, 0.0]

[[objects]]
mesh = "box"
size = [2.0, 2.0, 2.0]
rotation_degrees = [-90.0, 45.0, 0.0]
scale = [1.0, 2.0, 1.0]
  [objects.material]
  diffuse_color = [255, 0, 0, 100]
  transparent = true
  refraction_index = 1.32
  reflectiveness = 0.7
  interpolate_normals = false
""")
        scene, cam = load_scene_toml(str(p))
        assert cam is None
        obj = scene.objects[0]
        m = obj.meshes[0].material
        assert m.transparent and abs(m.refraction_index - 1.32) < 1e-6
        assert abs(m.reflectiveness - 0.7) < 1e-6
        assert not m.interpolate_normals
        np.testing.assert_allclose(
            m.diffuse_color, (1.0, 0.0, 0.0, 100.0 / 255.0), atol=1e-6)
        import math

        np.testing.assert_allclose(
            obj.rotation, (-math.pi / 2, math.pi / 4, 0.0), atol=1e-6)
        np.testing.assert_allclose(obj.scale, (1.0, 2.0, 1.0))


class TestInteractiveViewer:
    """Interactive shell state machine (cli/interactive.py): the Game1
    keyboard loop analog — camera keys, Enter-to-trace, Space toggle,
    diagnostic-mode cycling, ANSI half-block display."""

    @pytest.fixture(scope="class")
    def sess(self):
        from raytpu.cli.interactive import InteractiveSession
        from raytpu.config import Intersector, RenderConfig
        from tests.scenes import sphere_and_plane_scene

        flat = sphere_and_plane_scene().flatten(leaf_threshold=16,
                                                max_depth=8)
        cfg = RenderConfig(width=32, height=32, max_reflections=1,
                           intersector=Intersector.BRUTE, tile_pixels=1024)
        return InteractiveSession(flat, cfg, preview_res=24)

    def test_camera_keys_move_the_camera(self, sess):
        c0 = sess.camera()
        assert sess.handle_key("a") == "move"
        assert sess.handle_key("w") == "move"
        c1 = sess.camera()
        assert not np.allclose(c0.position, c1.position)
        assert sess.radius < 35.0  # w dollied in

    def test_preview_and_trace_and_toggle(self, sess):
        pv = sess.render_preview()
        assert pv.shape == (24, 24, 3) and pv.any()
        assert sess.handle_key("\r") == "trace"
        calls = []
        img = sess.render_full(progress=lambda d, t: calls.append((d, t)))
        assert img.shape == (32, 32, 3) and img.any()
        assert calls and calls[-1][0] == calls[-1][1]  # progress completed
        assert sess.showing_trace
        assert sess.handle_key(" ") == "toggle" and not sess.showing_trace
        assert sess.handle_key(" ") == "toggle" and sess.showing_trace
        np.testing.assert_array_equal(sess.current_image(), img)
        # Moving the camera drops back to the (stale-free) preview.
        sess.handle_key("d")
        assert not sess.showing_trace

    def test_mode_cycle_changes_preview(self, sess):
        from raytpu.config import RenderMode

        sess.mode = RenderMode.SHADED
        shaded = sess.render_preview()
        assert sess.handle_key("n") == "mode"
        assert sess.mode == RenderMode.NORMALS
        normals = sess.render_preview()
        assert not np.allclose(shaded, normals)
        sess.handle_key("n")
        sess.handle_key("n")
        assert sess.mode == RenderMode.SHADED

    def test_quit_and_noop(self, sess):
        assert sess.handle_key("q") == "quit"
        assert sess.handle_key("\x1b") == "quit"
        assert sess.handle_key("z") == "noop"

    def test_ansi_image(self):
        from raytpu.cli.interactive import ansi_image

        img = np.zeros((4, 3, 3), np.float32)
        img[0, 0] = (1.0, 0.0, 0.0)   # top-left red
        txt = ansi_image(img)
        lines = txt.split("\n")
        assert len(lines) == 2  # 4 rows -> 2 half-block lines
        assert "\x1b[38;2;255;0;0m" in lines[0]  # red foreground
        assert txt.count("▀") == 6
        # Odd height pads; wide images downsample to <= max_cols.
        txt2 = ansi_image(np.zeros((5, 240, 3)), max_cols=80)
        assert all(l.count("▀") <= 80 for l in txt2.split("\n"))


def test_toml_convex_applies_to_all_mesh_kinds(tmp_path):
    from raytpu.scene.sceneformat import load_scene_toml

    p = tmp_path / "c.toml"
    p.write_text("""
[[objects]]
mesh = "box"
convex = true

[[objects]]
mesh = "plane"
convex = true
""")
    scene, _ = load_scene_toml(str(p))
    assert all(m.convex for o in scene.objects for m in o.meshes)


def test_toml_use_texture_without_texture_raises(tmp_path):
    from raytpu.scene.sceneformat import load_scene_toml

    p = tmp_path / "bad.toml"
    p.write_text("""
[[objects]]
mesh = "box"
  [objects.material]
  use_texture = true
""")
    with pytest.raises(ValueError, match="use_texture"):
        load_scene_toml(str(p))


def test_interactive_arrow_key_decode():
    import io

    from raytpu.cli.interactive import _read_key

    class FakeStdin(io.StringIO):
        def fileno(self):
            raise io.UnsupportedOperation

    # select() needs a real fd; emulate with a pipe.
    import os as _os

    r, w = _os.pipe()
    _os.write(w, b"\x1b[Ax\x1b[Z")
    with _os.fdopen(r, "r") as f:
        assert _read_key(f) == "r"      # Up arrow -> rise
        assert _read_key(f) == "x"      # plain key passes through
        assert _read_key(f) == ""       # unknown CSI -> noop
    _os.close(w)


def test_interactive_object_spin_rebakes():
    """j/k spin the first object (the reference's N/M keys) by re-baking
    the host scene; without a host scene they are noops."""
    from raytpu.cli.interactive import InteractiveSession
    from raytpu.config import Intersector, RenderConfig
    from tests.scenes import sphere_and_plane_scene

    host = sphere_and_plane_scene()
    flat = host.flatten(leaf_threshold=16, max_depth=8)
    cfg = RenderConfig(width=16, height=16, max_reflections=0,
                       intersector=Intersector.BRUTE, tile_pixels=256)
    sess = InteractiveSession(flat, cfg, preview_res=16, host_scene=host,
                              flatten_kwargs=dict(leaf_threshold=16,
                                                  max_depth=8))
    v0 = np.asarray(sess.scene.tri_v1).copy()
    assert sess.handle_key("j") == "move"
    assert abs(host.objects[0].rotation[1]) > 0
    assert not np.allclose(v0, np.asarray(sess.scene.tri_v1))

    no_host = InteractiveSession(flat, cfg, preview_res=16)
    assert no_host.handle_key("j") == "noop"


class TestCliDistribution:
    """--devices / --ring product surface (cli/main.py::_render_frame):
    parallel rendering is the default execution mode of the reference's
    engine (the scanline pool, RayTracer.cs:48-120) — here it must be
    reachable from the CLI, not just the library."""

    def test_render_devices_all(self, tmp_path):
        import numpy as np

        from raytpu.cli.main import main
        from raytpu.io.image import read_image

        out = str(tmp_path / "d.png")
        single = str(tmp_path / "s.png")
        args = ["render", "--scene", "spheres", "--width", "24",
                "--height", "24", "--max-reflections", "1",
                "--intersector", "brute"]
        assert main(args + ["--out", out, "--devices", "all"]) == 0
        assert main(args + ["--out", single]) == 0
        np.testing.assert_array_equal(read_image(out), read_image(single))

    def test_render_devices_ring(self, tmp_path):
        import numpy as np

        from raytpu.cli.main import main
        from raytpu.io.image import read_image

        out = str(tmp_path / "ring.png")
        single = str(tmp_path / "s.png")
        args = ["render", "--scene", "spheres", "--width", "24",
                "--height", "24", "--max-reflections", "1",
                "--intersector", "tiled"]
        assert main(args + ["--out", out, "--devices", "all",
                            "--ring"]) == 0
        assert main(args + ["--out", single]) == 0
        a, b = read_image(out), read_image(single)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


class TestCompileCacheRule:
    """utils/cache.py: JAX_COMPILATION_CACHE_DIR wins when set; otherwise
    the cache is the checkout's .jax_cache."""

    def test_env_dir_is_left_to_jax(self, monkeypatch):
        import jax

        from raytpu.utils import cache

        updates = []
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: updates.append(a))
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
        assert cache.setup_compile_cache() == "/elsewhere/cache"
        assert updates == []

    def test_default_is_repo_dot_jax_cache(self, monkeypatch):
        import jax

        from raytpu.utils import cache

        updates = []
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: updates.append(a))
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        want = os.path.join(repo, ".jax_cache")
        assert cache.setup_compile_cache() == want
        assert updates == [("jax_compilation_cache_dir", want)]
        with open(os.path.join(repo, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
