"""Renderer integration tests (brute vs octree, masks, quantization)."""

import numpy as np
import pytest

from raytpu.config import Intersector, Quantize
from raytpu.render.wavefront import render_image
from tests.scenes import (
    crate_scene,
    default_camera,
    small_cfg,
    sphere_and_plane_scene,
)


def _img(scene, cfg):
    flat = scene.flatten(leaf_threshold=16, max_depth=8)
    return np.asarray(render_image(flat, cfg, default_camera()))


class TestRenderImage:
    def test_nonempty_and_bounded(self):
        img = _img(sphere_and_plane_scene(), small_cfg())
        assert img.shape == (24, 24, 3)
        assert img.min() >= 0.0 and img.max() <= 1.0
        assert img.mean() > 0.01  # something was lit

    def test_brute_vs_octree_identical(self):
        sc = sphere_and_plane_scene()
        a = _img(sc, small_cfg(intersector=Intersector.BRUTE))
        b = _img(sc, small_cfg(intersector=Intersector.OCTREE))
        np.testing.assert_allclose(a, b, atol=1e-6)

    def test_pallas_full_shading_matches_brute(self):
        """End-to-end shading (shadows, reflection, texture) through the
        walk kernel (kernels/walk.py, interpret mode on CPU)."""
        sc = sphere_and_plane_scene(reflect=0.5, textured=True)
        a = _img(sc, small_cfg(intersector=Intersector.BRUTE,
                               max_reflections=2))
        b = _img(sc, small_cfg(intersector=Intersector.PALLAS,
                               max_reflections=2, interpret=True))
        np.testing.assert_allclose(a, b, atol=1e-5)

    def test_reflections_add_light(self):
        sc = sphere_and_plane_scene(reflect=0.8)
        none = _img(sc, small_cfg(max_reflections=0))
        some = _img(sc, small_cfg(max_reflections=3))
        assert not np.allclose(none, some)

    def test_textured_crate(self):
        img = _img(crate_scene(), small_cfg(max_reflections=0))
        # The checkerboard produces both bright and dark texels.
        assert img.max() > 0.3
        assert img.std() > 0.02

    def test_transparent_scene_runs(self):
        sc = sphere_and_plane_scene(transparent=True)
        img = _img(sc, small_cfg(max_reflections=2))
        assert np.isfinite(img).all()
        assert img.mean() > 0.0

    def test_quantize_bounce_is_byte_stepped(self):
        sc = sphere_and_plane_scene()
        img = _img(sc, small_cfg(quantize=Quantize.BOUNCE))
        steps = img * 255.0
        np.testing.assert_allclose(steps, np.round(steps), atol=1e-4)

    def test_tile_size_invariance(self):
        sc = sphere_and_plane_scene()
        a = _img(sc, small_cfg(tile_pixels=576))
        b = _img(sc, small_cfg(tile_pixels=64))
        np.testing.assert_allclose(a, b, atol=1e-6)

    def test_two_lights(self):
        sc = sphere_and_plane_scene(light="both")
        img = _img(sc, small_cfg())
        one = _img(sphere_and_plane_scene(light="spot"), small_cfg())
        assert img.mean() > one.mean()  # extra light adds energy


class TestWavefrontCompaction:
    """Transparent wavefront slot management (render/wavefront.py):
    no-dual scenes keep R0 slots per level (single-child merge), dual
    scenes optionally compact live-first between levels — both exact."""

    def _render(self, flat, cfg, cam, spy_sizes=None, monkeypatch=None):
        import raytpu.render.wavefront as wf
        from raytpu.render import render_image

        if spy_sizes is not None:
            orig = wf._trace_level

            def spy(scene, cfg_, rays, is_max, **kw):
                spy_sizes.append(int(rays.origin.shape[0]))
                return orig(scene, cfg_, rays, is_max, **kw)

            monkeypatch.setattr(wf, "_trace_level", spy)
        try:
            return np.asarray(render_image(flat, cfg, cam))
        finally:
            if spy_sizes is not None:
                monkeypatch.setattr(wf, "_trace_level", orig)

    def test_nodual_levels_stay_r0_and_match_forced_dual(self, monkeypatch):
        from raytpu.config import Intersector, Quantize, RenderConfig
        from raytpu.core.camera import Camera

        # Plain glass: transparent, reflectiveness 0 -> no dual branching.
        flat = sphere_and_plane_scene(reflect=0.0, transparent=True).flatten(
            build_octree=False, cluster_size=16)
        assert flat.has_transparent and not flat.has_dual_branch
        cfg = RenderConfig(width=24, height=24, max_reflections=8,
                           intersector=Intersector.TILED,
                           quantize=Quantize.NONE, tile_pixels=576)
        cam = Camera(position=(0.0, 16.0, 32.0), aspect=1.0)

        sizes = []
        img_merged = self._render(flat, cfg, cam, sizes, monkeypatch)
        r0 = 576
        assert sizes and all(s == r0 for s in sizes), sizes
        assert len(sizes) == 9

        # Forcing the dual (doubling) path must give identical pixels.
        sizes2 = []
        img_dual = self._render(flat.replace(has_dual_branch=True), cfg,
                                cam, sizes2, monkeypatch)
        assert sizes2[-1] == r0 * 2 ** 8
        np.testing.assert_allclose(img_merged, img_dual, atol=1e-6)

    def test_dual_compaction_parity(self, monkeypatch):
        import dataclasses

        from raytpu.config import Intersector, Quantize, RenderConfig
        from raytpu.core.camera import Camera

        flat = sphere_and_plane_scene(reflect=0.3, transparent=True).flatten(
            build_octree=False, cluster_size=16)
        assert flat.has_dual_branch
        cfg = RenderConfig(width=24, height=24, max_reflections=4,
                           intersector=Intersector.TILED,
                           quantize=Quantize.NONE, tile_pixels=576)
        cam = Camera(position=(0.0, 16.0, 32.0), aspect=1.0)
        img_c = self._render(flat, cfg, cam)
        img_u = self._render(
            flat, dataclasses.replace(cfg, compact_wavefront=False), cam)
        np.testing.assert_allclose(img_c, img_u, atol=1e-6)


class TestShadowFromLight:
    """Shadow-from-light reversal (render/wavefront.py::_light_result):
    occlusion cast light->fragment with mirrored culling must give the
    same image as the forward fragment->light query."""

    @pytest.mark.parametrize("intersector",
                             [Intersector.BRUTE, Intersector.TILED])
    def test_reversed_equals_forward(self, intersector):
        import dataclasses

        from raytpu.config import RenderConfig
        from raytpu.core.camera import Camera

        # Sphere over plane: real occlusion (the sphere's shadow).
        flat = sphere_and_plane_scene(reflect=0.2).flatten(
            build_octree=False, cluster_size=16)
        cfg = RenderConfig(width=32, height=32, max_reflections=1,
                           intersector=intersector, quantize=Quantize.NONE,
                           tile_pixels=1024, tri_block=256)
        cam = Camera(position=(0.0, 16.0, 32.0), aspect=1.0)
        img_rev = np.asarray(render_image(flat, cfg, cam))
        img_fwd = np.asarray(render_image(
            flat, dataclasses.replace(cfg, shadow_from_light=False), cam))
        # The contract is FP-rounding equality: an edge-grazing occluder
        # can flip a shadow texel between the two casts on some backends
        # (render/wavefront.py), so allow a sub-0.5% pixel disagreement.
        flipped = (np.abs(img_rev - img_fwd).max(axis=-1) > 1e-6).mean()
        assert flipped < 0.005, f"{100 * flipped:.2f}% of pixels flipped"

    def test_directional_light_stays_forward(self):
        """Directional lights have no position; the reversal must not
        engage (light_kinds gating) and the render must still match the
        forward-only config."""
        import dataclasses

        from raytpu.config import RenderConfig
        from raytpu.core.camera import Camera

        flat = sphere_and_plane_scene(reflect=0.0, light="directional"
                                      ).flatten(build_octree=False,
                                                cluster_size=16)
        cfg = RenderConfig(width=24, height=24, max_reflections=0,
                           intersector=Intersector.BRUTE,
                           quantize=Quantize.NONE, tile_pixels=576,
                           tri_block=256)
        cam = Camera(position=(0.0, 16.0, 32.0), aspect=1.0)
        img_a = np.asarray(render_image(flat, cfg, cam))
        img_b = np.asarray(render_image(
            flat, dataclasses.replace(cfg, shadow_from_light=False), cam))
        np.testing.assert_array_equal(img_a, img_b)


class TestShadowClearance:
    """Per-block shadow clearance (accel/shadowcull.py, r5): the reversed
    spot query starts at light + t_min*dir and the directional query caps
    t_max at the own-block exit — both EXACT (every possible occluder
    provably inside the searched segment)."""

    def test_spot_parity_with_real_occlusion(self):
        import dataclasses

        scene = sphere_and_plane_scene(reflect=0.0, textured=True)
        flat = scene.flatten(build_octree=False, cluster_size=16)
        cfg = small_cfg(width=32, height=32, max_reflections=0,
                        intersector=Intersector.TILED, tile_pixels=256,
                        quantize=Quantize.NONE)
        cam = default_camera()
        img_on = np.asarray(render_image(
            flat, dataclasses.replace(cfg, shadow_clearance=True), cam))
        img_off = np.asarray(render_image(flat, cfg, cam))
        # The scene must actually exercise shadows.
        assert (img_on.max(-1) == 0).sum() > 100
        np.testing.assert_array_equal(img_on, img_off)

    def test_directional_parity(self):
        import dataclasses

        from raytpu.scene.lights import DirectionalLight
        from raytpu.scene.types import Scene

        base = sphere_and_plane_scene(reflect=0.0)
        scene = Scene(objects=base.objects,
                      lights=[DirectionalLight(direction=(0.3, -0.8, -0.5))])
        flat = scene.flatten(build_octree=False, cluster_size=16)
        cfg = small_cfg(width=32, height=32, max_reflections=0,
                        intersector=Intersector.TILED, tile_pixels=256,
                        quantize=Quantize.NONE)
        cam = default_camera()
        img_on = np.asarray(render_image(
            flat, dataclasses.replace(cfg, shadow_clearance=True), cam))
        img_off = np.asarray(render_image(flat, cfg, cam))
        np.testing.assert_array_equal(img_on, img_off)

    def test_clearance_lower_bounds_every_occluder(self):
        """Soundness probe: for random fragments, EVERY brute-force
        occluder along the light segment sits at light-distance >=
        min(D(own block), own-block entry) — the exactness invariant the
        query shift relies on."""
        import jax.numpy as jnp

        from raytpu.accel.shadowcull import (clearance_spot,
                                             own_block_entry_exit)
        from raytpu.accel.traverse import nearest_hit_brute

        flat = sphere_and_plane_scene(reflect=0.0).flatten(
            build_octree=False, cluster_size=16)
        cl = flat.clusters
        lp = np.asarray([0.0, 5.0, 20.0], np.float32)
        dvals = np.asarray(clearance_spot(cl, lp))

        rng = np.random.default_rng(12)
        tri_ids = rng.integers(0, flat.num_tris, size=64)
        v1 = np.asarray(flat.tri_v1)[tri_ids]
        e1 = np.asarray(flat.tri_e1)[tri_ids]
        e2 = np.asarray(flat.tri_e2)[tri_ids]
        w1 = rng.uniform(0, 1, 64).astype(np.float32)
        w2 = (rng.uniform(0, 1, 64) * (1 - w1)).astype(np.float32)
        frag = v1 + e1 * w1[:, None] + e2 * w2[:, None]
        vec = frag - lp
        dist = np.linalg.norm(vec, axis=-1)
        dirs = vec / dist[:, None]

        b_id, t_en, _ = own_block_entry_exit(
            cl, cl["tri_block"], jnp.asarray(tri_ids, jnp.int32),
            jnp.asarray(np.broadcast_to(lp, frag.shape).copy()),
            jnp.asarray(dirs))
        t_min = np.minimum(dvals[np.asarray(b_id)],
                           np.maximum(np.asarray(t_en), 0.0))

        # March each segment with brute nearest hits to enumerate real
        # occluder distances; each must be >= its ray's bound.
        o = jnp.asarray(np.broadcast_to(lp, frag.shape).copy())
        d = jnp.asarray(dirs)
        h = nearest_hit_brute(flat, o, d, cull=False, block=256)
        hit = np.asarray(h.hit) & (np.asarray(h.t) < dist - 1e-4)
        assert hit.any()  # the probe must see real occluders
        viol = hit & (np.asarray(h.t) < t_min - 1e-5)
        assert not viol.any(), np.asarray(h.t)[viol]
