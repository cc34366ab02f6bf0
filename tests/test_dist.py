"""Sharded rendering on the 8-device virtual CPU mesh (SURVEY.md §4 item 5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytpu.config import Intersector, Quantize
from raytpu.dist import make_mesh, render_image_sharded, replicate_scene
from raytpu.render import render_image
from raytpu.scene.flatten import flatten_scene

from scenes import default_camera, small_cfg, sphere_and_plane_scene


@pytest.fixture(scope="module")
def flat():
    return flatten_scene(sphere_and_plane_scene(reflect=0.4, textured=True))


def test_mesh_spans_all_devices():
    mesh = make_mesh()
    assert mesh.size == len(jax.devices()) == 8


@pytest.mark.parametrize(
    "intersector", [Intersector.BRUTE, Intersector.OCTREE, Intersector.PALLAS]
)
def test_sharded_matches_single_device(flat, intersector):
    cfg = small_cfg(width=32, height=24, intersector=intersector,
                    interpret=intersector == Intersector.PALLAS)
    cam = default_camera(aspect=32 / 24)
    mesh = make_mesh()
    scene_rep = replicate_scene(flat, mesh)
    img_sharded = np.asarray(render_image_sharded(scene_rep, cfg, cam, mesh))
    img_single = np.asarray(render_image(flat, cfg, cam))
    np.testing.assert_allclose(img_sharded, img_single, atol=1e-6)


def test_sharded_2d_mesh(flat):
    """hosts×chips mesh (simulated 2×4) renders identically."""
    cfg = small_cfg(width=16, height=16)
    cam = default_camera()
    mesh = make_mesh(axes=("hosts", "chips"), shape=(2, 4))
    scene_rep = replicate_scene(flat, mesh)
    img = np.asarray(render_image_sharded(scene_rep, cfg, cam, mesh))
    ref = np.asarray(render_image(flat, cfg, cam))
    np.testing.assert_allclose(img, ref, atol=1e-6)


def test_ragged_ray_count(flat):
    """Width×height not divisible by devices×tile still renders exactly."""
    cfg = small_cfg(width=19, height=13, tile_pixels=32)
    cam = default_camera(aspect=19 / 13)
    mesh = make_mesh()
    img = np.asarray(render_image_sharded(flat, cfg, cam, mesh))
    ref = np.asarray(render_image(flat, cfg, cam))
    assert img.shape == (13, 19, 3)
    np.testing.assert_allclose(img, ref, atol=1e-6)


class TestRingShardedBigScene:
    """Ring-sharded intersection (dist/bigscene.py): geometry sharded over
    the mesh, rays rotated with ppermute — the >HBM scene path."""

    @pytest.fixture(scope="class")
    def setup(self):
        from tests.scenes import sphere_and_plane_scene

        fl = sphere_and_plane_scene().flatten(build_octree=False,
                                              cluster_size=16)
        return fl

    def _rays(self, n=96, seed=5):
        rng = np.random.default_rng(seed)
        o = rng.uniform(-18, 18, size=(n, 3)).astype(np.float32)
        o[:, 1] = np.abs(o[:, 1]) + 0.5
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return jnp.asarray(o), jnp.asarray(d)

    @pytest.mark.parametrize("intersector", ["auto", "pallas"])
    def test_matches_single_device(self, setup, intersector):
        from raytpu.accel.traverse import nearest_hit_brute
        from raytpu.dist.bigscene import nearest_hit_ring, shard_scene_clusters
        from raytpu.dist.mesh import make_mesh

        mesh = make_mesh(devices=jax.devices()[:4])
        shards = shard_scene_clusters(setup, mesh)
        # Each shard holds only ~1/4 of the clusters.
        n_local = shards["cluster_min"].shape[1]
        total = setup.clusters["cluster_min"].shape[0]
        assert n_local <= -(-total // 4) + 1

        o, d = self._rays()
        hr = nearest_hit_ring(shards, o, d, mesh, intersector=intersector,
                              interpret=intersector == "pallas")
        hb = nearest_hit_brute(setup, o, d, block=256)
        np.testing.assert_array_equal(np.asarray(hr.hit), np.asarray(hb.hit))
        m = np.asarray(hb.hit)
        np.testing.assert_allclose(np.asarray(hr.t)[m], np.asarray(hb.t)[m],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(hr.tri)[m],
                                      np.asarray(hb.tri)[m])

    def test_t_max_and_ignore(self, setup):
        from raytpu.accel.traverse import nearest_hit_brute
        from raytpu.dist.bigscene import nearest_hit_ring, shard_scene_clusters
        from raytpu.dist.mesh import make_mesh

        mesh = make_mesh(devices=jax.devices()[:4])
        shards = shard_scene_clusters(setup, mesh)
        o, d = self._rays(64, seed=9)
        hb0 = nearest_hit_brute(setup, o, d, block=256)
        itri = jnp.where(jnp.arange(64) % 2 == 0, hb0.tri, -1).astype(
            jnp.int32)
        tmax = jnp.full((64,), 15.0, jnp.float32)
        hr = nearest_hit_ring(shards, o, d, mesh, ignore_tri=itri,
                              t_max=tmax)
        hb = nearest_hit_brute(setup, o, d, ignore_tri=itri, block=256,
                               t_max=tmax)
        np.testing.assert_array_equal(np.asarray(hr.hit), np.asarray(hb.hit))
        m = np.asarray(hb.hit)
        np.testing.assert_array_equal(np.asarray(hr.tri)[m],
                                      np.asarray(hb.tri)[m])

    def test_ragged_ray_count_pads(self, setup):
        from raytpu.dist.bigscene import nearest_hit_ring, shard_scene_clusters
        from raytpu.dist.mesh import make_mesh

        mesh = make_mesh(devices=jax.devices()[:4])
        shards = shard_scene_clusters(setup, mesh)
        o, d = self._rays(37, seed=2)  # not divisible by 4
        hr = nearest_hit_ring(shards, o, d, mesh)
        assert hr.hit.shape == (37,)


class TestRingRendering:
    """>HBM rendering end-to-end (dist/bigscene.py): geometry AND shade
    rows sharded over the mesh, the full wavefront running through the
    injected ring query/gather — pixel parity with the replicated
    renderer (BASELINE config 5's >HBM half)."""

    def test_gather_rows_ring_matches_table(self):
        from raytpu.dist.bigscene import gather_rows_ring, shard_scene_shade
        from raytpu.dist.mesh import make_mesh

        fl = sphere_and_plane_scene().flatten(build_octree=False,
                                              cluster_size=16)
        mesh = make_mesh()
        shade = shard_scene_shade(fl, mesh)
        # Each device holds only its row shard.
        assert shade["shade"].shape[0] == mesh.size
        t = fl.tri_shade.shape[0]
        rng = np.random.default_rng(3)
        ids = jnp.asarray(rng.integers(-1, t, size=53), jnp.int32)
        rows = np.asarray(gather_rows_ring(shade, ids, mesh))
        want = np.asarray(fl.tri_shade)[np.asarray(ids)]
        want[np.asarray(ids) < 0] = 0.0
        np.testing.assert_array_equal(rows, want)

    @pytest.mark.parametrize("transparent", [False, True])
    def test_ring_render_matches_replicated(self, transparent):
        """Ring pixel parity vs the replicated renderer; the opaque case
        additionally renders from a STRIPPED scene + prebuilt shards
        (strip_for_ring drops every per-triangle array), proving the >HBM
        property: no code path touches a replicated triangle table."""
        from raytpu.dist.bigscene import (render_image_ring,
                                          shard_scene_clusters,
                                          shard_scene_shade,
                                          shard_scene_textures,
                                          strip_for_ring)
        from raytpu.dist.mesh import make_mesh

        fl = sphere_and_plane_scene(
            reflect=0.4, textured=True, transparent=transparent,
        ).flatten(build_octree=False, cluster_size=16)
        cfg = small_cfg(width=24, height=16, max_reflections=2,
                        intersector=Intersector.TILED, tile_pixels=384)
        cam = default_camera(aspect=24 / 16)
        mesh = make_mesh()
        img_rep = np.asarray(render_image(fl, cfg, cam))
        if transparent:
            img_ring = np.asarray(render_image_ring(fl, cfg, cam, mesh))
        else:
            shards = shard_scene_clusters(fl, mesh)
            shade = shard_scene_shade(fl, mesh)
            tex = shard_scene_textures(fl, mesh)
            stripped = strip_for_ring(fl)
            assert stripped.tri_shade is None and stripped.tri_v1 is None
            # r5: the ATLAS is sharded too — no replicated big table left.
            assert stripped.textures is None
            img_ring = np.asarray(render_image_ring(
                stripped, cfg, cam, mesh, shards=shards, shade=shade,
                texshards=tex))
        np.testing.assert_allclose(img_ring, img_rep, atol=1e-5)


class TestRingDifferentiable:
    """Differentiable ring rendering (r5): the shade-row gather's custom
    VJP ppermutes cotangent rows back to their owner shards, so GEOMETRY
    fits run with the trainable tables sharded (>HBM; BASELINE configs
    4x5 composed)."""

    def test_ring_geometry_fit_matches_replicated(self):
        import optax

        from raytpu.diff.fit import render_loss
        from raytpu.diff.params import GEOMETRY, extract_params
        from raytpu.dist.bigscene import (extract_ring_params,
                                          make_ring_fit_step,
                                          shard_scene_clusters,
                                          shard_scene_shade,
                                          shard_scene_textures,
                                          strip_for_ring)
        from raytpu.dist.mesh import make_mesh
        from raytpu.core.camera import camera_rays

        from raytpu.core.camera import Camera

        fl = sphere_and_plane_scene(reflect=0.4, textured=True).flatten(
            build_octree=False, cluster_size=16)
        cfg = small_cfg(width=16, height=16, max_reflections=1,
                        intersector=Intersector.TILED, tile_pixels=256,
                        quantize=Quantize.NONE, differentiable=True)
        # Jittered camera: an axis-aligned 16x16 grid fires rays EXACTLY
        # down shared quad edges, and equidistant-tie winners differ
        # between the ring (shard visit order) and tiled (pick order)
        # backends — a documented ring deviation, not a gradient bug.
        cam = Camera(position=(0.313, 16.17, 31.9), aspect=1.0)
        o, d = camera_rays(cam, 16, 16)
        target = jnp.zeros((256, 3), jnp.float32)

        # Replicated reference: loss + grads w.r.t. GEOMETRY fields.
        params_rep = extract_params(fl, GEOMETRY)
        loss_rep, g_rep = jax.value_and_grad(render_loss, argnums=2)(
            fl, cfg, params_rep, o, d, target)

        # Ring fit on a STRIPPED scene + sharded params (sgd(1.0):
        # grads = params - new_params).
        mesh = make_mesh()
        shards = shard_scene_clusters(fl, mesh)
        shade = shard_scene_shade(fl, mesh)
        tex = shard_scene_textures(fl, mesh)
        stripped = strip_for_ring(fl)
        params = extract_ring_params(fl, mesh)
        opt = optax.sgd(1.0)
        step = make_ring_fit_step(stripped, cfg, mesh, opt,
                                  shards=shards, shade=shade,
                                  texshards=tex)
        new_params, _, loss_ring = step(params, opt.init(params), o, d,
                                        target)

        np.testing.assert_allclose(float(loss_ring), float(loss_rep),
                                   rtol=1e-6)
        t = fl.tri_v1.shape[0]
        for f in GEOMETRY:
            g_ring = (np.asarray(params[f])
                      - np.asarray(new_params[f])).reshape(-1, 3)[:t]
            # atol 5e-7: the ring backward accumulates cotangents
            # per-chunk around the ring (different summation order than
            # the replicated single scatter) — pure fp reassociation.
            np.testing.assert_allclose(g_ring, np.asarray(g_rep[f]),
                                       rtol=1e-5, atol=5e-7)

    def test_ring_render_differentiable_cfg_allowed(self):
        """cfg.differentiable no longer raises on the ring path and the
        forward pixels stay identical to the non-differentiable render."""
        import dataclasses

        from raytpu.dist.bigscene import render_image_ring
        from raytpu.dist.mesh import make_mesh

        fl = sphere_and_plane_scene(reflect=0.4).flatten(
            build_octree=False, cluster_size=16)
        cfg = small_cfg(width=16, height=16, max_reflections=1,
                        intersector=Intersector.TILED, tile_pixels=256,
                        quantize=Quantize.NONE)
        cam = default_camera()
        mesh = make_mesh()
        img = np.asarray(render_image_ring(fl, cfg, cam, mesh))
        img_d = np.asarray(render_image_ring(
            fl, dataclasses.replace(cfg, differentiable=True), cam, mesh))
        # ulp-level only: the ring query's winner (u, v) round differently
        # from the differentiable recompute (udet/det vs triple-product).
        np.testing.assert_allclose(img_d, img, atol=1e-5)


def test_sharded_multisampled_matches_single_device(flat):
    """--devices all + --multisample: the supersampler shards over the
    pixel axis and must match the single-device adaptive AA exactly
    (verdict r4 gap: render_image_sharded silently ignored AA)."""
    import dataclasses

    from raytpu.render.supersample import render_image_multisampled

    # Quantize.NONE: the per-device tile regrouping reorders the walk,
    # which can flip byte-rounding on tie-grazing corners (1/255 steps);
    # the float pixels themselves must agree to fp noise.
    cfg = small_cfg(width=16, height=12, max_reflections=1,
                    intersector=Intersector.TILED, tile_pixels=256,
                    quantize=Quantize.NONE,
                    use_multisampling=True, multisample_quality=1)
    cam = default_camera(aspect=16 / 12)
    mesh = make_mesh()
    img_one = np.asarray(render_image_multisampled(flat, cfg, cam))
    img_sh = np.asarray(render_image_sharded(flat, cfg, cam, mesh))
    np.testing.assert_allclose(img_sh, img_one, atol=1e-5)


def test_ring_sharded_atlas_bilinear_parity(flat):
    """Ring texel fetch (shard_scene_textures + make_texel_fetch_ring)
    under BILINEAR filtering — four footprint gathers per ray resolve
    from atlas shards with pixel parity vs the replicated atlas."""
    import dataclasses

    from raytpu.config import TextureFiltering
    from raytpu.dist.bigscene import render_image_ring
    from raytpu.dist.mesh import make_mesh

    cfg = small_cfg(width=24, height=16, max_reflections=1,
                    intersector=Intersector.TILED, tile_pixels=384,
                    quantize=Quantize.NONE)
    cfg = dataclasses.replace(cfg, filtering=TextureFiltering.BILINEAR)
    cam = default_camera(aspect=24 / 16)
    mesh = make_mesh()
    img_rep = np.asarray(render_image(flat, cfg, cam))
    img_ring = np.asarray(render_image_ring(flat, cfg, cam, mesh))
    np.testing.assert_allclose(img_ring, img_rep, atol=1e-5)
