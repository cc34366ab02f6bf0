"""Octree build + traversal vs brute force (cross-validation)."""

import numpy as np
import pytest

import jax.numpy as jnp

from raytpu.accel.octree import build_octree, tri_box_overlap
from raytpu.accel.traverse import nearest_hit_brute, nearest_hit_octree
from tests.scenes import sphere_and_plane_scene


def random_tris(rng, n, scale=10.0):
    base = rng.uniform(-scale, scale, size=(n, 1, 3))
    return (base + rng.normal(size=(n, 3, 3))).astype(np.float32)


class TestTriBoxOverlap:
    def test_contained(self):
        v = np.asarray([[[0.1, 0.1, 0.1], [0.2, 0.1, 0.1], [0.1, 0.2, 0.1]]], np.float32)
        ok = tri_box_overlap(v[:, 0], v[:, 1], v[:, 2], np.zeros(3, np.float32),
                             np.ones(3, np.float32))
        assert ok[0]

    def test_spanning_no_vertex_inside(self):
        # A big triangle cutting through the box with all vertices outside —
        # the case the reference's vertex test misses (octree.py docstring).
        v = np.asarray(
            [[[-5.0, 0.5, 0.5], [5.0, 0.5, 0.4], [0.0, 0.5, 5.0]]], np.float32
        )
        ok = tri_box_overlap(v[:, 0], v[:, 1], v[:, 2], np.zeros(3, np.float32),
                             np.ones(3, np.float32))
        assert ok[0]

    def test_outside(self):
        v = np.asarray([[[3.0, 3.0, 3.0], [4.0, 3.0, 3.0], [3.0, 4.0, 3.0]]], np.float32)
        ok = tri_box_overlap(v[:, 0], v[:, 1], v[:, 2], np.zeros(3, np.float32),
                             np.ones(3, np.float32))
        assert not ok[0]


class TestOctreeBuild:
    def test_all_triangles_reachable(self, rng):
        tris = random_tris(rng, 300)
        oct_ = build_octree(tris, leaf_threshold=20, max_depth=8)
        reached = set(np.unique(oct_.leaf_tris)) - {-1}
        assert reached == set(range(300))
        # Root escape covers the whole flat array.
        assert oct_.node_skip[0] == len(oct_.node_min) or oct_.node_is_leaf[0]

    def test_chunk_layout(self, rng):
        tris = random_tris(rng, 500)
        oct_ = build_octree(tris, leaf_threshold=50, max_depth=10, chunk=16)
        # Every leaf slot's chunk row holds at most `chunk` valid entries and
        # padding is -1 only in the tail.
        assert oct_.leaf_tris.shape[1] == 16
        valid = oct_.leaf_tris >= 0
        # Valid entries are left-packed in each row.
        first_invalid = np.argmin(valid, axis=1)
        full_rows = valid.all(axis=1)
        for row in range(oct_.leaf_tris.shape[0]):
            if not full_rows[row]:
                assert not valid[row, first_invalid[row]:].any()
        # Leaf slots reference real rows; internal slots have -1.
        assert (oct_.node_chunk[oct_.node_is_leaf] >= 0).all()
        assert (oct_.node_chunk[~oct_.node_is_leaf] == -1).all()

    def test_preorder_skip_monotone(self, rng):
        tris = random_tris(rng, 400)
        oct_ = build_octree(tris, leaf_threshold=20, max_depth=8)
        n = len(oct_.node_min)
        skips = oct_.node_skip
        assert (skips > np.arange(n)).all()
        assert (skips <= n).all()


class TestTraversalVsBrute:
    @pytest.fixture(scope="class")
    def flat(self):
        return sphere_and_plane_scene().flatten(leaf_threshold=16, max_depth=8)

    def _rays(self, rng, n):
        o = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
        o[:, 1] = np.abs(o[:, 1]) + 0.5
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return jnp.asarray(o), jnp.asarray(d)

    @pytest.mark.parametrize("cull", [True, False])
    def test_match(self, flat, rng, cull):
        o, d = self._rays(rng, 256)
        hb = nearest_hit_brute(flat, o, d, cull=cull, block=128)
        ho = nearest_hit_octree(flat, o, d, cull=cull)
        np.testing.assert_array_equal(np.asarray(hb.hit), np.asarray(ho.hit))
        m = np.asarray(hb.hit)
        np.testing.assert_allclose(np.asarray(hb.t)[m], np.asarray(ho.t)[m], rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(hb.tri)[m], np.asarray(ho.tri)[m])

    def test_ignore_triangle(self, flat, rng):
        o, d = self._rays(rng, 64)
        hb = nearest_hit_brute(flat, o, d, block=128)
        ign = hb.tri
        hb2 = nearest_hit_brute(flat, o, d, ignore_tri=ign, block=128)
        ho2 = nearest_hit_octree(flat, o, d, ignore_tri=ign)
        m = np.asarray(hb.hit)
        # The previously-hit triangle is never returned again.
        assert not np.any(np.asarray(hb2.tri)[m] == np.asarray(ign)[m])
        np.testing.assert_array_equal(np.asarray(hb2.tri), np.asarray(ho2.tri))


class TestTiledVsBrute:
    """Tiled cluster cull (accel/tiled.py) vs brute force — exact nearest hit."""

    @pytest.fixture(scope="class")
    def flat(self):
        return sphere_and_plane_scene().flatten(
            build_octree=False, cluster_size=16
        )

    def _rays(self, rng, n):
        o = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
        o[:, 1] = np.abs(o[:, 1]) + 0.5
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return jnp.asarray(o), jnp.asarray(d)

    @pytest.mark.parametrize("cull", [True, False])
    @pytest.mark.parametrize("tile,chunk", [(64, 1), (64, 4), (1024, 2)])
    def test_match_incoherent(self, flat, rng, cull, tile, chunk):
        from raytpu.accel.tiled import nearest_hit_tiled

        o, d = self._rays(rng, 256)
        hb = nearest_hit_brute(flat, o, d, cull=cull, block=128)
        ht = nearest_hit_tiled(flat, o, d, cull=cull, tile_size=tile, chunk=chunk)
        np.testing.assert_array_equal(np.asarray(hb.hit), np.asarray(ht.hit))
        m = np.asarray(hb.hit)
        np.testing.assert_allclose(np.asarray(hb.t)[m], np.asarray(ht.t)[m], rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(hb.tri)[m], np.asarray(ht.tri)[m])

    def test_match_coherent_camera(self, flat, rng):
        from raytpu.accel.tiled import nearest_hit_tiled
        from raytpu.core.camera import Camera, camera_rays

        cam = Camera(position=(0.0, 16.0, 32.0), aspect=1.0)
        o, d = camera_rays(cam, 48, 48)
        hb = nearest_hit_brute(flat, o, d, block=128)
        ht = nearest_hit_tiled(flat, o, d, tile_size=256, chunk=2)
        np.testing.assert_array_equal(np.asarray(hb.hit), np.asarray(ht.hit))
        m = np.asarray(hb.hit)
        np.testing.assert_allclose(np.asarray(hb.t)[m], np.asarray(ht.t)[m], rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(hb.tri)[m], np.asarray(ht.tri)[m])

    def test_ignore_tri_and_mesh(self, flat, rng):
        from raytpu.accel.tiled import nearest_hit_tiled

        o, d = self._rays(rng, 128)
        hb = nearest_hit_brute(flat, o, d, block=128)
        ign = hb.tri
        hb2 = nearest_hit_brute(flat, o, d, ignore_tri=ign, block=128)
        ht2 = nearest_hit_tiled(flat, o, d, ignore_tri=ign, tile_size=64)
        np.testing.assert_array_equal(np.asarray(hb2.tri), np.asarray(ht2.tri))
        imesh = jnp.zeros(o.shape[0], jnp.int32)  # ignore the sphere mesh
        hb3 = nearest_hit_brute(flat, o, d, ignore_mesh=imesh, block=128)
        ht3 = nearest_hit_tiled(flat, o, d, ignore_mesh=imesh, tile_size=64)
        np.testing.assert_array_equal(np.asarray(hb3.tri), np.asarray(ht3.tri))

    def test_nonfinite_rays_miss(self, flat):
        from raytpu.accel.tiled import nearest_hit_tiled

        o = jnp.zeros((8, 3), jnp.float32).at[2, 1].set(jnp.nan)
        d = jnp.ones((8, 3), jnp.float32) / np.sqrt(3.0)
        d = d.at[5, 0].set(jnp.nan)
        o = o.at[:, 1].add(5.0)
        ht = nearest_hit_tiled(flat, o, d, tile_size=8)
        assert not bool(ht.hit[2]) and not bool(ht.hit[5])


class TestReverseCull:
    """cull="reverse" (core/intersect.py): the segment occlusion test cast
    from the opposite end accepts exactly the triangles the forward
    backface-culled test accepts (the shadow-from-light reversal's
    foundation) — across brute, tiled and walk-kernel backends."""

    @pytest.fixture(scope="class")
    def flat(self):
        return sphere_and_plane_scene().flatten(
            build_octree=False, cluster_size=16)

    def test_segment_occlusion_matches_forward(self, flat):
        from raytpu.accel.tiled import nearest_hit_tiled
        from raytpu.accel.traverse import nearest_hit_brute
        from raytpu.kernels.walk import nearest_hit_walk

        rng = np.random.default_rng(21)
        n = 96
        a = rng.uniform(-12, 12, (n, 3)).astype(np.float32)  # fragment end
        a[:, 1] = np.abs(a[:, 1])
        b = np.tile(np.array([[0.0, 5.0, 20.0]], np.float32), (n, 1))
        seg = b - a
        dist = np.linalg.norm(seg, axis=1)
        fwd_d = jnp.asarray(seg / dist[:, None])
        rev_d = -fwd_d
        a, b = jnp.asarray(a), jnp.asarray(b)
        tmax = jnp.asarray(dist)

        h_fwd = nearest_hit_brute(flat, a, fwd_d, block=128, t_max=tmax,
                                  cull=True)
        occ_fwd = np.asarray(h_fwd.hit) & (np.asarray(h_fwd.t)
                                           < np.asarray(tmax))
        h_rev_b = nearest_hit_brute(flat, b, rev_d, block=128, t_max=tmax,
                                    cull="reverse")
        occ_rev = np.asarray(h_rev_b.hit) & (np.asarray(h_rev_b.t)
                                             < np.asarray(tmax))
        np.testing.assert_array_equal(occ_rev, occ_fwd)

        h_rev_t = nearest_hit_tiled(flat, b, rev_d, cull="reverse",
                                    tile_size=32, t_max=tmax, any_hit=True)
        np.testing.assert_array_equal(np.asarray(h_rev_t.hit), occ_fwd)

        h_rev_f = nearest_hit_walk(flat, b, rev_d, cull="reverse",
                                   tile_size=32, t_max=tmax, any_hit=True,
                                   interpret=True)
        np.testing.assert_array_equal(np.asarray(h_rev_f.hit), occ_fwd)
