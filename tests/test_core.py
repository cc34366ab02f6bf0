"""Unit tests for raytpu.core — XNA-parity math, intersection, camera."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from raytpu.core import xna
from raytpu.core.intersect import moller_trumbore, moller_trumbore_cull, ray_aabb
from raytpu.core.math3d import normalize, reflect, refract_xna


class TestXnaMatrices:
    def test_look_at_identity_frame(self):
        # Camera at +Z looking at origin: view maps world +Z to view +Z axis.
        m = np.asarray(xna.look_at((0, 0, 10), (0, 0, 0), (0, 1, 0)))
        # Row-vector convention: [p,1] @ M. Position maps to origin.
        p = np.asarray(xna.transform_point(jnp.asarray([0.0, 0.0, 10.0]), jnp.asarray(m)))
        np.testing.assert_allclose(p, [0, 0, 0], atol=1e-6)
        # A point 1 unit in front of the camera maps to z = -1 (RH view).
        q = np.asarray(xna.transform_point(jnp.asarray([0.0, 0.0, 9.0]), jnp.asarray(m)))
        np.testing.assert_allclose(q, [0, 0, -1], atol=1e-6)

    def test_perspective_projects_center(self):
        m = xna.perspective_fov(jnp.float32(np.pi / 4), 1.0, 1.0, 1000.0)
        xyz, w = xna.transform_homogeneous(jnp.asarray([0.0, 0.0, -10.0]), m)
        xyz = np.asarray(xyz) / float(w)
        np.testing.assert_allclose(xyz[:2], [0, 0], atol=1e-6)
        assert 0.0 < xyz[2] < 1.0

    def test_unproject_roundtrip(self):
        view = xna.look_at((0, 16, 32), (0, 0, 0), (0, 1, 0))
        proj = xna.perspective_fov(jnp.float32(np.pi / 4), 1.0, 1.0, 1000.0)
        # Unproject the screen center at depth 0 and 1: both points lie on a
        # line through the camera position.
        near = np.asarray(xna.unproject(jnp.asarray([256.0, 256.0, 0.0]), view, proj, (512, 512)))
        far = np.asarray(xna.unproject(jnp.asarray([256.0, 256.0, 1.0]), view, proj, (512, 512)))
        d = far - near
        d /= np.linalg.norm(d)
        to_target = np.asarray([0, 0, 0]) - np.asarray([0, 16.0, 32.0])
        to_target /= np.linalg.norm(to_target)
        np.testing.assert_allclose(d, to_target, atol=1e-4)

    def test_world_compose_translation_last(self):
        m = xna.compose_world(
            jnp.asarray([2.0, 2.0, 2.0]), jnp.asarray([0.0, 0.0, 0.0]),
            jnp.asarray([1.0, 2.0, 3.0]),
        )
        p = np.asarray(xna.transform_point(jnp.asarray([1.0, 0.0, 0.0]), m))
        np.testing.assert_allclose(p, [3.0, 2.0, 3.0], atol=1e-6)

    def test_rotation_y_row_vector(self):
        # Row-vector CreateRotationY(π/2) maps +X to -Z ([1,0,0] @ M).
        m = xna.rotation_y(jnp.float32(np.pi / 2))
        p = np.asarray(xna.transform_point(jnp.asarray([1.0, 0.0, 0.0]), m))
        np.testing.assert_allclose(p, [0, 0, -1], atol=1e-6)

    def test_quantize_round_half_even(self):
        v = jnp.asarray([0.5 / 255.0, 1.5 / 255.0, 2.0])
        q = np.asarray(xna.quantize_color(v))
        np.testing.assert_allclose(q, [0.0, 2.0 / 255.0, 1.0], atol=1e-7)


class TestMollerTrumbore:
    V1 = jnp.asarray([0.0, 0.0, 0.0])
    E1 = jnp.asarray([1.0, 0.0, 0.0])  # v2 = (1,0,0)
    E2 = jnp.asarray([0.0, 1.0, 0.0])  # v3 = (0,1,0)

    def test_center_hit(self):
        o = jnp.asarray([0.25, 0.25, 5.0])
        d = jnp.asarray([0.0, 0.0, -1.0])
        hit, u, v, t = moller_trumbore(o, d, self.V1, self.E1, self.E2)
        assert bool(hit)
        np.testing.assert_allclose([u, v, t], [0.25, 0.25, 5.0], atol=1e-6)

    def test_outside_misses(self):
        o = jnp.asarray([0.9, 0.9, 5.0])  # u+v > 1
        d = jnp.asarray([0.0, 0.0, -1.0])
        hit, *_ = moller_trumbore(o, d, self.V1, self.E1, self.E2)
        assert not bool(hit)

    def test_behind_misses(self):
        o = jnp.asarray([0.25, 0.25, -5.0])
        d = jnp.asarray([0.0, 0.0, -1.0])
        hit, *_ = moller_trumbore(o, d, self.V1, self.E1, self.E2)
        assert not bool(hit)

    def test_parallel_ray_no_hit(self):
        # No epsilon guard: det == 0 → inf/nan, acceptance fails
        # (RayExtensions.cs:31-39 net behavior).
        o = jnp.asarray([0.25, 0.25, 5.0])
        d = jnp.asarray([1.0, 0.0, 0.0])
        hit, *_ = moller_trumbore(o, d, self.V1, self.E1, self.E2)
        assert not bool(hit)

    def test_backface_cull(self):
        sn = jnp.asarray([0.0, 0.0, 1.0])  # faces +Z
        o = jnp.asarray([0.25, 0.25, -5.0])
        d = jnp.asarray([0.0, 0.0, 1.0])  # hits the back
        hit_nc, *_ = moller_trumbore(o, d, self.V1, self.E1, self.E2)
        hit_c, *_ = moller_trumbore_cull(o, d, self.V1, self.E1, self.E2, sn)
        assert bool(hit_nc) and not bool(hit_c)

    def test_barycentric_against_random_oracle(self, rng):
        # Random triangles and rays vs a plane-intersection oracle.
        for _ in range(50):
            tri = rng.normal(size=(3, 3)).astype(np.float32)
            o = rng.normal(size=3).astype(np.float32) * 3
            target = tri[0] + rng.random() * 0.4 * (tri[1] - tri[0]) + rng.random() * 0.4 * (
                tri[2] - tri[0]
            )
            d = target - o
            d = (d / np.linalg.norm(d)).astype(np.float32)
            hit, u, v, t = moller_trumbore(
                jnp.asarray(o), jnp.asarray(d), jnp.asarray(tri[0]),
                jnp.asarray(tri[1] - tri[0]), jnp.asarray(tri[2] - tri[0]),
            )
            assert bool(hit)
            p = tri[0] + float(u) * (tri[1] - tri[0]) + float(v) * (tri[2] - tri[0])
            np.testing.assert_allclose(p, target, atol=1e-3)
            np.testing.assert_allclose(np.asarray(o) + float(t) * np.asarray(d), target, atol=1e-3)


class TestRayAabb:
    BMIN = jnp.asarray([-1.0, -1.0, -1.0])
    BMAX = jnp.asarray([1.0, 1.0, 1.0])

    def test_hit_from_outside(self):
        hit, t = ray_aabb(jnp.asarray([0.0, 0.0, 5.0]), jnp.asarray([0.0, 0.0, -1.0]),
                          self.BMIN, self.BMAX)
        assert bool(hit) and abs(float(t) - 4.0) < 1e-6

    def test_inside_reports_zero(self):
        hit, t = ray_aabb(jnp.asarray([0.0, 0.0, 0.0]), jnp.asarray([0.0, 0.0, -1.0]),
                          self.BMIN, self.BMAX)
        assert bool(hit) and float(t) == 0.0

    def test_miss(self):
        hit, _ = ray_aabb(jnp.asarray([5.0, 5.0, 5.0]), jnp.asarray([0.0, 0.0, -1.0]),
                          self.BMIN, self.BMAX)
        assert not bool(hit)

    def test_parallel_slab_outside_misses(self):
        # Ray parallel to x slabs, origin outside them (x=2): XNA misses.
        hit, _ = ray_aabb(jnp.asarray([2.0, 0.0, 5.0]), jnp.asarray([0.0, 0.0, -1.0]),
                          self.BMIN, self.BMAX)
        assert not bool(hit)

    def test_behind_misses(self):
        hit, _ = ray_aabb(jnp.asarray([0.0, 0.0, 5.0]), jnp.asarray([0.0, 0.0, 1.0]),
                          self.BMIN, self.BMAX)
        assert not bool(hit)


class TestVectorOps:
    def test_reflect(self):
        d = jnp.asarray([1.0, -1.0, 0.0]) / np.sqrt(2)
        n = jnp.asarray([0.0, 1.0, 0.0])
        r = np.asarray(reflect(d, n))
        np.testing.assert_allclose(r, np.asarray([1.0, 1.0, 0.0]) / np.sqrt(2), atol=1e-6)

    def test_refract_straight_through(self):
        d = jnp.asarray([0.0, 0.0, -1.0])
        n = jnp.asarray([0.0, 0.0, 1.0])
        r = np.asarray(refract_xna(d, n, 1.0, 1.0))
        np.testing.assert_allclose(r, [0, 0, -1], atol=1e-6)

    def test_refract_snell_angle(self):
        # 45° incidence air→glass (n=1.5): sin θ2 = sin 45° / 1.5.
        d = normalize(jnp.asarray([1.0, -1.0, 0.0]))
        n = jnp.asarray([0.0, 1.0, 0.0])
        r = np.asarray(normalize(refract_xna(d, n, 1.0, 1.5)))
        sin_t2 = abs(r[0])
        np.testing.assert_allclose(sin_t2, np.sin(np.pi / 4) / 1.5, atol=1e-6)

    def test_total_internal_reflection_nan(self):
        # Glass→air beyond the critical angle: reference takes sqrt of a
        # negative → NaN (math3d.refract_xna docstring).
        d = normalize(jnp.asarray([1.0, -0.2, 0.0]))
        n = jnp.asarray([0.0, 1.0, 0.0])
        r = np.asarray(refract_xna(d, n, 1.5, 1.0))
        assert np.isnan(r).any()


# --- full float32 products and the FlatScene pytree -------------------------


def _dot_precisions(jaxpr, out):
    """Precision of every dot_general in ``jaxpr`` and its sub-jaxprs."""
    from jax.extend import core as jcore

    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                if isinstance(sub, jcore.ClosedJaxpr):
                    _dot_precisions(sub.jaxpr, out)
                elif isinstance(sub, jcore.Jaxpr):
                    _dot_precisions(sub, out)
    return out


_HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


class TestFullPrecisionProducts:
    """Every matrix product the render and fit paths trace asks for full
    float32 (an accelerator may otherwise run f32 products in TF32)."""

    def test_render_rays_with_camera(self):
        from raytpu.core.camera import camera_rays
        from raytpu.render.wavefront import render_rays
        from tests.scenes import default_camera, small_cfg, sphere_and_plane_scene

        flat = sphere_and_plane_scene().flatten(build_octree=False,
                                                cluster_size=16)
        cfg = small_cfg(width=8, height=8, tile_pixels=64)
        cam = default_camera()
        jp = jax.make_jaxpr(
            lambda s: render_rays(s, cfg, *camera_rays(cam, 8, 8)))(flat)
        precisions = _dot_precisions(jp.jaxpr, [])
        assert precisions, "the camera's unproject traces matrix products"
        assert all(p == _HIGHEST for p in precisions), precisions

    def test_fit_step(self):
        import optax

        from raytpu.core.camera import camera_rays
        from raytpu.diff.fit import make_fit_step
        from raytpu.diff.params import GEOMETRY, extract_params
        from tests.scenes import crate_scene, default_camera, small_cfg

        flat = crate_scene().flatten(build_octree=False, cluster_size=16)
        cfg = small_cfg(width=8, height=8, tile_pixels=64, max_reflections=1)
        params = extract_params(flat, GEOMETRY)
        opt = optax.sgd(1e-3)
        step = make_fit_step(flat, cfg, opt, fields=GEOMETRY)
        o, d = camera_rays(default_camera(), 8, 8)
        jp = jax.make_jaxpr(step)(params, opt.init(params), o, d,
                                  jnp.zeros((64, 3)))
        precisions = _dot_precisions(jp.jaxpr, [])
        assert all(p == _HIGHEST for p in precisions), precisions

    def test_instance_transforms(self):
        from raytpu.accel.instanced import instance_world_aabb
        from tests.scenes import sphere_and_plane_scene

        bake = sphere_and_plane_scene().flatten(build_octree=False,
                                                cluster_size=16)
        world = np.eye(4, dtype=np.float32)
        jp = jax.make_jaxpr(lambda w: instance_world_aabb(bake, w))(world)
        precisions = _dot_precisions(jp.jaxpr, [])
        assert precisions and all(p == _HIGHEST for p in precisions)


class TestFlatScenePytree:
    """FlatScene is a frozen dataclass registered as a pytree: arrays are
    leaves, the ``_static`` fields are metadata."""

    @pytest.fixture(scope="class")
    def flat(self):
        from tests.scenes import sphere_and_plane_scene

        return sphere_and_plane_scene().flatten(build_octree=False,
                                                cluster_size=16)

    def test_roundtrip_and_static_metadata(self, flat):
        leaves, treedef = jax.tree.flatten(flat)
        assert all(hasattr(x, "shape") for x in leaves)
        back = jax.tree.unflatten(treedef, leaves)
        assert back.num_tris == flat.num_tris
        assert back.light_kinds == flat.light_kinds
        assert back.has_transparent == flat.has_transparent
        # Static fields are not leaves: a scene differing only in them has
        # the same leaves but another tree structure.
        other = flat.replace(has_dual_branch=not flat.has_dual_branch)
        assert jax.tree.structure(other) != treedef
        assert len(jax.tree.leaves(other)) == len(leaves)

    def test_replace_and_frozen(self, flat):
        import dataclasses

        moved = flat.replace(tri_v1=flat.tri_v1 + 1.0)
        np.testing.assert_allclose(np.asarray(moved.tri_v1),
                                   np.asarray(flat.tri_v1) + 1.0)
        assert moved.num_tris == flat.num_tris
        with pytest.raises(dataclasses.FrozenInstanceError):
            flat.num_tris = 0

    def test_jit_retraces_on_static_change_only(self, flat):
        traces = []

        @jax.jit
        def f(s):
            traces.append(s.has_dual_branch)
            return s.tri_v1.sum()

        f(flat)
        f(flat.replace(tri_v1=flat.tri_v1 * 2.0))
        assert len(traces) == 1
        f(flat.replace(has_dual_branch=not flat.has_dual_branch))
        assert len(traces) == 2
