"""Differentiable rendering: finite-difference checks, sharded-grad parity,
and inverse-rendering fits (SURVEY.md §4 item 4, BASELINE config 4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from raytpu.config import Intersector, Quantize, RenderConfig
from raytpu.diff import apply_params, extract_params, fit, make_fit_step, render_loss
from raytpu.diff.params import GEOMETRY, TEXTURE
from raytpu.dist import make_mesh
from raytpu.core.camera import camera_rays
from raytpu.render import render_image
from raytpu.scene.flatten import flatten_scene

from scenes import crate_scene, default_camera, small_cfg, sphere_and_plane_scene


def diff_cfg(**kw):
    kw.setdefault("quantize", Quantize.NONE)
    kw.setdefault("differentiable", True)
    return small_cfg(**kw)


@pytest.fixture(scope="module")
def crate():
    return flatten_scene(crate_scene())


def loss_of(scene, cfg, cam, params, target):
    o, d = camera_rays(cam, cfg.width, cfg.height)
    return render_loss(scene, cfg, params, o, d, target)


def test_differentiable_forward_unchanged(crate):
    """differentiable=True must not change forward pixels."""
    cam = default_camera()
    base = small_cfg(width=24, height=24, quantize=Quantize.NONE)
    img_plain = np.asarray(render_image(crate, base, cam))
    img_diff = np.asarray(
        render_image(crate, dataclasses.replace(base, differentiable=True), cam)
    )
    np.testing.assert_array_equal(img_plain, img_diff)


@pytest.mark.parametrize("intersector", [Intersector.BRUTE, Intersector.OCTREE])
def test_geometry_grad_matches_finite_difference(crate, intersector):
    """d(loss)/d(vertex) vs central differences, shading-only perturbation."""
    cfg = diff_cfg(width=16, height=16, intersector=intersector)
    cam = default_camera()
    target = jnp.zeros((16 * 16, 3))
    params = extract_params(crate, GEOMETRY)

    g = jax.grad(lambda p: loss_of(crate, cfg, cam, p, target))(params)
    rng = np.random.default_rng(3)
    # Probe a few coordinates with |analytic| large enough to measure.
    ga = np.asarray(g["tri_v1"])
    flat = np.argsort(-np.abs(ga).ravel())[:3]
    for idx in flat:
        ti, ci = np.unravel_index(idx, ga.shape)
        eps = 1e-3
        for sign, store in ((+1, "hi"), (-1, "lo")):
            p = {k: np.array(v) for k, v in params.items()}
            p["tri_v1"][ti, ci] += sign * eps
            val = float(loss_of(crate, cfg, cam, {k: jnp.asarray(v) for k, v in p.items()}, target))
            if store == "hi":
                hi = val
            else:
                lo = val
        fd = (hi - lo) / (2 * eps)
        assert np.isfinite(fd)
        np.testing.assert_allclose(ga[ti, ci], fd, rtol=0.15, atol=1e-4)


def test_texture_grad_matches_finite_difference(crate):
    cfg = diff_cfg(width=16, height=16)
    cam = default_camera()
    target = jnp.zeros((16 * 16, 3))
    params = extract_params(crate, TEXTURE)
    g = np.asarray(
        jax.grad(lambda p: loss_of(crate, cfg, cam, p, target))(params)["textures"]
    )
    idx = np.unravel_index(np.argmax(np.abs(g)), g.shape)
    eps = 0.5  # texel values are 0..255
    vals = []
    for sign in (+1, -1):
        t = np.array(params["textures"])
        t[idx] += sign * eps
        vals.append(float(loss_of(crate, cfg, cam, {"textures": jnp.asarray(t)}, target)))
    fd = (vals[0] - vals[1]) / (2 * eps)
    np.testing.assert_allclose(g[idx], fd, rtol=0.05, atol=1e-9)


def test_sharded_grads_match_single_device(crate):
    """psum-averaged sharded gradient == single-device gradient."""
    cfg = diff_cfg(width=16, height=16)
    cam = default_camera()
    o, d = camera_rays(cam, 16, 16)
    target = jnp.zeros((16 * 16, 3))
    params = extract_params(crate, GEOMETRY)

    g1 = jax.grad(render_loss, argnums=2)(crate, cfg, params, o, d, target)

    mesh = make_mesh()
    opt = optax.sgd(1.0)
    step = make_fit_step(crate, cfg, opt, mesh)
    new_params, _, loss = step(params, opt.init(params), o, d, target)
    # sgd(1.0): params_new = params - grad  →  grad = params - params_new
    for k in params:
        np.testing.assert_allclose(
            np.asarray(params[k]) - np.asarray(new_params[k]),
            np.asarray(g1[k]),
            atol=1e-6,
        )
    assert np.isfinite(float(loss))


def test_fit_recovers_texture(crate):
    """Render a target with a known texture, randomize, fit it back."""
    cfg = diff_cfg(width=24, height=24)
    cam = default_camera()
    target = render_image(crate, cfg, cam)

    rng = np.random.default_rng(0)
    noisy_tex = jnp.asarray(
        np.clip(
            np.asarray(crate.textures) + rng.normal(0, 60, crate.textures.shape),
            0,
            255,
        ),
        jnp.float32,
    )
    noisy = crate.replace(textures=noisy_tex)
    loss0 = float(
        loss_of(noisy, cfg, cam, extract_params(noisy, TEXTURE),
                jnp.asarray(target).reshape(-1, 3))
    )
    fitted, _, hist = fit(
        noisy, cfg, cam, target, fields=TEXTURE, steps=25, learning_rate=8.0
    )
    assert hist[-1] < 0.3 * loss0, (loss0, hist[-1])


def test_geometry_gradient_is_descent_direction():
    """A single step along -grad(vertices) reduces the pixel loss.

    (Full geometry recovery needs multi-view / silhouette-aware losses —
    the landscape has discrete shadow flips; what the framework must
    guarantee is that the analytic gradient descends, which FD tests above
    confirm coordinate-wise and this confirms for the full step.)"""
    flat = flatten_scene(sphere_and_plane_scene(reflect=0.0))
    cfg = diff_cfg(width=24, height=24)
    cam = default_camera()
    target = jnp.asarray(render_image(flat, cfg, cam)).reshape(-1, 3)

    # Lower the ground plane: a smooth, shading-visible perturbation.
    off = jnp.where(flat.tri_mesh[:, None] == 1, jnp.asarray([[0.0, -0.5, 0.0]]), 0.0)
    shifted = flat.replace(tri_v1=flat.tri_v1 + off)
    params = extract_params(shifted, ("tri_v1",))
    loss0, g = jax.value_and_grad(
        lambda p: loss_of(shifted, cfg, cam, p, target)
    )(params)
    stepped = {"tri_v1": params["tri_v1"] - 1e3 * g["tri_v1"]}
    loss1 = float(loss_of(shifted, cfg, cam, stepped, target))
    assert loss1 < 0.8 * float(loss0), (float(loss0), loss1)


def test_fit_checkpoint_resume(tmp_path, crate):
    cfg = diff_cfg(width=8, height=8)
    cam = default_camera()
    target = render_image(crate, cfg, cam)
    kw = dict(
        fields=TEXTURE, steps=4, learning_rate=1.0,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
    )
    seen = []
    fit(crate, cfg, cam, target, callback=lambda i, l: seen.append(i), **kw)
    assert seen == [0, 1, 2, 3]
    seen.clear()
    # Resume: latest checkpoint is step 4 → no further steps run.
    fit(crate, cfg, cam, target, callback=lambda i, l: seen.append(i), **kw)
    assert seen == []


def test_sharded_grads_match_single_device_2d_mesh(crate):
    """Hierarchical reduction (reduce_scatter over chips + psum over hosts,
    dist/mesh.py::hierarchical_pmean) on a 2-D ("hosts", "chips") mesh must
    produce the same gradient as one device — including leaves that do not
    tile over the chip axis (flat-psum fallback)."""
    cfg = diff_cfg(width=16, height=16)
    cam = default_camera()
    o, d = camera_rays(cam, 16, 16)
    target = jnp.zeros((16 * 16, 3))
    # GEOMETRY leaves (T, 3) exercise psum_scatter when T % chips == 0 and
    # the fallback otherwise; MATERIALS leaves are tiny 1-D fallbacks.
    from raytpu.diff.params import MATERIALS

    params = extract_params(crate, GEOMETRY + MATERIALS)

    g1 = jax.grad(render_loss, argnums=2)(crate, cfg, params, o, d, target)

    mesh = make_mesh(axes=("hosts", "chips"), shape=(2, 4))
    opt = optax.sgd(1.0)
    step = make_fit_step(crate, cfg, opt, mesh)
    new_params, _, loss = step(params, opt.init(params), o, d, target)
    for k in params:
        np.testing.assert_allclose(
            np.asarray(params[k]) - np.asarray(new_params[k]),
            np.asarray(g1[k]),
            atol=1e-6,
        )
    assert np.isfinite(float(loss))


def test_gradients_through_pallas_intersector():
    """The walk kernel has no JVP rule: differentiable mode must
    detach the query inputs so AD never enters it (regression for the
    backward bench crash), while geometry gradients still flow through the
    recompute path."""
    from raytpu.config import Intersector

    flat = crate_scene().flatten(build_octree=False, cluster_size=16)
    cfg = diff_cfg(width=12, height=12, max_reflections=1,
                   intersector=Intersector.PALLAS, cull_tile=16,
                   interpret=True)
    cam = default_camera()
    params = extract_params(flat, GEOMETRY)
    target = jnp.zeros((12 * 12, 3))
    g = jax.grad(render_loss, argnums=2)(flat, cfg, params,
                                         *camera_rays(cam, 12, 12), target)
    total = sum(float(jnp.abs(v).sum()) for v in g.values())
    assert np.isfinite(total) and total > 0.0


def test_fit_with_epoch_accel_rebuild():
    """Geometry fit through a CLUSTER-backed intersector with per-epoch
    acceleration rebuilds (fit(rebuild_every=...)): tables track the moving
    geometry with stable shapes (the compiled step is reused), and the fit
    still descends."""
    from raytpu.config import Intersector
    from raytpu.diff.fit import fit
    from tests.scenes import crate_scene

    flat = crate_scene().flatten(build_octree=False, cluster_size=16)
    cfg = diff_cfg(width=16, height=16, max_reflections=0,
                   intersector=Intersector.TILED, cull_tile=64)
    cam = default_camera()
    target = render_image(flat, cfg, cam)

    # Perturb geometry; the fit must pull it back while rebuilding the
    # cluster tables every 3 steps.
    key = jax.random.PRNGKey(1)
    pert = {
        f: getattr(flat, f) + 0.05 * jax.random.normal(
            jax.random.split(key, 3)[i], getattr(flat, f).shape)
        for i, f in enumerate(GEOMETRY)
    }
    noisy = flat.replace(**pert)

    shapes_before = jax.tree.map(jnp.shape, noisy.clusters)
    fitted, params, losses = fit(noisy, cfg, cam, target, fields=GEOMETRY,
                                 steps=9, learning_rate=5e-3,
                                 rebuild_every=3)
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()
    # Rebuilt (padded) tables keep one stable shape across epochs.
    cl = fitted.clusters
    # cluster_size preserved
    assert cl["tri_v1"].shape[0] // cl["cluster_min"].shape[0] == 16


def test_rebuild_accel_shapes_stable():
    from raytpu.diff.fit import rebuild_accel
    from raytpu.diff.params import extract_params
    from tests.scenes import crate_scene

    flat = crate_scene().flatten(build_octree=False, cluster_size=16)
    params = extract_params(flat, GEOMETRY)
    nc0 = flat.clusters["cluster_min"].shape[0]
    pad = nc0 + 4
    r1 = rebuild_accel(flat, params, pad)
    moved = {k: v + 0.3 for k, v in params.items()}
    r2 = rebuild_accel(flat, moved, pad)
    s1 = jax.tree.map(jnp.shape, r1.clusters)
    s2 = jax.tree.map(jnp.shape, r2.clusters)
    assert s1 == s2
    # The rebuilt tables actually reflect the moved geometry.
    assert not np.allclose(np.asarray(r1.clusters["cluster_min"]),
                           np.asarray(r2.clusters["cluster_min"]))


def test_geometry_grad_channels_match_all():
    """The geometry-pruned shade-row gather VJP (cfg.grad_channels =
    "geometry") must produce the SAME gradients as the exact "all" path
    for GEOMETRY params — the pruned channels are scene constants there
    (render/wavefront.py::_gather_rows_geo contract)."""
    import dataclasses

    import jax

    from raytpu.config import Intersector, Quantize, RenderConfig
    from raytpu.core.camera import Camera, camera_rays
    from raytpu.diff.fit import render_loss
    from raytpu.diff.params import GEOMETRY, extract_params
    from tests.scenes import sphere_and_plane_scene

    flat = sphere_and_plane_scene(reflect=0.3, textured=True).flatten(
        build_octree=False, cluster_size=16)
    cfg = RenderConfig(width=16, height=16, max_reflections=1,
                       intersector=Intersector.TILED,
                       quantize=Quantize.NONE, tile_pixels=256,
                       differentiable=True)
    cam = Camera(position=(0.0, 16.0, 32.0), aspect=1.0)
    o, d = camera_rays(cam, 16, 16)
    params = extract_params(flat, GEOMETRY)
    target = jnp.zeros((256, 3), jnp.float32)

    g_all = jax.grad(render_loss, argnums=2)(flat, cfg, params, o, d,
                                             target)
    cfg_geo = dataclasses.replace(cfg, grad_channels="geometry")
    g_geo = jax.grad(render_loss, argnums=2)(flat, cfg_geo, params, o, d,
                                             target)
    for k in params:
        np.testing.assert_allclose(np.asarray(g_geo[k]),
                                   np.asarray(g_all[k]),
                                   rtol=1e-5, atol=1e-7)


def test_materials_fit_forces_dual_branch():
    """Training mat_reflect on a transparent scene flattened WITHOUT a
    dual-branch material must force the dual wavefront path: the merged
    single-child path would silently drop the refraction branch once the
    fit raises reflectiveness above 0."""
    from raytpu.diff.params import MATERIALS

    scene = flatten_scene(
        sphere_and_plane_scene(reflect=0.0, transparent=True))
    assert scene.has_transparent and not scene.has_dual_branch

    cfg = diff_cfg(width=12, height=12, max_reflections=2)
    cam = default_camera()
    o, d = camera_rays(cam, 12, 12)
    target = jnp.zeros((12 * 12, 3))
    params = extract_params(scene, MATERIALS)
    # The fit has moved the transparent material's reflectiveness off 0:
    # both children (reflection + refraction) are now live.
    params["mat_reflect"] = jnp.clip(params["mat_reflect"] + 0.4, 0.0, 1.0)

    step = make_fit_step(scene, cfg, optax.sgd(0.0), fields=MATERIALS)
    _, _, loss_step = step(params, optax.sgd(0.0).init(params), o, d,
                           target)

    dual = scene.replace(has_dual_branch=True)
    loss_dual = float(render_loss(dual, cfg, params, o, d, target))
    loss_merged = float(render_loss(scene, cfg, params, o, d, target))
    # The merged path visibly drops the refraction contribution here...
    assert abs(loss_merged - loss_dual) > 1e-6
    # ...and the fit step must be on the dual path.
    np.testing.assert_allclose(float(loss_step), loss_dual, rtol=1e-6)
