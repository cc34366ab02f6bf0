"""Inverse rendering: fit scene parameters to target images.

BASELINE config 4 ("differentiable vertex+texture optimization").  The loss
is pixel MSE between a differentiable render (cfg.differentiable=True,
quantize=NONE — see render/wavefront.py) and a target image; parameters are
any FlatScene field group (diff/params.py).

Distributed form: rays are sharded over the device mesh exactly like the
forward renderer (dist/render.py); each device differentiates its own ray
block and the gradient all-reduce (``psum`` over the mesh axes) runs as a
collective that XLA schedules against the remaining backward work, which is
the overlapped-reduction design from SURVEY.md §2.

Octree caveat: moving vertices invalidates the host-built octree.  Use
Intersector.BRUTE while fitting geometry (exact for any motion), or refit in
epochs, rebuilding the octree between them (accel.octree.build_octree).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from raytpu.config import Quantize, RenderConfig
from raytpu.core.camera import Camera, camera_rays
from raytpu.diff.params import (GEOMETRY, SHADE_CONST_FIELDS, TEXTURE,
                                apply_params, extract_params)
from raytpu.render.wavefront import render_rays
from raytpu.scene.types import FlatScene


def _diff_cfg(cfg: RenderConfig) -> RenderConfig:
    return dataclasses.replace(cfg, differentiable=True, quantize=Quantize.NONE)


def render_loss(scene: FlatScene, cfg: RenderConfig, params: Dict,
                origin, direction, target, valid=None) -> jnp.ndarray:
    """Mean-squared pixel error of the differentiable render.

    ``valid`` (optional (R,) bool): rows excluded from the loss — their
    color is zeroed against a zero target, so padded phantom rays (the
    device-count round-up in ``fit``) contribute EXACTLY zero error and
    zero gradient; the mean is then diluted only by the constant factor
    n_valid/n, a pure learning-rate scale."""
    colors = render_rays(apply_params(scene, params), _diff_cfg(cfg), origin,
                         direction)
    if valid is not None:
        colors = jnp.where(valid[:, None], colors, 0.0)
    return jnp.mean((colors - target) ** 2)


def make_fit_step(scene: FlatScene, cfg: RenderConfig,
                  optimizer: optax.GradientTransformation,
                  mesh: Optional[Mesh] = None,
                  fields: Optional[Sequence[str]] = None) -> Callable:
    """Build a jitted ``step(params, opt_state, origin, direction, target)
    -> (params, opt_state, loss)``.

    The scene enters the jitted program as an ARGUMENT (not a closure
    constant): triangle/texture tables never bloat the HLO, and swapping
    in a rebuilt scene of identical shapes — per-epoch acceleration
    rebuilds (``fit(rebuild_every=...)``) — reuses the compiled step with
    no retrace.  Use ``step.set_scene(new_scene)`` to swap.

    With a mesh, rays/targets are expected pre-sharded along dim 0 (equal
    per-device blocks); params/opt_state are replicated and gradients are
    psum-averaged across the mesh.
    """
    cfg = _diff_cfg(cfg)
    # FlatScene.has_dual_branch is a *flatten-time* static flag (reflection
    # XOR refraction per material, from the original Material dataclasses).
    # A MATERIALS fit can raise mat_reflect above 0 on a transparent
    # material at runtime, making BOTH children live — the merged
    # single-child wavefront path would then silently drop the refraction
    # branch (wrong image, wrong gradients).  Force the dual-branch path
    # whenever mat_reflect is trainable on a transparent scene.
    force_dual = ("mat_reflect" in (fields or ())
                  and scene.has_transparent and not scene.has_dual_branch)
    if force_dual:
        scene = scene.replace(has_dual_branch=True)
    if fields is not None:
        if set(fields) & SHADE_CONST_FIELDS:
            # These fields' gradients flow through the channels the
            # pruned gather VJP drops — force the exact path even if the
            # caller's cfg carried grad_channels="geometry" from an
            # earlier geometry fit (silent zero gradients otherwise).
            cfg = dataclasses.replace(cfg, grad_channels="all")
        else:
            # None of the trainable fields flows through the non-geometry
            # shade-row channels: the gather's VJP may scatter only the
            # (T, 12) geometry columns (config.py grad_channels contract).
            cfg = dataclasses.replace(cfg, grad_channels="geometry")

    if mesh is None:

        @jax.jit
        def _impl(scene_, params, opt_state, origin, direction, target,
                  valid):
            loss, grads = jax.value_and_grad(render_loss, argnums=2)(
                scene_, cfg, params, origin, direction, target, valid
            )
            updates, opt_state = optimizer.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

    else:
        axes = mesh.axis_names
        spec = P(axes if len(axes) > 1 else axes[0])

        @jax.jit
        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(), P(), P(), spec, spec, spec, spec),
            out_specs=(P(), P(), P()),
            check_vma=False,  # the walk kernel (see dist/render.py)
        )
        def _impl(scene_, params, opt_state, origin, direction, target,
                  valid):
            from raytpu.dist.mesh import hierarchical_pmean

            loss, grads = jax.value_and_grad(render_loss, argnums=2)(
                scene_, cfg, params, origin, direction, target, valid
            )
            # Gradient all-reduce, overlapped with remaining backward work
            # by XLA; equal shard sizes → psum-mean is the
            # global gradient of the global mean loss.  On a 2-D
            # ("hosts", "chips") mesh this is the hierarchical
            # reduce_scatter-over-chips + psum-over-hosts form
            # (dist/mesh.py::hierarchical_pmean).
            grads = hierarchical_pmean(grads, mesh)
            loss = jax.lax.pmean(loss, axes)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

    box = {"scene": scene, "valid": None}

    def step(params, opt_state, origin, direction, target):
        valid = box["valid"]
        if valid is None:
            valid = jnp.ones(origin.shape[:1], bool)
        return _impl(box["scene"], params, opt_state, origin, direction,
                     target, valid)

    def _set_scene(s):
        if force_dual and s.has_transparent and not s.has_dual_branch:
            s = s.replace(has_dual_branch=True)
        box["scene"] = s

    step.set_scene = _set_scene
    step.set_valid = lambda v: box.__setitem__("valid", v)
    return step


def rebuild_accel(scene: FlatScene, params: Dict,
                  pad_clusters_to: Optional[int] = None) -> FlatScene:
    """Rebuild the cluster tables from the CURRENT fitted geometry.

    Host-side O(T log T) (accel/clusters.py); with ``pad_clusters_to`` the
    device-array shapes stay identical across rebuilds so a compiled fit
    step is reused without retracing.  The octree (if any) is NOT rebuilt
    (its node count is data-dependent; use cluster backends while
    fitting)."""
    import numpy as np

    s2 = apply_params(scene, params)
    v1 = np.asarray(s2.tri_v1)
    e1 = np.asarray(s2.tri_e1)
    e2 = np.asarray(s2.tri_e2)
    sn = np.asarray(s2.tri_snormal)
    mids = np.asarray(scene.tri_mesh)
    valid = np.asarray(scene.tri_valid)
    v = np.stack([v1, v1 + e1, v1 + e2], axis=1)
    cl = scene.clusters
    csize = cl["tri_v1"].shape[0] // cl["cluster_min"].shape[0]
    from raytpu.accel.clusters import build_clusters

    ct = build_clusters(v, cluster_size=csize, valid=valid,
                        pad_clusters_to=pad_clusters_to)
    newcl = ct.as_device_arrays(v1, e1, e2, sn, mids)
    return scene.replace(clusters=newcl)


def fit(scene: FlatScene, cfg: RenderConfig, camera: Camera, target_image,
        fields: Sequence[str] = GEOMETRY + TEXTURE,
        steps: int = 100, learning_rate: float = 1e-2,
        optimizer: Optional[optax.GradientTransformation] = None,
        mesh: Optional[Mesh] = None,
        callback: Optional[Callable[[int, float], None]] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        rebuild_every: int = 0,
        ) -> Tuple[FlatScene, Dict, list]:
    """Optimize ``fields`` of ``scene`` so its render matches ``target_image``.

    Returns (fitted scene, fitted params, per-step loss history).  With
    ``checkpoint_dir`` set, optimization state is saved every
    ``checkpoint_every`` steps and the fit resumes from the latest
    checkpoint if one exists (io/checkpoint.py).

    ``rebuild_every``: while fitting GEOMETRY with a cluster-backed
    intersector (TILED/PALLAS), rebuild the acceleration tables from the
    current geometry every N steps (epoch rebuilds — the moving-geometry
    story the octree caveat above describes).  Tables are padded to a
    fixed cluster count so the compiled step is reused, not retraced;
    between rebuilds the detached hit query lags the geometry by at most
    N steps (the differentiable recompute always uses current values).
    """
    optimizer = optimizer or optax.adam(learning_rate)
    params = extract_params(scene, fields)
    opt_state = optimizer.init(params)

    o, d = camera_rays(camera, cfg.width, cfg.height)
    target = jnp.asarray(target_image, jnp.float32).reshape(-1, 3)
    n = o.shape[0]
    start_step = 0
    valid = None

    if mesh is not None:
        pad = (-n) % mesh.size
        if pad:
            o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
            d = jnp.concatenate([d, jnp.ones((pad, 3), d.dtype)])
            target = jnp.concatenate([target, jnp.zeros((pad, 3))])
            # Phantom pad rays are masked out of the loss (render_loss
            # ``valid``): zero error, zero gradient — they exist only to
            # even out the device shards.
            valid = jnp.arange(o.shape[0]) < n

    ckpt = None
    if checkpoint_dir is not None:
        from raytpu.io.checkpoint import FitCheckpointer

        ckpt = FitCheckpointer(checkpoint_dir)
        restored = ckpt.restore_latest((params, opt_state))
        if restored is not None:
            start_step, (params, opt_state) = restored

    pad_to = None
    if rebuild_every and scene.clusters is not None:
        # AFTER checkpoint restore: a resumed fit must rebuild from the
        # restored geometry, not the step-0 geometry.
        nc0 = scene.clusters["cluster_min"].shape[0]
        pad_to = nc0 + max(8, nc0 // 8)  # slack for split-count drift
        scene = rebuild_accel(scene, params, pad_to)

    step_fn = make_fit_step(scene, cfg, optimizer, mesh, fields=fields)
    if valid is not None:
        step_fn.set_valid(valid)
    history = []
    for i in range(start_step, steps):
        if (rebuild_every and pad_to is not None and i > start_step
                and (i - start_step) % rebuild_every == 0):
            try:
                scene = rebuild_accel(scene, params, pad_to)
                step_fn.set_scene(scene)  # same shapes — no retrace
            except ValueError:
                # Split-count drift exceeded the pad slack: grow the pad
                # and re-make the step (one retrace) instead of aborting
                # a partially-done fit.
                pad_to = int(pad_to * 1.5) + 8
                scene = rebuild_accel(scene, params, pad_to)
                step_fn = make_fit_step(scene, cfg, optimizer, mesh,
                                        fields=fields)
                if valid is not None:
                    step_fn.set_valid(valid)
        params, opt_state, loss = step_fn(params, opt_state, o, d, target)
        loss = float(loss)
        history.append(loss)
        if callback is not None:
            callback(i, loss)
        if ckpt is not None and checkpoint_every and (i + 1) % checkpoint_every == 0:
            ckpt.save(i + 1, (params, opt_state))
    return apply_params(scene, params), params, history
