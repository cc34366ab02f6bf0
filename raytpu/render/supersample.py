"""Adaptive 4-corner supersampling (RayTracer.cs:128-311).

The reference's ``GetColorForQuadrant(cx, cy, size, iter)`` casts 4 corner
rays at ``(cx ± size/4, cy ± size/4)``, and — while ``iter <
MultisampleQuality`` — recursively subdivides any corner whose color-vector
length deviates from the 4-corner average length by more than ``TRESHOLD =
0.5`` (RayTracer.cs:288-306), returning the byte-quantized corner average
(RayTracer.cs:309).

Array formulation: the recursion is *level-synchronous*.  Level ``l`` holds all
quadrants at subdivision depth ``l`` (``4^l`` static slots per pixel, with an
``alive`` mask — masked quadrants trace but are discarded, which keeps shapes
static under jit).  Each level is one batched trace of ``4·Q_l`` corner rays;
the backward pass replaces subdivided corners with their child quadrant's
result and re-averages, exactly mirroring the recursive combine.

The reference bug at RayTracer.cs:305 (the lower-right child's result is
written into ``urColor``) is fixed by default and replicated when
``RenderConfig.replicate_lr_bug`` is set (SURVEY.md §7 build order step 1:
bugs to fix, documented).
"""

from __future__ import annotations

import jax.numpy as jnp

from raytpu.config import Quantize, RenderConfig
from raytpu.core.camera import Camera, rays_through_screen
from raytpu.core.xna import quantize_color
from raytpu.render.wavefront import trace_colors

# Corner order: upper-left, upper-right, lower-left, lower-right
# (RayTracer.cs:223-276).
_CORNER_OFF = jnp.asarray(
    [[-1.0, -1.0], [1.0, -1.0], [-1.0, 1.0], [1.0, 1.0]], jnp.float32
)


def _trace_batch(scene, cfg, camera, sx, sy, alive):
    """Trace screen-space sample positions, tiled to bound memory."""
    o, d = rays_through_screen(camera, cfg.width, cfg.height, sx, sy)
    return trace_colors(scene, cfg, o, d, alive=alive)


def supersample_colors(scene, cfg: RenderConfig, camera: Camera, cx, cy,
                       alive=None):
    """Colors for quadrants centered at screen coords (cx, cy), size 1.

    Returns (Q, 3) colors implementing the full adaptive recursion.
    """
    q0 = cx.shape[0]
    if alive is None:
        alive = jnp.ones((q0,), bool)
    threshold = jnp.float32(cfg.multisample_threshold)

    # Forward expansion: per level, quadrant centers and sizes.
    centers_x = [cx]
    centers_y = [cy]
    alives = [alive]
    corner_colors = []  # (Q_l, 4, 3) per level
    size = jnp.float32(1.0)
    for level in range(cfg.multisample_quality + 1):
        qx, qy, qa = centers_x[-1], centers_y[-1], alives[-1]
        quarter = size * 0.25
        sx = (qx[:, None] + _CORNER_OFF[None, :, 0] * quarter).reshape(-1)
        sy = (qy[:, None] + _CORNER_OFF[None, :, 1] * quarter).reshape(-1)
        ca = jnp.repeat(qa, 4)
        colors = _trace_batch(scene, cfg, camera, sx, sy, ca).reshape(-1, 4, 3)
        corner_colors.append(colors)

        if level < cfg.multisample_quality:
            # Subdivision decision (RayTracer.cs:281-306): corner length vs
            # average length of the *initial* corner colors.
            lens = jnp.linalg.norm(colors, axis=-1)  # (Q, 4)
            avg_len = jnp.linalg.norm(colors.mean(axis=1), axis=-1)  # (Q,)
            subdiv = jnp.abs(avg_len[:, None] - lens) > threshold  # (Q, 4)
            child_alive = (qa[:, None] & subdiv).reshape(-1)
            child_x = (qx[:, None] + _CORNER_OFF[None, :, 0] * quarter).reshape(-1)
            child_y = (qy[:, None] + _CORNER_OFF[None, :, 1] * quarter).reshape(-1)
            centers_x.append(child_x)
            centers_y.append(child_y)
            alives.append(child_alive)
        size = size * 0.5

    # Backward combine: deepest level first.
    child_result = None
    for level in reversed(range(cfg.multisample_quality + 1)):
        corners = corner_colors[level]  # (Q, 4, 3)
        if child_result is not None:
            child = child_result.reshape(-1, 4, 3)  # child quadrant results
            used = alives[level + 1].reshape(-1, 4)  # which corners subdivided
            if cfg.replicate_lr_bug:
                # RayTracer.cs:305: the LR child result lands in urColor.
                # LR's own slot keeps its single-ray color.
                lr_used = used[:, 3]
                used = used.at[:, 3].set(False)
                corners = jnp.where(used[..., None], child, corners)
                corners = corners.at[:, 1].set(
                    jnp.where(lr_used[:, None], child[:, 3], corners[:, 1])
                )
            else:
                corners = jnp.where(used[..., None], child, corners)
        result = corners.mean(axis=1)
        if cfg.quantize != Quantize.NONE:
            # new Color(average) byte-packs every quadrant return
            # (RayTracer.cs:309).
            result = quantize_color(result)
        child_result = result
    return child_result


def render_image_multisampled(scene, cfg: RenderConfig, camera: Camera):
    """Full-frame adaptive-supersampled render (RenderFirstPass,
    RayTracer.cs:170-213: quadrant centers at integer pixel coords).

    One jitted program per frame: the pixel loop dispatches equal-size
    tiles (the tail is padded with dead quadrants, which every backend
    drops from its tile bounds via the NaN-direction convention), so the
    tracer compiles exactly once instead of retracing per tile and
    recompiling for a ragged tail."""
    import jax

    ys, xs = jnp.meshgrid(
        jnp.arange(cfg.height, dtype=jnp.float32),
        jnp.arange(cfg.width, dtype=jnp.float32),
        indexing="ij",
    )
    cx = xs.reshape(-1)
    cy = ys.reshape(-1)

    # Tile over pixels to bound the 4^quality expansion.
    n = cx.shape[0]
    tile = max(1, cfg.tile_pixels // (4 ** cfg.multisample_quality * 4))
    pad = (-n) % tile
    if pad:
        cx = jnp.concatenate([cx, jnp.zeros((pad,), jnp.float32)])
        cy = jnp.concatenate([cy, jnp.zeros((pad,), jnp.float32)])
    alive = jnp.arange(cx.shape[0]) < n

    fn = jax.jit(lambda s, x, y, a: supersample_colors(s, cfg, camera,
                                                       x, y, alive=a))
    outs = []
    for start in range(0, cx.shape[0], tile):
        sl = slice(start, start + tile)
        outs.append(fn(scene, cx[sl], cy[sl], alive[sl]))
    colors = jnp.concatenate(outs, axis=0)[:n]
    return colors.reshape(cfg.height, cfg.width, 3)
