"""Sharded full-frame rendering.

``shard_map`` over the ray axis: each device traces its contiguous ray block
with the same wavefront program a single chip runs (render/wavefront.py), the
out-sharding assembles the frame.  This replaces the reference's scanline
dispenser + Thread.Join barrier (RayTracer.cs:48-52, :108-120) — scheduling
is static because ray cost variance averages out over device-sized blocks,
and a static split is the only thing that compiles to one XLA program.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from raytpu.config import RenderConfig
from raytpu.core.camera import Camera, camera_rays
from raytpu.render.wavefront import render_rays
from raytpu.scene.types import FlatScene


def _flat_axis(mesh: Mesh):
    """Spec entry sharding dim 0 over every mesh axis."""
    return mesh.axis_names if len(mesh.axis_names) > 1 else mesh.axis_names[0]


def render_rays_sharded(scene: FlatScene, cfg: RenderConfig, origin, direction,
                        mesh: Mesh):
    """Trace a ray batch sharded over the mesh; rays padded to the device
    count times the tile size so every shard runs the identical program."""
    n_dev = mesh.size
    n = origin.shape[0]
    chunk = -(-n // n_dev)
    chunk = -(-chunk // cfg.tile_pixels) * cfg.tile_pixels
    pad = chunk * n_dev - n
    if pad:
        origin = jnp.concatenate([origin, jnp.zeros((pad, 3), origin.dtype)])
        direction = jnp.concatenate(
            [direction, jnp.ones((pad, 3), direction.dtype)]
        )

    axis = _flat_axis(mesh)
    spec = P(axis)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), spec, spec),
        out_specs=spec,
        # The walk kernel's pallas_call does not carry varying-axis types
        # through its body, so shard_maps that may run it skip the check.
        check_vma=False,
    )
    def shard_trace(scene_rep, o, d):
        return render_rays(scene_rep, cfg, o, d)

    colors = shard_trace(scene, origin, direction)
    return colors[:n]


def render_image_sharded(scene: FlatScene, cfg: RenderConfig,
                         camera: Optional[Camera] = None,
                         mesh: Optional[Mesh] = None):
    """Full-frame render over a device mesh → (H, W, 3) float32.

    Drop-in sharded equivalent of render/wavefront.py::render_image —
    including ``cfg.use_multisampling`` (the adaptive supersampler shards
    over the pixel axis, see render_image_multisampled_sharded; the
    reference's multisampling likewise ran inside its parallel path,
    RayTracer.cs:128-213).
    """
    from raytpu.dist.mesh import make_mesh

    from raytpu.render.wavefront import block_order_perm

    mesh = mesh or make_mesh()
    camera = camera or Camera(aspect=cfg.width / cfg.height)
    if cfg.use_multisampling:
        return render_image_multisampled_sharded(scene, cfg, camera, mesh)
    o, d = camera_rays(camera, cfg.width, cfg.height)
    # Block-major ray order: compact cull-tile cones per device chunk.
    block = max(1, int(cfg.cull_tile ** 0.5))
    perm = block_order_perm(cfg.width, cfg.height, block)
    colors = render_rays_sharded(scene, cfg, o[perm], d[perm], mesh)
    colors = jnp.zeros_like(colors).at[perm].set(colors)
    return colors.reshape(cfg.height, cfg.width, 3)


def render_image_multisampled_sharded(scene: FlatScene, cfg: RenderConfig,
                                      camera: Optional[Camera] = None,
                                      mesh: Optional[Mesh] = None):
    """Adaptive-supersampled frame sharded over the PIXEL axis.

    Each device runs the identical level-synchronous supersampler
    (render/supersample.py) on its contiguous pixel block — the adaptive
    subdivision stays per-quadrant data so the shards need no
    communication beyond the out-sharding assembly.  Pixel parity with
    the single-device supersampler (dead-quadrant padding rounds the
    pixel count up to the device count)."""
    from raytpu.dist.mesh import make_mesh
    from raytpu.render.supersample import supersample_colors

    mesh = mesh or make_mesh()
    camera = camera or Camera(aspect=cfg.width / cfg.height)
    ys, xs = jnp.meshgrid(
        jnp.arange(cfg.height, dtype=jnp.float32),
        jnp.arange(cfg.width, dtype=jnp.float32),
        indexing="ij",
    )
    cx = xs.reshape(-1)
    cy = ys.reshape(-1)
    n = cx.shape[0]
    n_dev = mesh.size
    chunk = -(-n // n_dev)
    pad = chunk * n_dev - n
    if pad:
        cx = jnp.concatenate([cx, jnp.zeros((pad,), jnp.float32)])
        cy = jnp.concatenate([cy, jnp.zeros((pad,), jnp.float32)])
    alive = jnp.arange(cx.shape[0]) < n

    axis = _flat_axis(mesh)
    spec = P(axis)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), spec, spec, spec),
        out_specs=spec,
        check_vma=False,  # the walk kernel (see render_rays_sharded)
    )
    def shard_ss(scene_rep, x, y, a):
        return supersample_colors(scene_rep, cfg, camera, x, y, alive=a)

    colors = shard_ss(scene, cx, cy, alive)[:n]
    return colors.reshape(cfg.height, cfg.width, 3)
