"""Headline benchmark: rays/s (primary + shadow) on a 1M-triangle mesh.

BASELINE.json's primary metric ("rays/sec/chip (primary+shadow) at 1M
tris"), measured on one GPU.  Prints ONE JSON line:

    {"metric": ..., "mode": "single_frame", "value": N, "unit": "rays/s",
     "device": {...}, ...}

Scene: ~1M-triangle height-field mesh + one spot light.  Each frame casts
W*H primary rays plus W*H shadow rays (one light), i.e. rays/frame =
2 * W * H; ``value`` is rays/frame over the median time of one frame, one
dispatch per frame.  The renderer is the same jitted wavefront program the
framework uses for real renders.

Also times one differentiable-render gradient step (pixel MSE, GEOMETRY
params — BASELINE's "backward rays/s" metric) at BENCH_BACK_RES (default
512) and reports it as the ``backward_rays_per_s`` key of the same JSON
line.

The benchmark runs only on a GPU: it exits non-zero on any other backend.

Environment knobs: BENCH_TRIS (default ~1e6), BENCH_RES (default 1024),
BENCH_REPS (default 4), BENCH_INTERSECTOR (auto|tiled|pallas|octree|brute,
default auto), BENCH_BACKWARD (default 1; 0 skips it), BENCH_BACK_RES
(default 512).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def build_scene(n_tris: int, textured: bool = False, tex_size: int = 128):
    from raytpu.scene.lights import SpotLight
    from raytpu.scene.procedural import subdivided_plane
    from raytpu.scene.types import Material, Scene, SceneObject

    mat = Material(reflectiveness=0.0, diffuse_color=(0.7, 0.6, 0.5, 1.0))
    if textured:
        # Small atlas => heavy texel-id collisions across bilinear
        # footprints — the contended case the texture-gradient scatter
        # must survive (SURVEY.md §7 hard parts).
        yy, xx = np.meshgrid(np.arange(tex_size), np.arange(tex_size),
                             indexing="ij")
        checker = (((xx // 8) + (yy // 8)) % 2).astype(np.uint8)
        tex = np.stack([checker * 180 + 40, checker * 120 + 60,
                        np.full_like(checker, 90)], axis=-1).astype(np.uint8)
        mat = Material(reflectiveness=0.0, use_texture=True, texture=tex,
                       diffuse_color=(0.7, 0.6, 0.5, 1.0))
    divisions = max(8, int(round((n_tris / 2) ** 0.5)))
    mesh = subdivided_plane(
        size=(40.0, 40.0),
        divisions=divisions,
        material=mat,
        uv_scale=4.0 if textured else 1.0,
        height_fn=lambda x, z: 2.0 * np.sin(x * 0.7) * np.cos(z * 0.7)
        + 0.5 * np.sin(x * 3.1) * np.sin(z * 2.3),
    )
    scene = Scene(
        objects=[SceneObject(meshes=[mesh])],
        lights=[SpotLight(position=(0.0, 30.0, 25.0),
                          direction=(0.0, -0.7682213, -0.6401844))],
    )
    return scene, mesh.num_triangles


def main():
    import jax

    from raytpu.config import Intersector, Quantize, RenderConfig
    from raytpu.core.camera import Camera, camera_rays
    from raytpu.render.wavefront import block_order_perm, render_rays
    from raytpu.utils.backend import card_name_and_power_limit, describe_devices
    from raytpu.utils.cache import setup_compile_cache

    device = describe_devices()
    if device["platform"] != "gpu":
        print(f"bench.py measures the GPU; JAX found {device['platform']!r}",
              file=sys.stderr)
        sys.exit(1)
    card = card_name_and_power_limit()
    print(f"# card: {card}", file=sys.stderr)
    setup_compile_cache()

    n_tris = int(float(os.environ.get("BENCH_TRIS", 1e6)))
    res = int(os.environ.get("BENCH_RES", 1024))
    reps = int(os.environ.get("BENCH_REPS", 4))
    backend = os.environ.get("BENCH_INTERSECTOR", "auto")
    csize = int(os.environ.get("BENCH_CSIZE", 128))

    t0 = time.perf_counter()
    scene, true_tris = build_scene(n_tris)
    flat = scene.flatten(
        build_octree=backend == "octree", leaf_threshold=50, max_depth=12,
        build_clusters=backend in ("auto", "tiled", "pallas"),
        cluster_size=csize,
    )
    setup_s = time.perf_counter() - t0

    cfg = RenderConfig(
        width=res,
        height=res,
        max_reflections=0,  # primary + shadow only: the headline metric
        intersector=Intersector[backend.upper()],
        # One lax.map body for the whole opaque frame (no refraction
        # doubling).
        tile_pixels=int(os.environ.get("BENCH_TILE", res * res)),
        quantize=Quantize.NONE,
    )
    camera = Camera(position=(0.0, 28.0, 34.0), target=(0.0, 0.0, 0.0),
                    aspect=1.0)
    origin, direction = camera_rays(camera, cfg.width, cfg.height)
    # Square-block ray order, exactly as render_image traces frames.
    perm = block_order_perm(cfg.width, cfg.height, max(1, int(cfg.cull_tile ** 0.5)))
    origin = jax.device_put(origin[perm])
    direction = jax.device_put(direction[perm])

    fn = jax.jit(lambda s, o, d: render_rays(s, cfg, o, d))

    t0 = time.perf_counter()
    img = jax.block_until_ready(fn(flat, origin, direction))
    compile_s = time.perf_counter() - t0

    hit_frac = float(np.asarray(img).any(axis=-1).mean())

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(flat, origin, direction))
        times.append(time.perf_counter() - t0)
    median = float(np.median(times))

    rays_per_frame = 2 * res * res  # primary + shadow (1 light)
    rays_per_s = rays_per_frame / median

    backward_rays_per_s = None
    if os.environ.get("BENCH_BACKWARD", "1") == "1":
        backward_rays_per_s = bench_backward(flat, cfg)

    backward_texture_rays_per_s = None
    if os.environ.get("BENCH_BACKWARD_TEXTURE", "1") == "1":
        scene_t, _ = build_scene(n_tris, textured=True)
        flat_t = scene_t.flatten(build_octree=False, cluster_size=csize)
        backward_texture_rays_per_s = bench_backward(
            flat_t, cfg, fields="texture")

    print(
        f"# device={device} card={card} tris={true_tris} "
        f"res={res} backend={backend} setup={setup_s:.1f}s "
        f"compile={compile_s:.1f}s median={median * 1e3:.2f}ms "
        f"times_ms={[round(t * 1e3, 2) for t in times]} "
        f"nonblack={hit_frac:.3f} "
        f"backward={backward_rays_per_s} "
        f"backward_tex={backward_texture_rays_per_s}",
        file=sys.stderr,
    )
    out = {
        "metric": "rays_per_sec_1Mtri_primary_shadow",
        "mode": "single_frame",
        "value": round(rays_per_s),
        "unit": "rays/s",
        "times_s": times,
        "device": device,
        "card": card,
    }
    if backward_rays_per_s is not None:
        out["backward_rays_per_s"] = round(backward_rays_per_s)
    if backward_texture_rays_per_s is not None:
        out["backward_texture_rays_per_s"] = round(
            backward_texture_rays_per_s)
    print(json.dumps(out))


def bench_backward(flat, cfg, fields: str = "geometry"):
    """rays/s for one differentiable-render gradient step (pixel MSE) —
    BASELINE.json's "backward rays/s" metric.

    ``fields="geometry"``: GEOMETRY params (vertex/edge tables; engages
    the geometry-pruned (T, 12) gather VJP).  ``fields="texture"``: the
    texture ATLAS is the trainable — gradients scatter-add over bilinear
    texel footprints (4 texels/ray, heavy collisions at small atlases:
    the contended case); the run forces bilinear
    filtering so the footprint path is what gets measured.

    The target is the scene's own render (zero-ish loss, but the backward
    work is identical for any target).  Counts primary + shadow rays of the
    differentiable forward, i.e. the rays whose shading is differentiated.
    """
    import dataclasses
    import time

    import jax
    import optax

    from raytpu.config import Quantize, TextureFiltering
    from raytpu.core.camera import Camera, camera_rays
    from raytpu.diff.fit import make_fit_step
    from raytpu.diff.params import GEOMETRY, TEXTURE, extract_params
    from raytpu.render.wavefront import block_order_perm, render_rays

    res_b = int(os.environ.get("BENCH_BACK_RES", 512))
    reps = int(os.environ.get("BENCH_REPS", 4))
    # tile_pixels must follow the backward resolution: inheriting the
    # forward frame's (res^2) pads the ray set 4x with phantom rays that
    # get traced AND differentiated (measured 3x backward inflation).
    cfg_b = dataclasses.replace(cfg, width=res_b, height=res_b,
                                quantize=Quantize.NONE,
                                tile_pixels=res_b * res_b)
    if fields == "texture":
        cfg_b = dataclasses.replace(cfg_b,
                                    filtering=TextureFiltering.BILINEAR)
    camera = Camera(position=(0.0, 28.0, 34.0), target=(0.0, 0.0, 0.0),
                    aspect=1.0)
    o, d = camera_rays(camera, res_b, res_b)
    perm = block_order_perm(res_b, res_b, max(1, int(cfg_b.cull_tile ** 0.5)))
    o = jax.device_put(o[perm])
    d = jax.device_put(d[perm])
    target = jax.jit(lambda s, oo, dd: render_rays(s, cfg_b, oo, dd))(
        flat, o, d)

    field_list = GEOMETRY if fields == "geometry" else TEXTURE
    params = extract_params(flat, field_list)
    optimizer = optax.sgd(0.0)  # timing only: do not perturb the scene
    opt_state = optimizer.init(params)
    step = make_fit_step(flat, cfg_b, optimizer, fields=field_list)

    jax.block_until_ready(step(params, opt_state, o, d, target))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(step(params, opt_state, o, d, target))
        times.append(time.perf_counter() - t0)
    return 2 * res_b * res_b / float(np.median(times))


if __name__ == "__main__":
    main()
