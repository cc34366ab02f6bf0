"""Wavefront rendering over shared mesh bakes + per-instance transforms.

End-to-end shading for the two-level instanced path (accel/instanced.py) —
the reference's actual architecture: one mesh copy, per-object transforms,
rays moved into object space per candidate and hits compared in world space
(OctreeSpatialManager.cs:312-482).  The default baked path
(render/wavefront.py) stays canonical; this module mirrors its level
expansion + linear combine exactly (same LevelRecord algebra) and trades
per-level B-way attribute selects (one per mesh bake) for the N-fold
geometry memory the bake would cost.

Capabilities: textures / vertex colors, interpolated or face normals
(transformed by each instance's inverse-transpose), spot + directional
lights, shadow rays with transparent-occluder attenuation, recursive
reflection, Snell refraction — matching wavefront.py feature for feature.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from raytpu.accel.instanced import (Instance, InstancedHit, make_instance,
                                    nearest_hit_instanced)
from raytpu.config import Quantize, RenderConfig
from raytpu.core.camera import Camera, camera_rays
from raytpu.core.math3d import normalize, reflect, refract_xna
from raytpu.core.xna import quantize_color
from raytpu.render.wavefront import LevelRecord
from raytpu.scene import lights as lights_mod
from raytpu.scene import texture as texture_mod
from raytpu.scene.types import FlatScene, Scene, SceneObject

INF = 3.4028235e38


class InstancedScene(NamedTuple):
    """Host-side container for the two-level representation."""

    bakes: Tuple[FlatScene, ...]        # per unique mesh set, OBJECT space
    instances: Tuple[Instance, ...]
    worlds: jnp.ndarray                 # (I, 4, 4)
    inv_t: jnp.ndarray                  # (I, 3, 3) inverse-transpose
    bake_of_instance: Tuple[int, ...]
    lights: dict
    num_lights: int
    has_transparent: bool


def flatten_instanced(scene: Scene, max_lights: int = 4,
                      **flatten_kw) -> InstancedScene:
    """Bake each unique mesh set once; record per-object transforms.

    Objects sharing the same ``meshes`` list (by identity) share one bake —
    the memory win the reference gets from Model.Tag reuse
    (SceneObject.cs:123-134).
    """
    bakes: List[FlatScene] = []
    bake_ids = {}
    instances: List[Instance] = []
    bake_of = []
    for obj in scene.objects:
        key = tuple(id(m) for m in obj.meshes)
        if key not in bake_ids:
            bake_ids[key] = len(bakes)
            bakes.append(
                Scene(objects=[SceneObject(meshes=obj.meshes)],
                      lights=scene.lights).flatten(
                          max_lights=max_lights, **flatten_kw)
            )
        b = bake_ids[key]
        inst = make_instance(b, np.asarray(obj.world_matrix(), np.float32))
        instances.append(inst)
        bake_of.append(b)

    worlds = jnp.asarray(np.stack([i.world for i in instances]))
    inv_t = jnp.asarray(
        np.stack([i.inv_world.T[:3, :3] for i in instances])
    )
    lights = {k: jnp.asarray(v) for k, v in
              lights_mod.pack_lights(scene.lights,
                                     max_lights=max_lights).items()}
    return InstancedScene(
        bakes=tuple(bakes),
        instances=tuple(instances),
        worlds=worlds,
        inv_t=inv_t,
        bake_of_instance=tuple(bake_of),
        lights=lights,
        num_lights=len(scene.lights),
        has_transparent=any(b.has_transparent for b in bakes),
    )


class _RaySet(NamedTuple):
    origin: jnp.ndarray
    direction: jnp.ndarray
    ignore_tri: jnp.ndarray
    ignore_inst: jnp.ndarray
    cur_ref: jnp.ndarray
    alive: jnp.ndarray


def _select_by_bake(iscene: InstancedScene, inst_idx, per_bake_fn):
    """Evaluate ``per_bake_fn(bake)`` for every bake and select per ray by
    the winning instance's bake id (B-way where; B is small)."""
    bake_id = jnp.asarray(iscene.bake_of_instance, jnp.int32)[
        jnp.maximum(inst_idx, 0)
    ]
    out = None
    for b, bake in enumerate(iscene.bakes):
        val = per_bake_fn(bake)
        if out is None:
            out = val
        else:
            sel = bake_id == b
            out = jax.tree.map(
                lambda o, v: jnp.where(
                    sel.reshape(sel.shape + (1,) * (o.ndim - 1)), v, o),
                out, val,
            )
    return out


def _shade_inputs(iscene: InstancedScene, cfg: RenderConfig,
                  ih: InstancedHit, rays: _RaySet):
    """Per-ray world-space shading inputs from the winning bake/instance."""
    safe_tri = jnp.maximum(ih.tri, 0)
    safe_inst = jnp.maximum(ih.instance, 0)

    def gather(bake):
        s = bake.tri_shade[safe_tri]
        mesh = jax.lax.bitcast_convert_type(s[..., 31], jnp.int32)
        mat = bake.mesh_material[mesh]
        uv = (s[..., 18:20]
              + (s[..., 20:22] - s[..., 18:20]) * ih.u[..., None]
              + (s[..., 22:24] - s[..., 18:20]) * ih.v[..., None])
        base = s[..., 27:30]
        if bake.has_textures:
            tex_id = jnp.maximum(bake.mat_texture[mat], 0)
            tex = texture_mod.lookup_uv(
                bake.textures, tex_id, bake.tex_hw[tex_id, 0],
                bake.tex_hw[tex_id, 1], uv, cfg.address_mode, cfg.filtering,
            )
            use = bake.mat_use_texture[mat] & (bake.mat_texture[mat] >= 0)
            base = jnp.where(use[..., None], tex, base)
        n_obj = jnp.where(
            bake.mat_interp_normals[mat][..., None],
            normalize(s[..., 9:12]
                      + (s[..., 12:15] - s[..., 9:12]) * ih.u[..., None]
                      + (s[..., 15:18] - s[..., 9:12]) * ih.v[..., None]),
            s[..., 24:27],
        )
        frag_obj = (s[..., 0:3] + s[..., 3:6] * ih.u[..., None]
                    + s[..., 6:9] * ih.v[..., None])
        return {
            "surface": base,
            "alpha": s[..., 30],
            "n_obj": n_obj,
            "frag_obj": frag_obj,
            "refl": bake.mat_reflect[mat],
            "transparent": bake.mat_transparent[mat],
            "ior": bake.mat_refraction[mat],
        }

    g = _select_by_bake(iscene, ih.instance, gather)

    w = iscene.worlds[safe_inst]
    it = iscene.inv_t[safe_inst]
    hi = jax.lax.Precision.HIGHEST
    frag_w = jnp.einsum("ri,rij->rj", g["frag_obj"], w[:, :3, :3],
                        precision=hi) + w[:, 3, :3]
    normal_w = normalize(jnp.einsum("ri,rij->rj", g["n_obj"], it,
                                    precision=hi))
    return g, frag_w, normal_w


def _light_result(iscene: InstancedScene, cfg: RenderConfig, frag_pos,
                  normal, tri, inst, valid):
    """Shadow-tested light sum (wavefront._light_result, instanced)."""
    total = jnp.zeros_like(frag_pos)
    nanv = jnp.float32(jnp.nan)
    for i in range(iscene.num_lights):
        sdir, sdist = lights_mod.light_shadow_query(iscene.lights, i, frag_pos)
        contrib = lights_mod.light_contrib(iscene.lights, i, frag_pos, normal)
        lit = valid & jnp.any(contrib != 0.0, axis=-1)
        shadow = nearest_hit_instanced(
            iscene.bakes, list(iscene.instances), frag_pos,
            jnp.where(lit[..., None], sdir, nanv),
            t_max=sdist, ignore_tri=tri, ignore_instance=inst,
            intersector=cfg.intersector, cull_tile=cfg.cull_tile,
            block=cfg.tri_block,
            brute_force_max_tris=cfg.brute_force_max_tris,
        )
        obstructed = shadow.hit & (shadow.t_world < sdist)
        if iscene.has_transparent:
            g = _select_by_bake(
                iscene, shadow.instance,
                lambda bake: {
                    "trans": bake.mat_transparent[bake.mesh_material[
                        bake.tri_mesh[jnp.maximum(shadow.tri, 0)]]],
                    "alpha": bake.tri_color[jnp.maximum(shadow.tri, 0), 3],
                },
            )
            amount = jnp.where(
                obstructed, jnp.where(g["trans"], g["alpha"], 1.0), 0.0
            )
        else:
            amount = obstructed.astype(jnp.float32)
        total = total + contrib * (1.0 - amount)[..., None]
    return total


def _trace_level(iscene: InstancedScene, cfg: RenderConfig, rays: _RaySet,
                 is_max: bool):
    ih = nearest_hit_instanced(
        iscene.bakes, list(iscene.instances), rays.origin,
        jnp.where(rays.alive[..., None], rays.direction,
                  jnp.float32(jnp.nan)),
        ignore_tri=rays.ignore_tri, ignore_instance=rays.ignore_inst,
        intersector=cfg.intersector, cull_tile=cfg.cull_tile,
        block=cfg.tri_block, brute_force_max_tris=cfg.brute_force_max_tris,
    )
    mask = ih.hit & rays.alive
    g, frag_w, normal_w = _shade_inputs(iscene, cfg, ih, rays)
    light = _light_result(iscene, cfg, frag_w, normal_w, ih.tri,
                          ih.instance, mask)

    refl = g["refl"][..., None]
    alpha = g["alpha"]
    transparent = g["transparent"] & jnp.asarray(iscene.has_transparent)

    if is_max:
        a = g["surface"] * light
        b = jnp.zeros_like(a)
        c = jnp.zeros_like(alpha)
        children = None
    else:
        a_op = (1.0 - refl) * g["surface"] * light
        b_op = refl * light
        a = jnp.where(transparent[..., None], alpha[..., None] * a_op, a_op)
        b = jnp.where(transparent[..., None], alpha[..., None] * b_op, b_op)
        c = jnp.where(transparent, 1.0 - alpha, 0.0)

        refl_dir = normalize(reflect(rays.direction, normal_w))
        refl_rays = _RaySet(
            origin=frag_w, direction=refl_dir,
            ignore_tri=jnp.where(mask, ih.tri, -1),
            ignore_inst=jnp.where(mask, ih.instance, -1),
            cur_ref=rays.cur_ref,
            alive=mask & jnp.any(b != 0.0, axis=-1),
        )
        refr_rays = None
        if iscene.has_transparent:
            inside = rays.cur_ref == g["ior"]
            n1 = jnp.where(inside, 1.0, g["ior"])
            n2 = jnp.where(inside, rays.cur_ref, 1.0)
            refr_dir = normalize(refract_xna(rays.direction, normal_w, n1, n2))
            refr_rays = _RaySet(
                origin=frag_w, direction=refr_dir,
                ignore_tri=jnp.where(mask, ih.tri, -1),
                ignore_inst=jnp.where(mask, ih.instance, -1),
                cur_ref=n2,
                alive=mask & (c != 0.0),
            )
        children = (refl_rays, refr_rays)

    m3 = mask[..., None]
    rec = LevelRecord(mask=mask, a=jnp.where(m3, a, 0.0),
                      b=jnp.where(m3, b, 0.0), c=jnp.where(mask, c, 0.0))
    return rec, children


def trace_colors_instanced(iscene: InstancedScene, cfg: RenderConfig,
                           origin, direction):
    """Batched CastRay over the instanced scene (wavefront.trace_colors)."""
    r0 = origin.shape[0]
    rays = _RaySet(
        origin=origin, direction=direction,
        ignore_tri=jnp.full((r0,), -1, jnp.int32),
        ignore_inst=jnp.full((r0,), -1, jnp.int32),
        cur_ref=jnp.ones((r0,), jnp.float32),
        alive=jnp.ones((r0,), bool),
    )
    records = []
    for level in range(cfg.max_reflections + 1):
        is_max = level == cfg.max_reflections
        rec, children = _trace_level(iscene, cfg, rays, is_max)
        records.append(rec)
        if not is_max:
            refl_rays, refr_rays = children
            if iscene.has_transparent:
                rays = jax.tree.map(
                    lambda x, y: jnp.concatenate([x, y]), refl_rays, refr_rays
                )
            else:
                rays = refl_rays

    color = None
    for level in reversed(range(cfg.max_reflections + 1)):
        rec = records[level]
        rl = rec.a.shape[0]
        if color is None:
            node = rec.a
        else:
            node = rec.a + rec.b * color[:rl]
            if iscene.has_transparent:
                node = node + rec.c[..., None] * color[rl:]
        node = jnp.where(rec.mask[..., None], node, 0.0)
        if cfg.quantize == Quantize.BOUNCE:
            node = quantize_color(node)
        color = node
    if cfg.quantize == Quantize.FINAL:
        color = quantize_color(color)
    return color


def render_image_instanced(iscene: InstancedScene, cfg: RenderConfig,
                           camera: Optional[Camera] = None):
    """Full-frame instanced render → (H, W, 3) float32."""
    camera = camera or Camera(aspect=cfg.width / cfg.height)
    o, d = camera_rays(camera, cfg.width, cfg.height)
    colors = trace_colors_instanced(iscene, cfg, o, d)
    return colors.reshape(cfg.height, cfg.width, 3)
