"""The wavefront renderer.

``RayTracer.CastRay`` (RayTracer.cs:506-737) is a recursive tree: every hit
spawns a reflection ray (RayTracer.cs:545-559) and, for transparent
materials, a refraction ray (RayTracer.cs:656-699), combined as

    colorVector = lerp(reflection, surface, 1 - reflectiveness) * light
    color       = lerp(refraction, colorVector, alpha)        # if transparent

Both combines are *linear* in the child colors, so the recursion maps to a
two-pass wavefront over static-shaped ray levels:

1. **Forward expansion** — level ``l`` holds the rays at recursion depth
   ``l`` (`R0 * 2^l` slots when the scene has transparent materials —
   children are laid out ``[reflection | refraction]`` — else ``R0``).  Each
   level runs one batched nearest-hit query plus one shadow query per light
   and records per-node linear coefficients:

       color(node) = a + b * color(refl child) + c * color(refr child)

   with ``a = alpha*(1-refl)*S*L``, ``b = alpha*refl*L``, ``c = (1-alpha)``
   (``alpha``/``c`` only for transparent hits; at the reflection limit the
   reference shades ``S*L`` with no children — RayTracer.cs:708-727).

2. **Backward combine** — colors propagate from the deepest level to the
   root.  XNA quantizes every ``CastRay`` return into a byte ``Color``;
   ``Quantize.BOUNCE`` replicates that exactly, ``FINAL`` only rounds the
   framebuffer write, ``NONE`` is full fp32 (HDR).

The scanline dispenser (RayTracer.cs:48-52) becomes tile batching here and
device-mesh sharding in ``raytpu.dist``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from raytpu.accel.traverse import nearest_hit
from raytpu.core import intersect
from raytpu.config import Quantize, RenderConfig, RenderMode
from raytpu.core.camera import Camera, camera_rays
from raytpu.core.math3d import normalize, reflect, refract_xna
from raytpu.core.xna import quantize_color
from raytpu.scene import lights as lights_mod
from raytpu.scene import texture as texture_mod
from raytpu.scene.types import FlatScene


class LevelRecord(NamedTuple):
    mask: jnp.ndarray  # (R,) valid-hit mask
    a: jnp.ndarray  # (R, 3) local emission coefficient
    b: jnp.ndarray  # (R, 3) reflection-child weight
    c: jnp.ndarray  # (R,) refraction-child weight


class RaySet(NamedTuple):
    origin: jnp.ndarray
    direction: jnp.ndarray
    ignore_tri: jnp.ndarray
    ignore_mesh: jnp.ndarray
    cur_ref: jnp.ndarray  # currentRefIndex (RayTracer.cs:506)
    alive: jnp.ndarray


def shade_row_views(s):
    """Field views of packed (…, 32)-float shade rows (FlatScene.tri_shade).

    The ONE layout definition: used by the replicated gather below and by
    the ring-sharded row resolution of dist/bigscene.py."""
    return {
        "v1": s[..., 0:3],
        "e1": s[..., 3:6],
        "e2": s[..., 6:9],
        "n1": s[..., 9:12],
        "n2": s[..., 12:15],
        "n3": s[..., 15:18],
        "uv1": s[..., 18:20],
        "uv2": s[..., 20:22],
        "uv3": s[..., 22:24],
        "snormal": s[..., 24:27],
        "color": s[..., 27:31],
        "mesh": jax.lax.bitcast_convert_type(s[..., 31], jnp.int32),
    }


@jax.custom_vjp
def _gather_rows_geo(table, tri):
    """tri_shade row gather whose VJP scatters ONLY the geometry channels.

    Forward-identical to ``table[tri]``.  Backward: the cotangent of the
    non-geometry channels (normals/uv/color/mesh — scene constants under
    GEOMETRY fits) is dropped and the scatter-add runs on a packed (T, 12)
    table (v1 e1 e2 | snormal) instead of (T, 32), moving 12/32 of the
    scatter's bytes.  Only used when
    cfg.grad_channels == "geometry" (exactness contract in config.py)."""
    return table[tri]


def _gather_rows_geo_fwd(table, tri):
    return table[tri], (tri, table.shape[0])


def _gather_rows_geo_bwd(res, ct):
    tri, t = res
    packed = jnp.concatenate([ct[..., 0:9], ct[..., 24:27]], axis=-1)
    z = jnp.zeros((t, 12), ct.dtype).at[tri].add(packed)
    ct_table = jnp.concatenate(
        [z[:, 0:9],
         jnp.zeros((t, 15), ct.dtype),
         z[:, 9:12],
         jnp.zeros((t, 5), ct.dtype)], axis=-1)
    return ct_table, None


_gather_rows_geo.defvjp(_gather_rows_geo_fwd, _gather_rows_geo_bwd)


def _gather_tri(scene: FlatScene, tri, grad_channels: str = "all"):
    if scene.tri_shade is not None:
        # One packed (32,)-float row per ray (FlatScene.tri_shade) instead
        # of twelve separate gathers.
        if grad_channels == "geometry":
            return shade_row_views(_gather_rows_geo(scene.tri_shade, tri))
        return shade_row_views(scene.tri_shade[tri])
    g = lambda arr: arr[tri]
    return {
        "v1": g(scene.tri_v1),
        "e1": g(scene.tri_e1),
        "e2": g(scene.tri_e2),
        "n1": g(scene.tri_n1),
        "n2": g(scene.tri_n2),
        "n3": g(scene.tri_n3),
        "uv1": g(scene.tri_uv1),
        "uv2": g(scene.tri_uv2),
        "uv3": g(scene.tri_uv3),
        "snormal": g(scene.tri_snormal),
        "color": g(scene.tri_color),
        "mesh": g(scene.tri_mesh),
    }


def _surface_color(scene: FlatScene, cfg: RenderConfig, tri_data, mat, u, v,
                   texel_fetch=None):
    """Texture lookup or per-triangle color (RayTracer.cs:568-581).

    ``texel_fetch``: injected texel backend (ring-sharded >HBM atlases,
    dist/bigscene.py); None = the replicated atlas array."""
    base = tri_data["color"][..., :3]
    if not scene.has_textures:
        return base
    uv = (
        tri_data["uv1"]
        + (tri_data["uv2"] - tri_data["uv1"]) * u[..., None]
        + (tri_data["uv3"] - tri_data["uv1"]) * v[..., None]
    )
    tex_id = jnp.maximum(scene.mat_texture[mat], 0)
    h = scene.tex_hw[tex_id, 0]
    w = scene.tex_hw[tex_id, 1]
    tex = texture_mod.lookup_uv(
        scene.textures, tex_id, h, w, uv, cfg.address_mode, cfg.filtering,
        fetch=texel_fetch,
    )
    use = scene.mat_use_texture[mat] & (scene.mat_texture[mat] >= 0)
    return jnp.where(use[..., None], tex, base)


def _default_query(cfg: RenderConfig):
    """Bind cfg's intersector knobs into the standard nearest-hit query.

    The renderer reaches geometry ONLY through a ``query`` callable (and
    per-triangle data only through ``gather``), so alternative backends —
    the ring-sharded >HBM intersector of dist/bigscene.py — inject theirs
    and reuse every line of the level/shading logic."""

    def query(scene, origin, direction, *, ignore_tri=None,
              ignore_mesh=None, t_max=None, any_hit=False, cull=True):
        return nearest_hit(
            scene, origin, direction, ignore_tri=ignore_tri,
            ignore_mesh=ignore_mesh, cull=cull,
            intersector=cfg.intersector, block=cfg.tri_block,
            brute_force_max_tris=cfg.brute_force_max_tris,
            cull_tile=cfg.cull_tile, cull_chunk=cfg.cull_chunk,
            t_max=t_max, any_hit=any_hit, interpret=cfg.interpret)

    return query


def _light_result(scene: FlatScene, cfg: RenderConfig, frag_pos, normal,
                  hit_tri, valid, query, gather):
    """Per-fragment light sum with shadow rays (RayTracer.cs:533-542).

    Shadow attenuation: opaque occluder blocks fully, transparent occluder
    attenuates by its triangle alpha (IsLightPathObstructed,
    RayTracer.cs:465-502).

    ``valid`` masks live fragments: dead lanes (missed/expired rays) carry
    garbage ``frag_pos`` from the ``tri == -1`` gather, so their shadow rays
    are marked non-finite — they can never hit and, critically, the tiled
    backends exclude them from the cull-tile bounds (accel/tiled.py).
    """
    total = jnp.zeros_like(frag_pos)
    lt = scene.lights
    nanv = jnp.float32(jnp.nan)
    for i in range(scene.num_lights):
        sdir, sdist = lights_mod.light_shadow_query(lt, i, frag_pos)
        contrib = lights_mod.light_contrib(lt, i, frag_pos, normal)
        # Fragments the light cannot reach anyway (outside the spot cone,
        # facing away — SpotLight.cs:45-52) contribute zero regardless of
        # occlusion, so their shadow rays are skipped outright (dead-lane
        # NaN direction).  Exact: 0 * (1 - shadow) == 0.
        lit = valid & jnp.any(contrib != 0.0, axis=-1)
        # Shadow visibility is discrete — detach the query inputs in
        # differentiable mode (outputs are stop-gradient'ed below; the
        # walk kernel has no JVP rule).
        sg = jax.lax.stop_gradient if cfg.differentiable else (lambda x: x)
        # Shadow-from-light reversal (opaque scenes, positionable lights):
        # cast the segment test from the LIGHT toward the fragment.  All
        # rays of the query then share one origin — tile beams become thin
        # cones and the conservative cull prunes far more clusters.  The
        # accepted-triangle set is identical: same segment, same t-bound,
        # mirrored backface culling (cull="reverse"); only FP rounding at
        # edge-grazing occluders can flip.  Opaque-only because the
        # transparent path needs the occluder NEAREST THE FRAGMENT
        # (RayTracer.cs:465-502) and reversal finds the one nearest the
        # light.
        reverse = (
            cfg.shadow_from_light
            and not scene.has_transparent
            and i < len(scene.light_kinds)
            and scene.light_kinds[i] == lights_mod.SPOT
        )
        # Per-cluster shadow clearance (accel/shadowcull.py): every
        # possible occluder of a fragment provably lies at light-distance
        # >= min(D(own block), the ray's own-block AABB entry), so the
        # searched segment shrinks to the fragment's neighborhood on lit
        # open scenes — exact, computed in-graph per frame (no staleness
        # under moving lights / refit geometry).
        use_clear = (
            cfg.shadow_clearance
            and scene.clusters is not None
            and "tri_block" in scene.clusters
        )
        if reverse:
            origin_q = jnp.broadcast_to(lt["position"][i], frag_pos.shape)
            dir_q = -sdir
            tmax_q = sdist
            if use_clear:
                from raytpu.accel.shadowcull import (clearance_spot,
                                                     own_block_entry_exit)

                clr = scene.clusters
                dvals = clearance_spot(clr, lt["position"][i])
                b_id, t_en, _ = own_block_entry_exit(
                    clr, clr["tri_block"], hit_tri, origin_q, dir_q)
                t_en = jnp.maximum(t_en, 0.0)
                # BINARY shift: all-or-nothing per ray.  Blending
                # (tmin = min(D, entry)) would shift rays by varying
                # partial distances, landing mixed origins in one cull
                # tile and widening its origin box.
                # Shift only rays whose whole far field is provably
                # clear; tiles of block-coherent fragments then agree.
                clear_ray = dvals[b_id] >= t_en
                # Conservative shave: fp rounding in the clearance sweep
                # and the slab entry must never push the start past a
                # real occluder.
                tmin = jnp.where(lit & clear_ray,
                                 jnp.clip(t_en * (1.0 - 1e-4) - 1e-4,
                                          0.0, None),
                                 0.0)
                origin_q = origin_q + tmin[..., None] * dir_q
                tmax_q = sdist - tmin
            shadow = query(
                jax.tree.map(sg, scene) if cfg.differentiable else scene,
                sg(origin_q),
                sg(jnp.where(lit[..., None], dir_q, nanv)),
                ignore_tri=hit_tri,
                cull="reverse",
                t_max=sg(tmax_q),
                any_hit=True,
            )
        else:
            tmax_q = sdist
            directional = (i < len(scene.light_kinds)
                           and scene.light_kinds[i] == lights_mod.DIRECTIONAL)
            if use_clear and directional:
                # Directional analog: parallel beams.  When nothing lies
                # beyond the fragment's own block along the shared light
                # direction (D' = INF), the search may stop at the own
                # block's AABB exit — suffix emptiness is the only sound
                # cap in the fragment-side parametrization.
                from raytpu.accel.shadowcull import (
                    clearance_directional, own_block_entry_exit)

                clr = scene.clusters
                dl = -lt["direction"][i]
                dvals = clearance_directional(clr, dl)
                b_id, _, t_ex = own_block_entry_exit(
                    clr, clr["tri_block"], hit_tri, frag_pos,
                    jnp.broadcast_to(dl, frag_pos.shape))
                own_cap = jnp.maximum(t_ex, 0.0) * (1.0 + 1e-4) + 1e-4
                tmax_q = jnp.where(dvals[b_id] >= sdist,
                                   jnp.minimum(sdist, own_cap), sdist)
            shadow = query(
                jax.tree.map(sg, scene) if cfg.differentiable else scene,
                sg(frag_pos),
                sg(jnp.where(lit[..., None], sdir, nanv)),
                ignore_tri=hit_tri,
                cull=True,
                # Bound the search at the light: occluders beyond it are
                # irrelevant and unoccluded rays stop scanning early.
                t_max=sg(tmax_q),
                # Opaque scenes only need the occlusion boolean, so the
                # query may stop at the first qualifying hit.  Transparent
                # scenes need the *nearest* occluder (its alpha attenuates
                # the light).
                any_hit=not scene.has_transparent,
            )
        if cfg.differentiable:
            # Shadow visibility is discrete: detach the query (also severs
            # reverse-mode from the traversal while_loop); transparent-
            # occluder alpha stays differentiable via the tri_color gather.
            shadow = jax.tree.map(jax.lax.stop_gradient, shadow)
        obstructed = shadow.hit & (shadow.t < sdist)
        if scene.has_transparent:
            # Occluder mesh + alpha through the injected gather (one shade
            # row instead of two scalar gathers) so the ring-sharded >HBM
            # path resolves them from its row shards too.
            occ = gather(scene, shadow.tri)
            occ_transparent = scene.mat_transparent[
                scene.mesh_material[occ["mesh"]]
            ]
            occ_alpha = occ["color"][..., 3]
            light_amount = jnp.where(
                obstructed, jnp.where(occ_transparent, occ_alpha, 1.0), 0.0
            )
        else:
            # Opaque scene: every occluder blocks fully — skip the
            # occluder-material gathers (the any_hit query's reported
            # triangle is not meaningful anyway — accel/traverse.nearest_hit
            # docstring).
            light_amount = jnp.where(obstructed, 1.0, 0.0)
        total = total + contrib * (1.0 - light_amount)[..., None]
    return total


def _trace_level(scene: FlatScene, cfg: RenderConfig, rays: RaySet,
                 is_max_level: bool, capture_hits: bool = False,
                 query=None, gather=_gather_tri, texel_fetch=None):
    """One wavefront level: intersect + shade + spawn children.

    ``capture_hits``: additionally return ``(hit, frag_pos)`` so debug
    tooling (render/debug.py) reuses this level's intersection instead of
    re-querying — the captured path is *the* renderer's computation, with
    no second query that could drift from it.

    ``query``/``gather``: the intersection and per-triangle-data backends
    (default: cfg-bound ``nearest_hit`` + replicated ``tri_shade`` rows);
    dist/bigscene.py injects ring-sharded >HBM implementations."""
    if query is None:
        query = _default_query(cfg)
    if gather is _gather_tri:
        # Bind the cfg's gradient-channel contract into the default gather
        # (injected gathers manage their own differentiability).
        import functools

        gather = functools.partial(_gather_tri,
                                   grad_channels=cfg.grad_channels)
    # In differentiable mode the discrete query is detached (its outputs
    # are stop-gradient'ed below and (u, v, t) recomputed), so detach its
    # INPUTS too: AD then never enters the intersector at all — required
    # for the walk kernel (no JVP rule) and pure savings elsewhere.
    sg = jax.lax.stop_gradient if cfg.differentiable else (lambda x: x)
    hit = query(
        jax.tree.map(sg, scene) if cfg.differentiable else scene,
        sg(rays.origin),
        # Dead lanes become non-finite: they can never hit and the tiled
        # backends exclude them from cull-tile bounds (accel/tiled.py).
        sg(jnp.where(rays.alive[..., None], rays.direction,
                     jnp.float32(jnp.nan))),
        ignore_tri=rays.ignore_tri, ignore_mesh=rays.ignore_mesh, cull=True,
    )
    soft_vis = None
    if cfg.differentiable:
        hit = jax.tree.map(jax.lax.stop_gradient, hit)
    mask = hit.hit & rays.alive
    tri = hit.tri
    # Misses carry tri == -1 and gather the wrap row: finite values that
    # the mask below discards, so no NaN reaches shading.
    td = gather(scene, tri)
    if cfg.differentiable:
        # Detach the discrete search, then recompute (u, v, t) from the hit
        # triangle so gradients flow regardless of intersector backend.  The
        # recompute uses the same formula on the same inputs → identical
        # forward values (see core/intersect.py::moller_trumbore_safe).
        # The triangle data comes from the SAME gathered row as shading
        # (td) — a second differentiable gather of tri_v1/e1/e2 would cost
        # a second full scatter-add in the backward).  Misses
        # gather the wrap row instead of row 0 — masked below either way,
        # and the determinant guard keeps them NaN-free.
        u_d, v_d, t_d = intersect.moller_trumbore_safe(
            rays.origin,
            rays.direction,
            td["v1"],
            td["e1"],
            td["e2"],
        )
        u = jnp.where(hit.hit, u_d, 0.0)
        v = jnp.where(hit.hit, v_d, 0.0)
        if cfg.soft_tau > 0.0:
            # Straight-through silhouette gradients: forward is the exact
            # hard visibility; backward sees a sigmoid of the barycentric
            # edge distance (diff/: soft-visibility north star).
            edge = jnp.minimum(jnp.minimum(u_d, v_d), 1.0 - u_d - v_d)
            soft = jax.nn.sigmoid(edge / cfg.soft_tau)
            soft_vis = soft - jax.lax.stop_gradient(soft)
        hit = hit._replace(u=u, v=v, t=jnp.where(hit.hit, t_d, hit.t))
    mat = scene.mesh_material[td["mesh"]]

    # Fragment normal (RayTracer.cs:520-531).
    interp = scene.mat_interp_normals[mat]
    n_lerped = (
        td["n1"]
        + (td["n2"] - td["n1"]) * hit.u[..., None]
        + (td["n3"] - td["n1"]) * hit.v[..., None]
    )
    n_lerped = normalize(n_lerped)
    normal = jnp.where(interp[..., None], n_lerped, td["snormal"])

    # World-space hit position (MeshOctree.cs:310-322; already world space
    # since instances are baked).
    frag_pos = td["v1"] + td["e1"] * hit.u[..., None] + td["e2"] * hit.v[..., None]

    light = _light_result(scene, cfg, frag_pos, normal, tri, mask, query,
                          gather)
    surface = _surface_color(scene, cfg, td, mat, hit.u, hit.v,
                             texel_fetch=texel_fetch)

    refl = scene.mat_reflect[mat][..., None]
    alpha = td["color"][..., 3]
    transparent = scene.mat_transparent[mat] & jnp.asarray(scene.has_transparent)

    if is_max_level:
        # Reflection-limit shading: S * L (RayTracer.cs:708-727).
        a = surface * light
        b = jnp.zeros_like(a)
        c = jnp.zeros_like(alpha)
        children = None
    else:
        a_opaque = (1.0 - refl) * surface * light
        b_opaque = refl * light
        a = jnp.where(transparent[..., None], alpha[..., None] * a_opaque, a_opaque)
        b = jnp.where(transparent[..., None], alpha[..., None] * b_opaque, b_opaque)
        c = jnp.where(transparent, 1.0 - alpha, 0.0)

        # Reflection child (RayTracer.cs:545-559).
        refl_dir = normalize(reflect(rays.direction, normal))
        convex = scene.mesh_convex[td["mesh"]]
        refl_ignore_mesh = jnp.where(convex, td["mesh"], -1)
        refl_alive = mask & jnp.any(b != 0.0, axis=-1)
        refl_rays = RaySet(
            origin=frag_pos,
            direction=refl_dir,
            ignore_tri=jnp.where(mask, tri, -1),
            ignore_mesh=jnp.where(mask, refl_ignore_mesh, -1),
            cur_ref=rays.cur_ref,
            alive=refl_alive,
        )

        refr_rays = None
        if scene.has_transparent:
            # Refraction (RayTracer.cs:656-699): n1/n2 selected by comparing
            # currentRefIndex with the material's index, child recurses with
            # currentRefIndex = n2.
            mat_ior = scene.mat_refraction[mat]
            inside = rays.cur_ref == mat_ior
            n1 = jnp.where(inside, 1.0, mat_ior)
            n2 = jnp.where(inside, rays.cur_ref, 1.0)
            refr_dir = refract_xna(rays.direction, normal, n1, n2)
            refr_dir = normalize(refr_dir)
            refr_alive = mask & (c != 0.0)
            refr_rays = RaySet(
                origin=frag_pos,
                direction=refr_dir,
                ignore_tri=jnp.where(mask, tri, -1),
                ignore_mesh=jnp.full_like(tri, -1),
                cur_ref=n2,
                alive=refr_alive,
            )
        children = (refl_rays, refr_rays)

    m3 = mask[..., None]
    a = jnp.where(m3, a, 0.0)
    b = jnp.where(m3, b, 0.0)
    c = jnp.where(mask, c, 0.0)
    if soft_vis is not None:
        # Zero-forward residual: scales hit lanes by (1 + soft - sg(soft)) so
        # silhouette-adjacent hits carry d(pixel)/d(edge distance).
        stm = 1.0 + jnp.where(mask, soft_vis, 0.0)
        a, b, c = a * stm[..., None], b * stm[..., None], c * stm
    record = LevelRecord(mask=mask, a=a, b=b, c=c)
    if capture_hits:
        return record, children, (hit, frag_pos)
    return record, children


def debug_mode_colors(scene: FlatScene, cfg: RenderConfig, origin, direction):
    """Diagnostic render channels (RayTracer.cs:563-566).

    One primary nearest-hit, no recursion or lights: ``NORMALS`` clamps the
    fragment normal into RGB exactly like XNA's ``new Color(Vector3)``
    (negative components saturate to 0); ``CONVEXFLAG`` paints convex
    meshes green, the rest red.  Misses stay black."""
    rays = RaySet(
        origin=origin,
        direction=direction,
        ignore_tri=jnp.full(origin.shape[:1], -1, jnp.int32),
        ignore_mesh=jnp.full(origin.shape[:1], -1, jnp.int32),
        cur_ref=jnp.ones(origin.shape[:1], jnp.float32),
        alive=jnp.ones(origin.shape[:1], bool),
    )
    hit = _default_query(cfg)(
        scene, rays.origin, rays.direction, ignore_tri=rays.ignore_tri,
        ignore_mesh=rays.ignore_mesh, cull=True)
    td = _gather_tri(scene, hit.tri)
    mat = scene.mesh_material[td["mesh"]]
    if cfg.render_mode == RenderMode.NORMALS:
        interp = scene.mat_interp_normals[mat]
        n_lerped = normalize(
            td["n1"]
            + (td["n2"] - td["n1"]) * hit.u[..., None]
            + (td["n3"] - td["n1"]) * hit.v[..., None]
        )
        normal = jnp.where(interp[..., None], n_lerped, td["snormal"])
        color = jnp.clip(normal, 0.0, 1.0)
    elif cfg.render_mode == RenderMode.CONVEXFLAG:
        convex = scene.mesh_convex[td["mesh"]]
        green = jnp.asarray([0.0, 128.0 / 255.0, 0.0], jnp.float32)
        red = jnp.asarray([1.0, 0.0, 0.0], jnp.float32)
        color = jnp.where(convex[..., None], green, red)
    else:
        raise ValueError(cfg.render_mode)
    return jnp.where(hit.hit[..., None], color, 0.0)


def trace_colors(scene: FlatScene, cfg: RenderConfig, origin, direction,
                 alive=None, query=None, gather=_gather_tri,
                 texel_fetch=None):
    """Batched CastRay: colors for an arbitrary set of primary rays.

    Implements the full recursion of RayTracer.CastRay as a forward
    expansion + backward combine (see module docstring).  Miss = black
    (RayTracer.cs:729-735).

    ``query``/``gather``: see ``_trace_level`` — dist/bigscene.py injects
    the ring-sharded backends here to render >HBM scenes with this exact
    level/shading code.
    """
    if cfg.render_mode != RenderMode.SHADED:
        return debug_mode_colors(scene, cfg, origin, direction)
    r0 = origin.shape[0]
    rays = RaySet(
        origin=origin,
        direction=direction,
        ignore_tri=jnp.full((r0,), -1, jnp.int32),
        ignore_mesh=jnp.full((r0,), -1, jnp.int32),
        cur_ref=jnp.ones((r0,), jnp.float32),
        alive=jnp.ones((r0,), bool) if alive is None else alive,
    )

    # Slot layout per level:
    #  - opaque scenes: R0 (reflection chain only);
    #  - transparent, NO dual-branch material: R0 — a parent spawns at most
    #    ONE live child (reflection needs reflectiveness > 0, refraction
    #    needs transparency; no material has both), so children merge into
    #    the parent's slot with a per-parent select and the combine
    #    coefficient folds b/c into one (exact; the 2^depth expansion the
    #    reference's recursion implies simply never materializes);
    #  - dual-branch: [reflection | refraction] doubling, optionally
    #    live-first compacted between levels (cfg.compact_wavefront).
    dual = scene.has_transparent and scene.has_dual_branch
    merged = scene.has_transparent and not scene.has_dual_branch
    records = []
    orders = [None] * (cfg.max_reflections + 1)
    for level in range(cfg.max_reflections + 1):
        is_max = level == cfg.max_reflections
        record, children = _trace_level(scene, cfg, rays, is_max,
                                        query=query, gather=gather,
                                        texel_fetch=texel_fetch)
        if not is_max:
            refl_rays, refr_rays = children
            if dual:
                rays = jax.tree.map(
                    lambda x, y: jnp.concatenate([x, y]), refl_rays, refr_rays
                )
                if cfg.compact_wavefront:
                    order = _compact_order(~rays.alive)
                    take = lambda a: jnp.take(a, order, axis=0)
                    rays = jax.tree.map(take, rays)
                    orders[level + 1] = order
            elif merged:
                # One live child per parent: select it into the parent's
                # slot and fold the two combine coefficients into b.
                sel = refl_rays.alive

                def pick(fa, fb):
                    s = sel.reshape(sel.shape + (1,) * (fa.ndim - 1))
                    return jnp.where(s, fa, fb)

                rays = jax.tree.map(pick, refl_rays, refr_rays)
                record = record._replace(
                    b=jnp.where(sel[:, None], record.b,
                                jnp.broadcast_to(record.c[:, None],
                                                 record.b.shape)),
                    c=jnp.zeros_like(record.c),
                )
            else:
                rays = refl_rays
        records.append(record)

    # Backward combine (child colors → parent), deepest level first.
    color = None
    for level in reversed(range(cfg.max_reflections + 1)):
        rec = records[level]
        rl = rec.a.shape[0]
        if color is None:
            node = rec.a
        else:
            if orders[level + 1] is not None:
                # The child level ran live-first compacted; un-permute its
                # colors back to [reflection | refraction] slot order.
                color = jnp.zeros_like(color).at[orders[level + 1]].set(
                    color)
            child_r = color[:rl]
            node = rec.a + rec.b * child_r
            if dual:
                child_t = color[rl:]
                node = node + rec.c[..., None] * child_t
        node = jnp.where(rec.mask[..., None], node, 0.0)
        if cfg.quantize == Quantize.BOUNCE:
            node = quantize_color(node)
        color = node

    if cfg.quantize == Quantize.FINAL:
        color = quantize_color(color)
    return color


def _compact_order(resolved):
    """Stable permutation putting unresolved rays first.

    ``order[j]`` = source index of sorted slot ``j``.  Cumsum-based stable
    partition — O(R) instead of a full device sort."""
    i32 = jnp.int32
    res = resolved.astype(i32)
    n_unres = jnp.sum(1 - res)
    pos_u = jnp.cumsum(1 - res) - 1
    pos_r = n_unres + jnp.cumsum(res) - 1
    dest = jnp.where(resolved, pos_r, pos_u)
    return jnp.zeros_like(dest).at[dest].set(
        jnp.arange(dest.shape[0], dtype=i32))


def _pad_rays(o, d, tile: int):
    n = o.shape[0]
    pad = (-n) % tile
    if pad:
        o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
        d = jnp.concatenate([d, jnp.ones((pad, 3), d.dtype)])
    return o, d, n


def render_rays(scene: FlatScene, cfg: RenderConfig, origin, direction):
    """Trace an arbitrary ray batch tile-by-tile (lax.map over tiles)."""
    o, d, n = _pad_rays(origin, direction, cfg.tile_pixels)
    tiles = o.shape[0] // cfg.tile_pixels

    def one_tile(args):
        to, td = args
        return trace_colors(scene, cfg, to, td)

    colors = jax.lax.map(
        one_tile,
        (o.reshape(tiles, cfg.tile_pixels, 3), d.reshape(tiles, cfg.tile_pixels, 3)),
    )
    return colors.reshape(-1, 3)[:n]


def block_order_perm(width: int, height: int, block: int):
    """Raster indices in square-block-major order.

    The cull tiles of accel/tiled.py are consecutive ray runs; square pixel
    blocks give each tile a compact direction cone (and compact secondary-
    ray footprints), where raster runs of whole scanlines would give a
    degenerate wide one.  Pure permutation — per-ray results are identical,
    this only regroups them (the analog of the reference handing out
    scanlines, RayTracer.cs:49-52, except the unit is a tile).
    """
    import numpy as np

    ys, xs = np.mgrid[0:height, 0:width]
    ys, xs = ys.ravel(), xs.ravel()
    return np.lexsort((xs % block, ys % block, xs // block, ys // block))


def render_image(scene: FlatScene, cfg: RenderConfig,
                 camera: Optional[Camera] = None, progress=None,
                 watch_path: Optional[str] = None, watch_every: int = 4):
    """Full-frame render → (H, W, 3) float32 in [0, 1].

    The Render/RenderAsync equivalent (RayTracer.cs:391-428): primary rays
    through integer pixel coordinates, traced in square-block order.  With
    ``cfg.use_multisampling`` the adaptive 4-corner supersampler runs
    instead (RayTracer.cs:128-311).

    ``progress``: optional ``callback(done, total)`` — the reference's
    ``Progress`` fraction (RayTracer.cs:43-46, polled for the on-screen
    overlay at Game1.cs:331-341).  When set, tiles are dispatched from a
    host loop (one jitted call per tile batch) so the callback fires as the
    frame advances; without it the whole frame is one ``lax.map`` program.

    ``watch_path``: progressive viewing — write the partial frame (traced
    tiles filled in, the rest black) to this PNG path every ``watch_every``
    tile batches, the batch analog of watching the reference's live
    RenderTarget fill in (Game1.cs:389-416).  Implies the host loop.
    """
    camera = camera or Camera(aspect=cfg.width / cfg.height)
    if cfg.use_multisampling:
        from raytpu.render.supersample import render_image_multisampled

        return render_image_multisampled(scene, cfg, camera)
    o, d = camera_rays(camera, cfg.width, cfg.height)
    block = max(1, int(cfg.cull_tile ** 0.5))
    perm = block_order_perm(cfg.width, cfg.height, block)
    if progress is None and watch_path is None:
        colors = render_rays(scene, cfg, o[perm], d[perm])
    else:
        op, dp, n = _pad_rays(o[perm], d[perm], cfg.tile_pixels)
        tiles = op.shape[0] // cfg.tile_pixels
        fn = jax.jit(lambda s, to, td: trace_colors(s, cfg, to, td))
        parts = []

        def partial_image():
            done = jnp.concatenate(parts) if parts else jnp.zeros((0, 3))
            fill = jnp.zeros((op.shape[0] - done.shape[0], 3), jnp.float32)
            cols = jnp.concatenate([done, fill])[:n]
            img = jnp.zeros_like(cols).at[perm].set(cols)
            return img.reshape(cfg.height, cfg.width, 3)

        for t in range(tiles):
            sl = slice(t * cfg.tile_pixels, (t + 1) * cfg.tile_pixels)
            parts.append(fn(scene, op[sl], dp[sl]))
            if progress is not None:
                progress(t + 1, tiles)
            if watch_path is not None and t + 1 < tiles and (
                    (t + 1) % watch_every == 0):
                from raytpu.io.image import write_image

                write_image(watch_path, partial_image())
        colors = jnp.concatenate(parts)[:n]
    out = jnp.zeros_like(colors).at[perm].set(colors)
    return out.reshape(cfg.height, cfg.width, 3)
