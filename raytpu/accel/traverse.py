"""Nearest-hit queries: brute-force sweep and stackless octree traversal.

Both return the same ``Hit`` structure and are cross-validated against each
other and against the NumPy oracle.  The query semantics follow the
reference's scene query (OctreeSpatialManager.GetRayIntersection,
OctreeSpatialManager.cs:312-455): optional backface culling
(the engine always culls — MeshOctree.cs:293), an ``ignore_triangle`` id for
self-intersection avoidance (MeshOctree.cs:290) and an ``ignore_mesh`` id for
convex-geometry reflection rays (RayTracer.cs:554-559), with ties broken by
scan order (strict ``<`` on distance).  Unlike the reference we return the
*exact* nearest hit (see accel/octree.py for why).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from raytpu.core.intersect import moller_trumbore, ray_aabb
from raytpu.core.math3d import dot

FLOAT_MAX = jnp.float32(3.4028235e38)


class Hit(NamedTuple):
    """Nearest-hit result per ray (mirrors IntersectionResult,
    OctreeSpatialManager.cs:11-33, minus the world position which the
    renderer derives)."""

    hit: jnp.ndarray  # (R,) bool
    t: jnp.ndarray  # (R,) distance (FLOAT_MAX on miss)
    u: jnp.ndarray  # (R,)
    v: jnp.ndarray  # (R,)
    tri: jnp.ndarray  # (R,) int32 triangle index (-1 on miss)


def _tri_hits(scene, origin, direction, tri_idx, ignore_tri, ignore_mesh, cull):
    """Test a (R, B) block of ray x triangle pairs.

    ``origin/direction``: (R, 3); ``tri_idx``: (B,) triangle ids.
    Returns (ok, u, v, d) with shape (R, B).
    """
    v1 = scene.tri_v1[tri_idx][None]
    e1 = scene.tri_e1[tri_idx][None]
    e2 = scene.tri_e2[tri_idx][None]
    o = origin[:, None, :]
    d = direction[:, None, :]
    ok, u, v, dist = moller_trumbore(o, d, v1, e1, e2)
    if cull:
        from raytpu.core.intersect import facing_gate

        ok &= facing_gate(scene.tri_snormal[tri_idx][None], d, cull)
    ok &= scene.tri_valid[tri_idx][None]
    ok &= tri_idx[None, :] != ignore_tri[:, None]
    ok &= scene.tri_mesh[tri_idx][None] != ignore_mesh[:, None]
    return ok, u, v, dist


def nearest_hit_brute(scene, origin, direction, ignore_tri=None,
                      ignore_mesh=None, cull: bool = True,
                      block: int = 2048, t_max=None) -> Hit:
    """Dense sweep over all triangles, blocked to bound memory.

    Every block is a dense (R, B) elementwise Möller–Trumbore with a
    running strict-min, which preserves the reference's first-in-scan-order
    tie-breaking.
    """
    r = origin.shape[0]
    n = scene.tri_v1.shape[0]
    if ignore_tri is None:
        ignore_tri = jnp.full((r,), -1, jnp.int32)
    if ignore_mesh is None:
        ignore_mesh = jnp.full((r,), -1, jnp.int32)

    nblocks = max(1, -(-n // block))
    pad_n = nblocks * block
    # Padding indices point at triangle 0 but are masked via tri_valid==False
    # only when the scene itself is padded; guard explicitly instead.
    idx_all = jnp.arange(pad_n, dtype=jnp.int32)
    in_range = idx_all < n
    idx_all = jnp.where(in_range, idx_all, 0)

    def body(carry, blk):
        best_t, best_u, best_v, best_tri = carry
        tri_idx, valid_blk = blk
        ok, u, v, dist = _tri_hits(
            scene, origin, direction, tri_idx, ignore_tri, ignore_mesh, cull
        )
        ok &= valid_blk[None, :]
        dist = jnp.where(ok, dist, FLOAT_MAX)
        j = jnp.argmin(dist, axis=1)
        rr = jnp.arange(r)
        cand_t = dist[rr, j]
        upd = cand_t < best_t
        best_t = jnp.where(upd, cand_t, best_t)
        best_u = jnp.where(upd, u[rr, j], best_u)
        best_v = jnp.where(upd, v[rr, j], best_v)
        best_tri = jnp.where(upd, tri_idx[j], best_tri)
        return (best_t, best_u, best_v, best_tri), None

    # Derive the carry init from the (possibly device-varying) ray arrays so
    # the scan carry type matches under shard_map manual axes.
    zero_r = jnp.zeros_like(origin[:, 0])
    init = (
        zero_r + (FLOAT_MAX if t_max is None else t_max),
        zero_r,
        zero_r,
        zero_r.astype(jnp.int32) - 1,
    )
    blocks = (idx_all.reshape(nblocks, block), in_range.reshape(nblocks, block))
    (best_t, best_u, best_v, best_tri), _ = jax.lax.scan(body, init, blocks)
    hit = best_tri >= 0
    best_t = jnp.where(hit, best_t, FLOAT_MAX)
    return Hit(hit=hit, t=best_t, u=best_u, v=best_v, tri=best_tri)


def nearest_hit_octree(scene, origin, direction, ignore_tri=None,
                       ignore_mesh=None, cull: bool = True,
                       t_max=None) -> Hit:
    """Batched stackless octree traversal (lockstep "while-while").

    The whole ray batch advances together — no per-ray scalar program, so
    XLA sees only dense (R,) / (R, chunk) operations:

    - **inner loop**: every unfinished ray steps its preorder node pointer
      (descend to ``i+1`` on AABB hit of an internal node with entry
      distance below its current best t, else jump to ``skip[i]``) until it
      parks on a leaf chunk or walks off the end.  Cost per iteration is a
      6-float gather + slab test per ray.
    - **leaf phase**: all parked rays test their chunk's pre-gathered
      (chunk, 3) triangle block with one dense Möller–Trumbore + strict-min
      update, then jump to ``skip`` (which chains multi-chunk leaves).

    This is the classic batched traversal shape (cf. Aila & Laine's
    while-while) restructured as dense array ops: per-ray divergence costs
    masked lanes, never recompilation or scalar loops.  Exact nearest hit —
    strict-min keeps scan-order tie-breaking within a chunk; across
    duplicated leaves the winning hit is identical.
    """
    oct_ = scene.octree
    node_min = oct_["node_min"]
    node_max = oct_["node_max"]
    node_skip = oct_["node_skip"]
    node_chunk = oct_["node_chunk"]
    leaf_tris = oct_["leaf_tris"]  # (C, CH)
    leaf_v1 = oct_["leaf_v1"]
    leaf_e1 = oct_["leaf_e1"]
    leaf_e2 = oct_["leaf_e2"]
    leaf_sn = oct_["leaf_snormal"]
    leaf_mesh = oct_["leaf_mesh"]
    num_nodes = node_min.shape[0]

    r = origin.shape[0]
    if ignore_tri is None:
        ignore_tri = jnp.full((r,), -1, jnp.int32)
    if ignore_mesh is None:
        ignore_mesh = jnp.full((r,), -1, jnp.int32)

    # NaN rays (the reference's TIR refraction rays) never hit.
    bad = ~(jnp.all(jnp.isfinite(direction), axis=-1)
            & jnp.all(jnp.isfinite(origin), axis=-1))

    zero = jnp.zeros_like(origin[:, 0])
    izero = zero.astype(jnp.int32)
    state0 = (
        jnp.where(bad, num_nodes, 0) + izero,  # node
        # best_t starts at the per-ray bound: prunes node entry (t_near <
        # best_t) and bounds the scan, e.g. shadow rays stop at the light.
        zero + (FLOAT_MAX if t_max is None else t_max),
        zero,  # best_u
        zero,  # best_v
        izero - 1,  # best_tri
    )

    def outer_cond(st):
        return jnp.any(st[0] < num_nodes)

    def outer_body(st):
        node, best_t, best_u, best_v, best_tri = st

        def inner_cond(s):
            nd, parked = s[0], s[1]
            return jnp.any((nd < num_nodes) & ~parked)

        def inner_body(s):
            nd, parked = s
            safe = jnp.minimum(nd, num_nodes - 1)
            box_hit, t_near = ray_aabb(
                origin, direction, node_min[safe], node_max[safe]
            )
            active = (nd < num_nodes) & ~parked
            enter = box_hit & (t_near < best_t)
            is_leaf = node_chunk[safe] >= 0
            newpark = active & enter & is_leaf
            nxt = jnp.where(enter & ~is_leaf, nd + 1, node_skip[safe])
            nd = jnp.where(active & ~newpark, nxt, nd)
            return nd, parked | newpark

        node, parked = jax.lax.while_loop(
            inner_cond, inner_body, (node, jnp.zeros_like(bad) & False)
        )

        # Leaf phase: dense (R, CH) test of each parked ray's chunk.
        safe = jnp.minimum(node, num_nodes - 1)
        row = jnp.where(parked, node_chunk[safe], 0)
        tri_ids = leaf_tris[row]  # (R, CH)
        ok, u, v, dist = moller_trumbore(
            origin[:, None, :],
            direction[:, None, :],
            leaf_v1[row],
            leaf_e1[row],
            leaf_e2[row],
        )
        if cull:
            from raytpu.core.intersect import facing_gate

            ok &= facing_gate(leaf_sn[row], direction[:, None, :], cull)
        ok &= tri_ids >= 0
        ok &= tri_ids != ignore_tri[:, None]
        ok &= leaf_mesh[row] != ignore_mesh[:, None]
        ok &= parked[:, None]
        dist = jnp.where(ok, dist, FLOAT_MAX)
        j = jnp.argmin(dist, axis=1)
        rr = jnp.arange(r)
        cand = dist[rr, j]
        upd = cand < best_t
        best_t = jnp.where(upd, cand, best_t)
        best_u = jnp.where(upd, u[rr, j], best_u)
        best_v = jnp.where(upd, v[rr, j], best_v)
        best_tri = jnp.where(upd, tri_ids[rr, j], best_tri)
        node = jnp.where(parked, node_skip[safe], node)
        return node, best_t, best_u, best_v, best_tri

    _, bt, bu, bv, btri = jax.lax.while_loop(outer_cond, outer_body, state0)
    hit = btri >= 0
    return Hit(hit=hit, t=jnp.where(hit, bt, FLOAT_MAX), u=bu, v=bv, tri=btri)


def nearest_hit(scene, origin, direction, ignore_tri=None, ignore_mesh=None,
                cull: bool = True, intersector="auto", block: int = 2048,
                brute_force_max_tris: int = 4096, cull_tile: int = 256,
                cull_chunk: int = 1, t_max=None,
                any_hit: bool = False, interpret: bool = False) -> Hit:
    """Dispatch by configured intersector (config.Intersector).

    AUTO: BRUTE for small scenes; with a cluster table, the walk kernel
    (PALLAS) on a GPU and TILED elsewhere; else OCTREE or BRUTE.  PALLAS
    raises off the GPU unless ``interpret`` asks for the Pallas
    interpreter (utils/backend.py).

    ``any_hit``: occlusion-query mode — the hit/no-hit boolean (against
    ``t_max``) is exact but the reported hit may not be the nearest, letting
    the tiled/walk backends stop at the first qualifying hit
    (IsLightPathObstructed's early-out, RayTracer.cs:465-502).  Only valid
    when the caller uses nothing but ``Hit.hit``.  BRUTE/OCTREE ignore it
    (they return the nearest hit, whose boolean is identical).
    """
    from raytpu.config import Intersector
    from raytpu.utils.backend import check_kernel_platform, on_gpu

    mode = intersector
    if isinstance(mode, str):
        mode = Intersector[mode.upper()]
    if mode == Intersector.AUTO:
        if scene.num_tris <= brute_force_max_tris:
            mode = Intersector.BRUTE
        elif getattr(scene, "clusters", None) is not None:
            mode = Intersector.PALLAS if on_gpu() else Intersector.TILED
        elif scene.octree is not None:
            mode = Intersector.OCTREE
        else:
            mode = Intersector.BRUTE
    if mode == Intersector.BRUTE:
        return nearest_hit_brute(
            scene, origin, direction, ignore_tri, ignore_mesh, cull, block,
            t_max=t_max,
        )
    if mode == Intersector.OCTREE:
        return nearest_hit_octree(
            scene, origin, direction, ignore_tri, ignore_mesh, cull,
            t_max=t_max,
        )
    if mode == Intersector.TILED:
        from raytpu.accel.tiled import nearest_hit_tiled

        return nearest_hit_tiled(
            scene, origin, direction, ignore_tri, ignore_mesh, cull,
            tile_size=cull_tile, chunk=cull_chunk, t_max=t_max,
            any_hit=any_hit,
        )
    if mode == Intersector.PALLAS:
        from raytpu.kernels.walk import nearest_hit_walk

        check_kernel_platform(interpret)
        return nearest_hit_walk(
            scene, origin, direction, ignore_tri, ignore_mesh, cull,
            tile_size=cull_tile, t_max=t_max, any_hit=any_hit,
            interpret=interpret,
        )
    raise ValueError(mode)
