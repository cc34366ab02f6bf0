"""Front-to-back cluster walk: one Pallas kernel through Triton.

The exact nearest hit of accel/tiled.py with the lockstep chunk scan
replaced by a kernel in which every ray tile walks on its own:

1. **Front half (XLA).**  ``prepare_tiles`` summarises each cull tile of
   ``tile_size`` rays and culls every (tile, cluster) pair; one
   ``sort_key_val`` orders each tile's candidate clusters by entry bound —
   exactly TILED's front half.
2. **Walk (this kernel).**  One program per walk tile of ``walk_tile`` rays
   (a power of two dividing the cull tile; the walk tiles of one cull tile
   share its candidate list, which is conservative for each of them).  A
   program walks the list in a ``while_loop``: per trip it loads one
   cluster's triangle rows straight from device memory into registers, runs
   Möller–Trumbore (core/intersect.moller_trumbore_xyz, the XLA backends'
   formula) on the (walk_tile, cluster) pairs and keeps a strict-min best.
   It stops on its own settle test — every ray's best is no farther than the
   next candidate's entry bound (for ``any_hit``: every ray has a hit inside
   its bound or is provably clear) — or when its list is exhausted.

Unlike TILED, a tile that settles stops at once instead of riding along
until the slowest tile of the batch is done, and no (tiles, rays,
triangles) intermediate ever reaches device memory.  The settle tests and
tie-breaking (first in cluster order, then first in slot order) are TILED's,
so the two return the same hits — up to ties: where a ray passes through the
edge two triangles share, their distances agree to an ulp, and the kernel's
rounding (its own order of each dot product's sum) may pick the other one.

The kernel compiles for the GPU only; ``interpret=True`` runs it in the
Pallas interpreter, which is how the CPU tests reach it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from raytpu.accel.tiled import prepare_tiles
from raytpu.accel.traverse import Hit
from raytpu.core.intersect import facing_gate, moller_trumbore_xyz

#: A Python float, so the kernel captures no array constant.
INF = 3.4028235e38

#: Rays per kernel program (walk tile), chosen on an H100 at the bench size
#: (1M triangles, 1024^2 primary + shadow, cull tile 256; PERF.md).
WALK_TILE = 4


def _num_warps(walk_tile: int) -> int:
    """One warp per 4 rays: a program holds walk_tile x cluster pairs in
    registers, and fewer threads for a wider tile fail to compile."""
    return max(1, walk_tile // 4)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _walk_kernel(counts_ref, cand_ref, keys_ref, geo_ref, tid_ref, tmesh_ref,
                 ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tmax_ref,
                 itri_ref, imesh_ref,
                 t_ref, u_ref, v_ref, tri_ref, *,
                 csize: int, cpad: int, per_tile: int, cull, any_hit: bool,
                 has_ignore: bool):
    tile = pl.program_id(0) // per_tile
    ncand = counts_ref[tile]
    o = (ox_ref[...][:, None], oy_ref[...][:, None], oz_ref[...][:, None])
    d = (dx_ref[...][:, None], dy_ref[...][:, None], dz_ref[...][:, None])
    tmax = tmax_ref[...]
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, cpad), 1)
    if has_ignore:
        itri = itri_ref[...][:, None]
        imesh = imesh_ref[...][:, None]

    def settled(best_t, j):
        last = cand_ref.shape[1] - 1
        next_entry = jnp.where(j < ncand,
                               keys_ref[tile, jnp.minimum(j, last)], INF)
        if any_hit:
            ok = (best_t < tmax) | (tmax <= next_entry)
        else:
            ok = best_t <= next_entry
        return jnp.min(jnp.where(ok, 1, 0)) == 1

    def cond(state):
        j, done = state[0], state[1]
        return (j < ncand) & jnp.logical_not(done)

    def body(state):
        j, _, best_t, best_u, best_v, best_tri = state
        base = cand_ref[tile, j] * csize
        row = lambda k: geo_ref[k, pl.ds(base, cpad)][None, :]
        v1 = (row(0), row(1), row(2))
        e1 = (row(3), row(4), row(5))
        e2 = (row(6), row(7), row(8))
        tid = tid_ref[pl.ds(base, cpad)][None, :]
        ok, u, v, dist = moller_trumbore_xyz(o, d, v1, e1, e2)
        if cull:
            ok &= facing_gate((row(9), row(10), row(11)), d, cull)
        ok &= tid >= 0
        if cpad != csize:
            ok &= lane < csize
        if has_ignore:
            tmesh = tmesh_ref[pl.ds(base, cpad)][None, :]
            ok &= (tid != itri) & (tmesh != imesh)
        dist = jnp.where(ok, dist, INF)
        k = jnp.argmin(dist, axis=1)
        t_c = jnp.min(dist, axis=1)
        win = lane == k[:, None]
        upd = t_c < best_t
        best_t = jnp.where(upd, t_c, best_t)
        best_u = jnp.where(upd, jnp.sum(jnp.where(win, u, 0.0), axis=1),
                           best_u)
        best_v = jnp.where(upd, jnp.sum(jnp.where(win, v, 0.0), axis=1),
                           best_v)
        best_tri = jnp.where(upd, jnp.sum(jnp.where(win, tid, 0), axis=1),
                             best_tri)
        j = j + 1
        return j, settled(best_t, j), best_t, best_u, best_v, best_tri

    zero = jnp.zeros_like(tmax)
    state = (jnp.int32(0), settled(tmax, 0), tmax, zero, zero,
             jnp.full(tmax.shape, -1, jnp.int32))
    _, _, best_t, best_u, best_v, best_tri = jax.lax.while_loop(
        cond, body, state)
    t_ref[...] = best_t
    u_ref[...] = best_u
    v_ref[...] = best_v
    tri_ref[...] = best_tri


def walk_tiles(geo, tri_id, tri_mesh, cand, keys, counts, rays, *,
               csize: int, walk_tile: int, cull, any_hit: bool,
               has_ignore: bool, interpret: bool = False):
    """Run the walk kernel.

    ``geo``: (12, Tp) f32 triangle rows (v1, e1, e2, snormal; x, y, z
    each) in cluster slot order; ``tri_id``/``tri_mesh``: (Tp,) i32.
    ``cand``/``keys``: (NT, NC) sorted candidates and entry bounds of each
    cull tile; ``counts``: (NT,) candidates per tile.  ``rays``: nine
    (NT * TS,) arrays ``ox oy oz dx dy dz tmax itri imesh``.  Returns
    (best_t, u, v, tri) per ray; ``tri`` is -1 where nothing was hit.
    """
    nt = counts.shape[0]
    rp = rays[0].shape[0]
    per_tile = rp // nt // walk_tile
    cpad = _next_pow2(csize)
    if cpad != csize:
        # The last cluster's load runs cpad - csize slots past the table;
        # pad it so those lanes read (masked) zeros.
        extra = cpad - csize
        geo = jnp.pad(geo, ((0, 0), (0, extra)))
        tri_id = jnp.pad(tri_id, (0, extra), constant_values=-1)
        tri_mesh = jnp.pad(tri_mesh, (0, extra), constant_values=-1)
    kernel = functools.partial(
        _walk_kernel, csize=csize, cpad=cpad, per_tile=per_tile, cull=cull,
        any_hit=any_hit, has_ignore=has_ignore)
    whole = pl.no_block_spec
    ray_spec = pl.BlockSpec((walk_tile,), lambda p: (p,))
    inputs = (counts, cand, keys, geo, tri_id, tri_mesh, *rays)
    out_shape = ([jax.ShapeDtypeStruct((rp,), jnp.float32)] * 3
                 + [jax.ShapeDtypeStruct((rp,), jnp.int32)])
    return pl.pallas_call(
        kernel,
        grid=(rp // walk_tile,),
        in_specs=[whole] * 6 + [ray_spec] * 9,
        out_specs=[ray_spec] * 4,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_num_warps(walk_tile)),
        interpret=interpret,
        name="nearest_walk",
    )(*inputs)


def front_half(scene, origin, direction, ignore_tri=None, ignore_mesh=None,
               t_max=None, tile_size: int = 256):
    """TILED's front half in XLA: pad the rays to cull tiles of a power of
    two, cull every (tile, cluster) pair and sort each tile's candidates by
    entry bound.  Returns ``(cand, keys, counts, rays)`` as ``walk_tiles``
    takes them."""
    nc = scene.clusters["cluster_min"].shape[0]
    (o, d, itri, imesh, tmax), (mask, entry) = prepare_tiles(
        scene, origin, direction, ignore_tri, ignore_mesh, t_max,
        _next_pow2(max(tile_size, 1)))
    nt, ts = o.shape[:2]
    keys, cand = jax.lax.sort_key_val(
        entry, jnp.broadcast_to(jnp.arange(nc, dtype=jnp.int32), entry.shape))
    counts = jnp.sum(mask, axis=1, dtype=jnp.int32)
    flat = lambda a: a.reshape(nt * ts)
    rays = ([flat(o[..., k]) for k in range(3)]
            + [flat(d[..., k]) for k in range(3)]
            + [flat(tmax), flat(itri), flat(imesh)])
    return cand, keys, counts, rays


def nearest_hit_walk(scene, origin, direction, ignore_tri=None,
                     ignore_mesh=None, cull=True, tile_size: int = 256,
                     walk_tile: int = WALK_TILE, t_max=None,
                     any_hit: bool = False, interpret: bool = False) -> Hit:
    """Exact nearest hit: TILED's front half, then the walk kernel.

    Same arguments and result as ``accel.tiled.nearest_hit_tiled``.  The
    cull tile (``tile_size``) is rounded up to a power of two; ``walk_tile``
    is clamped to the cull tile.
    """
    cl = scene.clusters
    csize = cl["tri_v1"].shape[0] // cl["cluster_min"].shape[0]
    r = origin.shape[0]
    cand, keys, counts, rays = front_half(
        scene, origin, direction, ignore_tri, ignore_mesh, t_max, tile_size)
    ts = rays[0].shape[0] // counts.shape[0]
    geo = jnp.concatenate(
        [cl["tri_v1"], cl["tri_e1"], cl["tri_e2"], cl["tri_snormal"]],
        axis=1).T
    bt, bu, bv, btri = walk_tiles(
        geo, cl["tri_id"], cl["tri_mesh"], cand, keys, counts, rays,
        csize=csize, walk_tile=min(_next_pow2(walk_tile), ts), cull=cull,
        any_hit=any_hit,
        has_ignore=ignore_tri is not None or ignore_mesh is not None,
        interpret=interpret)
    btri = btri[:r]
    hit = btri >= 0
    return Hit(hit=hit, t=jnp.where(hit, bt[:r], INF), u=bu[:r], v=bv[:r],
               tri=btri)
