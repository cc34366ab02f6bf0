"""Tiled cull + dense chunk testing over Morton clusters (accel/clusters.py).

The XLA replacement for per-ray octree descent.  Query pipeline for a
ray batch (R,):

1. **Tile summary** — rays are grouped into tiles of ``tile_size``; each tile
   is summarized by an origin AABB and a direction interval box.  Primary
   rays in raster order are naturally coherent (the reference's scanline
   locality, RayTracer.cs:391-428); secondary rays inherit the coherence of
   the surface they bounced off.
2. **Conservative cull** — one interval-arithmetic slab test per
   (tile, cluster) pair: a dense (NT, NC) array computation that yields a
   may-hit mask and a lower bound on the entry distance.  This replaces the
   reference's recursive node walk (MeshOctree.cs:328-353) with one dense op.
3. **Front-to-back chunks** — each tile sorts its candidate clusters by the
   entry bound, then all tiles walk their lists in lockstep chunks of
   ``chunk`` clusters: pre-gathered (128-triangle) Morton blocks are tested
   with one dense Möller–Trumbore + strict-min per chunk.  A tile stops when
   every ray's best hit distance is <= the next chunk's entry bound (the
   exact-correct analog of the reference's first-hit-group early stop,
   MeshOctree.cs:281-306) or its list is exhausted.

Exact nearest hit.  Tie-breaking on *exactly* equal distances follows Morton
order rather than the reference's original scan order — the only observable
deviation, and only for degenerate coincident geometry.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytpu.accel.traverse import FLOAT_MAX, Hit
from raytpu.core.intersect import moller_trumbore
from raytpu.core.math3d import dot

INF = FLOAT_MAX


def cull_clusters(o_min, o_max, d_min, d_max, cl_min, cl_max):
    """Conservative (tiles, clusters) may-hit test.

    ``o_min/o_max/d_min/d_max``: (NT, 3) tile bounds; ``cl_min/cl_max``:
    (NC, 3).  Returns (mask, entry_lower_bound) of shape (NT, NC).

    Per axis the conservative interval of t >= 0 with t*d in [s_lo, s_hi]
    for some d in [d_lo, d_hi] is computed division-free: the only divisions
    are per-tile reciprocals of the direction bounds, hoisted out of the
    (NT, NC) pair computation (the original per-pair ``div`` formulation
    compiled pathologically and ran ~10x slower).
    """
    big = INF
    t_lo = jnp.zeros(o_min.shape[:1] + cl_min.shape[:1], o_min.dtype)
    t_hi = jnp.full_like(t_lo, big)
    for k in range(3):
        d_lo = d_min[:, None, k]
        d_hi = d_max[:, None, k]
        # Per-tile scalars (broadcast along clusters): reciprocals + sign
        # flags.  The guarded where keeps 1/0 out even on dead lanes.
        inv_hi = 1.0 / jnp.where(d_hi == 0.0, 1.0, d_hi)
        inv_lo = 1.0 / jnp.where(d_lo == 0.0, 1.0, d_lo)
        hi_pos = d_hi > 0.0
        lo_pos = d_lo > 0.0
        lo_neg = d_lo < 0.0
        hi_neg = d_hi < 0.0

        s_lo = cl_min[None, :, k] - o_max[:, None, k]
        s_hi = cl_max[None, :, k] - o_min[:, None, k]
        pos = s_lo > 0.0  # cluster strictly ahead along +k
        neg = s_hi < 0.0  # strictly behind (reachable only with d < 0)

        # Entry bound (INF == infeasible: need d of the matching sign).
        lo_k = jnp.where(
            pos,
            jnp.where(hi_pos, s_lo * inv_hi, big),
            jnp.where(neg, jnp.where(lo_neg, s_hi * inv_lo, big), 0.0),
        )
        # Exit bound: finite only when the whole d interval is one-signed.
        hi_same = jnp.where(lo_pos, s_hi * inv_lo,
                            jnp.where(hi_neg, s_lo * inv_hi, big))
        hi_k = jnp.where(pos, jnp.where(lo_pos, s_hi * inv_lo, big),
                         jnp.where(neg, jnp.where(hi_neg, s_lo * inv_hi, big),
                                   hi_same))
        t_lo = jnp.maximum(t_lo, lo_k)
        t_hi = jnp.minimum(t_hi, hi_k)
    mask = (t_lo <= t_hi) & (t_lo < big)
    return mask, jnp.where(mask, t_lo, INF)


def _pad_to_tiles(a, tile, fill):
    n = a.shape[0]
    pad = (-n) % tile
    if pad:
        filler = jnp.full((pad,) + a.shape[1:], fill, a.dtype)
        a = jnp.concatenate([a, filler])
    return a


def prepare_tiles(scene, origin, direction, ignore_tri, ignore_mesh, t_max,
                  tile_size: int):
    """Shared front half of TILED and the walk kernel: pad the ray batch to
    tiles, compute per-tile bounds, and cull clusters.

    Returns ``(o, d, itri, imesh, tmax)`` reshaped to (NT, TS[, 3]) and the
    ``(mask, entry)`` result of :func:`cull_clusters` (entry == INF outside
    the mask and beyond the tile's t_max).
    """
    cl = scene.clusters
    r = origin.shape[0]
    if ignore_tri is None:
        ignore_tri = jnp.full((r,), -1, jnp.int32)
    if ignore_mesh is None:
        ignore_mesh = jnp.full((r,), -1, jnp.int32)
    if t_max is None:
        t_max = jnp.full((r,), INF, origin.dtype)

    # A batch smaller than one tile pads up to the next power of two (the
    # walk kernel's blocks are powers of two).
    ts = min(tile_size, 1 << max(0, (r - 1).bit_length()))
    o = _pad_to_tiles(origin, ts, 0.0)
    d = _pad_to_tiles(direction, ts, 1.0)
    itri = _pad_to_tiles(ignore_tri, ts, -1)
    imesh = _pad_to_tiles(ignore_mesh, ts, -1)
    tmax = _pad_to_tiles(t_max, ts, 0.0).reshape(-1, ts)
    nt = o.shape[0] // ts
    o = o.reshape(nt, ts, 3)
    d = d.reshape(nt, ts, 3)
    itri = itri.reshape(nt, ts)
    imesh = imesh.reshape(nt, ts)

    # Rays with non-finite components (the reference's TIR refraction rays)
    # never hit; exclude them from the tile bounds so they don't poison them.
    finite = jnp.all(jnp.isfinite(o), -1) & jnp.all(jnp.isfinite(d), -1)
    fo = jnp.where(finite[..., None], o, 0.0)
    fd = jnp.where(finite[..., None], d, 0.0)
    big = jnp.where(finite[..., None], 0.0, INF)
    o_min = jnp.min(fo + big, axis=1)
    o_max = jnp.max(fo - big, axis=1)
    d_min = jnp.min(fd + big, axis=1)
    d_max = jnp.max(fd - big, axis=1)
    any_finite = jnp.any(finite, axis=1)
    o_min = jnp.where(any_finite[:, None], o_min, 0.0)
    o_max = jnp.where(any_finite[:, None], o_max, 0.0)
    d_min = jnp.where(any_finite[:, None], d_min, 1.0)
    d_max = jnp.where(any_finite[:, None], d_max, 1.0)

    # Per-ray search bound from the scene's root AABB: every triangle lies
    # inside it, so any hit satisfies t < exit-of-root (with margin for f32
    # slab error).  Sky rays miss the root box entirely (t_max -> 0, they
    # settle immediately instead of scanning the whole candidate list to
    # prove a miss); surface rays stop at the backdrop instead of infinity.
    if "root_min" in cl:
        diag = jnp.max(cl["root_max"] - cl["root_min"])
        margin = 1e-3 * diag + 1e-4
        safe_d = jnp.where(d == 0.0, 1e-30, d)
        t1 = (cl["root_min"] - margin - o) / safe_d
        t2 = (cl["root_max"] + margin - o) / safe_d
        t_en = jnp.max(jnp.minimum(t1, t2), axis=-1)
        t_ex = jnp.min(jnp.maximum(t1, t2), axis=-1)
        root_hit = (t_en <= t_ex) & (t_ex >= 0.0)
        cap = jnp.where(root_hit, t_ex * (1.0 + 1e-5) + margin, 0.0)
        cap = jnp.where(jnp.isfinite(cap), cap, 0.0)
        tmax = jnp.minimum(tmax, cap)

    mask, entry = cull_clusters(
        o_min, o_max, d_min, d_max, cl["cluster_min"], cl["cluster_max"]
    )
    # Clusters entirely beyond every ray's bound can never matter.
    tile_tmax = jnp.max(tmax, axis=1)
    mask &= entry < tile_tmax[:, None]
    entry = jnp.where(mask, entry, INF)
    return (o, d, itri, imesh, tmax), (mask, entry)


def lockstep_chunks(cl, o, d, itri, imesh, cand, keys, counts, chunk: int,
                    cull: bool, init, start=0, any_hit: bool = False,
                    tmax0=None):
    """Lockstep front-to-back chunk scan over sorted candidates.

    All tiles advance together; a tile's lanes stop updating once it is done
    (exhausted candidates or settled: every ray's best <= next entry bound).
    ``init`` is the (done, best_t, best_u, best_v, best_tri) starting state —
    ``start`` lets a caller resume mid-scan from a previous partial result.

    ``any_hit`` (occlusion queries): a tile settles once every ray either
    found *some* hit inside its bound ``tmax0`` or is provably clear (next
    entry bound beyond its ``tmax0``) — the reported hit may not be the
    nearest, but the hit/no-hit boolean is exact.
    """
    nt, ts = o.shape[:2]
    nc = cand.shape[1]
    csize = cl["tri_v1"].shape[0] // cl["cluster_min"].shape[0]
    max_chunks = -(-nc // chunk)
    cc = chunk * csize  # triangles per chunk

    def body(state):
        i, done, best_t, best_u, best_v, best_tri = state
        cid = jax.lax.dynamic_slice_in_dim(cand, i * chunk, chunk, axis=1)
        slot = (cid[:, :, None] * csize
                + jnp.arange(csize, dtype=jnp.int32)).reshape(nt, cc)
        v1 = cl["tri_v1"][slot]
        e1 = cl["tri_e1"][slot]
        e2 = cl["tri_e2"][slot]
        tid = cl["tri_id"][slot]
        tmesh = cl["tri_mesh"][slot]

        ok, u, v, dist = moller_trumbore(
            o[:, :, None, :], d[:, :, None, :],
            v1[:, None], e1[:, None], e2[:, None],
        )
        if cull:
            from raytpu.core.intersect import facing_gate

            sn = cl["tri_snormal"][slot]
            ok &= facing_gate(sn[:, None], d[:, :, None, :], cull)
        ok &= tid[:, None, :] >= 0
        ok &= tid[:, None, :] != itri[:, :, None]
        ok &= tmesh[:, None, :] != imesh[:, :, None]
        ok &= ~done[:, None, None]
        dist = jnp.where(ok, dist, INF)
        j = jnp.argmin(dist, axis=2)
        t_c = jnp.take_along_axis(dist, j[..., None], axis=2)[..., 0]
        upd = t_c < best_t
        best_t = jnp.where(upd, t_c, best_t)
        best_u = jnp.where(
            upd, jnp.take_along_axis(u, j[..., None], axis=2)[..., 0], best_u
        )
        best_v = jnp.where(
            upd, jnp.take_along_axis(v, j[..., None], axis=2)[..., 0], best_v
        )
        best_tri = jnp.where(
            upd, jnp.take_along_axis(tid[:, None, :].repeat(ts, 1),
                                     j[..., None], axis=2)[..., 0], best_tri
        )

        nxt = i + 1
        exhausted = (nxt * chunk) >= counts
        next_entry = jnp.where(
            nxt * chunk < nc,
            jax.lax.dynamic_slice_in_dim(
                keys, jnp.minimum(nxt * chunk, nc - 1), 1, axis=1
            )[:, 0],
            INF,
        )
        if any_hit:
            resolved = (best_t < tmax0) | (tmax0 <= next_entry[:, None])
            settled = jnp.all(resolved, axis=1)
        else:
            settled = jnp.all(best_t <= next_entry[:, None], axis=1)
        done = done | exhausted | settled
        return nxt, done, best_t, best_u, best_v, best_tri

    def cond(state):
        i, done = state[0], state[1]
        return (i < max_chunks) & jnp.any(~done)

    state0 = (jnp.int32(start),) + tuple(init)
    _, _, bt, bu, bv, btri = jax.lax.while_loop(cond, body, state0)
    return bt, bu, bv, btri


def nearest_hit_tiled(scene, origin, direction, ignore_tri=None,
                      ignore_mesh=None, cull: bool = True,
                      tile_size: int = 1024, chunk: int = 1,
                      t_max=None, any_hit: bool = False) -> Hit:
    """Exact nearest hit via tiled cull + front-to-back dense chunks.

    ``t_max`` (per-ray, optional) bounds the search: hits at ``t >= t_max``
    are never reported and — critically — a tile stops scanning once the
    next chunk's entry bound exceeds every ray's bound.  Shadow queries pass
    the light distance so unoccluded rays terminate at the light instead of
    scanning their whole candidate list to prove a miss
    (IsLightPathObstructed's early-out analog, RayTracer.cs:465-502).
    """
    cl = scene.clusters
    nc = cl["cluster_min"].shape[0]

    r = origin.shape[0]
    (o, d, itri, imesh, tmax), (mask, entry) = prepare_tiles(
        scene, origin, direction, ignore_tri, ignore_mesh, t_max, tile_size
    )
    nt, ts = o.shape[:2]
    rp = nt * ts

    # Per-tile front-to-back candidate order.
    keys, cand = jax.lax.sort_key_val(
        entry, jnp.broadcast_to(jnp.arange(nc, dtype=jnp.int32), entry.shape)
    )
    counts = jnp.sum(mask, axis=1)  # (NT,)

    # Derive from ``o`` (not a fresh constant) so the scan carries inherit
    # the device-varying manual axes under shard_map — a constant init
    # trips the while_loop vma check when this runs sharded (diff/fit.py).
    # zeros_like (not o*0.0): a non-finite origin would make o*0.0 NaN and
    # NaN.astype(int32) is backend-defined (INT_MIN wraps izero-1 to a huge
    # positive btri => phantom hit); zeros_like keeps the manual-axes aval
    # while staying exactly 0 for every lane.
    zero = jnp.zeros_like(o[..., 0])
    izero = zero.astype(jnp.int32)
    init = (
        counts == 0,
        zero + tmax,  # best_t starts at the per-ray bound
        zero,
        zero,
        izero - 1,
    )
    bt, bu, bv, btri = lockstep_chunks(
        cl, o, d, itri, imesh, cand, keys, counts, chunk, cull, init,
        any_hit=any_hit, tmax0=tmax,
    )
    flat = lambda a: a.reshape(rp)[:r]
    btri = flat(btri)
    hit = btri >= 0
    t = jnp.where(hit, flat(bt), INF)  # misses report INF, not t_max
    return Hit(hit=hit, t=t, u=flat(bu), v=flat(bv), tri=btri)
