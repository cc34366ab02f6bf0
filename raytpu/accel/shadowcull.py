"""Per-(cluster, light) shadow clearance — cheap shadows in the lit case.

Why: the shadow query can cost more than the primary query even after the
from-the-light reversal, because occlusion on open scenes is mostly ZERO — every shadow ray must *prove clear* by walking every feasible
cluster inside its segment (IsLightPathObstructed semantics,
RayTracer.cs:465-502, where the early-out never fires).

This module precomputes, per cluster ``b`` and positionable light
``L``, a **clearance distance**

    D(b) = min over blocks b' != b that intersect the cone
           hull(L, AABB_b) of  dist(L, AABB_b')        (INF if none)

with a conservative per-axis interval test (the same case analysis as the
kernel's beam cull, accel/tiled.py::cull_clusters).  Soundness: every
possible occluder point x on a segment [L, p], p in block b, lies either

  * in b itself      => |x - L| >= entry of b's own AABB along the ray, or
  * in some b' != b  => b' intersects the cone and |x - L| >= dist(L, b')
                        >= D(b).

So every occluder satisfies |x - L| >= t_min := min(D(b), own-AABB entry),
and the reversed shadow query may START at ``L + t_min * dir`` with the
bound shortened by t_min — EXACT, no kernel change.  On a lit open scene
D(b) collapses the searched segment to the fragment's own neighborhood:
the tile-level cull then prunes every cluster between the light and the
terrain, and the walk touches only the clusters the segment ends in.

For DIRECTIONAL lights the analog sweeps a cylinder along the shared
direction and yields a per-block first-occluder distance D'(b) measured
from the fragment; when D'(b) is infinite the fragment-side query's t_max
shrinks to its own block's AABB exit (suffix emptiness — the only sound
cap in that parametrization).

Everything here runs IN-GRAPH per frame (one (NCB, NCB) interval sweep,
~60M lane-ops at the bench's 7.8k blocks), so moving lights or refitted
geometry can never use a stale table.

**When it pays**: only where most shadow rays have a provably clear far
field.  On hilly open terrain a cluster-level cone from an elevated light
sweeps over many other hills that never occlude the actual rays, so
D(b) < own-entry almost everywhere; the few shifted rays then scatter
across cull tiles, their mixed origins widen the tile origin boxes, and
the per-ray cluster-id/AABB gathers add cost of their own.  The technique
is exact and stays available (cfg.shadow_clearance, off by default) for
sparse scenes — isolated occluders over open floor — where the clear
fraction approaches 1 and tiles shift coherently.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

INF = 3.4028235e38


def _block_aabbs(cl):
    """(NCB, 3) per-cluster AABB min/max from the bake."""
    return cl["cluster_min"], cl["cluster_max"]


def _interval_t(b_lo, b_hi, c_lo, c_hi):
    """Conservative [t_lo, t_hi] of { t >= 0 : t*[b_lo,b_hi] ∩ [c_lo,c_hi] }.

    One axis of the cone test; the same case analysis as the cull's slab
    step (accel/tiled.py::cull_clusters) with the block interval playing
    the direction range."""
    f32 = jnp.float32
    inv_hi = 1.0 / jnp.where(b_hi == 0.0, f32(1.0), b_hi)
    inv_lo = 1.0 / jnp.where(b_lo == 0.0, f32(1.0), b_lo)
    hi_pos = b_hi > 0.0
    lo_pos = b_lo > 0.0
    lo_neg = b_lo < 0.0
    hi_neg = b_hi < 0.0
    pos = c_lo > 0.0
    neg = c_hi < 0.0
    t_lo = jnp.where(
        pos,
        jnp.where(hi_pos, c_lo * inv_hi, INF),
        jnp.where(neg, jnp.where(lo_neg, c_hi * inv_lo, INF), f32(0.0)),
    )
    hi_same = jnp.where(lo_pos, c_hi * inv_lo,
                        jnp.where(hi_neg, c_lo * inv_hi, INF))
    t_hi = jnp.where(pos, jnp.where(lo_pos, c_hi * inv_lo, INF),
                     jnp.where(neg,
                               jnp.where(hi_neg, c_lo * inv_hi, INF),
                               hi_same))
    return t_lo, t_hi


def clearance_spot(cl, light_pos, rows_per_chunk: int = 256):
    """(NCB,) clearance distances D(b) for a positionable light.

    ``D[b]`` lower-bounds the distance from ``light_pos`` of ANY geometry
    point outside block ``b`` that can lie on a segment from the light to
    a point of ``b`` (module docstring).  INF where no other block can
    occlude at all."""
    mn, mx = _block_aabbs(cl)
    ncb = mn.shape[0]
    lp = jnp.asarray(light_pos, jnp.float32)
    b_lo = mn - lp  # (NCB, 3) block intervals relative to the light
    b_hi = mx - lp
    # Distance from the light to each candidate occluder block.
    near = jnp.clip(lp, mn, mx)
    d_near = jnp.linalg.norm(near - lp, axis=-1)  # (NCB,)
    idx = jnp.arange(ncb)

    rows_c = min(rows_per_chunk, ncb)

    def chunk(lo_rows):
        bl = jax.lax.dynamic_slice_in_dim(b_lo, lo_rows, rows_c)
        bh = jax.lax.dynamic_slice_in_dim(b_hi, lo_rows, rows_c)
        row_ids = lo_rows + jnp.arange(rows_c)
        t_lo = jnp.zeros((rows_c, ncb), jnp.float32)
        t_hi = jnp.full((rows_c, ncb), INF, jnp.float32)
        for k in range(3):
            lo_k, hi_k = _interval_t(
                bl[:, k:k + 1], bh[:, k:k + 1],
                b_lo[None, :, k], b_hi[None, :, k])
            t_lo = jnp.maximum(t_lo, lo_k)
            t_hi = jnp.minimum(t_hi, hi_k)
        # Segment: some t in (0, 1] must work; exclude self.
        feasible = (t_lo <= t_hi) & (t_lo <= 1.0)
        feasible &= row_ids[:, None] != idx[None, :]
        d = jnp.where(feasible, d_near[None, :], INF)
        return jnp.min(d, axis=1)

    return _chunked_rows(chunk, ncb, rows_per_chunk)


def _chunked_rows(chunk, ncb, rows):
    """Assemble a (NCB,) result from overlapping row windows.

    The last window is shifted back to stay in bounds; overlapping rows
    recompute identical values, so the scatter assembly is exact."""
    rows = min(rows, ncb)
    nst = -(-ncb // rows)
    starts = jnp.minimum(jnp.arange(nst) * rows, ncb - rows)
    out = jax.lax.map(chunk, starts)  # (nst, rows)
    idxs = (starts[:, None] + jnp.arange(rows)[None, :]).reshape(-1)
    return jnp.zeros((ncb,), out.dtype).at[idxs].set(out.reshape(-1))


def clearance_directional(cl, direction_to_light, rows_per_chunk: int = 256):
    """(NCB,) first-occluder distances D'(b) along a shared direction.

    Fragment-side parametrization x = p + s*dl (p in block b, s > 0):
    D'[b] lower-bounds s for any geometry outside b — INF means nothing
    above the block toward the light, so the shadow search may stop at
    the block's own AABB exit."""
    mn, mx = _block_aabbs(cl)
    ncb = mn.shape[0]
    dl = jnp.asarray(direction_to_light, jnp.float32)
    idx = jnp.arange(ncb)

    rows_c = min(rows_per_chunk, ncb)

    def chunk(lo_rows):
        bmn = jax.lax.dynamic_slice_in_dim(mn, lo_rows, rows_c)
        bmx = jax.lax.dynamic_slice_in_dim(mx, lo_rows, rows_c)
        row_ids = lo_rows + jnp.arange(rows_c)
        s_lo = jnp.zeros((rows_c, ncb), jnp.float32)
        s_hi = jnp.full((rows_c, ncb), INF, jnp.float32)
        for k in range(3):
            lo_k = mn[None, :, k] - bmx[:, k:k + 1]  # s*dl_k in [lo, hi]
            hi_k = mx[None, :, k] - bmn[:, k:k + 1]
            dk = dl[k]
            big_pos = jnp.where(dk > 0.0, lo_k / jnp.where(dk == 0, 1, dk),
                                jnp.where(dk < 0.0,
                                          hi_k / jnp.where(dk == 0, 1, dk),
                                          jnp.where((lo_k <= 0.0)
                                                    & (hi_k >= 0.0),
                                                    0.0, INF)))
            small = jnp.where(dk > 0.0, hi_k / jnp.where(dk == 0, 1, dk),
                              jnp.where(dk < 0.0,
                                        lo_k / jnp.where(dk == 0, 1, dk),
                                        jnp.where((lo_k <= 0.0)
                                                  & (hi_k >= 0.0),
                                                  INF, -INF)))
            s_lo = jnp.maximum(s_lo, big_pos)
            s_hi = jnp.minimum(s_hi, small)
        feasible = (s_lo <= s_hi) & (s_hi > 0.0)
        feasible &= row_ids[:, None] != idx[None, :]
        d = jnp.where(feasible, jnp.maximum(s_lo, 0.0), INF)
        return jnp.min(d, axis=1)

    return _chunked_rows(chunk, ncb, rows_per_chunk)


def own_block_entry_exit(cl, tri_block, hit_tri, origin, direction):
    """Per-ray slab entry/exit of the ray against its OWN block's AABB.

    ``hit_tri``: original winner triangle ids (< 0 for misses — clamped;
    callers mask).  Returns (block_id, t_entry, t_exit)."""
    mn, mx = _block_aabbs(cl)
    b_id = tri_block[jnp.clip(hit_tri, 0, tri_block.shape[0] - 1)]
    bmn = mn[b_id]  # (R, 3)
    bmx = mx[b_id]
    t_en = jnp.full(origin.shape[:-1], -INF, jnp.float32)
    t_ex = jnp.full(origin.shape[:-1], INF, jnp.float32)
    for k in range(3):
        d = direction[..., k]
        safe = jnp.where(d == 0.0, 1e-30, d)
        t1 = (bmn[..., k] - origin[..., k]) / safe
        t2 = (bmx[..., k] - origin[..., k]) / safe
        t_en = jnp.maximum(t_en, jnp.minimum(t1, t2))
        t_ex = jnp.minimum(t_ex, jnp.maximum(t1, t2))
    return b_id, t_en, t_ex
