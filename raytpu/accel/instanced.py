"""Two-level instanced intersection — the reference's scene-octree design.

The reference's scene level (OctreeSpatialManager.cs:312-482) keeps ONE
copy of each mesh and intersects instances by transforming the ray into
each candidate object's space via ``InverseWorld`` — the two-point method:
transform origin and origin+dir as points, re-subtract, normalize
(OctreeSpatialManager.cs:349-364, whose comment notes the naive direction
transform is wrong under non-uniform scale) — then compares WORLD distances
of the per-object hits (OctreeSpatialManager.cs:438-452).

The default raytpu path deliberately bakes instances into one world-space
triangle soup (scene/flatten.py): one flat cluster table, zero per-ray
transforms, the best shape for the walk kernel.  This module is the
two-level alternative for scenes where N instances of a large mesh would
blow up memory N-fold: per unique mesh one FlatScene bake, per instance a
world/inverse pair; rays are transformed per instance, intersected against
the shared bake, and merged by world-space distance — exactly the
reference's semantics, vectorized over the ray batch.

Scene-level pruning (the OctreeSpatialManager.cs:457-482 analog): before
each instance's pass, every ray runs a slab test against the instance's
conservative WORLD AABB (the transformed object-bounds corners), bounded by
its current best world distance.  Rays that provably cannot hit the
instance closer than their running best enter the pass as dead lanes (NaN
direction), which every backend excludes from its cull-tile bounds — tiles
whose rays are all dead settle in zero walk trips, so rays aimed at one
instance do not pay for the other N-1 beyond a per-tile prologue.
Use for few instances of heavy meshes; use flatten() baking otherwise.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from raytpu.accel.traverse import Hit, nearest_hit
from raytpu.config import Intersector

INF = 3.4028235e38


class InstancedHit(NamedTuple):
    """Nearest hit over all instances, distances in WORLD space."""

    hit: jnp.ndarray       # (R,) bool
    t_world: jnp.ndarray   # (R,) world-space distance to the hit
    u: jnp.ndarray         # (R,) barycentric u (object space — invariant)
    v: jnp.ndarray         # (R,)
    tri: jnp.ndarray       # (R,) triangle id within the winning mesh bake
    instance: jnp.ndarray  # (R,) winning instance index (-1 on miss)


class Instance(NamedTuple):
    mesh_index: int        # index into the shared mesh bakes
    world: np.ndarray      # (4, 4) row-vector convention (p @ W)
    inv_world: np.ndarray  # (4, 4)


def make_instance(mesh_index: int, world: np.ndarray) -> Instance:
    world = np.asarray(world, np.float32)
    return Instance(mesh_index, world, np.linalg.inv(world).astype(np.float32))


def _transform_points(p, m):
    from raytpu.core.xna import mm

    return mm(p, m[:3, :3]) + m[3, :3]


def instance_world_aabb(bake, world) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Conservative world-space AABB of a mesh bake under ``world``.

    Transforms the 8 corners of the object-space bounds (from the cluster
    table when present, else the triangle vertices) and takes min/max —
    the standard conservative box of a transformed box."""
    if getattr(bake, "clusters", None) is not None:
        mn = bake.clusters["root_min"]
        mx = bake.clusters["root_max"]
    else:
        vs = jnp.concatenate([
            bake.tri_v1,
            bake.tri_v1 + bake.tri_e1,
            bake.tri_v1 + bake.tri_e2,
        ])
        mn = jnp.min(vs, axis=0)
        mx = jnp.max(vs, axis=0)
    corners = jnp.stack([
        jnp.where(jnp.asarray([(i >> k) & 1 for k in range(3)], bool), mx, mn)
        for i in range(8)
    ])
    cw = _transform_points(corners, jnp.asarray(world))
    return jnp.min(cw, axis=0), jnp.max(cw, axis=0)


def _prune_mask(origin, direction, mn, mx, cap):
    """Rays that could still hit inside [mn, mx] closer than ``cap``.

    Conservative slab test with a relative margin; misses and rays whose
    entry distance already exceeds their running best are pruned exactly
    (the AABB contains the instance, so no closer hit exists inside)."""
    margin = 1e-4 * jnp.max(mx - mn) + 1e-5
    t_en = jnp.full(origin.shape[:1], -INF, jnp.float32)
    t_ex = jnp.full(origin.shape[:1], INF, jnp.float32)
    for k in range(3):
        d = direction[:, k]
        safe_d = jnp.where(d == 0.0, 1e-30, d)
        t1 = (mn[k] - margin - origin[:, k]) / safe_d
        t2 = (mx[k] + margin - origin[:, k]) / safe_d
        t_en = jnp.maximum(t_en, jnp.minimum(t1, t2))
        t_ex = jnp.minimum(t_ex, jnp.maximum(t1, t2))
    return (t_en <= t_ex) & (t_ex >= 0.0) & (t_en < cap)


def order_front_to_back(instances: List[Instance], mesh_bakes: List,
                        eye) -> List[int]:
    """Instance indices ordered by world-AABB distance from ``eye``.

    Host-side (static) — the instance-hierarchy role of the reference's
    sorted scene-octree walk (OctreeSpatialManager.cs:457-482): passing
    near instances first tightens every ray's running best early, so the
    per-instance world-AABB prune (and the lax.cond pass skip) eliminates
    far instances instead of testing them."""
    eye = np.asarray(eye, np.float32)
    d = []
    for inst in instances:
        mn, mx = instance_world_aabb(mesh_bakes[inst.mesh_index],
                                     inst.world)
        mn, mx = np.asarray(mn), np.asarray(mx)
        nearest = np.clip(eye, mn, mx)
        d.append(float(np.linalg.norm(nearest - eye)))
    return list(np.argsort(d, kind="stable"))


def nearest_hit_instanced(mesh_bakes: List, instances: List[Instance],
                          origin, direction, t_max=None,
                          ignore_tri=None, ignore_instance=None,
                          intersector: Intersector = Intersector.AUTO,
                          prune: bool = True, return_stats: bool = False,
                          skip_empty: bool = True, order=None,
                          **kw) -> InstancedHit:
    """Nearest hit of ``origin``/``direction`` (R, 3, world space) over all
    instances, merged by world distance.

    ``mesh_bakes``: per unique mesh, a FlatScene from flattening that mesh
    alone in OBJECT space (``scene/flatten.py`` with an identity
    SceneObject).  The instance loop is unrolled at trace time — one
    intersector pass per instance, the analog of the scene
    octree's per-candidate-object loop (OctreeSpatialManager.cs:366-379).

    ``t_max``: (R,) WORLD-space search bound (converted per instance to
    object scale through the direction-transform norm).  ``ignore_tri``
    with ``ignore_instance``: per-ray (triangle, instance) to skip — the
    instanced form of the reference's ignoreTriangle (the same mesh's other
    instances must still test that triangle).

    ``prune``: scene-level world-AABB ray pruning (module docstring; the
    OctreeSpatialManager.cs:457-482 analog) — exact, on by default.
    ``return_stats``: also return a (num_instances,) array of live-ray
    counts per instance pass (pruning observability; used by tests).

    ``skip_empty``: wrap each instance's intersector pass in ``lax.cond``
    so a pass with ZERO live rays is skipped at runtime outright (no walk,
    no prologue) — with ``order`` (a static instance ordering, e.g.
    ``order_front_to_back(instances, bakes, camera_pos)``) the running
    best tightens on the near instances first and far passes prune to
    empty, so runtime tracks the instances a ray batch can actually see
    instead of the instance count.  Compile time stays O(instances) (the
    loop is still unrolled; each pass is traced once).
    """
    origin = jnp.asarray(origin, jnp.float32)
    direction = jnp.asarray(direction, jnp.float32)
    r = origin.shape[0]

    best = InstancedHit(
        hit=jnp.zeros((r,), bool),
        t_world=jnp.full((r,), INF, jnp.float32),
        u=jnp.zeros((r,), jnp.float32),
        v=jnp.zeros((r,), jnp.float32),
        tri=jnp.full((r,), -1, jnp.int32),
        instance=jnp.full((r,), -1, jnp.int32),
    )

    if order is not None:
        order = list(order)  # materialize: validation must not consume it
        if sorted(order) != list(range(len(instances))):
            # A partial order would silently skip instances' intersections.
            raise ValueError(
                f"order must be a permutation of range({len(instances)})")
    stats = [None] * len(instances)
    for idx in (order if order is not None else range(len(instances))):
        inst = instances[idx]
        bake = mesh_bakes[inst.mesh_index]
        inv = jnp.asarray(inst.inv_world)
        w = jnp.asarray(inst.world)

        # Two-point direction transform (OctreeSpatialManager.cs:349-364):
        # transform origin and origin+dir as points, re-subtract, normalize.
        o_obj = _transform_points(origin, inv)
        p2_obj = _transform_points(origin + direction, inv)
        d_obj = p2_obj - o_obj
        norm = jnp.linalg.norm(d_obj, axis=-1, keepdims=True)
        d_obj = d_obj / jnp.where(norm == 0, 1.0, norm)

        live = None
        if prune:
            # Scene-level pruning: rays that provably cannot beat their
            # running best inside this instance's world AABB enter the
            # pass as dead lanes (NaN direction — every backend treats
            # them as settled misses and drops them from tile bounds).
            mn_w, mx_w = instance_world_aabb(bake, inst.world)
            cap = best.t_world
            if t_max is not None:
                cap = jnp.minimum(cap, jnp.asarray(t_max, jnp.float32))
            live = _prune_mask(origin, direction, mn_w, mx_w, cap)
            d_obj = jnp.where(live[:, None], d_obj, jnp.float32(jnp.nan))
            if return_stats:
                stats[idx] = jnp.sum(live)
        elif return_stats:
            stats[idx] = jnp.asarray(r, jnp.int32)

        # World t -> object t along the normalized object direction: a world
        # step of 1 maps to |inv_world . d| object units (= norm).
        t_max_obj = None
        if t_max is not None:
            t_max_obj = jnp.asarray(t_max, jnp.float32) * norm[:, 0]
        itri = None
        if ignore_tri is not None:
            this = jnp.asarray(ignore_instance) == idx
            itri = jnp.where(this, jnp.asarray(ignore_tri, jnp.int32), -1)

        def run_pass(best_in, idx=idx, bake=bake, o_obj=o_obj, d_obj=d_obj,
                     t_max_obj=t_max_obj, itri=itri, w=w):
            h: Hit = nearest_hit(bake, o_obj, d_obj, t_max=t_max_obj,
                                 ignore_tri=itri, intersector=intersector,
                                 **kw)

            # World-space hit point and distance (OctreeSpatialManager.cs:
            # 438-452): object hit = v1 + e1*u + e2*v, transformed by World.
            safe = jnp.maximum(h.tri, 0)
            frag_obj = (bake.tri_v1[safe]
                        + bake.tri_e1[safe] * h.u[..., None]
                        + bake.tri_e2[safe] * h.v[..., None])
            frag_w = _transform_points(frag_obj, w)
            t_world = jnp.linalg.norm(frag_w - origin, axis=-1)
            t_world = jnp.where(h.hit, t_world, INF)

            upd = t_world < best_in.t_world
            return InstancedHit(
                hit=best_in.hit | (upd & h.hit),
                t_world=jnp.where(upd, t_world, best_in.t_world),
                u=jnp.where(upd, h.u, best_in.u),
                v=jnp.where(upd, h.v, best_in.v),
                tri=jnp.where(upd, h.tri, best_in.tri),
                instance=jnp.where(upd, jnp.int32(idx), best_in.instance),
            )

        if skip_empty and live is not None:
            # An all-pruned pass is skipped at RUNTIME: lax.cond executes
            # only the taken branch, so rays aimed elsewhere pay one slab
            # test + one any-reduce for this instance, not a walk.
            import jax

            best = jax.lax.cond(jnp.any(live), run_pass, lambda b: b, best)
        else:
            best = run_pass(best)
    if return_stats:
        return best, jnp.stack(stats)
    return best


def nearest_hit_instanced_scan(mesh_bakes: List, instances: List[Instance],
                               origin, direction, t_max=None,
                               ignore_tri=None, ignore_instance=None,
                               intersector: Intersector = Intersector.AUTO,
                               prune: bool = True,
                               return_stats: bool = False,
                               **kw):
    """``nearest_hit_instanced`` with ONE compiled pass per unique mesh.

    The unrolled loop compiles O(instances) intersector passes — fine at
    the reference's ~5 objects, hostile at 64+.  The instance
    hierarchy is NOT a pointer octree over bodies (OctreeSpatialManager.cs
    :35-99 — per-ray divergent node walks are the shape the cluster
    redesign removed): instances sharing a mesh bake run under ONE
    ``lax.scan`` whose step gathers that instance's transform/AABB by
    index, so the traced program size is O(unique meshes) and the
    per-step work for a pruned-empty instance is one slab test + a
    skipped ``lax.cond`` branch — sub-linear RUNTIME in the instance
    count for any ray batch that sees a few instances, with compile time
    independent of it.

    Front-to-back ordering happens IN-GRAPH per call: instances are
    sorted by world-AABB distance from the batch's origin centroid, so
    the running best tightens on near instances first (secondary-bounce
    batches get their own ordering, which the static ``order`` of the
    unrolled path cannot do).  Results are identical to the unrolled path
    up to equal-distance tie order.  ``return_stats``: per-instance live
    counts, indexed by ORIGINAL instance position.
    """
    import jax

    origin = jnp.asarray(origin, jnp.float32)
    direction = jnp.asarray(direction, jnp.float32)
    r = origin.shape[0]
    f32, i32 = jnp.float32, jnp.int32

    best = InstancedHit(
        hit=jnp.zeros((r,), bool),
        t_world=jnp.full((r,), INF, f32),
        u=jnp.zeros((r,), f32),
        v=jnp.zeros((r,), f32),
        tri=jnp.full((r,), -1, i32),
        instance=jnp.full((r,), -1, i32),
    )
    cap_user = (None if t_max is None else jnp.asarray(t_max, f32))
    stats_out = jnp.zeros((len(instances),), i32)

    # Ray-batch reference point for the in-graph front-to-back sort.
    finite_o = jnp.all(jnp.isfinite(origin), axis=-1, keepdims=True)
    centroid = (jnp.sum(jnp.where(finite_o, origin, 0.0), axis=0)
                / jnp.maximum(jnp.sum(finite_o), 1))

    groups = {}
    for idx, inst in enumerate(instances):
        groups.setdefault(inst.mesh_index, []).append(idx)

    for mesh_index, grp in groups.items():
        bake = mesh_bakes[mesh_index]
        ws = jnp.asarray(np.stack([instances[i].world for i in grp]))
        invs = jnp.asarray(
            np.stack([instances[i].inv_world for i in grp]))
        # Host-side (numpy) world AABBs: a per-instance jnp loop here
        # would re-inflate the traced program with O(instances) ops — the
        # exact thing the scan exists to avoid.
        if getattr(bake, "clusters", None) is not None:
            mn_o = np.asarray(bake.clusters["root_min"])
            mx_o = np.asarray(bake.clusters["root_max"])
        else:
            vs = np.concatenate([
                np.asarray(bake.tri_v1),
                np.asarray(bake.tri_v1) + np.asarray(bake.tri_e1),
                np.asarray(bake.tri_v1) + np.asarray(bake.tri_e2),
            ])
            mn_o = vs.min(axis=0)
            mx_o = vs.max(axis=0)
        corners = np.stack([
            np.where([(i >> k) & 1 for k in range(3)], mx_o, mn_o)
            for i in range(8)
        ])  # (8, 3)
        ws_np = np.stack([instances[i].world for i in grp])
        cw = corners[None] @ ws_np[:, :3, :3] + ws_np[:, None, 3, :3]
        mns = jnp.asarray(cw.min(axis=1).astype(np.float32))
        mxs = jnp.asarray(cw.max(axis=1).astype(np.float32))
        ids = jnp.asarray(grp, i32)

        near = jnp.clip(centroid[None, :], mns, mxs)
        dist = jnp.linalg.norm(near - centroid[None, :], axis=-1)
        perm = jnp.argsort(dist)
        xs = (ws[perm], invs[perm], mns[perm], mxs[perm], ids[perm])

        def step(carry, x, bake=bake):
            best_in, stats_in = carry
            w, inv, mn_w, mx_w, inst_id = x

            o_obj = _transform_points(origin, inv)
            p2_obj = _transform_points(origin + direction, inv)
            d_obj = p2_obj - o_obj
            norm = jnp.linalg.norm(d_obj, axis=-1, keepdims=True)
            d_obj = d_obj / jnp.where(norm == 0, 1.0, norm)

            cap = best_in.t_world
            if cap_user is not None:
                cap = jnp.minimum(cap, cap_user)
            if prune:
                live = _prune_mask(origin, direction, mn_w, mx_w, cap)
            else:
                live = jnp.ones((r,), bool)
            d_obj = jnp.where(live[:, None], d_obj, f32(jnp.nan))

            t_max_obj = None
            if cap_user is not None:
                t_max_obj = cap_user * norm[:, 0]
            itri = None
            if ignore_tri is not None:
                this = jnp.asarray(ignore_instance) == inst_id
                itri = jnp.where(this, jnp.asarray(ignore_tri, i32), -1)

            def run_pass(b):
                h: Hit = nearest_hit(bake, o_obj, d_obj, t_max=t_max_obj,
                                     ignore_tri=itri,
                                     intersector=intersector, **kw)
                safe = jnp.maximum(h.tri, 0)
                frag_obj = (bake.tri_v1[safe]
                            + bake.tri_e1[safe] * h.u[..., None]
                            + bake.tri_e2[safe] * h.v[..., None])
                frag_w = _transform_points(frag_obj, w)
                t_world = jnp.linalg.norm(frag_w - origin, axis=-1)
                t_world = jnp.where(h.hit, t_world, INF)
                upd = t_world < b.t_world
                return InstancedHit(
                    hit=b.hit | (upd & h.hit),
                    t_world=jnp.where(upd, t_world, b.t_world),
                    u=jnp.where(upd, h.u, b.u),
                    v=jnp.where(upd, h.v, b.v),
                    tri=jnp.where(upd, h.tri, b.tri),
                    instance=jnp.where(upd, inst_id, b.instance),
                )

            import jax as _jax

            best_out = _jax.lax.cond(jnp.any(live), run_pass,
                                     lambda b: b, best_in)
            stats_out_ = stats_in.at[inst_id].set(
                jnp.sum(live).astype(i32))
            return (best_out, stats_out_), None

        (best, stats_out), _ = jax.lax.scan(step, (best, stats_out), xs)

    if return_stats:
        return best, stats_out
    return best
