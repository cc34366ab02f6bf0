"""Spatial triangle clusters — the acceleration structure of TILED and the
walk kernel.

The reference accelerates rays with a two-level recursive octree walked one
node at a time per ray (MeshOctree.cs:259-353, OctreeSpatialManager.cs:312-
482).  Here the structure is flat:

- **Clusters, not nodes.**  Triangles are grouped into fixed-size clusters
  of ``cluster_size`` (128 by default) by spatial-median splits, and the
  clusters are ordered by the Morton code of their centroid.  Cluster AABBs
  are tight — the same locality the reference's octree leaves capture
  (MeshOctree.cs:224-232), but with **zero duplication**, contiguous memory
  per cluster, and a flat table instead of a pointer tree.
- **Dense culling, not traversal.**  A batch of rays is tiled; each tile is
  summarized by an origin AABB + direction interval box, and every
  (tile, cluster) pair gets one conservative interval slab test
  (accel/tiled.py).
- **Front-to-back walks, not sorted leaf lists.**  Candidate clusters are
  ordered by conservative entry distance and tested one by one with a
  strict-min update until every ray's best hit precedes the next cluster —
  the batched analog of the reference's sorted-leaf early-stop
  (MeshOctree.cs:281-306), with *exact* nearest-hit semantics.

Build is host-side vectorized NumPy (the content-processor stage of the
pipeline, TracerModelProcessor.cs:105-119); the device table is a dict of
flat arrays in cluster slot order, so a walk reads one cluster's triangles
as contiguous rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def morton3(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave three 10-bit integer coordinates into a 30-bit Morton code."""

    def spread(v):
        v = v.astype(np.uint64) & np.uint64(0x3FF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
        return v

    return (spread(x) << np.uint64(2)) | (spread(y) << np.uint64(1)) | spread(z)


@dataclasses.dataclass
class ClusterTable:
    """Host-side cluster build result.

    ``order``: (Tp,) original triangle index per Morton-ordered slot
    (-1 padding); ``cluster_min/max``: (NC, 3) cluster AABBs.
    """

    order: np.ndarray
    cluster_min: np.ndarray
    cluster_max: np.ndarray
    cluster_size: int

    @property
    def num_clusters(self) -> int:
        return self.cluster_min.shape[0]

    def as_device_arrays(self, tri_v1, tri_e1, tri_e2, tri_snormal,
                         tri_mesh):
        """Device dict: cluster AABBs + triangle geometry permuted into
        cluster slot order (slot -> original id in ``tri_id``; padding slots
        are degenerate triangles with ``tri_id == -1`` that can never be
        hit).  ``tri_block`` maps an original triangle id to its cluster
        (shadow clearance, accel/shadowcull.py)."""
        import jax.numpy as jnp

        safe = np.maximum(self.order, 0)
        pad = self.order < 0

        def perm(a, fill=0.0):
            out = np.asarray(a)[safe].copy()
            out[pad] = fill
            return jnp.asarray(out)

        tri_id = np.where(pad, -1, safe).astype(np.int32)
        mesh = np.where(pad, -1, np.asarray(tri_mesh)[safe]).astype(np.int32)
        cmin = self.cluster_min.astype(np.float32)
        cmax = self.cluster_max.astype(np.float32)

        n_orig = int(np.asarray(tri_v1).shape[0])
        tri_block = np.zeros(n_orig, np.int32)
        tri_block[self.order[~pad]] = (
            np.flatnonzero(~pad) // self.cluster_size).astype(np.int32)

        return {
            "cluster_min": jnp.asarray(cmin),
            "cluster_max": jnp.asarray(cmax),
            "tri_block": jnp.asarray(tri_block),
            "root_min": jnp.asarray(cmin.min(axis=0)),
            "root_max": jnp.asarray(cmax.max(axis=0)),
            "tri_id": jnp.asarray(tri_id),
            "tri_v1": perm(tri_v1),
            "tri_e1": perm(tri_e1),
            "tri_e2": perm(tri_e2),
            "tri_snormal": perm(tri_snormal),
            "tri_mesh": jnp.asarray(mesh),
        }


def _median_split_leaves(centroids: np.ndarray, idx: np.ndarray,
                         cluster_size: int) -> list:
    """Spatial-median BVH leaves of <= cluster_size triangles each.

    Level-synchronous longest-axis median splits (argpartition per segment,
    O(T log T) host time).  Versus Morton runs this yields *tight*, nearly
    disjoint leaf AABBs: a fixed-length run of Z-curve codes snakes across
    cells and jumps at curve discontinuities, so Morton clusters measured
    ~5-7x wider per axis on the 1M-tri bench terrain (a 0.6x0.6 beam
    column overlapped a median of 34 Morton clusters vs ~4-9 spatial
    patches) — which is exactly the number of front-to-back trips the
    walk has to make per tile.

    The split point is the multiple of ``cluster_size`` nearest the median,
    so leaves pack full (plain halving strands ~cluster_size/2 triangles in
    every leaf when T sits just above cluster_size * 2^k, inflating the
    cluster count, HBM tables and walk trips by up to ~2x).

    Splits operate on *positions* into ``centroids``/``idx`` (0..len-1) and
    map back through ``idx`` at the end, so a ``valid`` mask with holes
    (compact ``centroids``, non-contiguous ``idx``) is handled correctly.
    """
    n = idx.shape[0]
    segments = [np.arange(n, dtype=np.int64)]
    leaves = []
    while segments:
        nxt = []
        for seg in segments:
            if seg.shape[0] <= cluster_size:
                leaves.append(idx[seg])
                continue
            c = centroids[seg]
            ext = c.max(axis=0) - c.min(axis=0)
            axis = int(np.argmax(ext))
            # Nearest multiple of cluster_size to the median, clamped to a
            # proper split — left children stay exact multiples all the way
            # down, so every leaf except per-subtree remainders holds
            # exactly cluster_size triangles.
            half = seg.shape[0] // 2
            m = int(round(half / cluster_size)) * cluster_size
            m = min(max(m, cluster_size), seg.shape[0] - 1)
            part = np.argpartition(c[:, axis], m)
            nxt.append(seg[part[:m]])
            nxt.append(seg[part[m:]])
        segments = nxt
    return leaves


def build_clusters(tri_verts: np.ndarray, cluster_size: int = 128,
                   valid: Optional[np.ndarray] = None,
                   method: str = "median",
                   pad_clusters_to: Optional[int] = None) -> ClusterTable:
    """Cluster ``tri_verts`` (T, 3, 3) into fixed-size spatial groups.

    ``method="median"`` (default): spatial-median BVH leaves, tight and
    nearly disjoint (see _median_split_leaves).  ``method="morton"``: the
    round-1 fixed-length Morton-run clustering (kept for comparison).
    O(T log T) host time either way; rebuilds are cheap enough to run
    per-epoch while fitting geometry (diff/fit.py ``rebuild_every``).

    ``pad_clusters_to``: pad the table to a fixed cluster count with
    infeasible (±big AABB, empty) clusters so per-epoch rebuilds keep
    every device-array shape stable — the jitted fit step then never
    recompiles across rebuilds.
    """
    v = np.asarray(tri_verts, np.float32).reshape(-1, 3, 3)
    t = v.shape[0]
    if valid is None:
        valid = np.ones(t, bool)
    idx = np.flatnonzero(valid)
    centroids = v[idx].mean(axis=1)

    if method == "median" and idx.shape[0] > cluster_size:
        leaves = _median_split_leaves(centroids, idx, cluster_size)
        # Order leaves by the Morton code of their centroid so neighboring
        # slots stay spatially local (slot order breaks exact-tie picks).
        cents = np.stack([centroids[np.searchsorted(idx, lf)].mean(axis=0)
                          for lf in leaves])
        lo = cents.min(axis=0)
        extent = np.maximum(cents.max(axis=0) - lo, 1e-30)
        q = np.clip(((cents - lo) / extent) * 1023.0, 0, 1023).astype(
            np.uint32)
        codes = morton3(q[:, 0], q[:, 1], q[:, 2])
        leaves = [leaves[i] for i in np.argsort(codes, kind="stable")]
        nc = len(leaves)
        slots = np.full(nc * cluster_size, -1, np.int64)
        for i, lf in enumerate(leaves):
            slots[i * cluster_size:i * cluster_size + lf.shape[0]] = lf
    else:
        lo = centroids.min(axis=0)
        hi = centroids.max(axis=0)
        extent = np.maximum(hi - lo, 1e-30)
        q = np.clip(((centroids - lo) / extent) * 1023.0, 0, 1023).astype(
            np.uint32)
        codes = morton3(q[:, 0], q[:, 1], q[:, 2])
        order = idx[np.argsort(codes, kind="stable")].astype(np.int64)

        n = order.shape[0]
        nc = max(1, -(-n // cluster_size))
        slots = np.full(nc * cluster_size, -1, np.int64)
        slots[:n] = order

    if pad_clusters_to is not None:
        if pad_clusters_to < nc:
            raise ValueError(
                f"pad_clusters_to={pad_clusters_to} < built count {nc}")
        pad = (pad_clusters_to - nc) * cluster_size
        if pad:
            slots = np.concatenate([slots, np.full(pad, -1, np.int64)])
        nc = pad_clusters_to

    member = v[np.maximum(slots, 0)]  # (Tp, 3, 3)
    big = np.float32(3.4028235e38)
    mn = np.where(slots[:, None, None] >= 0, member, big).reshape(
        nc, cluster_size, 3, 3
    )
    mx = np.where(slots[:, None, None] >= 0, member, -big).reshape(
        nc, cluster_size, 3, 3
    )
    cluster_min = mn.min(axis=(1, 2))
    cluster_max = mx.max(axis=(1, 2))
    # Fully-padded clusters (possible when leaves under-fill) keep +/-big
    # bounds and are never feasible in any cull.

    return ClusterTable(
        order=slots,
        cluster_min=cluster_min.astype(np.float32),
        cluster_max=cluster_max.astype(np.float32),
        cluster_size=cluster_size,
    )
