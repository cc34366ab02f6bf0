"""Device-mesh construction and scene replication.

The reference's only parallelism is a shared-memory scanline pool with an
atomic dispenser (RayTracer.cs:48-52, :81-120).  The equivalent here is data
parallelism over the ray dimension on a ``jax.sharding.Mesh``:

- axis ``"rays"`` spans every device; each device owns a contiguous ray
  block — the moral successor of "each thread owns a scanline", with the
  XLA collective replacing Thread.Join (RayTracer.cs:117-120).
- the scene (triangles, octree, materials, textures, lights) is replicated —
  the analog of all threads reading the same shared octree.

For multi-host topologies ``make_mesh(axes=("hosts", "chips"))`` lets
gradient reductions run within a host first and cross hosts once
(`reduce_scatter` over chips, `psum` over hosts — see raytpu.diff.fit).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices: Optional[Sequence] = None,
              axes: Tuple[str, ...] = ("rays",),
              shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """Build a Mesh over ``devices`` (default: all).

    1-D ``("rays",)`` for pure ray data parallelism; 2-D
    ``("hosts", "chips")`` with ``shape=(num_hosts, chips_per_host)`` for
    hierarchical reductions.
    """
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        if len(axes) == 1:
            shape = (len(devices),)
        elif len(axes) == 2:
            hosts = max(1, jax.process_count())
            shape = (hosts, len(devices) // hosts)
        else:
            raise ValueError("give an explicit shape for >2 mesh axes")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axes)


def hierarchical_pmean(tree, mesh: Mesh):
    """Mean-reduce a shard_map-varying ``tree`` across all mesh axes.

    1-D mesh: one flat ``pmean``.  2-D ``("hosts", "chips")``: the
    hierarchical all-reduce the mesh docstring promises — ``psum_scatter``
    over the chip axis (each chip owns 1/chips of the sum, traffic stays
    within the host), ``psum`` of the small shard across hosts (one
    crossing at 1/chips the bytes of a flat all-reduce), then
    ``all_gather`` back over chips.  Leaves whose leading dim does not
    tile over the chip axis fall back to a flat psum (the scatter needs
    equal shards).
    """
    axes = mesh.axis_names
    if len(axes) == 1:
        return jax.lax.pmean(tree, axes)
    hosts_ax, chips_ax = axes
    nchips = mesh.shape[chips_ax]
    total = mesh.size

    def red(x):
        if x.ndim >= 1 and x.shape[0] >= nchips and x.shape[0] % nchips == 0:
            y = jax.lax.psum_scatter(x, chips_ax, scatter_dimension=0,
                                     tiled=True)
            # The cross-host stage carries 1/chips of the gradient bytes —
            # the whole point of the hierarchy.
            y = jax.lax.psum(y, hosts_ax)
            # Gather the chip shards back.  Expressed as a one-hot psum
            # rather than all_gather because shard_map's varying-axis type
            # system cannot infer replication through all_gather, while
            # psum's output is invariant by construction.  Same in-host
            # traffic class; the cross-host saving above is untouched.
            idx = jax.lax.axis_index(chips_ax)
            full = jnp.zeros((nchips,) + y.shape, y.dtype)
            full = jax.lax.dynamic_update_index_in_dim(full, y, idx, 0)
            full = jax.lax.psum(full, chips_ax)
            y = full.reshape(x.shape)
        else:
            y = jax.lax.psum(x, axes)
        return y / total

    return jax.tree.map(red, tree)


def ray_axis(mesh: Mesh) -> str:
    """The (flattened) axis name rays are sharded over."""
    return mesh.axis_names[-1] if len(mesh.axis_names) == 1 else mesh.axis_names


def replicate_scene(scene, mesh: Mesh):
    """Place every scene array fully replicated on the mesh.

    Explicit placement keeps XLA from inserting per-step broadcasts of the
    triangle/texture tables (the "shared scene" of RayTracer's thread pool).
    Scenes larger than device memory instead shard the triangle table and
    rotate partitions (ring traversal, dist/bigscene.py).
    """
    rep = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, rep), scene)
