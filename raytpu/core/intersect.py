"""Ray-primitive intersection math (vmap/broadcast friendly, jnp).

Faithful to the reference's formulas:

- Möller–Trumbore exactly as ``RayExtensions.IntersectsTriangle`` /
  ``IntersectsTriangleBackfaceCulling`` (RayExtensions.cs:13-75): no epsilon
  guard on the determinant (a parallel ray divides by zero, producing inf/NaN
  which fails the acceptance tests — same net behavior as the C# float math),
  acceptance ``u >= 0 && v >= 0 && d >= 0 && u + v <= 1``, and the backface
  variant rejecting when ``dot(surfaceNormal, D) > 0``.
- AABB slab test with XNA ``BoundingBox.Intersects(ref Ray, out float?)``
  semantics (used by MeshOctree.cs:331): near-zero direction components are
  handled with an explicit 1e-6 branch, the entry distance is clamped at 0
  (origin inside the box reports 0).
"""

from __future__ import annotations

import jax.numpy as jnp

from raytpu.core.math3d import cross, dot


def moller_trumbore(origin, direction, v1, e1, e2):
    """Möller–Trumbore over broadcastable stacks of rays and triangles.

    Parameters are (..., 3); ``e1 = v2 - v1``, ``e2 = v3 - v1`` precomputed.
    Returns ``(hit, u, v, d)`` with the reference's exact acceptance test
    (RayExtensions.cs:36-39).
    """
    t = origin - v1
    p = cross(direction, e2)
    q = cross(t, e1)
    det = dot(p, e1)
    inv_det = 1.0 / det
    d = dot(q, e2) * inv_det
    u = dot(p, t) * inv_det
    v = dot(q, direction) * inv_det
    hit = (u >= 0.0) & (v >= 0.0) & (d >= 0.0) & (u + v <= 1.0)
    return hit, u, v, d


def moller_trumbore_xyz(origin, direction, v1, e1, e2):
    """:func:`moller_trumbore` with every vector given as an (x, y, z)
    tuple of broadcastable arrays — the same formula, in the same order,
    for kernels whose blocks cannot carry a trailing axis of 3
    (kernels/walk.py).  Returns ``(hit, u, v, d)``."""

    def cross3(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    def dot3(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    t = tuple(o - p for o, p in zip(origin, v1))
    p = cross3(direction, e2)
    q = cross3(t, e1)
    det = dot3(p, e1)
    inv_det = 1.0 / det
    d = dot3(q, e2) * inv_det
    u = dot3(p, t) * inv_det
    v = dot3(q, direction) * inv_det
    hit = (u >= 0.0) & (v >= 0.0) & (d >= 0.0) & (u + v <= 1.0)
    return hit, u, v, d


def moller_trumbore_safe(origin, direction, v1, e1, e2, eps: float = 1e-20):
    """Möller–Trumbore with a determinant guard, for the differentiable
    recompute path (render/wavefront.py, cfg.differentiable).

    For a triangle that actually passed the acceptance test the determinant
    is nonzero and the guard never fires, so forward values are identical to
    :func:`moller_trumbore`; for masked-out lanes (missed rays gathering a
    placeholder triangle) it avoids inf/NaN that would poison gradients
    through ``where``.
    """
    t = origin - v1
    p = cross(direction, e2)
    q = cross(t, e1)
    det = dot(p, e1)
    det = jnp.where(jnp.abs(det) < eps, jnp.float32(1.0), det)
    inv_det = 1.0 / det
    d = dot(q, e2) * inv_det
    u = dot(p, t) * inv_det
    v = dot(q, direction) * inv_det
    return u, v, d


def moller_trumbore_cull(origin, direction, v1, e1, e2, surface_normal):
    """Backface-culling variant (RayExtensions.cs:42-75).

    Rejects when ``dot(surfaceNormal, D) > 0`` before the arithmetic.
    """
    hit, u, v, d = moller_trumbore(origin, direction, v1, e1, e2)
    facing = dot(surface_normal, direction) <= 0.0
    return hit & facing, u, v, d


def facing_gate(surface_normal, direction, cull):
    """The backface-cull gate (RayExtensions.cs:48-51) as a mask.

    ``cull="reverse"`` mirrors it for queries cast along the REVERSED ray
    (render/wavefront.py shadow-from-light): accept iff the triangle would
    face the original (un-reversed) direction.  One definition for every
    backend, on (..., 3) arrays or (x, y, z) tuples (kernels/walk.py), so
    the mirror can never drift."""
    if isinstance(surface_normal, tuple):
        facing = sum(n * d for n, d in zip(surface_normal, direction))
    else:
        facing = dot(surface_normal, direction)
    if cull == "reverse":
        return facing >= 0.0
    return facing <= 0.0


def ray_aabb(origin, direction, box_min, box_max):
    """XNA ``BoundingBox.Intersects(ref Ray)`` slab test.

    Returns ``(hit, t_near)`` where ``t_near`` is the reference's reported
    distance: 0 when the origin is inside the box, the slab entry distance
    otherwise.  Broadcasts over (..., 3) rays/boxes.

    XNA's implementation walks the three axes: when ``|d| < 1e-6`` the ray is
    parallel to the slab and misses unless the origin is inside it; otherwise
    the entry/exit distances are accumulated with ``t_near`` clamped at 0.
    """
    d = direction
    o = origin
    parallel = jnp.abs(d) < 1e-6
    inside_slab = (o >= box_min) & (o <= box_max)
    inv = 1.0 / jnp.where(parallel, 1.0, d)
    t1 = (box_min - o) * inv
    t2 = (box_max - o) * inv
    t_lo = jnp.minimum(t1, t2)
    t_hi = jnp.maximum(t1, t2)
    # Parallel axes do not constrain t (but must contain the origin).
    t_lo = jnp.where(parallel, -jnp.inf, t_lo)
    t_hi = jnp.where(parallel, jnp.inf, t_hi)
    t_near = jnp.maximum(jnp.max(t_lo, axis=-1), 0.0)
    t_far = jnp.min(t_hi, axis=-1)
    hit = (
        (t_near <= t_far)
        & (t_far >= 0.0)
        & jnp.all(~parallel | inside_slab, axis=-1)
    )
    return hit, t_near


def barycentric_point(v1, e1, e2, u, v):
    """Object-space hit point ``v1 + e1*u + e2*v`` (MeshOctree.cs:310-322)."""
    return v1 + e1 * u[..., None] + e2 * v[..., None]
