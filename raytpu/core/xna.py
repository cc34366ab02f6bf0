"""XNA-parity matrix math (row-vector convention).

The reference outsources its matrix math to ``Microsoft.Xna.Framework``
(SURVEY.md §1 L0).  The tracer's ray generation is exactly
``Viewport.Unproject`` of the near/far pixel points (RayTracer.cs:410-421),
so bit-faithful images require XNA's exact LookAt / PerspectiveFieldOfView /
Unproject conventions: XNA uses *row vectors* (``v' = [v, 1] @ M``) and a
right-handed view space looking down -Z.

Everything here is written with ``jax.numpy`` so it traces under ``jit`` and
is differentiable w.r.t. camera parameters; it also runs eagerly on host.
Every product runs at ``Precision.HIGHEST``: full float32, never the
reduced-precision (TF32/bf16) passes an accelerator may pick by default.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_HIGHEST = lax.Precision.HIGHEST


def mm(a, b):
    """``a @ b`` in full float32 (see module docstring)."""
    return jnp.matmul(a, b, precision=_HIGHEST)


def look_at(position, target, up):
    """XNA ``Matrix.CreateLookAt`` (row-vector, RH).

    Used by Camera.CreateView (reference: Camera.cs:40-47).
    """
    position = jnp.asarray(position, jnp.float32)
    target = jnp.asarray(target, jnp.float32)
    up = jnp.asarray(up, jnp.float32)
    zaxis = _normalize(position - target)
    xaxis = _normalize(jnp.cross(up, zaxis))
    yaxis = jnp.cross(zaxis, xaxis)
    r0 = jnp.stack([xaxis[0], yaxis[0], zaxis[0], jnp.float32(0)])
    r1 = jnp.stack([xaxis[1], yaxis[1], zaxis[1], jnp.float32(0)])
    r2 = jnp.stack([xaxis[2], yaxis[2], zaxis[2], jnp.float32(0)])
    r3 = jnp.stack(
        [
            -jnp.dot(xaxis, position, precision=_HIGHEST),
            -jnp.dot(yaxis, position, precision=_HIGHEST),
            -jnp.dot(zaxis, position, precision=_HIGHEST),
            jnp.float32(1),
        ]
    )
    return jnp.stack([r0, r1, r2, r3])


def perspective_fov(fov, aspect, near, far):
    """XNA ``Matrix.CreatePerspectiveFieldOfView`` (row-vector, RH).

    Used by Camera.CreateProjection (reference: Camera.cs:49-54).
    """
    fov = jnp.asarray(fov, jnp.float32)
    y_scale = 1.0 / jnp.tan(fov * 0.5)
    x_scale = y_scale / aspect
    zero = jnp.zeros((), jnp.float32)
    one = jnp.ones((), jnp.float32)
    m22 = jnp.asarray(far / (near - far), jnp.float32)
    m32 = jnp.asarray(near * far / (near - far), jnp.float32)
    return jnp.stack(
        [
            jnp.stack([x_scale, zero, zero, zero]),
            jnp.stack([zero, y_scale, zero, zero]),
            jnp.stack([zero, zero, m22, -one]),
            jnp.stack([zero, zero, m32, zero]),
        ]
    )


def transform_point(p, m):
    """XNA ``Vector3.Transform`` of a point: ``[p, 1] @ M`` (w dropped).

    The reference uses this both for world transforms (SceneObject.cs:195-196)
    and for transforming rays into object space (OctreeSpatialManager.cs:358-364).
    ``p`` may be (..., 3).
    """
    p = jnp.asarray(p, jnp.float32)
    return mm(p, m[:3, :3]) + m[3, :3]


def transform_normal(n, m):
    """XNA ``Vector3.TransformNormal``: ``n @ M[:3,:3]`` (no translation)."""
    n = jnp.asarray(n, jnp.float32)
    return mm(n, m[:3, :3])


def transform_homogeneous(p, m):
    """Full 4-component row-vector transform returning (xyz, w)."""
    p = jnp.asarray(p, jnp.float32)
    xyz = mm(p, m[:3, :3]) + m[3, :3]
    w = mm(p, m[:3, 3]) + m[3, 3]
    return xyz, w


def unproject(screen, view, proj, viewport_wh, world=None):
    """XNA ``Viewport.Unproject`` (reference ray-gen, RayTracer.cs:412-421).

    ``screen`` is (..., 3): pixel x, pixel y, depth in [0, 1].
    ``viewport_wh`` = (width, height); viewport origin 0, MinDepth 0,
    MaxDepth 1 (the reference never changes them).
    """
    xyz, a = unproject_h(screen, view, proj, viewport_wh, world)
    # XNA divides unless a == 1 within float.Epsilon; dividing by exactly 1 is
    # a no-op so we always divide.
    return xyz / a[..., None]


def unproject_h(screen, view, proj, viewport_wh, world=None):
    """``unproject`` without the final perspective division: (xyz, a).

    Ray generation combines near/far unprojections in homogeneous space
    (core/camera.py::rays_through_screen): the far point's ``a`` can round
    to exactly 0.0 in f32 (the far plane maps to w ~ 0 and the dot product
    cancels), which made ``far/a - near/a_n`` produce inf/NaN directions
    for whole scanlines at some camera poses.  ``xyz_f * a_n - xyz_n * a_f``
    is the same direction up to positive scale, exact in the a_f -> 0
    limit (the homogeneous point at infinity IS the direction)."""
    w, h = viewport_wh
    m = mm(view, proj) if world is None else mm(mm(world, view), proj)
    inv = jnp.linalg.inv(m)
    screen = jnp.asarray(screen, jnp.float32)
    sx = screen[..., 0] / w * 2.0 - 1.0
    sy = -(screen[..., 1] / h * 2.0 - 1.0)
    sz = screen[..., 2]
    src = jnp.stack([sx, sy, sz], axis=-1)
    return transform_homogeneous(src, inv)


def rotation_x(angle):
    """XNA ``Matrix.CreateRotationX`` (row-vector)."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([one, zero, zero, zero]),
            jnp.stack([zero, c, s, zero]),
            jnp.stack([zero, -s, c, zero]),
            jnp.stack([zero, zero, zero, one]),
        ]
    )


def rotation_y(angle):
    """XNA ``Matrix.CreateRotationY`` (row-vector)."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, zero, -s, zero]),
            jnp.stack([zero, one, zero, zero]),
            jnp.stack([s, zero, c, zero]),
            jnp.stack([zero, zero, zero, one]),
        ]
    )


def rotation_z(angle):
    """XNA ``Matrix.CreateRotationZ`` (row-vector)."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, s, zero, zero]),
            jnp.stack([-s, c, zero, zero]),
            jnp.stack([zero, zero, one, zero]),
            jnp.stack([zero, zero, zero, one]),
        ]
    )


def scale(s):
    """XNA ``Matrix.CreateScale`` for a 3-vector scale."""
    s = jnp.asarray(s, jnp.float32)
    m = jnp.diag(jnp.concatenate([s, jnp.ones((1,), jnp.float32)]))
    return m


def translation(t):
    """XNA ``Matrix.CreateTranslation`` (row-vector: translation in row 3)."""
    t = jnp.asarray(t, jnp.float32)
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[3, :3].set(t)


def compose_world(scale_v, rotation_v, position_v):
    """SceneObject world matrix: S · Rx · Ry · Rz · T.

    Reference: SceneObject.BuildWorld (SceneObject.cs:183-199).
    """
    m = scale(scale_v)
    m = mm(m, rotation_x(jnp.asarray(rotation_v[0], jnp.float32)))
    m = mm(m, rotation_y(jnp.asarray(rotation_v[1], jnp.float32)))
    m = mm(m, rotation_z(jnp.asarray(rotation_v[2], jnp.float32)))
    m = mm(m, translation(position_v))
    return m


def compose_world_np(scale_v, rotation_v, position_v) -> "np.ndarray":
    """Pure-NumPy twin of :func:`compose_world` for host-side scene baking.

    Scene flattening runs on the host before any device work; going through
    jnp here would compile and dispatch dozens of tiny programs.  Semantics
    identical: S · Rx · Ry · Rz · T with XNA
    row-vector rotation matrices (SceneObject.cs:183-199).
    """
    import numpy as np

    sx, sy, sz = (float(s) for s in np.asarray(scale_v).reshape(3))
    ax, ay, az = (float(a) for a in np.asarray(rotation_v).reshape(3))
    tx, ty, tz = (float(t) for t in np.asarray(position_v).reshape(3))

    def rx(a):
        c, s = np.cos(a), np.sin(a)
        return np.array(
            [[1, 0, 0, 0], [0, c, s, 0], [0, -s, c, 0], [0, 0, 0, 1]], np.float64
        )

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array(
            [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], np.float64
        )

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array(
            [[c, s, 0, 0], [-s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64
        )

    t = np.eye(4)
    t[3, :3] = (tx, ty, tz)
    # Match float32 rounding of the jnp path: compose in float32 steps.
    m32 = np.diag([sx, sy, sz, 1.0]).astype(np.float32)
    for r in (rx(ax), ry(ay), rz(az), t):
        m32 = (m32 @ r.astype(np.float32)).astype(np.float32)
    return m32


def quantize_color(v):
    """XNA ``new Color(Vector3)`` byte packing, as a float in [0, 1].

    XNA clamps each channel to [0,1], scales by 255 and rounds with .NET
    ``Math.Round`` (round-half-to-even) before byte-packing; ``ToVector3``
    divides by 255.  ``jnp.rint``/``np.rint`` are also round-half-to-even so
    this is exact.
    """
    v = jnp.clip(v, 0.0, 1.0)
    return jnp.rint(v * 255.0) / 255.0


def _normalize(v):
    return v / jnp.linalg.norm(v)
