"""Component-leading vector math: Vec3 as a tuple of three same-shape
arrays.

Why: XLA lays out the trailing axis of an array contiguously, so (B, 3)
vector math mixes components within vector registers and memory
transactions. Keeping x/y/z as separate arrays — shaped (R, 128) in the
renderer — makes every operation a dense elementwise pass over one
component. This is also exactly how the reference lays out its ray
streams: SoA, one array per component (src/render/driver.impala:24-61).

All functions broadcast over arbitrary array shapes.
"""
from __future__ import annotations

import jax.numpy as jnp

PI = jnp.float32(3.14159265359)
FLT_MAX = jnp.float32(3.402823466e38)


def splat(c, like=None):
    """Constant (3,) tuple -> Vec3 broadcast to `like`'s shape."""
    if like is None:
        return (jnp.float32(c[0]), jnp.float32(c[1]), jnp.float32(c[2]))
    return tuple(jnp.full_like(like, v) for v in c)


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def neg(a):
    return (-a[0], -a[1], -a[2])


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def length2(a):
    return dot(a, a)


def length(a):
    return jnp.sqrt(length2(a))


def normalize(a):
    inv = 1.0 / length(a)
    return scale(a, inv)


def reflect(v, n):
    """2*dot(n,v)*n - v (vector.impala vec3_reflect)."""
    k = 2.0 * dot(n, v)
    return (k * n[0] - v[0], k * n[1] - v[1], k * n[2] - v[2])


def lerp(a, b, k):
    return (a[0] + (b[0] - a[0]) * k,
            a[1] + (b[1] - a[1]) * k,
            a[2] + (b[2] - a[2]) * k)


def lerp2(a, b, c, u, v):
    """Barycentric (vector.impala vec3_lerp2)."""
    w = 1.0 - u - v
    return (w * a[0] + u * b[0] + v * c[0],
            w * a[1] + u * b[1] + v * c[1],
            w * a[2] + u * b[2] + v * c[2])


def where(m, a, b):
    return (jnp.where(m, a[0], b[0]),
            jnp.where(m, a[1], b[1]),
            jnp.where(m, a[2], b[2]))


def luminance(c):
    """Rec. 709 (color.impala:33-35)."""
    return c[0] * 0.2126 + c[1] * 0.7152 + c[2] * 0.0722


def onb(n):
    """Branchless orthonormal basis (matrix.impala:29-39).
    Returns (t, b, n) Vec3s."""
    nx, ny, nz = n
    sign = jnp.where(nz >= 0.0, jnp.float32(1.0), jnp.float32(-1.0))
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = (1.0 + sign * nx * nx * a, sign * b, -sign * nx)
    bt = (b, sign + ny * ny * a, -ny)
    return t, bt, n


def basis_mul(t, b, n, v):
    """Local -> world: t*v.x + b*v.y + n*v.z."""
    return (t[0] * v[0] + b[0] * v[1] + n[0] * v[2],
            t[1] * v[0] + b[1] * v[1] + n[1] * v[2],
            t[2] * v[0] + b[2] * v[1] + n[2] * v[2])


def from_rows(a):
    """(N, 3) array -> Vec3 of (N,) columns (host-side conversion)."""
    return (a[..., 0], a[..., 1], a[..., 2])


def to_rows(v):
    """Vec3 -> (..., 3) array."""
    return jnp.stack(v, axis=-1)
