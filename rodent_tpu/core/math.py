"""Batched 3D vector math over trailing-axis-3 JAX arrays.

The reference implements Vec3 math as structs-of-closures specialized by
partial evaluation (src/core/vector.impala, src/core/matrix.impala). Here the
analog is plain jnp arrays of shape (..., 3) so everything vectorizes over
ray megabatches; the "matrices" we need (orthonormal bases) are
kept as three basis-vector arrays rather than matrix objects so they fuse.
"""
from __future__ import annotations

import jax.numpy as jnp

FLT_MAX = jnp.float32(3.402823466e38)
FLT_EPS = jnp.float32(1.1920928955e-07)
PI = jnp.float32(3.14159265359)


def vec3(x, y, z):
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, jnp.float32),
        jnp.asarray(y, jnp.float32),
        jnp.asarray(z, jnp.float32)), axis=-1)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def length2(a):
    return dot(a, a)


def length(a):
    return jnp.sqrt(length2(a))


def normalize(a):
    return a * (1.0 / length(a))[..., None]


def reflect(v, n):
    """Reflects -v about n: 2*dot(n,v)*n - v (vector.impala vec3_reflect)."""
    return 2.0 * dot(n, v)[..., None] * n - v


def lerp(a, b, k):
    return (1.0 - k) * a + k * b


def lerp2(a, b, c, u, v):
    """Barycentric interpolation (vector.impala vec3_lerp2)."""
    w = (1.0 - u - v)
    if hasattr(u, "ndim") and getattr(u, "ndim", 0) == a.ndim - 1:
        return w[..., None] * a + u[..., None] * b + v[..., None] * c
    return w * a + u * b + v * c


def prodsign(x, y):
    """sign-bit XOR: x with y's sign bit applied (common.impala:78-80)."""
    xi = jnp.asarray(x, jnp.float32).view(jnp.int32)
    yi = jnp.asarray(y, jnp.float32).view(jnp.int32)
    return (xi ^ (yi & jnp.int32(-2147483648))).view(jnp.float32)


def safe_rcp(x):
    """Reciprocal avoiding inf/NaN blowups near +-0 (common.impala:82-85).

    |x| < 1e-8 -> copysign(flt_max, x); else 1/x. Keeps the ray-box slab test
    well-defined for axis-parallel rays exactly like the reference.
    """
    x = jnp.asarray(x, jnp.float32)
    return jnp.where(jnp.abs(x) < 1e-8, prodsign(FLT_MAX, x), 1.0 / x)


def make_orthonormal_basis(n):
    """Branchless ONB from a (unit) normal, matching matrix.impala:29-39.

    Returns (t, b, n): tangent, bitangent, normal — the columns of the
    reference's make_orthonormal_mat3x3.
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = jnp.where(nz >= 0.0, jnp.float32(1.0), jnp.float32(-1.0))
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = vec3(1.0 + sign * nx * nx * a, sign * b, -sign * nx)
    bt = vec3(b, sign + ny * ny * a, -ny)
    return t, bt, n


def basis_mul(t, b, n, v):
    """Transforms local-space v into world space: t*v.x + b*v.y + n*v.z."""
    return t * v[..., 0:1] + b * v[..., 1:2] + n * v[..., 2:3]


def luminance(c):
    """Rec. 709 luminance (color.impala:33-35)."""
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722
