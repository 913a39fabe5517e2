"""Sampling routines matching src/core/random.impala:44-131, batched.

Each sampler takes uniform floats (already drawn by the caller so RNG
threading stays explicit) and returns direction + pdf. Directions are in
the local frame (z = up) as in the reference; callers transform with
core.vmath.basis_mul / core.math.basis_mul.

Two forms of each sampler:
- `*_c` returns the direction as a component tuple (x, y, z) of same-shape
  arrays — the production form used by render.bsdf / render.light (see
  core.vmath for why component layout is the fast one);
- the unsuffixed form stacks into a trailing-axis vec3 (scalar-model form,
  used by oracle tests). Both share the same math (the `_c` body).
"""
from __future__ import annotations

import jax.numpy as jnp

from .math import PI, luminance, vec3


def dir_from_polar(c, s, phi):
    """make_dir_sample direction: (s*cos(phi), s*sin(phi), c)."""
    return vec3(s * jnp.cos(phi), s * jnp.sin(phi), c)


def sample_triangle(u, v, v0, v1, v2):
    """Uniform point on a triangle (random.impala:49-59)."""
    flip = (u + v) > 1.0
    u = jnp.where(flip, 1.0 - u, u)
    v = jnp.where(flip, 1.0 - v, v)
    w = (1.0 - v - u)
    return w[..., None] * v0 + u[..., None] * v1 + v[..., None] * v2


def sample_triangle_c(u, v, v0, v1, v2):
    """Component-tuple sample_triangle: v0/v1/v2 are Vec3 tuples."""
    flip = (u + v) > 1.0
    u = jnp.where(flip, 1.0 - u, u)
    v = jnp.where(flip, 1.0 - v, v)
    w = 1.0 - u - v
    return tuple(w * a + u * b + v * c for a, b, c in zip(v0, v1, v2))


def uniform_sphere_pdf():
    return 1.0 / (4.0 * PI)


def sample_uniform_sphere_c(u, v):
    c = 2.0 * v - 1.0
    s = jnp.sqrt(jnp.maximum(1.0 - c * c, 0.0))
    phi = 2.0 * PI * u
    pdf = jnp.broadcast_to(jnp.float32(uniform_sphere_pdf()), jnp.shape(u))
    return (s * jnp.cos(phi), s * jnp.sin(phi), c), pdf


def sample_uniform_sphere(u, v):
    d, pdf = sample_uniform_sphere_c(u, v)
    return vec3(*d), pdf


def cosine_hemisphere_pdf(c):
    return c * (1.0 / PI)


def sample_cosine_hemisphere_c(u, v):
    c = jnp.sqrt(jnp.maximum(1.0 - v, 0.0))
    s = jnp.sqrt(v)
    phi = 2.0 * PI * u
    return (s * jnp.cos(phi), s * jnp.sin(phi), c), cosine_hemisphere_pdf(c)


def sample_cosine_hemisphere(u, v):
    d, pdf = sample_cosine_hemisphere_c(u, v)
    return vec3(*d), pdf


def cosine_power_hemisphere_pdf(c, k):
    return jnp.power(jnp.maximum(c, 0.0), k) * (k + 1.0) * (1.0 / (2.0 * PI))


def sample_cosine_power_hemisphere_c(k, u, v):
    """Cosine-power lobe sample (random.impala:90-101); pdf uses the
    v/c = cos^k identity so no pow() is evaluated at sample time."""
    c = jnp.minimum(jnp.power(v, 1.0 / (k + 1.0)), 1.0)
    s = jnp.sqrt(jnp.maximum(1.0 - c * c, 0.0))
    phi = 2.0 * PI * u
    pow_c_k = jnp.where(c != 0.0, v / jnp.where(c != 0.0, c, 1.0), 0.0)
    pdf = pow_c_k * (k + 1.0) * (1.0 / (2.0 * PI))
    return (s * jnp.cos(phi), s * jnp.sin(phi), c), pdf


def sample_cosine_power_hemisphere(k, u, v):
    d, pdf = sample_cosine_power_hemisphere_c(k, u, v)
    return vec3(*d), pdf


def russian_roulette(contrib, clamp=0.75):
    """Continuation probability = min(2 * luminance, clamp)
    (random.impala:128-131)."""
    return jnp.minimum(2.0 * luminance(contrib), clamp)
