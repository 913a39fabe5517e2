"""Ray-triangle and ray-box primitives, batched over ray arrays.

Semantics mirror src/traversal/intersection.impala:
- Moller-Trumbore with precomputed edges and the sign-trick division
  deferral (intersect_ray_tri, :164-192): all comparisons happen on
  det-scaled values, one reciprocal at the end.
- slab ray-box test (intersect_ray_box, :194-208), unordered variant
  (octant-ordered loads are a CPU-SIMD trick; over batched arrays min/max
  pairs are one elementwise op each so ordering buys nothing).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.math import FLT_MAX, dot, prodsign, safe_rcp


def make_rays(org, dir, tmin, tmax):
    """Precomputes inv_dir/inv_org like make_ray (intersection.impala:92-103).
    Returns a dict of SoA arrays."""
    org = jnp.asarray(org, jnp.float32)
    dir = jnp.asarray(dir, jnp.float32)
    inv_dir = safe_rcp(dir)
    return {
        "org": org,
        "dir": dir,
        "inv_dir": inv_dir,
        "inv_org": -(org * inv_dir),
        "tmin": jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), org.shape[:-1]),
        "tmax": jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), org.shape[:-1]),
    }


def intersect_ray_tri(org, dir, tmin, tmax, v0, e1, e2, n):
    """Batched Moller-Trumbore. All inputs broadcast; the last axis is 3.

    Returns (hit_mask, t, u, v). Degenerate/out-of-range lanes report
    hit_mask=False with unspecified t/u/v.
    """
    c = v0 - org
    r = jnp.cross(dir, c)
    det = dot(n, dir)
    abs_det = jnp.abs(det)

    u = prodsign(dot(r, e2), det)
    v = prodsign(dot(r, e1), det)
    t = prodsign(dot(c, n), det)

    mask = (u >= 0.0) & (v >= 0.0) & (u + v <= abs_det)
    mask &= abs_det != 0.0
    mask &= (t >= abs_det * tmin) & (t <= abs_det * tmax)

    inv_det = 1.0 / jnp.where(abs_det != 0.0, abs_det, 1.0)
    return mask, t * inv_det, u * inv_det, v * inv_det


def intersect_ray_box(inv_dir, inv_org, tmin, tmax, lo, hi):
    """Batched slab test. lo/hi broadcast against inv_dir/inv_org; last
    axis is 3. Returns (entry, exit); hit iff entry <= exit."""
    t0 = inv_dir * lo + inv_org
    t1 = inv_dir * hi + inv_org
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    entry = jnp.maximum(jnp.maximum(tn[..., 0], tn[..., 1]),
                        jnp.maximum(tn[..., 2], tmin))
    exit_ = jnp.minimum(jnp.minimum(tf[..., 0], tf[..., 1]),
                        jnp.minimum(tf[..., 2], tmax))
    return entry, exit_


def intersect_ray_box_soa(inv_dir, inv_org, tmin, tmax, bounds):
    """Slab test against wide-node SoA bounds (..., 6, A): xmin, xmax,
    ymin, ymax, zmin, zmax — one test per child slot. Returns
    (entry, exit) of shape (..., A)."""
    idx = inv_dir[..., :, None]  # (..., 3, 1)
    iox = inv_org[..., :, None]
    t_lo = idx * bounds[..., 0::2, :] + iox  # (..., 3, A) using xmin,ymin,zmin
    t_hi = idx * bounds[..., 1::2, :] + iox
    tn = jnp.minimum(t_lo, t_hi)
    tf = jnp.maximum(t_lo, t_hi)
    entry = jnp.maximum(jnp.maximum(tn[..., 0, :], tn[..., 1, :]),
                        jnp.maximum(tn[..., 2, :], tmin[..., None]))
    exit_ = jnp.minimum(jnp.minimum(tf[..., 0, :], tf[..., 1, :]),
                        jnp.minimum(tf[..., 2, :], tmax[..., None]))
    return entry, exit_


def empty_hit(tmax):
    """Hit record for a miss (intersection.impala empty_hit)."""
    shape = jnp.shape(tmax)
    return {
        "t": jnp.asarray(tmax, jnp.float32),
        "u": jnp.zeros(shape, jnp.float32),
        "v": jnp.zeros(shape, jnp.float32),
        "prim_id": jnp.full(shape, -1, jnp.int32),
        "geom_id": jnp.full(shape, -1, jnp.int32),
    }


FLT_MAX = FLT_MAX
