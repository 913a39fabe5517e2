"""Ray reordering for incoherent workloads.

The reference's hybrid kernel handles divergence per-SIMD-packet
(mapping_cpu.impala:259-384); for megabatches the analog is *reordering*:
group rays so that neighbouring rays (one lockstep row, one warp of the
walk kernel) traverse similar node sets, which shortens the while-loop
tail and improves gather locality. Octant + origin-Morton sorting is the
classic ray-stream reordering (cf. PAPERS.md, "On Ray Reordering
Techniques for Faster GPU Ray Tracing").

sort_rays returns a permutation; callers traverse the permuted batch and
scatter results back (see tools/bench_traversal --sort).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def ray_octant(d):
    """Octant code from direction signs (intersection.impala
    ray_octant:128-132). d: (B, 3) or Vec3 tuple."""
    if isinstance(d, tuple):
        dx, dy, dz = d
    else:
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    return ((dx > 0).astype(jnp.int32)
            | ((dy > 0).astype(jnp.int32) << 1)
            | ((dz > 0).astype(jnp.int32) << 2))


def _morton10(x):
    """Spreads 10 bits to every 3rd bit (for 30-bit 3D Morton codes)."""
    x = x.astype(jnp.uint32) & 0x3FF
    x = (x | (x << 16)) & jnp.uint32(0x030000FF)
    x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
    x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x09249249)
    return x


def ray_sort_keys(org, d, scene_lo, scene_hi):
    """Sort key = coarse origin Morton (9 bits, 8^3 grid), then octant
    (3 bits), then direction Morton (20 bits). Origin-major groups rays
    from one scene cell; within a cell, octant+direction bits sort rays
    into compact cones. For same-origin primaries the org bits are
    constant, so the key degrades gracefully to pure octant+cone order."""
    if not isinstance(org, tuple):
        org = (org[:, 0], org[:, 1], org[:, 2])
    if not isinstance(d, tuple):
        dt = (d[:, 0], d[:, 1], d[:, 2])
    else:
        dt = d
    lo = jnp.asarray(scene_lo, jnp.float32)
    hi = jnp.asarray(scene_hi, jnp.float32)
    q = []
    for i in range(3):
        t = (org[i] - lo[i]) / jnp.maximum(hi[i] - lo[i], 1e-30)
        q.append(jnp.clip(t * 8.0, 0, 7).astype(jnp.uint32))
    org_m = ((_morton10(q[0]) | (_morton10(q[1]) << 1)
              | (_morton10(q[2]) << 2)) & 0x1FF)     # 9 bits
    inv_len = jax.lax.rsqrt(dt[0] * dt[0] + dt[1] * dt[1]
                            + dt[2] * dt[2] + 1e-30)
    qd = [jnp.clip((dt[i] * inv_len * 0.5 + 0.5) * 128.0, 0,
                   127).astype(jnp.uint32) for i in range(3)]
    dir_m = (_morton10(qd[0]) | (_morton10(qd[1]) << 1)
             | (_morton10(qd[2]) << 2))              # 21 bits
    oct_ = ray_octant(dt).astype(jnp.uint32)
    return (org_m << 23) | (oct_ << 20) | (dir_m >> 1)


def sort_rays(rays, scene_lo, scene_hi):
    """Returns (permuted rays dict, permutation) sorted by octant+Morton.
    Invert with results[argsort(perm)] or scatter back via perm."""
    keys = ray_sort_keys(rays["org"], rays["dir"], scene_lo, scene_hi)
    perm = jnp.argsort(keys)
    out = {k: v[perm] for k, v in rays.items()}
    return out, perm
