"""Dense small-scene traversal: brute-force every Tri packet, no BVH walk.

For scenes of a few dozen triangles (cornell-class quality-gate scenes,
procedural fixtures), a BVH walk is mostly overhead: the lockstep XLA
engine pays per-iteration row gathers while the whole triangle set is
only a handful of Tri8 packets. This engine tests EVERY packet lane
against every ray as full-tile (R, 128) elementwise ops inside one
fori_loop over packets: zero gathers, no scalar per-ray work, ~50 vector
ops per triangle lane. Role model: the reference swaps traversal engines
under one API per scene/config (Embree fallback device,
src/driver/interface.cpp:650-658); the triangle test is the same
sign-trick Moller-Trumbore as every other engine
(src/traversal/intersection.impala:164-192), so hits are cross-checked
against api.traverse in tests (ids exact; t/u/v to float ULPs — XLA's
FMA contraction differs between program shapes).

Update rule: strict t < best, packets in ascending order, so the winner
is the closest hit, identical to the BVH engines except for exact-t ties
between distinct triangles (measure-zero for real scenes; the BVH
engines already differ among themselves there).

traversal.engine.select_engine picks it on the CPU for scenes with at
most DENSE_MAX_PACKETS Tri packets; it is pure XLA, so it runs on every
backend.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .tiled import _tile

# at 16 Tri8 packets (128 triangles) a dense pass is ~6K vector ops
DENSE_MAX_PACKETS = 16


def traverse_dense_components(dev, org, dirv, inv_d, inv_o, tmin, tmax,
                              any_hit=False):
    """Same contract as tiled.traverse_components: org/dirv are Vec3
    tuples of (R, 128) arrays, tmin/tmax (R, 128); returns the hit dict
    of (R, 128) arrays. Rays with tmax < tmin cannot pass the t-window
    test, so the dead-slot convention holds for free. inv_d/inv_o are
    accepted for signature parity and unused (no box tests here)."""
    tris = dev["tris"]
    P = tris.shape[0]
    m = tris.shape[1] // 14
    tris_i = jax.lax.bitcast_convert_type(tris, jnp.int32)

    def packet_step(p, carry):
        t_cur, u_b, v_b, p_b, g_b = carry
        row = jax.lax.dynamic_slice_in_dim(tris, p, 1)[0]      # (14m,)
        row_i = jax.lax.dynamic_slice_in_dim(tris_i, p, 1)[0]
        for lane in range(m):
            v0 = [row[k * m + lane] for k in range(3)]
            e1 = [row[(3 + k) * m + lane] for k in range(3)]
            e2 = [row[(6 + k) * m + lane] for k in range(3)]
            nn = [row[(9 + k) * m + lane] for k in range(3)]
            pid = row_i[12 * m + lane]
            gid = row_i[13 * m + lane]
            # sign-trick Moller-Trumbore, identical to the BVH engines
            # (tiled.py leaf unit / walk.py leaf loop)
            cx, cy, cz = v0[0] - org[0], v0[1] - org[1], v0[2] - org[2]
            rx = dirv[1] * cz - dirv[2] * cy
            ry = dirv[2] * cx - dirv[0] * cz
            rz = dirv[0] * cy - dirv[1] * cx
            det = nn[0] * dirv[0] + nn[1] * dirv[1] + nn[2] * dirv[2]
            abs_det = jnp.abs(det)
            sign = jnp.where(det < 0, jnp.float32(-1.0), jnp.float32(1.0))
            uu = (rx * e2[0] + ry * e2[1] + rz * e2[2]) * sign
            vv = (rx * e1[0] + ry * e1[1] + rz * e1[2]) * sign
            tt = (cx * nn[0] + cy * nn[1] + cz * nn[2]) * sign
            ok = ((uu >= 0.0) & (vv >= 0.0) & (uu + vv <= abs_det)
                  & (abs_det != 0.0)
                  & (tt >= abs_det * tmin) & (tt <= abs_det * t_cur)
                  & (pid != -1))
            inv_det = 1.0 / jnp.where(abs_det != 0.0, abs_det, 1.0)
            tv = tt * inv_det
            upd = ok & (tv < t_cur)
            t_cur = jnp.where(upd, tv, t_cur)
            u_b = jnp.where(upd, uu * inv_det, u_b)
            v_b = jnp.where(upd, vv * inv_det, v_b)
            p_b = jnp.where(upd, pid & 0x7FFFFFFF, p_b)
            g_b = jnp.where(upd, gid, g_b)
        return t_cur, u_b, v_b, p_b, g_b

    init = (tmax,
            jnp.zeros_like(tmax),
            jnp.zeros_like(tmax),
            jnp.full(tmax.shape, -1, jnp.int32),
            jnp.full(tmax.shape, -1, jnp.int32))
    # tiny packet counts unroll (cornell: 4 rounds of straight-line vector
    # ops, no loop overhead inside the renderer's while_loop); larger ones
    # roll into a fori_loop to bound compile size
    if P <= 4:
        carry = init
        for p in range(P):
            carry = packet_step(p, carry)
    else:
        carry = jax.lax.fori_loop(0, P, packet_step, init)
    t_cur, u_b, v_b, p_b, g_b = carry

    # miss semantics: t == original tmax (already true: t_cur starts at
    # tmax and only moves on hits)
    t_out = jnp.where(p_b < 0, tmax, t_cur)
    return {"t": t_out, "u": u_b, "v": v_b, "prim_id": p_b, "geom_id": g_b}


def traverse_dense(dev, rays, any_hit=False):
    """Row-layout wrapper; same contract as api.traverse."""
    B = rays["org"].shape[0]
    R = -(-B // 128)

    def t1(x):
        return _tile(x, R)

    org = tuple(t1(rays["org"][:, i]) for i in range(3))
    dirv = tuple(t1(rays["dir"][:, i]) for i in range(3))
    tmin = t1(rays["tmin"])
    tmax = t1(rays["tmax"])
    if R * 128 != B:
        pad_dead = _tile(jnp.ones(B, jnp.int32), R) == 0
        tmax = jnp.where(pad_dead, -1.0, tmax)
    out = traverse_dense_components(dev, org, dirv, None, None, tmin, tmax,
                                    any_hit=any_hit)

    def untile(x):
        return x.reshape(R * 128)[:B]

    out = {k: untile(v) for k, v in out.items()}
    out["t"] = jnp.where(out["prim_id"] < 0, rays["tmax"], out["t"])
    return out
