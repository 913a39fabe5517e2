"""Per-ray stack traversal as one Pallas kernel through Triton.

The GPU mapping of the reference (mapping_gpu.impala:94-178): one ray per
thread, a private stack, while-while traversal. One program walks BLOCK
rays (one warp); every ray keeps its state in registers for the whole
traversal, so a call is one kernel launch however many trips the walk
takes (the XLA engine in tiled.py pays several launches per trip).

- The node loop runs while any ray of the block holds an inner-node
  entry: one wide-node row gather and slab test per ray, children sorted
  by entry distance with the Batcher network (closest hit) or kept in
  slot order (any hit); the nearest child becomes the ray's next entry
  and the rest go on its stack, farthest first.
- The leaf loop runs while any ray holds a Tri packet entry: one Tri
  packet row gather and the sign-trick Moller-Trumbore over its M lanes
  (intersection.impala:164-192); multi-packet leaves continue in place.
- The per-ray stacks live in a scratch output laid out (S, N), so rays of
  one warp at the same depth touch adjacent words.

Tables are the bvh_to_device rows (nodes (N, 7A), tris (P, 14M)); the
visit order, the comparator network and the update rules are those of
api.traverse, so results agree with it hit for hit.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .api import BvhMeta, STACK_DEPTH, _SORT_NETWORKS

BLOCK = 32        # rays per program: one warp
NUM_WARPS = 1


def _any(mask):
    # Triton lowers max but not reduce_or
    return jnp.max(mask.astype(jnp.int32)) > 0


def _bits_i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, ix_ref, iy_ref,
            iz_ref, tmin_ref, tmax_ref, nodes_ref, tris_ref,
            t_ref, u_ref, v_ref, prim_ref, geom_ref, stack_ref,
            *, arity, m, depth, n_rays, any_hit):
    start = pl.program_id(0) * BLOCK
    blk = pl.ds(start, BLOCK)
    lane = start + jnp.arange(BLOCK, dtype=jnp.int32)
    org = (ox_ref[blk], oy_ref[blk], oz_ref[blk])
    dirv = (dx_ref[blk], dy_ref[blk], dz_ref[blk])
    inv_d = (ix_ref[blk], iy_ref[blk], iz_ref[blk])
    tmin = tmin_ref[blk]
    tmax = tmax_ref[blk]

    def push(pos, val, mask):
        pos = jnp.clip(pos, 0, depth - 1)
        plgpu.store(stack_ref.at[pos * n_rays + lane], val, mask=mask)

    def pop(sptr, mask):
        """Top entry where mask & sptr > 0 (0 elsewhere), new sptr."""
        can = mask & (sptr > 0)
        top = jnp.maximum(sptr - 1, 0)
        code = plgpu.load(stack_ref.at[top * n_rays + lane], mask=can,
                          other=0)
        return jnp.where(can, code, 0), jnp.where(mask, top, sptr)

    def node_body(c):
        code, sptr, t_cur, u, v, prim, geom = c
        is_node = code > 0
        nidx = jnp.where(is_node, code - 1, 0)

        def col(j):
            return plgpu.load(nodes_ref.at[nidx, j], mask=is_node,
                              other=0.0)

        children, entry, chit = [], [], []
        for s in range(arity):
            # (bound - org) * inv_dir: NaN-free for axis-aligned rays
            # (see api._node_test)
            tx0 = (col(0 * arity + s) - org[0]) * inv_d[0]
            tx1 = (col(1 * arity + s) - org[0]) * inv_d[0]
            ty0 = (col(2 * arity + s) - org[1]) * inv_d[1]
            ty1 = (col(3 * arity + s) - org[1]) * inv_d[1]
            tz0 = (col(4 * arity + s) - org[2]) * inv_d[2]
            tz1 = (col(5 * arity + s) - org[2]) * inv_d[2]
            ent = jnp.maximum(jnp.maximum(jnp.minimum(tx0, tx1),
                                          jnp.minimum(ty0, ty1)),
                              jnp.maximum(jnp.minimum(tz0, tz1), tmin))
            ext = jnp.minimum(jnp.minimum(jnp.maximum(tx0, tx1),
                                          jnp.maximum(ty0, ty1)),
                              jnp.minimum(jnp.maximum(tz0, tz1), t_cur))
            ch = _bits_i32(col(6 * arity + s))
            children.append(ch)
            entry.append(ent)
            chit.append((ent <= ext) & (ch != 0) & is_node)
        if not any_hit:
            keys = [jnp.where(chit[s], entry[s], jnp.inf)
                    for s in range(arity)]
            for i, j in _SORT_NETWORKS[arity]:
                swap = keys[i] > keys[j]
                keys[i], keys[j] = (jnp.where(swap, keys[j], keys[i]),
                                    jnp.where(swap, keys[i], keys[j]))
                children[i], children[j] = (
                    jnp.where(swap, children[j], children[i]),
                    jnp.where(swap, children[i], children[j]))
                chit[i], chit[j] = (jnp.where(swap, chit[j], chit[i]),
                                    jnp.where(swap, chit[i], chit[j]))
        k = chit[0].astype(jnp.int32)
        for s in range(1, arity):
            k = k + chit[s].astype(jnp.int32)
        # rank 0 (the nearest hit) is walked next; rank r >= 1 goes to
        # sptr + k - 1 - r, so rank 1 ends on top
        nearest = jnp.zeros_like(code)
        rank = jnp.zeros_like(code)
        for s in range(arity):
            nearest = jnp.where(chit[s] & (rank == 0), children[s], nearest)
            push(sptr + k - 1 - rank, children[s], chit[s] & (rank > 0))
            rank = rank + chit[s].astype(jnp.int32)
        popped, sptr_pop = pop(sptr, is_node & (k == 0))
        code = jnp.where(is_node, jnp.where(k > 0, nearest, popped), code)
        sptr = jnp.where(is_node & (k > 0), sptr + k - 1, sptr_pop)
        return code, sptr, t_cur, u, v, prim, geom

    def leaf_body(c):
        code, sptr, t_cur, u, v, prim, geom = c
        is_leaf = code < 0
        pidx = jnp.where(is_leaf, ~code, 0)

        def col(j):
            return plgpu.load(tris_ref.at[pidx, j], mask=is_leaf,
                              other=0.0)

        best = None
        for ln in range(m):
            v0 = [col(q * m + ln) for q in range(3)]
            e1 = [col((3 + q) * m + ln) for q in range(3)]
            e2 = [col((6 + q) * m + ln) for q in range(3)]
            nn = [col((9 + q) * m + ln) for q in range(3)]
            pid = _bits_i32(col(12 * m + ln))
            gid = _bits_i32(col(13 * m + ln))
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
                  & (abs_det != 0.0) & (tt >= abs_det * tmin)
                  & (tt <= abs_det * t_cur) & (pid != -1) & is_leaf)
            inv_det = 1.0 / jnp.where(abs_det != 0.0, abs_det, 1.0)
            cand = (jnp.where(ok, tt * inv_det, jnp.inf), uu * inv_det,
                    vv * inv_det, pid & 0x7FFFFFFF, gid)
            if best is None:
                best = cand
            else:
                take = cand[0] < best[0]
                best = tuple(jnp.where(take, a, b)
                             for a, b in zip(cand, best))
            if ln == m - 1:
                is_last = pid < 0
        bt, bu, bv, bp, bg = best
        upd = bt < jnp.inf
        t_cur = jnp.where(upd, bt, t_cur)
        u = jnp.where(upd, bu, u)
        v = jnp.where(upd, bv, v)
        prim = jnp.where(upd, bp, prim)
        geom = jnp.where(upd, bg, geom)
        done = is_leaf & is_last
        popped, sptr = pop(sptr, done)
        code = jnp.where(done, popped, jnp.where(is_leaf, code - 1, code))
        if any_hit:
            stop = prim >= 0
            code = jnp.where(stop, 0, code)
            sptr = jnp.where(stop, 0, sptr)
        return code, sptr, t_cur, u, v, prim, geom

    def walk(c):
        c = jax.lax.while_loop(lambda c: _any(c[0] > 0), node_body, c)
        return jax.lax.while_loop(lambda c: _any(c[0] < 0), leaf_body, c)

    zero = jnp.zeros((BLOCK,), jnp.int32)
    code0 = jnp.where(tmax >= tmin, 1, 0).astype(jnp.int32)
    c = (code0, zero, tmax, jnp.zeros_like(tmax), jnp.zeros_like(tmax),
         zero - 1, zero - 1)
    _, _, t, u, v, prim, geom = jax.lax.while_loop(
        lambda c: _any(c[0] != 0), walk, c)
    t_ref[blk] = t
    u_ref[blk] = u
    v_ref[blk] = v
    prim_ref[blk] = prim
    geom_ref[blk] = geom


def stack_depth(dev):
    """Per-ray stack entries the walk needs: the shared-stack worst case
    of the tree (it pushes at most what api.traverse pushes)."""
    meta = dev.get("meta")
    return (max(meta.shared_stack, 1) if isinstance(meta, BvhMeta)
            else STACK_DEPTH)


def traverse_walk_components(dev, org, dirv, inv_d, inv_o, tmin, tmax,
                             any_hit=False, interpret=False):
    """Same contract as tiled.traverse_components: Vec3 tuples of (R, 128)
    arrays in, hit dict of (R, 128) arrays out; rays with tmax < tmin
    are dead. inv_o is accepted for signature parity and unused.
    interpret=True runs the kernel in the Pallas interpreter (tests)."""
    shape = tmin.shape
    n = tmin.size
    arity = dev["nodes"].shape[1] // 7
    m = dev["tris"].shape[1] // 14
    depth = stack_depth(dev)
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((n,), jnp.int32)
    kernel = functools.partial(_kernel, arity=arity, m=m, depth=depth,
                               n_rays=n, any_hit=any_hit)
    rays = [x.reshape(-1) for x in (*org, *dirv, *inv_d, tmin, tmax)]
    t, u, v, prim, geom, _stack = pl.pallas_call(
        kernel,
        out_shape=(f32, f32, f32, i32, i32,
                   jax.ShapeDtypeStruct((depth * n,), jnp.int32)),
        grid=(n // BLOCK,),     # (R, 128) rows hold whole blocks
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="walk_traverse",
    )(*rays, dev["nodes"], dev["tris"])
    out = {"t": t, "u": u, "v": v, "prim_id": prim, "geom_id": geom}
    return {k: x.reshape(shape) for k, x in out.items()}
