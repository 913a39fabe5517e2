"""Tile-layout BVH traversal: the XLA engine.

Every per-ray scalar lives in (R, 128) component layout (B = R*128), and
the whole traversal is plain jnp/lax, so XLA compiles it for any backend:

- the traversal stacks are tuples of (R, 128) arrays (loop-carried
  pytree); pop/push are one-hot select chains that XLA fuses into single
  passes over the stack;
- node/tri fetches are single flat row gathers (B, 7A) / (B, 14M)
  followed by one transpose/reshape so each component is an (R, 128)
  slice;
- child ordering uses the Batcher sorting network on (R, 128) columns
  (the data-parallel analog of src/traversal/stack.impala sort_n).

Staged row compaction (compact_stages > 0): the lockstep loop pays
max-trips x full width while most rays are already done. Per-ray
compaction is unaffordable (~60 state arrays of 1D gathers per element),
but at 128-ray ROW granularity cone-sorted rays die together. Each
stage runs the while_loop until the live rows fit in half the width,
permutes live rows to the front (row gathers), retires the dead half's
hits, and statically re-traces the SAME body at half width — a cascade
of while_loops with static shapes, legal inside one jit (and inside the
renderer's persistent loop).

Semantics are identical to traversal.api.traverse (same reference
semantics: src/traversal/mapping_cpu.impala:138-384, intersection.impala
:164-208); api.traverse remains as the readable oracle and both are
cross-checked in tests.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


_NEG0 = jnp.int32(-2147483648)

# single source for the Batcher networks: api.py (the two engines are
# cross-checked oracles of each other, so their comparator tables must
# be the same object, not a copy)
from .api import _SORT_NETWORKS  # noqa: E402
# (B,) -> (R, 128) zero-padding lives in core.tiles; keep the local
# alias for the call sites here and in dense.py
from ..core.tiles import tile as _tile  # noqa: E402


NODE_STACK_DEPTH = 24
LEAF_STACK_DEPTH = 16

def _stage_loop(dev, rays, state, stop_rows, any_hit, S_N, S_L,
                debug_counters=False, ablate=(), fixed_iters=0):
    """One lockstep dual-queue while_loop at the current (static) width.
    Runs until fewer than `stop_rows` rows still have work (stop_rows=0:
    drain completely). rays is {"org": Vec3, "dir": Vec3, "inv_d": Vec3,
    "tmin": (R, 128)}; state is the traversal state pytree.

    Dual-queue form: inner-node refs and leaf-packet refs live on separate
    stacks and every loop iteration retires one of EACH per ray (one wide
    node test + one Tri4 packet test), so both row gathers do useful work
    every iteration — the lockstep analog of the reference's interleaved
    while-while traversal (mapping_gpu.impala:94-178). A ray's node unit
    stalls when its leaf stack could overflow (lptr > S_L - arity), which
    guarantees boundedness; leaves always drain, so progress is
    guaranteed."""
    org, dirv = rays["org"], rays["dir"]
    inv_d, tmin = rays["inv_d"], rays["tmin"]
    arity = dev["nodes"].shape[1] // 7
    m = dev["tris"].shape[1] // 14
    R = tmin.shape[0]
    zero = jnp.zeros((R, 128), jnp.int32)

    def gather_cols(table, idx):
        """Flat row gather + relayout to component-major (C, R, 128)."""
        rows = table[idx.reshape(R * 128)]                # (B', C)
        return rows.T.reshape(table.shape[1], R, 128)

    def pop(stack_list, ptr, can):
        top = ptr - 1
        if "nopop" in ablate:   # waterfall: one-hot select-chain cost
            code = jnp.where(can, stack_list[0], 0)
            return code, jnp.where(can, top, ptr)
        code = zero
        for i, slot in enumerate(stack_list):
            code = jnp.where(top == i, slot, code)
        code = jnp.where(can, code, 0)
        return code, jnp.where(can, top, ptr)

    def cond(s):
        if fixed_iters:
            # waterfall mode: run exactly fixed_iters trips so ablations share one pop schedule and
            # time deltas isolate per-trip cost components
            return s["iters"] < fixed_iters
        live = (s["nptr"] > 0) | (s["lptr"] > 0)
        if stop_rows <= 0:
            return jnp.any(live)
        n_live = jnp.sum(jnp.any(live, axis=1).astype(jnp.int32))
        return n_live > stop_rows

    def body(state):
        nstack = list(state["nstack"])
        lstack = list(state["lstack"])
        nptr, lptr = state["nptr"], state["lptr"]
        t_cur = state["t"]

        # ---- leaf-unit gate: leaf pops are a few per ray while node
        # pops are several times more, yet an ungated leaf unit runs its
        # tri-row gather + M-lane MT test EVERY iteration. Serve
        # the leaf unit only when the global backlog is worth a batch
        # (>= live/4) or when no node can progress without it (rays whose
        # node unit stalls on a near-full leaf stack — the progress
        # guarantee). lax.cond executes one branch, so gated-off
        # iterations skip the gather entirely.
        has_leaf = lptr > 0
        leaf_cnt = jnp.sum(has_leaf.astype(jnp.int32))
        live_cnt = jnp.sum(((nptr > 0) | has_leaf).astype(jnp.int32))
        node_ok = jnp.sum(((nptr > 0)
                           & (lptr + arity + 1 <= S_L)).astype(jnp.int32))
        do_leaf = (leaf_cnt * 4 >= live_cnt) | ((node_ok == 0)
                                                & (leaf_cnt > 0))
        if "leafalways" in ablate:    # waterfall: gate savings
            do_leaf = leaf_cnt >= 0
        elif "noleaf" in ablate:      # waterfall: whole leaf-unit cost
            do_leaf = leaf_cnt < 0    # (fixed_iters only: stalls rays)

        # ---- leaf unit (conditional): pop one packet per ray, gather its
        # tri rows, MT-test M lanes, write multi-packet continuations ----
        def leaf_unit(operand):
            lstack_t, lptr0, t0, u0, v0, p0, g0 = operand
            lstack_l = list(lstack_t)
            can_leaf = lptr0 > 0
            lcode, lptr1 = pop(lstack_l, lptr0, can_leaf)
            is_leaf = lcode < 0
            pidx = jnp.where(is_leaf, ~lcode, 0)
            if "trigatherfix" in ablate:  # waterfall: tri-gather cost
                pidx = jnp.zeros_like(pidx)
            tc = gather_cols(dev["tris"], pidx)     # (14M, R, 128)
            best = None
            for lane in range(m):
                v0x, v0y, v0z = tc[lane], tc[m + lane], tc[2 * m + lane]
                e1x, e1y, e1z = (tc[3 * m + lane], tc[4 * m + lane],
                                 tc[5 * m + lane])
                e2x, e2y, e2z = (tc[6 * m + lane], tc[7 * m + lane],
                                 tc[8 * m + lane])
                nx, ny, nz = (tc[9 * m + lane], tc[10 * m + lane],
                              tc[11 * m + lane])
                pid = jax.lax.bitcast_convert_type(tc[12 * m + lane],
                                                   jnp.int32)
                gid = jax.lax.bitcast_convert_type(tc[13 * m + lane],
                                                   jnp.int32)
                cx, cy, cz = v0x - org[0], v0y - org[1], v0z - org[2]
                rx = dirv[1] * cz - dirv[2] * cy
                ry = dirv[2] * cx - dirv[0] * cz
                rz = dirv[0] * cy - dirv[1] * cx
                det = nx * dirv[0] + ny * dirv[1] + nz * dirv[2]
                abs_det = jnp.abs(det)
                sign = jnp.where(det < 0, jnp.float32(-1.0),
                                 jnp.float32(1.0))
                u = (rx * e2x + ry * e2y + rz * e2z) * sign
                v = (rx * e1x + ry * e1y + rz * e1z) * sign
                t = (cx * nx + cy * ny + cz * nz) * sign
                ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= abs_det)
                      & (abs_det != 0.0)
                      & (t >= abs_det * tmin) & (t <= abs_det * t0)
                      & (pid != -1) & is_leaf)
                inv_det = 1.0 / jnp.where(abs_det != 0.0, abs_det, 1.0)
                key = jnp.where(ok, t * inv_det, jnp.inf)
                cand = (key, u * inv_det, v * inv_det,
                        pid & 0x7FFFFFFF, gid)
                if best is None:
                    best = cand
                else:
                    takeb = cand[0] < best[0]
                    best = tuple(jnp.where(takeb, c, b)
                                 for c, b in zip(cand, best))
                if lane == m - 1:
                    is_last = pid < 0

            bk, bu, bv, bp, bg = best
            upd = jnp.isfinite(bk)
            cont = is_leaf & ~is_last
            cont_pos = jnp.where(cont, lptr1, -1)
            if "nopush" not in ablate:
                for si in range(S_L):
                    lstack_l[si] = jnp.where(cont_pos == si, lcode - 1,
                                             lstack_l[si])
            return (tuple(lstack_l), lptr1 + cont.astype(jnp.int32),
                    jnp.where(upd, bk, t0), jnp.where(upd, bu, u0),
                    jnp.where(upd, bv, v0), jnp.where(upd, bp, p0),
                    jnp.where(upd, bg, g0))

        (lstack, lptr, t_cur, n_u, n_v, n_p, n_g) = jax.lax.cond(
            do_leaf, leaf_unit, lambda op: op,
            (tuple(lstack), lptr, t_cur, state["u"], state["v"],
             state["prim_id"], state["geom_id"]))
        lstack = list(lstack)
        new = {"t": t_cur, "u": n_u, "v": n_v, "prim_id": n_p,
               "geom_id": n_g}

        # ---- node unit: pop one inner node; stall if the leaf stack
        # could overflow this iteration (cont + arity pushes) ----
        can_node = (nptr > 0) & (lptr + arity + 1 <= S_L)
        ncode, nptr = pop(nstack, nptr, can_node)
        is_node = ncode > 0

        # ---- wide node test ----
        nidx = jnp.where(is_node, ncode - 1, 0)
        if "nodegatherfix" in ablate:     # waterfall: node-gather cost
            nidx = jnp.zeros_like(nidx)
        nc = gather_cols(dev["nodes"], nidx)        # (7A, R, 128)
        children = []
        entry = []
        chit = []
        for c in range(arity):
            # (bound - org) * inv_dir: NaN-free for axis-aligned rays
            # (see api._node_test)
            tx0 = (nc[0 * arity + c] - org[0]) * inv_d[0]
            tx1 = (nc[1 * arity + c] - org[0]) * inv_d[0]
            ty0 = (nc[2 * arity + c] - org[1]) * inv_d[1]
            ty1 = (nc[3 * arity + c] - org[1]) * inv_d[1]
            tz0 = (nc[4 * arity + c] - org[2]) * inv_d[2]
            tz1 = (nc[5 * arity + c] - org[2]) * inv_d[2]
            ent = jnp.maximum(jnp.maximum(jnp.minimum(tx0, tx1),
                                          jnp.minimum(ty0, ty1)),
                              jnp.maximum(jnp.minimum(tz0, tz1), tmin))
            ext = jnp.minimum(jnp.minimum(jnp.maximum(tx0, tx1),
                                          jnp.maximum(ty0, ty1)),
                              jnp.minimum(jnp.maximum(tz0, tz1), t_cur))
            ch = jax.lax.bitcast_convert_type(nc[6 * arity + c], jnp.int32)
            children.append(ch)
            entry.append(ent)
            chit.append((ent <= ext) & (ch != 0) & is_node)

        if not any_hit and "nosort" not in ablate:
            keys = [jnp.where(chit[i], entry[i], jnp.inf)
                    for i in range(arity)]
            for i, j in _SORT_NETWORKS[arity]:
                swap = keys[i] > keys[j]
                keys[i], keys[j] = (jnp.where(swap, keys[j], keys[i]),
                                    jnp.where(swap, keys[i], keys[j]))
                children[i], children[j] = (
                    jnp.where(swap, children[j], children[i]),
                    jnp.where(swap, children[i], children[j]))
                chit[i], chit[j] = (jnp.where(swap, chit[j], chit[i]),
                                    jnp.where(swap, chit[i], chit[j]))

        inner_hit = [chit[i] & (children[i] > 0) for i in range(arity)]
        leaf_hit = [chit[i] & (children[i] < 0) for i in range(arity)]
        k_n = inner_hit[0].astype(jnp.int32)
        k_l = leaf_hit[0].astype(jnp.int32)
        for i in range(1, arity):
            k_n = k_n + inner_hit[i].astype(jnp.int32)
            k_l = k_l + leaf_hit[i].astype(jnp.int32)

        # ---- leaf-stack writes: this node's leaf children (the popped
        # packet's continuation was written inside the leaf unit) ----
        lpos = []
        lvals = []
        lrank = zero
        for i in range(arity):
            lpos.append(jnp.where(leaf_hit[i], lptr + lrank, -1))
            lvals.append(children[i])
            lrank = lrank + leaf_hit[i].astype(jnp.int32)
        if "nopush" not in ablate:
            for si in range(S_L):
                v = lstack[si]
                for i in range(arity):
                    v = jnp.where(lpos[i] == si, lvals[i], v)
                lstack[si] = v
        lptr = lptr + jnp.where(is_node, k_l, 0)

        # ---- node-stack pushes: nearest inner child ends on top ----
        nrank = zero
        npos = []
        for i in range(arity):
            npos.append(jnp.where(inner_hit[i], nptr + k_n - 1 - nrank, -1))
            nrank = nrank + inner_hit[i].astype(jnp.int32)
        if "nopush" not in ablate:
            for si in range(S_N):
                v = nstack[si]
                for i in range(arity):
                    v = jnp.where(npos[i] == si, children[i], v)
                nstack[si] = v
        nptr = nptr + jnp.where(is_node, k_n, 0)

        if any_hit:
            done = new["prim_id"] >= 0
            nptr = jnp.where(done, 0, nptr)
            lptr = jnp.where(done, 0, lptr)

        out = {"nstack": tuple(nstack), "lstack": tuple(lstack),
               "nptr": nptr, "lptr": lptr, **new}
        if debug_counters:
            out["iters"] = state["iters"] + 1
            out["leaf_iters"] = state["leaf_iters"] + do_leaf.astype(
                jnp.int32)
            out["live_sum"] = state["live_sum"] + live_cnt.astype(
                jnp.float32)
        return out

    return jax.lax.while_loop(cond, body, state)


_HIT_KEYS = ("t", "u", "v", "prim_id", "geom_id")


def traverse_components(dev, org, dirv, inv_d, inv_o, tmin, tmax,
                        any_hit=False, stack_depth=None,
                        debug_counters=False, compact_stages=0,
                        ablate=(), fixed_iters=0, sub_batches=0):
    """Component-level traversal: org/dirv/inv_d/inv_o are Vec3 tuples of
    (R, 128) arrays, tmin/tmax (R, 128). Returns a hit dict of (R, 128)
    arrays {t, u, v, prim_id, geom_id}; rays with tmax < tmin are skipped
    (dead-slot convention used by the integrator).

    compact_stages > 0 enables staged row compaction (see module
    docstring): each stage drains until the live rows fit in half the
    width, then live rows are permuted to the front and the loop re-runs
    at half the (static) width. Rays should be cone-sorted so rows die
    together; results are identical (hits are scattered back to original
    rows). Incompatible with debug_counters.

    sub_batches=k > 1 splits the rows into k sequential chunks (lax.map:
    one compiled body) so the lockstep loop pays each chunk's OWN
    max-trips instead of the global max — the reference bounds the same
    tail per 16x16 tile (cpu_parallel_tiles, mapping_cpu.impala:3-33).
    Cone-sorted chunks tend to share the global max-trips, in which case
    chunking only adds lax.map serialization. Ignored when R is not
    divisible into chunks of >= 8 rows or under
    debug_counters/fixed_iters (schedule-pinned diagnostics)."""
    from .api import BvhMeta
    R_all = tmin.shape[0]
    if (sub_batches > 1 and R_all % sub_batches == 0
            and R_all // sub_batches >= 8 and not debug_counters
            and not fixed_iters):
        k = sub_batches

        def rs(x):
            return x.reshape(k, R_all // k, 128)

        def chunk(a):
            o, dv, iv, io_, tn, tx = a
            return traverse_components(
                dev, tuple(o), tuple(dv), tuple(iv), tuple(io_), tn, tx,
                any_hit=any_hit, stack_depth=stack_depth,
                compact_stages=compact_stages, ablate=ablate)

        out = jax.lax.map(chunk, (tuple(rs(c) for c in org),
                                  tuple(rs(c) for c in dirv),
                                  tuple(rs(c) for c in inv_d),
                                  tuple(rs(c) for c in inv_o),
                                  rs(tmin), rs(tmax)))
        return {kk: v.reshape(R_all, 128) for kk, v in out.items()}
    arity = dev["nodes"].shape[1] // 7
    # node stack sized to the tree's worst case (BvhMeta is a static pytree
    # node computed host-side in bvh_to_device) so pushes cannot be
    # silently dropped; shallow trees get a SMALLER stack than the old
    # fixed 24, which shrinks the one-hot select chains
    meta = dev.get("meta")
    S_N = stack_depth or (max(meta.node_stack, 4)
                          if isinstance(meta, BvhMeta) else NODE_STACK_DEPTH)
    S_L = LEAF_STACK_DEPTH
    R = tmin.shape[0]

    zero = jnp.zeros((R, 128), jnp.int32)
    live = tmax >= tmin
    nstack = (jnp.ones((R, 128), jnp.int32),) + (zero,) * (S_N - 1)
    lstack = (zero,) * S_L
    nptr = jnp.where(live, jnp.int32(1), jnp.int32(0))
    lptr = zero

    state = {
        "nstack": nstack, "lstack": lstack,
        "nptr": nptr, "lptr": lptr,
        "t": tmax,
        "u": jnp.zeros((R, 128), jnp.float32),
        "v": jnp.zeros((R, 128), jnp.float32),
        "prim_id": jnp.full((R, 128), -1, jnp.int32),
        "geom_id": jnp.full((R, 128), -1, jnp.int32),
    }
    if debug_counters:
        # iters: loop trips; leaf_iters: trips whose leaf unit fired;
        # live_sum: sum over trips of live-ray count (the pay-mean-not-max
        # headroom: work_done/B vs iters)
        state["iters"] = jnp.zeros((), jnp.int32)
        state["leaf_iters"] = jnp.zeros((), jnp.int32)
        state["live_sum"] = jnp.zeros((), jnp.float32)

    rays = {"org": org, "dir": dirv, "inv_d": inv_d, "tmin": tmin}

    if fixed_iters:
        assert debug_counters, "fixed_iters needs the iters counter"

    if compact_stages and not debug_counters and R >= 8:
        out = _traverse_staged(dev, rays, state, any_hit, S_N, S_L,
                               compact_stages)
        out["t"] = jnp.where(out["prim_id"] < 0, tmax, out["t"])
        return out

    state = _stage_loop(dev, rays, state, 0, any_hit, S_N, S_L,
                        debug_counters, ablate=ablate,
                        fixed_iters=fixed_iters)
    out = {k: state[k] for k in _HIT_KEYS}
    # miss semantics: t == original tmax
    out["t"] = jnp.where(out["prim_id"] < 0, tmax, out["t"])
    if debug_counters:
        out["counters"] = {k: state[k] for k in ("iters", "leaf_iters",
                                                 "live_sum")}
    return out


def _traverse_staged(dev, rays, state, any_hit, S_N, S_L, max_stages):
    """Staged-halving cascade: while_loops at R, R/2, R/4, ... widths with
    row compaction between stages. Returns the full-width hit dict in original row order."""
    R = state["nptr"].shape[0]
    row_ids = jnp.arange(R, dtype=jnp.int32)
    outs = {k: state[k] for k in _HIT_KEYS}   # misses stay as initialized

    width = R
    for _ in range(max_stages):
        next_w = width // 2
        if next_w < 8:
            break
        state = _stage_loop(dev, rays, state, next_w, any_hit, S_N, S_L)
        live_row = jnp.any((state["nptr"] > 0) | (state["lptr"] > 0),
                           axis=1)
        # live rows first; stable keeps the cone-sort order inside each
        # class, so compacted tiles remain coherent
        order = jnp.argsort(~live_row, stable=True)
        rays = jax.tree.map(lambda x: x[order], rays)
        state = jax.tree.map(lambda x: x[order], state)
        row_ids = row_ids[order]
        # retire the (all-dead) tail half: scatter its hits to original
        # rows, then statically slice everything to the front half
        tail_ids = row_ids[next_w:]
        for k in _HIT_KEYS:
            outs[k] = outs[k].at[tail_ids].set(state[k][next_w:])
        rays = jax.tree.map(lambda x: x[:next_w], rays)
        state = jax.tree.map(lambda x: x[:next_w], state)
        row_ids = row_ids[:next_w]
        width = next_w

    state = _stage_loop(dev, rays, state, 0, any_hit, S_N, S_L)
    for k in _HIT_KEYS:
        outs[k] = outs[k].at[row_ids].set(state[k])
    return outs


def traverse_tiled(dev, rays, any_hit=False, stack_depth=None,
                   debug_counters=False, compact_stages=0,
                   ablate=(), fixed_iters=0, sub_batches=0):
    """Row-layout wrapper over traverse_components; same contract as
    api.traverse.

    sub_batches=k > 1 splits the megabatch into k sequential chunks
    (lax.map over the leading axis: XLA compiles ONE chunk body).
    The lockstep loop pays max-trips x full width; with cone-sorted
    rays a chunk's rays share a trip-count neighborhood, so the tail
    beyond each chunk's own max is never paid by the other chunks —
    the reference pays this per 16x16 tile (cpu_parallel_tiles,
    render/mapping_cpu.impala:3-33); k bounds it at B/k rays.
    Composes with compact_stages (stage-halving inside each chunk)."""
    B = rays["org"].shape[0]
    R = -(-B // 128)

    def t1(x):
        return _tile(x, R)

    org = tuple(t1(rays["org"][:, i]) for i in range(3))
    dirv = tuple(t1(rays["dir"][:, i]) for i in range(3))
    inv_d = tuple(t1(rays["inv_dir"][:, i]) for i in range(3))
    inv_o = tuple(t1(rays["inv_org"][:, i]) for i in range(3))
    tmin = t1(rays["tmin"])
    tmax = t1(rays["tmax"])
    if R * 128 != B:
        pad_dead = _tile(jnp.ones(B, jnp.int32), R) == 0
        tmax = jnp.where(pad_dead, -1.0, tmax)

    out = traverse_components(dev, org, dirv, inv_d, inv_o, tmin,
                              tmax, any_hit=any_hit,
                              stack_depth=stack_depth,
                              debug_counters=debug_counters,
                              compact_stages=compact_stages,
                              ablate=ablate, fixed_iters=fixed_iters,
                              sub_batches=sub_batches)
    counters = out.pop("counters", None)

    def untile(x):
        return x.reshape(R * 128)[:B]

    out = {k: untile(v) for k, v in out.items()}
    out["t"] = jnp.where(out["prim_id"] < 0, rays["tmax"], out["t"])
    if counters is not None:
        out["counters"] = counters
    return out


def occluded_tiled(dev, rays):
    hit = traverse_tiled(dev, rays, any_hit=True)
    return hit["prim_id"] >= 0
