"""BVH traversal over ray megabatches — the readable reference engine and
oracle, and the device table layout every engine shares.

Design (vs src/traversal/mapping_cpu.impala:138-384): rodent specializes
three SIMD mappings (single ray over child slots / ray packet over lanes /
hybrid switch). In plain jnp the natural mapping is one *megabatch* of
rays advanced in lockstep by a jax.lax.while_loop: every iteration, each live ray pops one entry off
its traversal stack and processes either one wide node (slab tests across
the N child slots, vectorized over the batch) or one Tri4 packet. Rays
idle once their stack empties; the loop ends when all stacks are empty.
Child ordering uses a small sort by entry distance — the data-parallel
equivalent of the reference's sorting-network stack sort
(src/traversal/stack.impala:59-123).

Table layout: nodes and triangle packets are packed into single flat
float rows (children bitcast into float lanes), so every per-ray fetch
is ONE flat row gather followed by cheap slices:

  node row  (arity A): [xmin*A | xmax*A | ymin*A | ymax*A | zmin*A |
                        zmax*A | child*A (i32 bitcast)]
  tri row   (TriM):    [v0x*M | v0y*M | v0z*M | e1x..e1z*M | e2x..e2z*M |
                        nx..nz*M | prim*M (i32) | geom*M (i32)]

The same function doubles as the "pure-XLA reference traversal" oracle
(SURVEY.md §4: the Embree-device role) — a brute-force all-triangles
intersector is also provided for small scenes.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .primitives import empty_hit, make_rays

# The reference uses a 64-deep stack (src/traversal/stack.impala:53); for
# the batched loop every stack column costs a (B, S) buffer pass per
# push, so we default to 32. The actual stack size is chosen per-BVH from
# the tree's worst-case requirement (BvhMeta, computed host-side in
# bvh_to_device), so overflow cannot occur; STACK_DEPTH is only the
# fallback for hand-built device dicts without metadata.
STACK_DEPTH = 32


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class BvhMeta:
    """Static (jit-invisible) per-BVH metadata.

    Registered as a static pytree node, so it rides inside the traced
    device dict while staying a plain Python value — traversal kernels use
    it to size their stacks at trace time. The reference's fixed 64-entry
    stack (src/traversal/stack.impala:53) can silently overflow on
    adversarially deep trees; computing the exact worst case at build time
    removes that failure mode at zero runtime cost.

    shared_stack: worst-case entries for a single mixed node/leaf stack
        (api.traverse, walk.py) assuming every child of every popped
        node is pushed and pop order is adversarial.
    node_stack: same for a node-only stack (tiled.py's dual-queue form,
        where leaf refs live on a separately-guarded stack).
    """
    shared_stack: int
    node_stack: int


def compute_stack_needs(child):
    """Worst-case traversal stack requirements for a BVH child table.

    child: (N, A) int32 — >0 inner (index+1), <0 leaf (~packet), 0 empty.
    Returns (shared_need, node_need) with the recurrence
        S(n) = max(1, max_i(S_desc[i] + k - 1 - i))
    over the k pushed children sorted by need descending (adversarial pop
    order upper bound for a LIFO stack); leaves need 1 slot on the shared
    stack (multi-packet continuations replace in place) and 0 on the node
    stack. Vectorized levelized sweep: each pass resolves every node whose
    inner children are all resolved, so passes == tree depth."""
    child = np.asarray(child)
    n, a = child.shape
    inner = child > 0
    leaf = child < 0
    idx = np.where(inner, child - 1, 0)
    NEG = np.int64(-1) << 40
    ar = np.arange(a, dtype=np.int64)[None, :]
    s_val = np.full(n, -1, np.int64)
    n_val = np.full(n, -1, np.int64)
    pend = np.ones(n, bool)
    while pend.any():
        child_s = np.where(inner, s_val[idx], 0)
        ready = pend & ~((inner & (child_s < 0)).any(axis=1))
        if not ready.any():
            raise ValueError("BVH child graph is not a tree")
        # shared stack: leaf slots need 1, inner slots their subtree need
        slot = np.where(leaf[ready], 1,
                        np.where(inner[ready], child_s[ready], NEG))
        k = (slot > NEG).sum(axis=1)[:, None]
        srt = -np.sort(-slot, axis=1)
        vals = np.where(ar < k, srt + (k - 1 - ar), NEG)
        s_val[ready] = np.maximum(vals.max(axis=1), 1)
        # node-only stack: leaf children are excluded entirely
        child_nv = np.where(inner, n_val[idx], 0)
        slot_n = np.where(inner[ready], child_nv[ready], NEG)
        kn = inner[ready].sum(axis=1)[:, None]
        srt_n = -np.sort(-slot_n, axis=1)
        vals_n = np.where(ar < kn, srt_n + (kn - 1 - ar), NEG)
        n_val[ready] = np.maximum(vals_n.max(axis=1), 1)
        pend &= ~ready
    return int(s_val[0]), int(n_val[0])


def _bitcast_f32(x):
    return jax.lax.bitcast_convert_type(x, jnp.float32)


def _bitcast_i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def bvh_to_device(bvh):
    """WideBvh (numpy) -> dict of flat-row jnp arrays for traverse()."""
    a = bvh.arity
    nn = bvh.num_nodes
    nodes = np.zeros((nn, 7 * a), np.float32)
    nodes[:, 0:6 * a] = bvh.bounds.reshape(nn, 6 * a)
    nodes[:, 6 * a:7 * a] = bvh.child.view(np.float32)

    m = bvh.packet
    np_ = bvh.num_packets
    tris = np.zeros((np_, 14 * m), np.float32)
    # (P, M, 3) -> [x*M | y*M | z*M] per vector
    for i, arr in enumerate((bvh.tri_v0, bvh.tri_e1, bvh.tri_e2, bvh.tri_n)):
        tris[:, i * 3 * m:(i + 1) * 3 * m] = (
            arr.transpose(0, 2, 1).reshape(np_, 3 * m))
    tris[:, 12 * m:13 * m] = bvh.prim_id.view(np.float32)
    tris[:, 13 * m:14 * m] = bvh.geom_id.view(np.float32)

    # arity/packet stay derivable from the static row widths (7A, 14M)
    # so they never become traced values under jit; "meta" is a static
    # pytree node (stack sizing data, no array leaves)
    s_need, n_need = compute_stack_needs(bvh.child)
    dev = {
        "nodes": jnp.asarray(nodes),
        "tris": jnp.asarray(tris),
        "meta": BvhMeta(shared_stack=s_need, node_stack=n_need),
    }
    # (the retired pair-kernel experiment lives in experiments/
    # pallas_pair.py and packs its own layouts via pair_device there)
    return dev


def _round_up(x, m):
    return (x + m - 1) // m * m


def _node_test(dev, rays, nidx, t_cur):
    """Gathers one node row per ray and slab-tests all child slots.
    Returns (children (B, A) i32, entry (B, A), hit mask (B, A))."""
    a = dev["nodes"].shape[1] // 7
    row = dev["nodes"][nidx]  # (B, 7A) single flat gather
    ix = rays["inv_dir"][:, 0:1]
    iy = rays["inv_dir"][:, 1:2]
    iz = rays["inv_dir"][:, 2:3]
    ox = rays["org"][:, 0:1]
    oy = rays["org"][:, 1:2]
    oz = rays["org"][:, 2:3]
    # (bound - org) * inv_dir, NOT bound*inv_dir + inv_org: safe_rcp
    # returns finite +-FLT_MAX for zero direction components, so this form
    # can overflow to +-inf but never produce (inf - inf) = NaN — NaN in
    # the slab min/max silently misses whole subtrees for axis-aligned
    # rays (same flop count: sub+mul vs mul+add)
    tx0 = (row[:, 0 * a:1 * a] - ox) * ix
    tx1 = (row[:, 1 * a:2 * a] - ox) * ix
    ty0 = (row[:, 2 * a:3 * a] - oy) * iy
    ty1 = (row[:, 3 * a:4 * a] - oy) * iy
    tz0 = (row[:, 4 * a:5 * a] - oz) * iz
    tz1 = (row[:, 5 * a:6 * a] - oz) * iz
    entry = jnp.maximum(jnp.maximum(jnp.minimum(tx0, tx1),
                                    jnp.minimum(ty0, ty1)),
                        jnp.maximum(jnp.minimum(tz0, tz1),
                                    rays["tmin"][:, None]))
    exit_ = jnp.minimum(jnp.minimum(jnp.maximum(tx0, tx1),
                                    jnp.maximum(ty0, ty1)),
                        jnp.minimum(jnp.maximum(tz0, tz1),
                                    t_cur[:, None]))
    children = _bitcast_i32(row[:, 6 * a:7 * a])
    hit = (entry <= exit_) & (children != 0)
    return children, entry, hit


def _leaf_test(dev, rays, pidx, t_cur):
    """Gathers one tri-packet row per ray and intersects its M lanes with
    the sign-trick Moller-Trumbore (intersection.impala:164-192).
    Returns per-lane (hit, t, u, v, prim, geom) plus the packet's is_last
    flag."""
    m = dev["tris"].shape[1] // 14
    row = dev["tris"][pidx]  # (B, 14M) single flat gather

    def v3(base):
        return (row[:, base:base + m], row[:, base + m:base + 2 * m],
                row[:, base + 2 * m:base + 3 * m])

    v0x, v0y, v0z = v3(0)
    e1x, e1y, e1z = v3(3 * m)
    e2x, e2y, e2z = v3(6 * m)
    nx, ny, nz = v3(9 * m)
    pid = _bitcast_i32(row[:, 12 * m:13 * m])
    gid = _bitcast_i32(row[:, 13 * m:14 * m])

    ox = rays["org"][:, 0:1]
    oy = rays["org"][:, 1:2]
    oz = rays["org"][:, 2:3]
    dx = rays["dir"][:, 0:1]
    dy = rays["dir"][:, 1:2]
    dz = rays["dir"][:, 2:3]

    cx, cy, cz = v0x - ox, v0y - oy, v0z - oz
    rx = dy * cz - dz * cy
    ry = dz * cx - dx * cz
    rz = dx * cy - dy * cx
    det = nx * dx + ny * dy + nz * dz
    abs_det = jnp.abs(det)
    sign = jnp.where(det < 0, jnp.float32(-1.0), jnp.float32(1.0))

    u = (rx * e2x + ry * e2y + rz * e2z) * sign
    v = (rx * e1x + ry * e1y + rz * e1z) * sign
    t = (cx * nx + cy * ny + cz * nz) * sign

    mask = (u >= 0.0) & (v >= 0.0) & (u + v <= abs_det)
    mask &= abs_det != 0.0
    mask &= (t >= abs_det * rays["tmin"][:, None])
    mask &= (t <= abs_det * t_cur[:, None])
    mask &= pid != -1

    inv_det = 1.0 / jnp.where(abs_det != 0.0, abs_det, 1.0)
    is_last = pid[:, m - 1] < 0
    return (mask, t * inv_det, u * inv_det, v * inv_det,
            pid & 0x7FFFFFFF, gid, is_last)


_SORT_NETWORKS = {
    # Batcher odd-even merge sorting networks (ascending), the data-parallel
    # analog of the reference's sorting-network stack sort
    # (src/core/sort.impala batcher_sort, src/traversal/stack.impala sort_n)
    2: [(0, 1)],
    4: [(0, 1), (2, 3), (0, 2), (1, 3), (1, 2)],
    8: [(0, 1), (2, 3), (4, 5), (6, 7),
        (0, 2), (1, 3), (4, 6), (5, 7),
        (1, 2), (5, 6),
        (0, 4), (1, 5), (2, 6), (3, 7),
        (2, 4), (3, 5),
        (1, 2), (3, 4), (5, 6)],
}


def _sort_by_key(keys, payloads, arity):
    """Sorts `arity` (B,) key columns ascending, permuting payload column
    lists the same way. All ops are elementwise selects, which fuse into
    the traversal body (jnp.argsort + take_along_axis would not)."""
    keys = list(keys)
    payloads = [list(p) for p in payloads]
    for i, j in _SORT_NETWORKS[arity]:
        swap = keys[i] > keys[j]
        ki = jnp.where(swap, keys[j], keys[i])
        kj = jnp.where(swap, keys[i], keys[j])
        keys[i], keys[j] = ki, kj
        for p in payloads:
            pi = jnp.where(swap, p[j], p[i])
            pj = jnp.where(swap, p[i], p[j])
            p[i], p[j] = pi, pj
    return keys, payloads


def traverse(dev, rays, any_hit=False, stack_depth=None):
    """Closest-hit (any_hit=False) or first-hit/occlusion (any_hit=True)
    traversal. rays: dict from make_rays with (B,)-batched fields.
    Returns hit dict {t, u, v, prim_id, geom_id} — prim_id == -1 on miss,
    t == original tmax on miss (empty_hit semantics).

    The loop body is two flat row gathers (node, tri packet) and
    otherwise pure elementwise ops — stack pop/push via one-hot masks
    over a (B, S) stack, child ordering via a static sorting network."""
    B = rays["org"].shape[0]
    arity = dev["nodes"].shape[1] // 7
    m = dev["tris"].shape[1] // 14
    meta = dev.get("meta")
    S = stack_depth or (max(meta.shared_stack, 4)
                        if isinstance(meta, BvhMeta) else STACK_DEPTH)

    stack = jnp.zeros((B, S), jnp.int32)
    stack = stack.at[:, 0].set(1)  # root node ref (1-based)
    sptr = jnp.ones((B,), jnp.int32)
    cols = jnp.arange(S, dtype=jnp.int32)[None, :]

    hit0 = empty_hit(rays["tmax"])

    def cond(state):
        return jnp.any(state["sptr"] > 0)

    def body(state):
        stack, sptr = state["stack"], state["sptr"]
        t_cur = state["t"]
        active = sptr > 0
        top = sptr - 1
        # one-hot pop
        code = jnp.sum(jnp.where(cols == top[:, None], stack, 0), axis=1)
        code = jnp.where(active, code, 0)
        sptr = jnp.where(active, top, sptr)

        is_node = code > 0
        is_leaf = code < 0

        # ---- wide node step: one flat gather + slab tests ----
        nidx = jnp.where(is_node, code - 1, 0)
        children, entry, chit = _node_test(dev, rays, nidx, t_cur)
        chit &= is_node[:, None]

        ch_cols = [children[:, i] for i in range(arity)]
        hit_cols = [chit[:, i] for i in range(arity)]
        if not any_hit:
            keys = [jnp.where(chit[:, i], entry[:, i], jnp.inf)
                    for i in range(arity)]
            _, (ch_cols, hit_cols) = _sort_by_key(
                keys, (ch_cols, hit_cols), arity)
        # after sorting, hits occupy ranks 0..k-1 (miss keys are +inf)
        k = sum(h.astype(jnp.int32) for h in hit_cols)
        new_sptr = sptr + jnp.where(is_node, k, 0)
        # push: nearest child must end on top: rank r -> column sptr+k-1-r
        rank = jnp.zeros_like(sptr)
        for i in range(arity):
            pos = sptr + k - 1 - rank
            write = hit_cols[i][:, None] & (cols == pos[:, None])
            stack = jnp.where(write, ch_cols[i][:, None], stack)
            rank = rank + hit_cols[i].astype(jnp.int32)
        sptr = new_sptr

        # ---- leaf (tri packet) step: one flat gather + M lane tests ----
        pidx = jnp.where(is_leaf, ~code, 0)
        lhit, lt, lu, lv, lprim, lgeom, is_last = _leaf_test(
            dev, rays, pidx, t_cur)
        lhit &= is_leaf[:, None]

        # best lane via pairwise min-select tree (no argmin/one-hot pick)
        bt = jnp.where(lhit, lt, jnp.inf)
        cand = [(bt[:, i], lt[:, i], lu[:, i], lv[:, i],
                 lprim[:, i], lgeom[:, i]) for i in range(m)]
        while len(cand) > 1:
            nxt = []
            for a, b in zip(cand[0::2], cand[1::2]):
                takeb = b[0] < a[0]
                nxt.append(tuple(
                    jnp.where(takeb, bv, av) for av, bv in zip(a, b)))
            if len(cand) % 2:
                nxt.append(cand[-1])
            cand = nxt
        bk, bt_, bu, bv_, bp, bg = cand[0]
        upd = jnp.isfinite(bk)
        t_cur = jnp.where(upd, bt_, t_cur)
        new = {
            "t": t_cur,
            "u": jnp.where(upd, bu, state["u"]),
            "v": jnp.where(upd, bv_, state["v"]),
            "prim_id": jnp.where(upd, bp, state["prim_id"]),
            "geom_id": jnp.where(upd, bg, state["geom_id"]),
        }

        # continue multi-packet leaves: next packet's code is code-1
        cont = is_leaf & ~is_last
        write = cont[:, None] & (cols == sptr[:, None])
        stack = jnp.where(write, code[:, None] - 1, stack)
        sptr = sptr + cont.astype(jnp.int32)

        if any_hit:
            # stop this ray as soon as anything is hit
            sptr = jnp.where(new["prim_id"] >= 0, 0, sptr)

        return {"stack": stack, "sptr": sptr, **new}

    state = {"stack": stack, "sptr": sptr, **hit0}
    state = jax.lax.while_loop(cond, body, state)
    return {k: state[k] for k in ("t", "u", "v", "prim_id", "geom_id")}


def occluded(dev, rays):
    """Any-hit query; returns a bool mask (True = blocked)."""
    hit = traverse(dev, rays, any_hit=True)
    return hit["prim_id"] >= 0


def intersect_bruteforce(dev, rays, any_hit=False):
    """O(B x T) all-triangles oracle (the 'Embree role' from SURVEY.md §4).
    Closest hit with lowest-t; ties broken by lowest packet/lane index."""
    P = dev["tris"].shape[0]
    m = dev["tris"].shape[1] // 14
    B = rays["org"].shape[0]

    def scan_packet(carry, row):
        t_best, u_b, v_b, p_b, g_b = carry
        # reuse _leaf_test with a 1-row table indexed at 0
        lhit, lt, lu, lv, lprim, lgeom, _ = _leaf_test(
            {"tris": row[None]}, rays, jnp.zeros(B, jnp.int32), t_best)
        t_masked = jnp.where(lhit, lt, jnp.inf)
        lane = jnp.argmin(t_masked, axis=1)
        lane_oh = lane[:, None] == jnp.arange(m)[None, :]
        upd = jnp.any(lhit, axis=1) & (
            jnp.min(t_masked, axis=1) < t_best)

        def pick(x):
            return jnp.sum(jnp.where(lane_oh, x, 0), axis=1)

        return ((jnp.where(upd, pick(lt), t_best),
                 jnp.where(upd, pick(lu), u_b),
                 jnp.where(upd, pick(lv), v_b),
                 jnp.where(upd, pick(lprim), p_b),
                 jnp.where(upd, pick(lgeom), g_b)), None)

    init = (rays["tmax"], jnp.zeros(B, jnp.float32),
            jnp.zeros(B, jnp.float32), jnp.full(B, -1, jnp.int32),
            jnp.full(B, -1, jnp.int32))
    (t, u, v, p, g), _ = jax.lax.scan(scan_packet, init, dev["tris"])
    return {"t": t, "u": u, "v": v, "prim_id": p, "geom_id": g}


__all__ = ["make_rays", "traverse", "occluded", "bvh_to_device",
           "intersect_bruteforce", "STACK_DEPTH", "BvhMeta",
           "compute_stack_needs"]
