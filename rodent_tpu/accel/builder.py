"""Host-side BVH construction: binned-SAH binary build + wide-node collapse.

Reimplements the role of the reference's SplitBvhBuilder + MultiNode
collapse (src/driver/bvh.h:44-246) with the same output conventions
(BvhNTriMAdapter, src/driver/converter.cpp:97-260):

- top-down SAH with the same cost model (leaf = count*area,
  traversal = area, converter.cpp:121-128);
- binary splits collapsed into N-wide nodes, expanding the
  largest-surface-area child first (bvh.h MultiNode::add/select_child);
- identical node/tri packet encoding (see accel.layout).

This Python/numpy implementation is the portable fallback; the C++
builder in rodent_tpu/native implements the same algorithm (plus spatial
splits) for production scene sizes and is used automatically when built.
"""
from __future__ import annotations

import numpy as np

from .layout import WideBvh

_INF = np.float32(np.inf)


def _half_area(lo, hi):
    e = np.maximum(hi - lo, 0.0)
    return e[..., 0] * (e[..., 1] + e[..., 2]) + e[..., 1] * e[..., 2]


def _native_build(vertices, indices, arity, packet, leaf_threshold,
                  quality, leaf_cost):
    from .. import native
    if not native.available():
        return None
    if indices.ndim == 1:
        idx4 = indices.reshape(-1, 4)
    elif indices.shape[1] == 4:
        idx4 = indices
    else:
        idx4 = np.concatenate(
            [indices[:, :3],
             np.zeros((len(indices), 1), np.int32)], axis=1)
    out = native.bvh_build(vertices, idx4, arity=arity, packet=packet,
                           leaf_threshold=leaf_threshold, quality=quality,
                           leaf_cost=leaf_cost)
    if out is None:
        return None
    bounds, child, tv0, te1, te2, tn, pid, gid = out
    return WideBvh(arity=arity, packet=packet, bounds=bounds, child=child,
                   tri_v0=tv0, tri_e1=te1, tri_e2=te2, tri_n=tn,
                   prim_id=pid, geom_id=gid)


class _BinaryBvh:
    """Flat binary BVH: per-node (bbox_lo, bbox_hi, left, right, start,
    count). Inner nodes have count == -1; leaves reference [start,
    start+count) in the permuted triangle order."""

    __slots__ = ("lo", "hi", "left", "right", "start", "count", "order", "n")

    def __init__(self, cap, order):
        self.lo = np.empty((cap, 3), np.float32)
        self.hi = np.empty((cap, 3), np.float32)
        self.left = np.full(cap, -1, np.int32)
        self.right = np.full(cap, -1, np.int32)
        self.start = np.full(cap, -1, np.int64)
        self.count = np.full(cap, -1, np.int64)
        self.order = order
        self.n = 0

    def alloc(self):
        i = self.n
        self.n += 1
        return i


def _build_binary(tri_lo, tri_hi, centers, leaf_threshold=4, max_leaf=0x7FFFFFFF,
                  num_bins=16):
    """Binned SAH over centroids. Returns a _BinaryBvh."""
    n = len(centers)
    order = np.arange(n, dtype=np.int64)
    bvh = _BinaryBvh(max(2 * n, 1), order)
    root = bvh.alloc()
    # worklist of (node_idx, start, end)
    stack = [(root, 0, n)]
    while stack:
        node, start, end = stack.pop()
        ids = order[start:end]
        lo = tri_lo[ids].min(axis=0)
        hi = tri_hi[ids].max(axis=0)
        bvh.lo[node] = lo
        bvh.hi[node] = hi
        count = end - start

        def make_leaf():
            bvh.start[node] = start
            bvh.count[node] = count

        if count <= leaf_threshold:
            make_leaf()
            continue

        c = centers[ids]
        clo = c.min(axis=0)
        chi = c.max(axis=0)
        ext = chi - clo
        axis = int(np.argmax(ext))
        if ext[axis] <= 0.0:
            # all centroids identical: split in half by index
            mid = start + count // 2
            if count > max_leaf:
                pass  # force the split below
            else:
                make_leaf()
                continue
            l, r = bvh.alloc(), bvh.alloc()
            bvh.left[node], bvh.right[node] = l, r
            stack.append((l, start, mid))
            stack.append((r, mid, end))
            continue

        # binned SAH on the widest centroid axis
        scale = num_bins / ext[axis]
        bins = np.minimum(((c[:, axis] - clo[axis]) * scale).astype(np.int32),
                          num_bins - 1)
        bin_lo = np.full((num_bins, 3), _INF, np.float32)
        bin_hi = np.full((num_bins, 3), -_INF, np.float32)
        bin_cnt = np.zeros(num_bins, np.int64)
        np.minimum.at(bin_lo, bins, tri_lo[ids])
        np.maximum.at(bin_hi, bins, tri_hi[ids])
        np.add.at(bin_cnt, bins, 1)

        # sweep: cost(i) = area_left(i)*n_left(i) + area_right(i)*n_right(i)
        lacc_lo = np.minimum.accumulate(bin_lo, axis=0)
        lacc_hi = np.maximum.accumulate(bin_hi, axis=0)
        racc_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
        racc_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
        lcnt = np.cumsum(bin_cnt)
        rcnt = count - lcnt
        la = _half_area(lacc_lo, lacc_hi)[:-1]
        ra = _half_area(racc_lo, racc_hi)[1:]
        cost = la * lcnt[:-1] + ra * rcnt[:-1]
        valid = (lcnt[:-1] > 0) & (rcnt[:-1] > 0)
        if not valid.any():
            if count <= max_leaf:
                make_leaf()
            else:
                mid = start + count // 2
                l, r = bvh.alloc(), bvh.alloc()
                bvh.left[node], bvh.right[node] = l, r
                stack.append((l, start, mid))
                stack.append((r, mid, end))
            continue
        cost = np.where(valid, cost, _INF)
        best = int(np.argmin(cost))
        # leaf if unsplit is cheaper (cost model: converter.cpp CostFn +
        # bvh.h traversal_cost(area) overhead)
        leaf_cost = _half_area(lo[None], hi[None])[0] * count
        split_cost = cost[best] + _half_area(lo[None], hi[None])[0]
        if count <= max_leaf and leaf_cost <= split_cost and count <= 64:
            make_leaf()
            continue

        mask = bins <= best
        left_ids = ids[mask]
        right_ids = ids[~mask]
        order[start:start + len(left_ids)] = left_ids
        order[start + len(left_ids):end] = right_ids
        mid = start + len(left_ids)
        l, r = bvh.alloc(), bvh.alloc()
        bvh.left[node], bvh.right[node] = l, r
        stack.append((l, start, mid))
        stack.append((r, mid, end))
    return bvh


C_NODE = 1.0   # cost of one wide-node pop
C_LEAF = 1.2   # cost of one leaf-packet pop (heavier lane math, measured)
MAX_LEAF_PACKETS = 8


def _collapse_wide_dp(bin_bvh, arity, packet, leaf_cost=C_LEAF):
    """Slot-constrained DP collapse (the Ylitie-et-al.-2017 'optimal wide
    BVH' formulation) under the packet kernel's cost model: every pop
    costs ~the same whether it tests 8 child boxes or one 8-triangle
    packet, so E[pops] = sum over wide nodes of area_frac * C_NODE +
    sum over leaf packets of area_frac * C_LEAF is the thing to minimize.
    The reference's greedy largest-area MultiNode collapse (bvh.h:44-96)
    leaves ~40%% of child slots empty (measured 4.76/8 mean on the hall
    SBVH); the DP trades those empty lanes for fewer, fuller nodes.

    C(b, i) = min cost of the subtree at b occupying i slots of its
    parent wide node:
      D(b, i) = min_j C(l, j) + C(r, i-j)         (i >= 2)
      C(b, 1) = min(leaf(b), area*C_NODE + D(b, arity))
      C(b, i) = min(C(b, i-1), D(b, i))
    leaf(b) = area * C_LEAF * ceil(count/packet), allowed while count <=
    MAX_LEAF_PACKETS*packet (subtree ranges are contiguous in `order`).

    Returns (nodes_children, links) with the same contract as the greedy
    collapse (entries reference binary node ids for their bounds)."""
    n = bin_bvh.n
    A = arity
    area = _half_area(bin_bvh.lo[:n], bin_bvh.hi[:n]).astype(np.float64)
    left = bin_bvh.left[:n]
    right = bin_bvh.right[:n]
    is_leaf = bin_bvh.count[:n] >= 0

    # subtree ranges + counts (leaves carry start/count; inners = union,
    # contiguous because splits partition `order` in place)
    start = np.where(is_leaf, bin_bvh.start[:n], np.int64(2 ** 62))
    end = np.where(is_leaf, bin_bvh.start[:n] + bin_bvh.count[:n],
                   np.int64(-1))

    INFC = np.float64(np.inf)
    C = np.full((n, A + 1), INFC)
    D = np.full((n, A + 1), INFC)
    dj = np.zeros((n, A + 1), np.int8)      # winning j for D(b, i)
    as_leaf = np.zeros(n, bool)             # C(b,1) decision

    resolved = is_leaf.copy()
    cnt_leaf = np.where(is_leaf, bin_bvh.count[:n], 0)
    cl = area * leaf_cost * np.ceil(cnt_leaf / packet)
    C[is_leaf, 1:] = cl[is_leaf, None]
    as_leaf[is_leaf] = True

    pend = ~resolved
    while pend.any():
        ready = pend & resolved[left] & resolved[right]
        if not ready.any():
            raise RuntimeError("collapse DP: cyclic binary BVH")
        ri = np.nonzero(ready)[0]
        l, r = left[ri], right[ri]
        start[ri] = np.minimum(start[l], start[r])
        end[ri] = np.maximum(end[l], end[r])
        cnt = (end[ri] - start[ri])
        for i in range(2, A + 1):
            # candidates over j = 1..i-1
            cand = np.stack([C[l, j] + C[r, i - j]
                             for j in range(1, i)], axis=0)
            bj = np.argmin(cand, axis=0)
            D[ri, i] = cand[bj, np.arange(len(ri))]
            dj[ri, i] = (bj + 1).astype(np.int8)
        leaf_c = np.where(
            cnt <= MAX_LEAF_PACKETS * packet,
            area[ri] * leaf_cost * np.ceil(cnt / packet), INFC)
        node_cost = area[ri] * C_NODE + D[ri, A]
        C[ri, 1] = np.minimum(leaf_c, node_cost)
        as_leaf[ri] = leaf_c <= node_cost
        for i in range(2, A + 1):
            C[ri, i] = np.minimum(C[ri, i - 1], D[ri, i])
        resolved[ri] = True
        pend[ri] = False

    # reconstruction: expand(b, i) -> list of slot-binary-nodes, where a
    # slot either becomes a leaf (its whole contiguous range) or a child
    # wide node
    def slots_of(b):
        out = []
        stack = [(b, A)]
        while stack:
            m, i = stack.pop()
            # i slots granted; did C(m, i) come from using fewer?
            while i > 1 and C[m, i] == C[m, i - 1]:
                i -= 1
            if i == 1 or is_leaf[m]:
                out.append(m)
                continue
            j = int(dj[m, i])
            stack.append((right[m], i - j))
            stack.append((left[m], j))
        return out

    if as_leaf[0]:
        # whole scene cheapest as one leaf chain: single wide node
        return [[("leaf", int(start[0]), int(end[0] - start[0]), 0)]], {}

    nodes_children = []
    links = {}

    def emit(b):
        idx = len(nodes_children)
        nodes_children.append(None)
        slots = slots_of(b)
        if len(slots) == 1 and slots[0] == b and not is_leaf[b]:
            # degenerate fixed point (coincident zero-area subtree: every
            # cost is 0, the tie-collapse returns the node itself) —
            # force a binary expansion so the recursion descends; same
            # guard as the native builder
            slots = [int(left[b]), int(right[b])]
        entries = []
        for m in slots:
            if is_leaf[m] or as_leaf[m]:
                entries.append(("leaf", int(start[m]),
                                int(end[m] - start[m]), int(m)))
            else:
                entries.append(("node", int(m), 0, int(m)))
        nodes_children[idx] = entries
        return idx, entries

    root_idx, root_entries = emit(0)
    work = [(root_idx, root_entries)]
    while work:
        widx, entries = work.pop()
        for slot, e in enumerate(entries):
            if e[0] == "node":
                cidx, centries = emit(e[1])
                links[(widx, slot)] = cidx
                work.append((cidx, centries))
    return nodes_children, links


def _collapse_wide(bin_bvh, arity):
    """Collapses a binary BVH into N-wide nodes, expanding the child with
    the largest surface area first (bvh.h MultiNode semantics). Returns
    (wide_children, wide_bboxes, leaf_ranges):
      wide nodes as a list of lists of entries; each entry is
      ('node', wide_idx) / ('leaf', start, count) plus its bbox.
    Emission order is depth-first like the reference's NodeWriter."""
    # Each wide node is discovered from a binary node. Children of the wide
    # node: collapse binary subtree until `arity` leaves-of-the-collapse.
    area = _half_area(bin_bvh.lo[:bin_bvh.n], bin_bvh.hi[:bin_bvh.n])

    def collapse_children(b):
        group = [b]
        while len(group) < arity:
            # pick expandable (inner) member with largest area
            best, best_area = -1, -1.0
            for gi, m in enumerate(group):
                if bin_bvh.count[m] < 0 and area[m] > best_area:
                    best, best_area = gi, area[m]
            if best < 0:
                break
            m = group.pop(best)
            group.append(bin_bvh.left[m])
            group.append(bin_bvh.right[m])
        return group

    # BFS/DFS emit wide nodes
    nodes_children = []  # per wide node: list of ('leaf'/'node', payload, bin_id)
    wide_of_binary = {}

    def emit(b):
        idx = len(nodes_children)
        nodes_children.append(None)
        group = collapse_children(b)
        entries = []
        for m in group:
            if bin_bvh.count[m] >= 0:
                entries.append(("leaf", int(bin_bvh.start[m]),
                                int(bin_bvh.count[m]), m))
            else:
                entries.append(("node", m, 0, m))
        nodes_children[idx] = entries
        return idx, entries

    # iterative DFS so child wide nodes are emitted after their parents
    root_idx, root_entries = emit(0)
    stack = [(root_idx, root_entries)]
    links = {}  # (wide_idx, slot) -> child wide idx
    while stack:
        widx, entries = stack.pop()
        for slot, e in enumerate(entries):
            if e[0] == "node":
                cidx, centries = emit(e[1])
                links[(widx, slot)] = cidx
                stack.append((cidx, centries))
    return nodes_children, links


def build_bvh(vertices, indices, arity=8, packet=4, leaf_threshold=4,
              use_native=True, quality=1, leaf_cost=0.0):
    """Builds a WideBvh from a triangle soup.

    vertices: (V, 3) f32; indices: flat i32, 4 per tri (v0, v1, v2, mat) —
    the reference's index convention — or (T, 3) with geom_ids implied 0.
    Uses the C++ builder (rodent_tpu/native) when available; the numpy
    implementation below is the portable fallback and the oracle the
    native one is tested against. quality=1 (default) builds an SBVH
    (sweep SAH + spatial splits + unsplitting, the reference
    SplitBvhBuilder tier, src/driver/bvh.h:102-539); quality=0 is the
    faster binned-SAH build for huge scenes. leaf_cost > 0 overrides the
    DP collapse's C_LEAF ratio (leaf-packet pop vs node pop, default
    1.2); a higher ratio trades node pops for fewer, smaller-area leaf
    packets.
    """
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    if use_native:
        out = _native_build(vertices, indices, arity, packet,
                            leaf_threshold, quality, leaf_cost)
        if out is not None:
            return out
    if indices.ndim == 1:
        idx4 = indices.reshape(-1, 4)
        tri_idx = idx4[:, :3].astype(np.int64)
        geom_ids = idx4[:, 3].astype(np.int32)
    else:
        tri_idx = indices[:, :3].astype(np.int64)
        geom_ids = (indices[:, 3].astype(np.int32) if indices.shape[1] > 3
                    else np.zeros(len(indices), np.int32))

    v0 = vertices[tri_idx[:, 0]]
    v1 = vertices[tri_idx[:, 1]]
    v2 = vertices[tri_idx[:, 2]]
    tri_lo = np.minimum(np.minimum(v0, v1), v2)
    tri_hi = np.maximum(np.maximum(v0, v1), v2)
    centers = (tri_lo + tri_hi) * 0.5

    num_tris = len(tri_idx)
    if num_tris == 0:
        raise ValueError("empty mesh")

    # build the binary tree finer than the target leaves: the DP collapse
    # decides the final leaf cuts, so deeper binary = more freedom
    bin_bvh = _build_binary(tri_lo, tri_hi, centers,
                            leaf_threshold=min(max(2, packet // 2),
                                               max(leaf_threshold, 2)))

    # Handle a root that is itself a leaf: the traversal convention needs at
    # least one wide node; make a single wide node whose slot 0 is the leaf.
    order = bin_bvh.order
    if bin_bvh.count[0] >= 0:
        nodes_children = [[("leaf", 0, int(bin_bvh.count[0]), 0)]]
        links = {}
    else:
        nodes_children, links = _collapse_wide_dp(
            bin_bvh, arity, packet,
            leaf_cost if leaf_cost > 0 else C_LEAF)

    num_nodes = len(nodes_children)
    bounds = np.empty((num_nodes, 6, arity), np.float32)
    bounds[:, 0::2, :] = _INF
    bounds[:, 1::2, :] = -_INF
    child = np.zeros((num_nodes, arity), np.int32)

    packets_v0, packets_e1, packets_e2, packets_n = [], [], [], []
    packets_pid, packets_gid = [], []

    for widx, entries in enumerate(nodes_children):
        for slot, e in enumerate(entries):
            kind, a, b_, m = e
            bounds[widx, 0, slot] = bin_bvh.lo[m, 0]
            bounds[widx, 1, slot] = bin_bvh.hi[m, 0]
            bounds[widx, 2, slot] = bin_bvh.lo[m, 1]
            bounds[widx, 3, slot] = bin_bvh.hi[m, 1]
            bounds[widx, 4, slot] = bin_bvh.lo[m, 2]
            bounds[widx, 5, slot] = bin_bvh.hi[m, 2]
            if kind == "node":
                child[widx, slot] = links[(widx, slot)] + 1
            else:
                start, count = a, b_
                first_packet = len(packets_pid)
                child[widx, slot] = ~first_packet
                ids = order[start:start + count]
                for i in range(0, count, packet):
                    lane_ids = ids[i:i + packet]
                    c = len(lane_ids)
                    pv0 = np.zeros((packet, 3), np.float32)
                    pe1 = np.zeros((packet, 3), np.float32)
                    pe2 = np.zeros((packet, 3), np.float32)
                    pn = np.zeros((packet, 3), np.float32)
                    pid = np.full(packet, -1, np.int32)
                    gid = np.zeros(packet, np.int32)
                    pv0[:c] = v0[lane_ids]
                    pe1[:c] = v0[lane_ids] - v1[lane_ids]
                    pe2[:c] = v2[lane_ids] - v0[lane_ids]
                    pn[:c] = np.cross(pe1[:c], pe2[:c])
                    pid[:c] = lane_ids
                    gid[:c] = geom_ids[lane_ids]
                    packets_v0.append(pv0)
                    packets_e1.append(pe1)
                    packets_e2.append(pe2)
                    packets_n.append(pn)
                    packets_pid.append(pid)
                    packets_gid.append(gid)
                # mark last packet of the leaf (converter.cpp:258)
                packets_pid[-1][packet - 1] = np.int32(
                    packets_pid[-1][packet - 1] | np.int32(-0x80000000))

    return WideBvh(
        arity=arity, packet=packet,
        bounds=bounds, child=child,
        tri_v0=np.stack(packets_v0), tri_e1=np.stack(packets_e1),
        tri_e2=np.stack(packets_e2), tri_n=np.stack(packets_n),
        prim_id=np.stack(packets_pid), geom_id=np.stack(packets_gid))
