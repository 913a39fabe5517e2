// Native BVH builder, two quality tiers:
//   quality=1 (default): SBVH — sweep-SAH object splits, 96-bin spatial
//     splits with a refinement pass, and reference unsplitting
//     (the algorithm class of the reference's SplitBvhBuilder,
//     src/driver/bvh.h:102-539, after Stich et al. 2009).
//   quality=0: binned-SAH binary build (fast path for huge scenes /
//     build-time-sensitive callers).
// Both tiers build a fine binary tree and collapse it into N-wide nodes
// with the slot-constrained DP (Ylitie et al. 2017) under a pop-cost
// model — see dp_collapse_emit below.
//
// Both emit the node/packet encoding consumed by the traversal kernels:
//   bounds[6][N] per node (xmin,xmax,ymin,ymax,zmin,zmax), empty slot =
//   (+inf,-inf); child > 0 inner (index+1), < 0 leaf (~packet index);
//   Tri packets with e1 = v0-v1, e2 = v2-v0, n = cross(e1,e2);
//   prim_id -1 invalid lane, sign bit on the last lane of the final
//   packet of each leaf (converter.cpp:252-258). Spatial splits may
//   duplicate triangle references (same prim_id in several leaves).
//
// The SAH cost model matches converter.cpp CostFn (leaf = count*area,
// traversal = area).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr float INF = std::numeric_limits<float>::infinity();

struct Vec3 {
    float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct BBox {
    Vec3 lo{INF, INF, INF};
    Vec3 hi{-INF, -INF, -INF};
    void extend(const BBox& o) {
        lo = vmin(lo, o.lo);
        hi = vmax(hi, o.hi);
    }
    void clip(const BBox& o) {
        lo = vmax(lo, o.lo);
        hi = vmin(hi, o.hi);
    }
    float half_area() const {
        float ex = std::max(hi.x - lo.x, 0.0f);
        float ey = std::max(hi.y - lo.y, 0.0f);
        float ez = std::max(hi.z - lo.z, 0.0f);
        return ex * (ey + ez) + ey * ez;
    }
};

struct BinaryNode {
    BBox box;
    int32_t left = -1, right = -1;
    int64_t start = -1, count = -1;  // leaf range into `order`
    bool is_leaf() const { return count >= 0; }
};

// A (possibly clipped) triangle reference: spatial splits give the same
// prim its own tighter box in each child.
struct SRef {
    int32_t id;
    BBox bb;
};

// Unified binary node for the DP collapse: leaf ranges index either
// `order` (binned tier) or `ref_pool` (SBVH tier); inner ranges are the
// union of their children's (contiguous by left-first DFS emission).
struct DPNode {
    BBox box;
    int32_t l = -1, r = -1;
    int64_t start = -1, end = -1;
};

struct Builder {
    int arity, packet, leaf_threshold;
    float leaf_cost = 1.2f;  // C_LEAF override (see dp_collapse_emit)
    int64_t num_tris;
    std::vector<Vec3> v0, v1, v2;
    std::vector<int32_t> gid;
    std::vector<BBox> tri_box;
    std::vector<Vec3> center;
    std::vector<int64_t> order;
    std::vector<BinaryNode> bnodes;
    float spatial_threshold = 0.0f;

    // DP-collapse inputs
    std::vector<DPNode> dpn;
    std::vector<SRef> ref_pool;   // SBVH leaf ranges
    bool refs_mode = false;       // leaf ranges into ref_pool vs order

    // outputs
    std::vector<float> out_bounds;  // num_nodes * 6 * arity
    std::vector<int32_t> out_child; // num_nodes * arity
    std::vector<float> t_v0, t_e1, t_e2, t_n;  // packets * packet * 3
    std::vector<int32_t> t_pid, t_gid;          // packets * packet

    int build_binary();
    void binary_to_dpn();
    int64_t emit_leaf_ids(const std::vector<int32_t>& ids);
    int64_t emit_leaf_range(int64_t start, int64_t end);
    void dp_collapse_emit();

    // SBVH path
    void build_sbvh_binary();
    int64_t alloc_node();
};

constexpr int NUM_BINS = 16;

int Builder::build_binary() {
    order.resize(num_tris);
    for (int64_t i = 0; i < num_tris; ++i) order[i] = i;
    bnodes.reserve(2 * size_t(num_tris) + 1);
    bnodes.emplace_back();
    struct Work { int32_t node; int64_t start, end; };
    std::vector<Work> stack{{0, 0, num_tris}};
    std::vector<int64_t> tmp(num_tris);

    while (!stack.empty()) {
        Work w = stack.back();
        stack.pop_back();
        BinaryNode& nref = bnodes[w.node];
        int64_t count = w.end - w.start;

        BBox box;
        BBox cbox;
        for (int64_t i = w.start; i < w.end; ++i) {
            box.extend(tri_box[order[i]]);
            const Vec3& c = center[order[i]];
            cbox.lo = vmin(cbox.lo, c);
            cbox.hi = vmax(cbox.hi, c);
        }
        nref.box = box;

        if (count <= leaf_threshold) {
            nref.start = w.start;
            nref.count = count;
            continue;
        }

        Vec3 ext{cbox.hi.x - cbox.lo.x, cbox.hi.y - cbox.lo.y,
                 cbox.hi.z - cbox.lo.z};
        int axis = 0;
        if (ext.y > ext.x) axis = 1;
        if (ext.z > (axis ? ext.y : ext.x)) axis = 2;
        float extent = axis == 0 ? ext.x : axis == 1 ? ext.y : ext.z;
        float base = axis == 0 ? cbox.lo.x : axis == 1 ? cbox.lo.y : cbox.lo.z;

        int64_t mid;
        bool did_sah = false;
        if (extent > 0.0f) {
            BBox bin_box[NUM_BINS];
            int64_t bin_cnt[NUM_BINS] = {};
            float scale = NUM_BINS / extent;
            auto bin_of = [&](int64_t t) {
                const Vec3& c = center[t];
                float v = axis == 0 ? c.x : axis == 1 ? c.y : c.z;
                int b = int((v - base) * scale);
                return std::min(std::max(b, 0), NUM_BINS - 1);
            };
            for (int64_t i = w.start; i < w.end; ++i) {
                int b = bin_of(order[i]);
                bin_box[b].extend(tri_box[order[i]]);
                bin_cnt[b]++;
            }
            // sweep
            float rarea[NUM_BINS];
            BBox acc;
            int64_t rcnt_arr[NUM_BINS];
            int64_t rc = 0;
            for (int b = NUM_BINS - 1; b >= 1; --b) {
                acc.extend(bin_box[b]);
                rc += bin_cnt[b];
                rarea[b] = acc.half_area();
                rcnt_arr[b] = rc;
            }
            BBox lacc;
            int64_t lc = 0;
            float best_cost = INF;
            int best_bin = -1;
            for (int b = 0; b < NUM_BINS - 1; ++b) {
                lacc.extend(bin_box[b]);
                lc += bin_cnt[b];
                if (lc == 0 || rcnt_arr[b + 1] == 0) continue;
                float cost = lacc.half_area() * lc
                             + rarea[b + 1] * rcnt_arr[b + 1];
                if (cost < best_cost) {
                    best_cost = cost;
                    best_bin = b;
                }
            }
            if (best_bin >= 0) {
                float leaf_cost = box.half_area() * count;
                float split_cost = best_cost + box.half_area();
                if (count <= 64 && leaf_cost <= split_cost) {
                    nref.start = w.start;
                    nref.count = count;
                    continue;
                }
                // stable partition by bin
                int64_t l = 0, r = 0;
                for (int64_t i = w.start; i < w.end; ++i) {
                    if (bin_of(order[i]) <= best_bin)
                        order[w.start + l++] = order[i];
                    else
                        tmp[r++] = order[i];
                }
                std::memcpy(&order[w.start + l], tmp.data(),
                            size_t(r) * sizeof(int64_t));
                mid = w.start + l;
                did_sah = true;
            }
        }
        if (!did_sah) {
            // identical centroids: halve by index
            if (count <= 64) {
                nref.start = w.start;
                nref.count = count;
                continue;
            }
            mid = w.start + count / 2;
        }

        int32_t l = int32_t(bnodes.size());
        bnodes.emplace_back();
        int32_t r = int32_t(bnodes.size());
        bnodes.emplace_back();
        bnodes[w.node].left = l;
        bnodes[w.node].right = r;
        stack.push_back({l, w.start, mid});
        stack.push_back({r, mid, w.end});
    }
    return 0;
}

int64_t Builder::alloc_node() {
    int64_t idx = int64_t(out_child.size()) / arity;
    out_bounds.resize(out_bounds.size() + size_t(6 * arity));
    out_child.resize(out_child.size() + size_t(arity), 0);
    float* bb = &out_bounds[size_t(idx) * 6 * arity];
    for (int s = 0; s < arity; ++s) {
        bb[0 * arity + s] = INF;
        bb[1 * arity + s] = -INF;
        bb[2 * arity + s] = INF;
        bb[3 * arity + s] = -INF;
        bb[4 * arity + s] = INF;
        bb[5 * arity + s] = -INF;
    }
    return idx;
}

int64_t Builder::emit_leaf_ids(const std::vector<int32_t>& ids) {
    int64_t first = int64_t(t_pid.size()) / packet;
    int64_t count = int64_t(ids.size());
    for (int64_t i = 0; i < count; i += packet) {
        int64_t c = std::min<int64_t>(packet, count - i);
        for (int64_t j = 0; j < packet; ++j) {
            if (j < c) {
                int64_t id = ids[i + j];
                Vec3 a = v0[id], b = v1[id], cc = v2[id];
                Vec3 e1{a.x - b.x, a.y - b.y, a.z - b.z};
                Vec3 e2{cc.x - a.x, cc.y - a.y, cc.z - a.z};
                Vec3 nn{e1.y * e2.z - e1.z * e2.y,
                        e1.z * e2.x - e1.x * e2.z,
                        e1.x * e2.y - e1.y * e2.x};
                t_v0.insert(t_v0.end(), {a.x, a.y, a.z});
                t_e1.insert(t_e1.end(), {e1.x, e1.y, e1.z});
                t_e2.insert(t_e2.end(), {e2.x, e2.y, e2.z});
                t_n.insert(t_n.end(), {nn.x, nn.y, nn.z});
                t_pid.push_back(int32_t(id));
                t_gid.push_back(gid[id]);
            } else {
                t_v0.insert(t_v0.end(), {0, 0, 0});
                t_e1.insert(t_e1.end(), {0, 0, 0});
                t_e2.insert(t_e2.end(), {0, 0, 0});
                t_n.insert(t_n.end(), {0, 0, 0});
                t_pid.push_back(-1);
                t_gid.push_back(0);
            }
        }
    }
    // flag the last lane of the final packet of this leaf
    t_pid.back() = int32_t(uint32_t(t_pid.back()) | 0x80000000u);
    return first;
}

int64_t Builder::emit_leaf_range(int64_t start, int64_t end) {
    std::vector<int32_t> ids;
    ids.reserve(size_t(end - start));
    if (refs_mode) {
        for (int64_t i = start; i < end; ++i)
            ids.push_back(ref_pool[i].id);
        // a DP leaf spanning spatial splits may hold the same prim twice;
        // test it once (the leaf covers the union volume)
        std::sort(ids.begin(), ids.end());
        ids.erase(std::unique(ids.begin(), ids.end()), ids.end());
    } else {
        for (int64_t i = start; i < end; ++i)
            ids.push_back(int32_t(order[i]));
    }
    return emit_leaf_ids(ids);
}

void Builder::binary_to_dpn() {
    dpn.resize(bnodes.size());
    for (size_t i = 0; i < bnodes.size(); ++i) {
        const BinaryNode& b = bnodes[i];
        DPNode& d = dpn[i];
        d.box = b.box;
        if (b.is_leaf()) {
            d.start = b.start;
            d.end = b.start + b.count;
        } else {
            d.l = b.left;
            d.r = b.right;
        }
    }
    refs_mode = false;
}

// Slot-constrained optimal wide collapse (the Ylitie et al. 2017 DP) in
// the packet kernel's cost units: a wide-node pop costs ~the same
// whether it tests 8 child boxes or one 8-triangle packet, so minimize
// E[pops] = sum over nodes of area * C_NODE + sum over leaf packets of
// area * C_LEAF. The reference's greedy largest-area MultiNode collapse
// (bvh.h:44-96) leaves ~40% of child slots empty (measured 4.76/8 on the
// hall SBVH); the DP trades empty lanes for fewer, fuller nodes
// (measured: -65% nodes, -38% packets on hall-60k).
//   D(b, i) = min_j C(l, j) + C(r, i-j)            i >= 2
//   C(b, 1) = min(leaf(b), area * C_NODE + D(b, arity))
//   C(b, i) = min(C(b, i-1), D(b, i))
// leaf(b) = area * C_LEAF * ceil(count / packet) while count stays
// under MAX_LEAF_PACKETS packets; subtree ranges are contiguous thanks
// to left-first DFS layout. The numpy twin is
// accel/builder.py::_collapse_wide_dp (oracle-tested vs brute force).
// C_LEAF is the DEFAULT leaf-packet pop cost relative to a node pop
// (heavier lane math); Builder::leaf_cost overrides it per build — a
// higher ratio gives fewer, tighter leaf packets.
constexpr float C_NODE = 1.0f;
constexpr float C_LEAF = 1.2f;
constexpr int MAX_LEAF_PACKETS = 8;

void Builder::dp_collapse_emit() {
    const float C_LEAF_EFF = leaf_cost;
    const int A = arity;
    const int64_t n = int64_t(dpn.size());
    std::vector<float> C(size_t(n) * (A + 1), INF);
    std::vector<uint8_t> dj(size_t(n) * (A + 1), 0);
    std::vector<uint8_t> as_leaf(size_t(n), 0);
    std::vector<float> D(size_t(A) + 1);

    auto ceil_pk = [&](int64_t cnt) {
        return float((cnt + packet - 1) / packet);
    };

    // children are allocated after their parents in both builders, so a
    // reverse index sweep is a valid post-order
    for (int64_t b = n - 1; b >= 0; --b) {
        DPNode& d = dpn[b];
        float* Cb = &C[size_t(b) * (A + 1)];
        float area = d.box.half_area();
        if (d.l < 0) {
            float cl = area * C_LEAF_EFF * ceil_pk(d.end - d.start);
            for (int i = 1; i <= A; ++i) Cb[i] = cl;
            as_leaf[b] = 1;
            continue;
        }
        const float* Cl = &C[size_t(d.l) * (A + 1)];
        const float* Cr = &C[size_t(d.r) * (A + 1)];
        d.start = dpn[d.l].start;
        d.end = dpn[d.r].end;
        uint8_t* djb = &dj[size_t(b) * (A + 1)];
        for (int i = 2; i <= A; ++i) {
            float best = INF;
            int bj = 1;
            for (int j = 1; j < i; ++j) {
                float c = Cl[j] + Cr[i - j];
                if (c < best) { best = c; bj = j; }
            }
            D[i] = best;
            djb[i] = uint8_t(bj);
        }
        int64_t cnt = d.end - d.start;
        float leaf_cost = cnt <= int64_t(MAX_LEAF_PACKETS) * packet
                              ? area * C_LEAF_EFF * ceil_pk(cnt) : INF;
        float node_cost = area * C_NODE + D[A];
        Cb[1] = std::min(leaf_cost, node_cost);
        as_leaf[b] = leaf_cost <= node_cost;
        for (int i = 2; i <= A; ++i) Cb[i] = std::min(Cb[i - 1], D[i]);
    }

    if (as_leaf[0]) {
        // whole scene cheapest as a single leaf chain
        int64_t widx = alloc_node();
        float* bb = &out_bounds[size_t(widx) * 6 * arity];
        const BBox& m = dpn[0].box;
        bb[0 * arity] = m.lo.x;
        bb[1 * arity] = m.hi.x;
        bb[2 * arity] = m.lo.y;
        bb[3 * arity] = m.hi.y;
        bb[4 * arity] = m.lo.z;
        bb[5 * arity] = m.hi.z;
        out_child[size_t(widx) * arity] =
            int32_t(~emit_leaf_range(dpn[0].start, dpn[0].end));
        return;
    }

    // reconstruction: expand a node's arity slots along the stored
    // decisions; each slot becomes a leaf or a child wide node
    std::vector<int32_t> slots;
    auto slots_of = [&](int32_t b) {
        slots.clear();
        std::vector<std::pair<int32_t, int>> st{{b, A}};
        while (!st.empty()) {
            auto [m, i] = st.back();
            st.pop_back();
            const float* Cm = &C[size_t(m) * (A + 1)];
            while (i > 1 && Cm[i] == Cm[i - 1]) --i;
            if (i == 1 || dpn[m].l < 0) {
                slots.push_back(m);
                continue;
            }
            int j = dj[size_t(m) * (A + 1) + i];
            st.push_back({dpn[m].r, i - j});
            st.push_back({dpn[m].l, j});
        }
    };

    struct Work { int32_t bnode; int64_t widx; int slot; };
    std::vector<Work> work;
    auto emit_wide = [&](int32_t b) {
        int64_t widx = alloc_node();
        slots_of(b);
        if (slots.size() == 1 && slots[0] == b && dpn[b].l >= 0) {
            // Degenerate fixed point: a subtree of coincident zero-area
            // boxes has cost 0 at every arity, the tie-collapse reduces
            // the expansion to the node itself, and the work loop would
            // re-emit it forever (seen on >64 coincident degenerate
            // tris). Force a binary expansion so the recursion always
            // descends.
            slots.clear();
            slots.push_back(dpn[b].l);
            slots.push_back(dpn[b].r);
        }
        float* bb = &out_bounds[size_t(widx) * 6 * arity];
        for (int s = 0; s < int(slots.size()); ++s) {
            int32_t m = slots[s];
            const BBox& mb = dpn[m].box;
            bb[0 * arity + s] = mb.lo.x;
            bb[1 * arity + s] = mb.hi.x;
            bb[2 * arity + s] = mb.lo.y;
            bb[3 * arity + s] = mb.hi.y;
            bb[4 * arity + s] = mb.lo.z;
            bb[5 * arity + s] = mb.hi.z;
            if (dpn[m].l < 0 || as_leaf[m]) {
                out_child[size_t(widx) * arity + s] =
                    int32_t(~emit_leaf_range(dpn[m].start, dpn[m].end));
            } else {
                work.push_back({m, widx, s});
            }
        }
        return widx;
    };

    emit_wide(0);
    while (!work.empty()) {
        Work w = work.back();
        work.pop_back();
        int64_t cidx = emit_wide(w.bnode);
        out_child[size_t(w.widx) * arity + w.slot] = int32_t(cidx + 1);
    }
}

// ---------------------------------------------------------------------
// SBVH (quality=1): sweep-SAH object splits + binned spatial splits with
// unsplitting (Stich et al. 2009; reference: src/driver/bvh.h:102-539),
// collapsed directly into N-wide nodes.
// ---------------------------------------------------------------------

constexpr int SPATIAL_BINS = 96;
constexpr int BINNING_PASSES = 2;
constexpr float SBVH_ALPHA = 1e-5f;  // spatial-split trigger (bvh.h alpha)

inline float leaf_sah(size_t count, float area) { return count * area; }

// Half-area of the intersection, <= 0 when disjoint (trigger test only).
inline float overlap_half_area(const BBox& a, const BBox& b) {
    float ex = std::min(a.hi.x, b.hi.x) - std::max(a.lo.x, b.lo.x);
    float ey = std::min(a.hi.y, b.hi.y) - std::max(a.lo.y, b.lo.y);
    float ez = std::min(a.hi.z, b.hi.z) - std::max(a.lo.z, b.lo.z);
    if (ex <= 0.0f || ey <= 0.0f || ez <= 0.0f) return 0.0f;
    return ex * (ey + ez) + ey * ez;
}

inline float axis_of(const Vec3& v, int a) {
    return a == 0 ? v.x : a == 1 ? v.y : v.z;
}

// Clips a triangle against the plane (axis == pos) and returns the bounds
// of the two polygon halves (the tri.h compute_split role, own impl:
// walk the edges, add each endpoint to its side, crossings to both).
inline void split_tri_bounds(const Vec3& a, const Vec3& b, const Vec3& c,
                             int axis, float pos, BBox& lb, BBox& rb) {
    lb = BBox();
    rb = BBox();
    const Vec3 vs[3] = {a, b, c};
    for (int i = 0; i < 3; ++i) {
        const Vec3& p = vs[i];
        const Vec3& q = vs[(i + 1) % 3];
        float pa = axis_of(p, axis), qa = axis_of(q, axis);
        if (pa <= pos) { lb.lo = vmin(lb.lo, p); lb.hi = vmax(lb.hi, p); }
        if (pa >= pos) { rb.lo = vmin(rb.lo, p); rb.hi = vmax(rb.hi, p); }
        if ((pa < pos) != (qa < pos) && pa != qa) {
            float t = (pos - pa) / (qa - pa);
            Vec3 x{p.x + t * (q.x - p.x), p.y + t * (q.y - p.y),
                   p.z + t * (q.z - p.z)};
            if (axis == 0) x.x = pos;
            else if (axis == 1) x.y = pos;
            else x.z = pos;
            lb.lo = vmin(lb.lo, x); lb.hi = vmax(lb.hi, x);
            rb.lo = vmin(rb.lo, x); rb.hi = vmax(rb.hi, x);
        }
    }
}

struct ObjSplit {
    float cost = INF;
    int axis = -1;
    size_t left_count = 0;
    BBox lb, rb;
};

struct SpatSplit {
    float cost = INF;
    int axis = -1;
    float pos = 0.0f;
};

// Sweep-SAH over all three axes (bvh.h find_object_split role). Sorts
// refs in place per axis; on return refs are sorted by the LAST axis
// swept (2) — apply re-sorts by the winning axis if needed.
void find_object_split(ObjSplit& os, std::vector<SRef>& refs,
                       std::vector<float>& rarea) {
    const size_t n = refs.size();
    rarea.resize(n);
    for (int axis = 0; axis < 3; ++axis) {
        std::sort(refs.begin(), refs.end(), [axis](const SRef& x,
                                                   const SRef& y) {
            float cx = axis_of(x.bb.lo, axis) + axis_of(x.bb.hi, axis);
            float cy = axis_of(y.bb.lo, axis) + axis_of(y.bb.hi, axis);
            return cx < cy || (cx == cy && x.id < y.id);
        });
        BBox acc;
        for (size_t i = n - 1; i > 0; --i) {
            acc.extend(refs[i].bb);
            rarea[i - 1] = acc.half_area();
        }
        BBox racc = acc;  // full right box at i=0 kept for the winner
        BBox lacc;
        BBox best_lb, best_rb;
        bool improved = false;
        size_t best_lc = 0;
        for (size_t i = 0; i + 1 < n; ++i) {
            lacc.extend(refs[i].bb);
            float cost = leaf_sah(i + 1, lacc.half_area())
                         + leaf_sah(n - i - 1, rarea[i]);
            if (cost < os.cost) {
                os.cost = cost;
                os.axis = axis;
                os.left_count = i + 1;
                os.lb = lacc;
                improved = true;
                best_lc = i + 1;
                best_lb = lacc;
            }
        }
        if (improved) {
            // rebuild the winning right box exactly
            BBox rb;
            for (size_t i = best_lc; i < n; ++i) rb.extend(refs[i].bb);
            os.lb = best_lb;
            os.rb = rb;
        }
        (void)racc;
    }
}

// One binning pass over [axis_min, axis_max] (bvh.h spatial_binning
// role). Returns the winning boundary index or -1.
int spatial_binning(SpatSplit& ss, const Builder& bld,
                    const std::vector<SRef>& refs, int axis,
                    float axis_min, float axis_max) {
    BBox bin_bb[SPATIAL_BINS];
    int64_t entry[SPATIAL_BINS] = {};
    int64_t exit_[SPATIAL_BINS] = {};
    const float width = (axis_max - axis_min) / SPATIAL_BINS;
    if (!(width > 0.0f)) return -1;
    const float inv = 1.0f / width;

    auto bin_of = [&](float v) {
        int b = int((v - axis_min) * inv);
        return std::min(std::max(b, 0), SPATIAL_BINS - 1);
    };
    for (const SRef& r : refs) {
        int b0 = bin_of(axis_of(r.bb.lo, axis));
        int b1 = bin_of(axis_of(r.bb.hi, axis));
        if (b0 == b1) {
            bin_bb[b0].extend(r.bb);
        } else {
            // chop the triangle across the spanned bins so each bin gets
            // the clipped geometry's bounds, not the whole ref box
            BBox cur = r.bb;
            const Vec3& a = bld.v0[r.id];
            const Vec3& b = bld.v1[r.id];
            const Vec3& c = bld.v2[r.id];
            for (int j = b0; j < b1; ++j) {
                float pos = j + 1 < SPATIAL_BINS
                                ? axis_min + (j + 1) * width : axis_max;
                BBox lb, rb;
                split_tri_bounds(a, b, c, axis, pos, lb, rb);
                lb.clip(cur);
                bin_bb[j].extend(lb);
                rb.clip(cur);
                cur = rb;
            }
            bin_bb[b1].extend(cur);
        }
        entry[b0]++;
        exit_[b1]++;
    }

    float rarea[SPATIAL_BINS];
    BBox acc;
    for (int i = SPATIAL_BINS - 1; i > 0; --i) {
        acc.extend(bin_bb[i]);
        rarea[i - 1] = acc.half_area();
    }
    BBox lacc;
    int64_t lc = 0, rc = int64_t(refs.size());
    int best = -1;
    for (int i = 0; i + 1 < SPATIAL_BINS; ++i) {
        lacc.extend(bin_bb[i]);
        lc += entry[i];
        rc -= exit_[i];
        if (lc == 0 || rc == 0) continue;
        if (size_t(lc) == refs.size() || size_t(rc) == refs.size())
            continue;
        float cost = leaf_sah(lc, lacc.half_area()) + leaf_sah(rc, rarea[i]);
        if (cost < ss.cost) {
            ss.cost = cost;
            ss.axis = axis;
            ss.pos = axis_min + (i + 1) * width;
            best = i;
        }
    }
    return best;
}

void find_spatial_split(SpatSplit& ss, const Builder& bld,
                        const std::vector<SRef>& refs, int axis,
                        const BBox& parent) {
    float axis_min = axis_of(parent.lo, axis);
    float axis_max = axis_of(parent.hi, axis);
    if (!(axis_max > axis_min)) return;
    for (int pass = 0; pass < BINNING_PASSES; ++pass) {
        int idx = spatial_binning(ss, bld, refs, axis, axis_min, axis_max);
        if (idx < 0) break;
        // refine: re-bin the neighborhood of the winning plane
        float width = (axis_max - axis_min) / SPATIAL_BINS;
        axis_min = ss.pos - width;
        axis_max = ss.pos + width;
    }
}

// Spatial-split application with unsplitting (bvh.h apply_spatial_split
// role): straddling refs are either clipped into both children or
// "unsplit" wholly into one side when that is cheaper.
void apply_spatial_split(const SpatSplit& ss, const Builder& bld,
                         std::vector<SRef>& refs,
                         std::vector<SRef>& left, BBox& lb,
                         std::vector<SRef>& right, BBox& rb) {
    left.clear();
    right.clear();
    lb = BBox();
    rb = BBox();
    std::vector<SRef> straddle;
    for (const SRef& r : refs) {
        if (axis_of(r.bb.hi, ss.axis) <= ss.pos) {
            lb.extend(r.bb);
            left.push_back(r);
        } else if (axis_of(r.bb.lo, ss.axis) >= ss.pos) {
            rb.extend(r.bb);
            right.push_back(r);
        } else {
            straddle.push_back(r);
        }
    }
    for (const SRef& r : straddle) {
        BBox lsb, rsb;
        split_tri_bounds(bld.v0[r.id], bld.v1[r.id], bld.v2[r.id],
                         ss.axis, ss.pos, lsb, rsb);
        lsb.clip(r.bb);
        rsb.clip(r.bb);
        BBox lu = lb, ru = rb, ld = lb, rd = rb;
        lu.extend(r.bb);
        ru.extend(r.bb);
        ld.extend(lsb);
        rd.extend(rsb);
        const size_t nl = left.size(), nr = right.size();
        float unsplit_l = leaf_sah(nl + 1, lu.half_area())
                          + leaf_sah(nr, rb.half_area());
        float unsplit_r = leaf_sah(nl, lb.half_area())
                          + leaf_sah(nr + 1, ru.half_area());
        float dup = leaf_sah(nl + 1, ld.half_area())
                    + leaf_sah(nr + 1, rd.half_area());
        float mn = std::min(dup, std::min(unsplit_l, unsplit_r));
        if (mn == unsplit_l) {
            lb = lu;
            left.push_back(r);
        } else if (mn == unsplit_r) {
            rb = ru;
            right.push_back(r);
        } else {
            lb = ld;
            rb = rd;
            left.push_back({r.id, lsb});
            right.push_back({r.id, rsb});
        }
    }
}

// Builds the binary SBVH into dpn + ref_pool (left-first DFS so every
// subtree's refs form a contiguous ref_pool range for the DP's
// merged-leaf option). Splits: sweep-SAH object split vs 96-bin spatial
// split with unsplitting (the reference SplitBvhBuilder tier,
// src/driver/bvh.h:102-539, after Stich et al. 2009), carried down to
// 2-ref leaves — the DP collapse decides the real leaf cuts.
void Builder::build_sbvh_binary() {
    refs_mode = true;
    std::vector<SRef> refs0(num_tris);
    BBox root;
    for (int64_t i = 0; i < num_tris; ++i) {
        refs0[i] = {int32_t(i), tri_box[i]};
        root.extend(tri_box[i]);
    }
    spatial_threshold = root.half_area() * SBVH_ALPHA;
    ref_pool.reserve(size_t(num_tris) * 5 / 4);

    struct SWork {
        int32_t node;
        std::vector<SRef> refs;
        BBox bb;
    };
    dpn.clear();
    dpn.emplace_back();
    dpn[0].box = root;
    std::vector<SWork> stack;
    stack.push_back({0, std::move(refs0), root});
    std::vector<float> rarea;
    int64_t live_refs = num_tris;
    const int64_t ref_budget = num_tris * 2;

    auto make_leaf = [&](int32_t node, std::vector<SRef>& refs) {
        dpn[node].start = int64_t(ref_pool.size());
        ref_pool.insert(ref_pool.end(), refs.begin(), refs.end());
        dpn[node].end = int64_t(ref_pool.size());
    };

    while (!stack.empty()) {
        SWork w = std::move(stack.back());
        stack.pop_back();
        dpn[w.node].box = w.bb;
        if (int64_t(w.refs.size()) <= 2) {
            make_leaf(w.node, w.refs);
            continue;
        }

        ObjSplit os;
        find_object_split(os, w.refs, rarea);
        SpatSplit ss;
        if (os.axis >= 0 && live_refs < ref_budget
            && overlap_half_area(os.lb, os.rb) > spatial_threshold) {
            for (int axis = 0; axis < 3; ++axis)
                find_spatial_split(ss, *this, w.refs, axis, w.bb);
        }

        SWork l, r;
        if (ss.cost < os.cost) {
            apply_spatial_split(ss, *this, w.refs, l.refs, l.bb, r.refs,
                                r.bb);
            live_refs += int64_t(l.refs.size() + r.refs.size())
                         - int64_t(w.refs.size());
        } else if (os.axis >= 0) {
            if (os.axis != 2) {
                int axis = os.axis;
                std::sort(w.refs.begin(), w.refs.end(),
                          [axis](const SRef& x, const SRef& y) {
                    float cx = axis_of(x.bb.lo, axis)
                               + axis_of(x.bb.hi, axis);
                    float cy = axis_of(y.bb.lo, axis)
                               + axis_of(y.bb.hi, axis);
                    return cx < cy || (cx == cy && x.id < y.id);
                });
            }
            l.refs.assign(w.refs.begin(), w.refs.begin() + os.left_count);
            r.refs.assign(w.refs.begin() + os.left_count, w.refs.end());
            l.bb = os.lb;
            r.bb = os.rb;
        }
        if (l.refs.empty() || r.refs.empty()) {
            // degenerate (all boxes identical): halve by order
            size_t mid = w.refs.size() / 2;
            l.refs.assign(w.refs.begin(), w.refs.begin() + mid);
            r.refs.assign(w.refs.begin() + mid, w.refs.end());
            l.bb = BBox();
            for (const SRef& s : l.refs) l.bb.extend(s.bb);
            r.bb = BBox();
            for (const SRef& s : r.refs) r.bb.extend(s.bb);
        }
        int32_t li = int32_t(dpn.size());
        dpn.emplace_back();
        int32_t ri = int32_t(dpn.size());
        dpn.emplace_back();
        dpn[w.node].l = li;
        dpn[w.node].r = ri;
        l.node = li;
        r.node = ri;
        // left-first DFS: push right below left
        stack.push_back(std::move(r));
        stack.push_back(std::move(l));
    }
}

} // namespace

extern "C" {

// leaf_cost <= 0 keeps the Builder's default DP-collapse leaf cost
// (C_LEAF override; see dp_collapse_emit).
void* rt_bvh_build2(const float* verts, const int32_t* idx4,
                    int64_t num_tris, int arity, int packet,
                    int leaf_threshold, int quality, float leaf_cost) {
    auto* b = new Builder();
    b->arity = arity;
    b->packet = packet;
    // the DP collapse decides the real leaf cuts; keep the binary tree
    // fine so it has freedom (leaf_threshold kept as a lower bound only)
    b->leaf_threshold = std::max(std::min(leaf_threshold, 4), 2);
    if (leaf_cost > 0.0f) b->leaf_cost = leaf_cost;
    b->num_tris = num_tris;
    b->v0.resize(num_tris);
    b->v1.resize(num_tris);
    b->v2.resize(num_tris);
    b->gid.resize(num_tris);
    b->tri_box.resize(num_tris);
    b->center.resize(num_tris);
    for (int64_t t = 0; t < num_tris; ++t) {
        auto fetch = [&](int32_t vi) {
            return Vec3{verts[vi * 3 + 0], verts[vi * 3 + 1],
                        verts[vi * 3 + 2]};
        };
        b->v0[t] = fetch(idx4[t * 4 + 0]);
        b->v1[t] = fetch(idx4[t * 4 + 1]);
        b->v2[t] = fetch(idx4[t * 4 + 2]);
        b->gid[t] = idx4[t * 4 + 3];
        BBox box;
        box.lo = vmin(vmin(b->v0[t], b->v1[t]), b->v2[t]);
        box.hi = vmax(vmax(b->v0[t], b->v1[t]), b->v2[t]);
        b->tri_box[t] = box;
        b->center[t] = {(box.lo.x + box.hi.x) * 0.5f,
                        (box.lo.y + box.hi.y) * 0.5f,
                        (box.lo.z + box.hi.z) * 0.5f};
    }
    if (quality >= 1) {
        b->build_sbvh_binary();
    } else {
        b->build_binary();
        b->binary_to_dpn();
    }
    b->dp_collapse_emit();
    return b;
}

// original ABI entry point: rt_bvh_build2 with the default leaf cost
void* rt_bvh_build(const float* verts, const int32_t* idx4,
                   int64_t num_tris, int arity, int packet,
                   int leaf_threshold, int quality) {
    return rt_bvh_build2(verts, idx4, num_tris, arity, packet,
                         leaf_threshold, quality, 0.0f);
}

int64_t rt_bvh_num_nodes(void* h) {
    auto* b = static_cast<Builder*>(h);
    return int64_t(b->out_child.size()) / b->arity;
}

int64_t rt_bvh_num_packets(void* h) {
    auto* b = static_cast<Builder*>(h);
    return int64_t(b->t_pid.size()) / b->packet;
}

void rt_bvh_copy(void* h, float* bounds, int32_t* child, float* tv0,
                 float* te1, float* te2, float* tn, int32_t* pid,
                 int32_t* gidp) {
    auto* b = static_cast<Builder*>(h);
    std::memcpy(bounds, b->out_bounds.data(),
                b->out_bounds.size() * sizeof(float));
    std::memcpy(child, b->out_child.data(),
                b->out_child.size() * sizeof(int32_t));
    std::memcpy(tv0, b->t_v0.data(), b->t_v0.size() * sizeof(float));
    std::memcpy(te1, b->t_e1.data(), b->t_e1.size() * sizeof(float));
    std::memcpy(te2, b->t_e2.data(), b->t_e2.size() * sizeof(float));
    std::memcpy(tn, b->t_n.data(), b->t_n.size() * sizeof(float));
    std::memcpy(pid, b->t_pid.data(), b->t_pid.size() * sizeof(int32_t));
    std::memcpy(gidp, b->t_gid.data(), b->t_gid.size() * sizeof(int32_t));
}

void rt_bvh_free(void* h) {
    delete static_cast<Builder*>(h);
}

} // extern "C"
