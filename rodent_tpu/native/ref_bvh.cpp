// Independent reference traversal engine (bench_embree/bench_aila role,
// SURVEY.md §2.3): a self-contained single-ray BVH2 — its own binned-SAH
// builder and its own scalar stack traversal — deliberately sharing NO
// code or data layout with bvh_builder.cpp or the JAX engines. It exists
// to give every throughput claim a second, independent measurement on
// this host's CPU (the reference uses Embree and Aila's CUDA kernels for
// the same purpose: tools/bench_embree/bench_embree.cpp,
// tools/bench_aila), and to cross-check hit results against an
// implementation that was never derived from the code under test.
//
// Single-threaded by design: this box has one CPU core, and the number
// is an anchor, not a competitor score.
#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace refbvh {

struct Node {
    float bmin[3], bmax[3];
    // count == 0: inner node, `index` is the left child (right = index+1)
    // count  > 0: leaf, tris[index .. index+count) are the triangles
    int32_t index;
    int32_t count;
};

struct Tri {
    float v0[3], e1[3], e2[3];
    int32_t id;
};

struct Accel {
    std::vector<Node> nodes;
    std::vector<Tri> tris;  // in leaf-emission (DFS) order
};

struct Box {
    float lo[3] = {1e38f, 1e38f, 1e38f};
    float hi[3] = {-1e38f, -1e38f, -1e38f};
    void grow(const float* p) {
        for (int k = 0; k < 3; k++) {
            lo[k] = std::min(lo[k], p[k]);
            hi[k] = std::max(hi[k], p[k]);
        }
    }
    void grow(const Box& b) {
        grow(b.lo);
        grow(b.hi);
    }
    float half_area() const {
        float dx = std::max(hi[0] - lo[0], 0.f);
        float dy = std::max(hi[1] - lo[1], 0.f);
        float dz = std::max(hi[2] - lo[2], 0.f);
        return dx * dy + dy * dz + dz * dx;
    }
};

struct BuildPrim {
    Box box;
    float center[3];
    int32_t id;
};

static constexpr int kBins = 16;
static constexpr int kLeafMax = 4;

}  // namespace refbvh

extern "C" {

void* rt_ref_build(const float* verts, const int32_t* idx4, int64_t ntris) {
    using namespace refbvh;
    auto* a = new Accel();
    std::vector<BuildPrim> prims(ntris);
    std::vector<Tri> src(ntris);
    for (int64_t i = 0; i < ntris; i++) {
        const int32_t* f = idx4 + 4 * i;
        const float* p0 = verts + 3 * f[0];
        const float* p1 = verts + 3 * f[1];
        const float* p2 = verts + 3 * f[2];
        Tri& t = src[i];
        for (int k = 0; k < 3; k++) {
            t.v0[k] = p0[k];
            t.e1[k] = p1[k] - p0[k];
            t.e2[k] = p2[k] - p0[k];
        }
        t.id = int32_t(i);
        BuildPrim& bp = prims[i];
        bp.box.grow(p0);
        bp.box.grow(p1);
        bp.box.grow(p2);
        for (int k = 0; k < 3; k++)
            bp.center[k] = (bp.box.lo[k] + bp.box.hi[k]) * 0.5f;
        bp.id = int32_t(i);
    }
    a->nodes.reserve(size_t(2 * ntris));
    a->nodes.emplace_back();
    a->tris.reserve(size_t(ntris));

    struct Frame { int32_t node, lo, hi, depth; };
    std::vector<Frame> work{{0, 0, int32_t(ntris), 0}};
    // depth cap keeps the traversal stack (128 entries) safe: a chain of
    // maximally lopsided SAH splits is bounded by forcing a leaf
    constexpr int kMaxDepth = 120;
    while (!work.empty()) {
        Frame f = work.back();
        work.pop_back();
        int32_t n = f.hi - f.lo;
        Box bounds, cbounds;
        for (int32_t i = f.lo; i < f.hi; i++) {
            bounds.grow(prims[i].box);
            cbounds.grow(prims[i].center);
        }
        Node& self = a->nodes[f.node];
        std::memcpy(self.bmin, bounds.lo, sizeof bounds.lo);
        std::memcpy(self.bmax, bounds.hi, sizeof bounds.hi);
        if (n <= kLeafMax || f.depth >= kMaxDepth) {
            self.index = int32_t(a->tris.size());
            self.count = n;
            for (int32_t i = f.lo; i < f.hi; i++)
                a->tris.push_back(src[prims[i].id]);
            continue;
        }
        // binned SAH split (SAH with Ct/Ci = 1; leaf cost = n tests)
        int best_axis = -1, best_bin = -1;
        float best_cost = float(n);
        for (int axis = 0; axis < 3; axis++) {
            float cmin = cbounds.lo[axis], cmax = cbounds.hi[axis];
            if (cmax - cmin < 1e-12f) continue;
            float scale = kBins / (cmax - cmin);
            Box bb[kBins];
            int cnt[kBins] = {0};
            for (int32_t i = f.lo; i < f.hi; i++) {
                int b = std::min(kBins - 1,
                                 int((prims[i].center[axis] - cmin) * scale));
                bb[b].grow(prims[i].box);
                cnt[b]++;
            }
            float rarea[kBins];
            Box acc;
            int racc = 0;
            for (int b = kBins - 1; b > 0; b--) {
                acc.grow(bb[b]);
                racc += cnt[b];
                rarea[b] = racc ? acc.half_area() : 0.f;
            }
            Box lacc;
            int lcnt = 0;
            float inv_root = 1.0f / std::max(bounds.half_area(), 1e-30f);
            for (int b = 0; b < kBins - 1; b++) {
                lacc.grow(bb[b]);
                lcnt += cnt[b];
                if (lcnt == 0 || lcnt == n) continue;
                float cost = 1.0f + (lacc.half_area() * lcnt +
                                     rarea[b + 1] * (n - lcnt)) * inv_root;
                if (cost < best_cost) {
                    best_cost = cost;
                    best_axis = axis;
                    best_bin = b;
                }
            }
        }
        int32_t mid;
        if (best_axis < 0) {
            // all centroids coincident or SAH prefers a (too-big) leaf:
            // median split on the widest centroid axis
            mid = f.lo + n / 2;
            int axis = 0;
            float ext = -1;
            for (int k = 0; k < 3; k++) {
                float e = cbounds.hi[k] - cbounds.lo[k];
                if (e > ext) { ext = e; axis = k; }
            }
            std::nth_element(prims.begin() + f.lo, prims.begin() + mid,
                             prims.begin() + f.hi,
                             [axis](const BuildPrim& x, const BuildPrim& y) {
                                 return x.center[axis] < y.center[axis];
                             });
        } else {
            float cmin = cbounds.lo[best_axis];
            float scale = kBins / (cbounds.hi[best_axis] - cmin);
            auto it = std::partition(
                prims.begin() + f.lo, prims.begin() + f.hi,
                [&](const BuildPrim& p) {
                    int b = std::min(
                        kBins - 1,
                        int((p.center[best_axis] - cmin) * scale));
                    return b <= best_bin;
                });
            mid = int32_t(it - prims.begin());
            if (mid == f.lo || mid == f.hi) mid = f.lo + n / 2;
        }
        int32_t left = int32_t(a->nodes.size());
        a->nodes.emplace_back();
        a->nodes.emplace_back();
        a->nodes[f.node].index = left;
        a->nodes[f.node].count = 0;
        work.push_back({left + 1, mid, f.hi, f.depth + 1});
        work.push_back({left, f.lo, mid, f.depth + 1});
    }
    return a;
}

int64_t rt_ref_num_nodes(void* h) {
    return int64_t(static_cast<refbvh::Accel*>(h)->nodes.size());
}

// Traverse `nrays` rays (AoS f32 org/dir (N,3) + per-ray tmin/tmax),
// writing closest-hit t (tmax kept on miss) and prim id (-1 on miss).
// any_hit != 0 stops at the first intersection. Returns wall seconds for
// the whole pass, timed inside C so the measurement excludes Python call
// overhead.
double rt_ref_traverse(void* h, const float* org, const float* dir,
                       const float* tmin, const float* tmax, int64_t nrays,
                       int any_hit, float* t_out, int32_t* prim_out) {
    using namespace refbvh;
    const Accel& a = *static_cast<Accel*>(h);
    const Node* nodes = a.nodes.data();
    const Tri* tris = a.tris.data();
    auto start = std::chrono::steady_clock::now();
    int32_t stack[128];
    for (int64_t r = 0; r < nrays; r++) {
        const float o[3] = {org[3 * r], org[3 * r + 1], org[3 * r + 2]};
        const float d[3] = {dir[3 * r], dir[3 * r + 1], dir[3 * r + 2]};
        float inv[3], t_near = tmin[r], t_hit = tmax[r];
        int32_t hit_id = -1;
        for (int k = 0; k < 3; k++)
            inv[k] = 1.0f / (d[k] == 0.0f ? 1e-30f : d[k]);
        int sp = 0;
        int32_t cur = 0;
        for (;;) {
            const Node& nd = nodes[cur];
            float t0x = (nd.bmin[0] - o[0]) * inv[0];
            float t1x = (nd.bmax[0] - o[0]) * inv[0];
            float t0y = (nd.bmin[1] - o[1]) * inv[1];
            float t1y = (nd.bmax[1] - o[1]) * inv[1];
            float t0z = (nd.bmin[2] - o[2]) * inv[2];
            float t1z = (nd.bmax[2] - o[2]) * inv[2];
            float tent = std::max(std::max(std::min(t0x, t1x),
                                           std::min(t0y, t1y)),
                                  std::max(std::min(t0z, t1z), t_near));
            float texi = std::min(std::min(std::max(t0x, t1x),
                                           std::max(t0y, t1y)),
                                  std::min(std::max(t0z, t1z), t_hit));
            if (tent <= texi) {
                if (nd.count > 0) {
                    // Moller-Trumbore over the leaf
                    for (int32_t i = 0; i < nd.count; i++) {
                        const Tri& t = tris[nd.index + i];
                        float px = d[1] * t.e2[2] - d[2] * t.e2[1];
                        float py = d[2] * t.e2[0] - d[0] * t.e2[2];
                        float pz = d[0] * t.e2[1] - d[1] * t.e2[0];
                        float det = t.e1[0] * px + t.e1[1] * py +
                                    t.e1[2] * pz;
                        if (std::fabs(det) < 1e-30f) continue;
                        float idet = 1.0f / det;
                        float sx = o[0] - t.v0[0];
                        float sy = o[1] - t.v0[1];
                        float sz = o[2] - t.v0[2];
                        float u = (sx * px + sy * py + sz * pz) * idet;
                        if (u < 0.0f || u > 1.0f) continue;
                        float qx = sy * t.e1[2] - sz * t.e1[1];
                        float qy = sz * t.e1[0] - sx * t.e1[2];
                        float qz = sx * t.e1[1] - sy * t.e1[0];
                        float v = (d[0] * qx + d[1] * qy + d[2] * qz) *
                                  idet;
                        if (v < 0.0f || u + v > 1.0f) continue;
                        float th = (t.e2[0] * qx + t.e2[1] * qy +
                                    t.e2[2] * qz) * idet;
                        if (th >= t_near && th < t_hit) {
                            t_hit = th;
                            hit_id = t.id;
                            if (any_hit) { sp = 0; break; }
                        }
                    }
                    if (any_hit && hit_id >= 0) break;
                } else {
                    // near child first: order children by box-center
                    // projection onto the ray direction
                    const Node& cl = nodes[nd.index];
                    const Node& cr = nodes[nd.index + 1];
                    float el = 0.f, er = 0.f;
                    for (int k = 0; k < 3; k++) {
                        el += (cl.bmin[k] + cl.bmax[k]) * d[k];
                        er += (cr.bmin[k] + cr.bmax[k]) * d[k];
                    }
                    int32_t near_c = nd.index, far_c = nd.index + 1;
                    if (er < el) std::swap(near_c, far_c);
                    stack[sp++] = far_c;
                    cur = near_c;
                    continue;
                }
            }
            if (sp == 0) break;
            cur = stack[--sp];
        }
        t_out[r] = t_hit;
        prim_out[r] = hit_id;
    }
    auto end = std::chrono::steady_clock::now();
    return std::chrono::duration<double>(end - start).count();
}

void rt_ref_free(void* h) { delete static_cast<refbvh::Accel*>(h); }

}  // extern "C"
