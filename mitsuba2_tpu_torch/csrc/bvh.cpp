// Binned-SAH BVH builder, host side (a copy of mitsuba2_tpu/native/bvh.cpp,
// the role of the reference's native kd-tree builder, kdtree.h:99,1710:
// min-max binning + SAH). Built with g++ into a plain C shared library and
// loaded through ctypes by ops/bvh.py; the port builds it from this file,
// never from the JAX package's. The code from the includes to the end of
// bvh_build is the reference's, byte for byte, so the two builds give the
// same face order and the same nodes. Below it, bvh_build_capped is the
// port's own: the depth-capped build of a traversal tree that the SAH
// tree would make deeper than the walk's stack (ops/bvh.py
// traversal_bvh).
//
// Node layout: 12 32-bit slots (48 bytes),
//   { bbox_min[3], left_or_first, bbox_max[3], count, right, pad[3] }
//   interior: count == 0, left and right child indices;
//   leaf: left_or_first = first primitive, count > 0, right = -1.
// Exported entries: bvh_build(...), bvh_build_capped(...)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BBox {
    float lo[3] = {1e30f, 1e30f, 1e30f};
    float hi[3] = {-1e30f, -1e30f, -1e30f};
    void expand(const float *p) {
        for (int k = 0; k < 3; ++k) {
            lo[k] = std::min(lo[k], p[k]);
            hi[k] = std::max(hi[k], p[k]);
        }
    }
    void expand(const BBox &b) {
        for (int k = 0; k < 3; ++k) {
            lo[k] = std::min(lo[k], b.lo[k]);
            hi[k] = std::max(hi[k], b.hi[k]);
        }
    }
    float area() const {
        float e[3] = {std::max(hi[0] - lo[0], 0.f),
                      std::max(hi[1] - lo[1], 0.f),
                      std::max(hi[2] - lo[2], 0.f)};
        return 2.f * (e[0] * e[1] + e[1] * e[2] + e[0] * e[2]);
    }
};

struct Prim {
    BBox box;
    float centroid[3];
    int32_t index;
};

struct Node {
    float lo[3];
    int32_t left;    // interior: left child; leaf: first prim
    float hi[3];
    int32_t count;   // leaf: number of prims (>0); interior: 0
    int32_t right;   // interior: right child; leaf: unused
    int32_t pad[3];
};

constexpr int N_BINS = 16;

int build_recursive(std::vector<Prim> &prims, int begin, int end,
                    std::vector<Node> &nodes, int leaf_size) {
    int node_idx = (int)nodes.size();
    nodes.emplace_back();
    BBox bounds, cbounds;
    for (int i = begin; i < end; ++i) {
        bounds.expand(prims[i].box);
        cbounds.expand(prims[i].centroid);
    }
    int n = end - begin;
    auto make_leaf = [&]() {
        Node &nd = nodes[node_idx];
        std::memcpy(nd.lo, bounds.lo, 12);
        std::memcpy(nd.hi, bounds.hi, 12);
        nd.left = begin;
        nd.count = n;
        nd.right = -1;
    };
    if (n <= leaf_size) { make_leaf(); return node_idx; }

    // binned SAH over the widest centroid axis (kdtree.h min-max binning)
    int axis = 0;
    float ext[3];
    for (int k = 0; k < 3; ++k) ext[k] = cbounds.hi[k] - cbounds.lo[k];
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    if (ext[axis] <= 1e-12f) { make_leaf(); return node_idx; }

    BBox bin_box[N_BINS];
    int bin_cnt[N_BINS] = {0};
    float scale = N_BINS / ext[axis];
    for (int i = begin; i < end; ++i) {
        int b = std::min(N_BINS - 1,
            (int)((prims[i].centroid[axis] - cbounds.lo[axis]) * scale));
        bin_cnt[b]++;
        bin_box[b].expand(prims[i].box);
    }
    float l_area[N_BINS], r_area[N_BINS];
    int l_cnt[N_BINS], r_cnt[N_BINS];
    { BBox acc; int c = 0;
      for (int b = 0; b < N_BINS; ++b) {
          acc.expand(bin_box[b]); c += bin_cnt[b];
          l_area[b] = acc.area(); l_cnt[b] = c; } }
    { BBox acc; int c = 0;
      for (int b = N_BINS - 1; b >= 0; --b) {
          acc.expand(bin_box[b]); c += bin_cnt[b];
          r_area[b] = acc.area(); r_cnt[b] = c; } }
    int best = -1; float best_cost = 1e30f;
    for (int b = 0; b < N_BINS - 1; ++b) {
        if (l_cnt[b] == 0 || r_cnt[b + 1] == 0) continue;
        float cost = l_area[b] * l_cnt[b] + r_area[b + 1] * r_cnt[b + 1];
        if (cost < best_cost) { best_cost = cost; best = b; }
    }
    float leaf_cost = bounds.area() * n;
    if (best < 0 || (best_cost >= leaf_cost && n <= 4 * leaf_size)) {
        make_leaf(); return node_idx;
    }
    float split = cbounds.lo[axis] + (best + 1) / scale;
    auto *mid_it = std::partition(
        prims.data() + begin, prims.data() + end,
        [&](const Prim &p) { return p.centroid[axis] < split; });
    int mid = (int)(mid_it - prims.data());
    if (mid == begin || mid == end) mid = begin + n / 2;

    int left = build_recursive(prims, begin, mid, nodes, leaf_size);
    int right = build_recursive(prims, mid, end, nodes, leaf_size);
    Node &nd = nodes[node_idx];
    std::memcpy(nd.lo, bounds.lo, 12);
    std::memcpy(nd.hi, bounds.hi, 12);
    nd.left = left;
    nd.right = right;
    nd.count = 0;
    return node_idx;
}

}  // namespace

extern "C" {

// v0/e1/e2: (n,3) float32. Outputs (caller-allocated):
//   order: (n,) int32 — primitive order after the build
//   nodes: (max_nodes * 12,) float32-compatible buffer (Node = 48 bytes)
// Returns the number of nodes written, or -1 if max_nodes too small.
int bvh_build(const float *v0, const float *e1, const float *e2, int n,
              int leaf_size, int32_t *order, float *nodes_out,
              int max_nodes) {
    std::vector<Prim> prims(n);
    for (int i = 0; i < n; ++i) {
        Prim &p = prims[i];
        float a[3], b[3], c[3];
        for (int k = 0; k < 3; ++k) {
            a[k] = v0[3 * i + k];
            b[k] = a[k] + e1[3 * i + k];
            c[k] = a[k] + e2[3 * i + k];
        }
        p.box.expand(a); p.box.expand(b); p.box.expand(c);
        for (int k = 0; k < 3; ++k)
            p.centroid[k] = (p.box.lo[k] + p.box.hi[k]) * 0.5f;
        p.index = i;
    }
    std::vector<Node> nodes;
    nodes.reserve(2 * n);
    build_recursive(prims, 0, n, nodes, leaf_size);
    if ((int)nodes.size() > max_nodes) return -1;
    for (int i = 0; i < n; ++i) order[i] = prims[i].index;
    std::memcpy(nodes_out, nodes.data(), nodes.size() * sizeof(Node));
    return (int)nodes.size();
}

}  // extern "C"

// ---- the depth-capped build (the port's own) ----
//
// Binned SAH, as build_recursive, down to binary depth sah_depth (the root
// at depth 0); below it, and wherever SAH would keep a leaf of more than
// 4 * leaf_size primitives or finds no split, an object-median split on
// the widest centroid axis, equal centroids ordered by primitive index, so
// that every level halves the primitive count: a subtree of n primitives
// below the cap is ceil(log2(ceil(n / leaf_size))) levels deep, whatever
// its geometry (clusters of coincident faces included).

namespace {

int build_capped(std::vector<Prim> &prims, int begin, int end,
                 std::vector<Node> &nodes, int leaf_size, int depth,
                 int sah_depth) {
    int node_idx = (int)nodes.size();
    nodes.emplace_back();
    BBox bounds, cbounds;
    for (int i = begin; i < end; ++i) {
        bounds.expand(prims[i].box);
        cbounds.expand(prims[i].centroid);
    }
    int n = end - begin;
    auto finish = [&](int left, int right) {
        Node &nd = nodes[node_idx];
        std::memcpy(nd.lo, bounds.lo, 12);
        std::memcpy(nd.hi, bounds.hi, 12);
        nd.left = left;
        nd.right = right;
        nd.count = right < 0 ? n : 0;
    };
    if (n <= leaf_size) { finish(begin, -1); return node_idx; }

    int axis = 0;
    float ext[3];
    for (int k = 0; k < 3; ++k) ext[k] = cbounds.hi[k] - cbounds.lo[k];
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int mid = -1;
    if (depth < sah_depth && ext[axis] > 1e-12f) {
        // build_recursive's binned SAH step
        BBox bin_box[N_BINS];
        int bin_cnt[N_BINS] = {0};
        float scale = N_BINS / ext[axis];
        for (int i = begin; i < end; ++i) {
            int b = std::min(N_BINS - 1,
                (int)((prims[i].centroid[axis] - cbounds.lo[axis]) * scale));
            bin_cnt[b]++;
            bin_box[b].expand(prims[i].box);
        }
        float l_area[N_BINS], r_area[N_BINS];
        int l_cnt[N_BINS], r_cnt[N_BINS];
        { BBox acc; int c = 0;
          for (int b = 0; b < N_BINS; ++b) {
              acc.expand(bin_box[b]); c += bin_cnt[b];
              l_area[b] = acc.area(); l_cnt[b] = c; } }
        { BBox acc; int c = 0;
          for (int b = N_BINS - 1; b >= 0; --b) {
              acc.expand(bin_box[b]); c += bin_cnt[b];
              r_area[b] = acc.area(); r_cnt[b] = c; } }
        int best = -1; float best_cost = 1e30f;
        for (int b = 0; b < N_BINS - 1; ++b) {
            if (l_cnt[b] == 0 || r_cnt[b + 1] == 0) continue;
            float cost = l_area[b] * l_cnt[b] + r_area[b + 1] * r_cnt[b + 1];
            if (cost < best_cost) { best_cost = cost; best = b; }
        }
        float leaf_cost = bounds.area() * n;
        if (n <= 4 * leaf_size && (best < 0 || best_cost >= leaf_cost)) {
            finish(begin, -1); return node_idx;
        }
        if (best >= 0) {
            float split = cbounds.lo[axis] + (best + 1) / scale;
            auto *mid_it = std::partition(
                prims.data() + begin, prims.data() + end,
                [&](const Prim &p) { return p.centroid[axis] < split; });
            mid = (int)(mid_it - prims.data());
            if (mid == begin || mid == end) mid = begin + n / 2;
        }
    }
    if (mid < 0) {
        mid = begin + n / 2;
        std::nth_element(
            prims.begin() + begin, prims.begin() + mid, prims.begin() + end,
            [&](const Prim &a, const Prim &b) {
                return a.centroid[axis] < b.centroid[axis]
                    || (a.centroid[axis] == b.centroid[axis]
                        && a.index < b.index); });
    }
    int left = build_capped(prims, begin, mid, nodes, leaf_size, depth + 1,
                            sah_depth);
    int right = build_capped(prims, mid, end, nodes, leaf_size, depth + 1,
                             sah_depth);
    finish(left, right);
    return node_idx;
}

}  // namespace

extern "C" {

// bvh_build's arguments and result, the tree capped as above at binary
// depth sah_depth (0: object medians from the root).
int bvh_build_capped(const float *v0, const float *e1, const float *e2,
                     int n, int leaf_size, int sah_depth, int32_t *order,
                     float *nodes_out, int max_nodes) {
    std::vector<Prim> prims(n);
    for (int i = 0; i < n; ++i) {
        Prim &p = prims[i];
        float a[3], b[3], c[3];
        for (int k = 0; k < 3; ++k) {
            a[k] = v0[3 * i + k];
            b[k] = a[k] + e1[3 * i + k];
            c[k] = a[k] + e2[3 * i + k];
        }
        p.box.expand(a); p.box.expand(b); p.box.expand(c);
        for (int k = 0; k < 3; ++k)
            p.centroid[k] = (p.box.lo[k] + p.box.hi[k]) * 0.5f;
        p.index = i;
    }
    std::vector<Node> nodes;
    nodes.reserve(2 * n);
    build_capped(prims, 0, n, nodes, leaf_size, 0, sah_depth);
    if ((int)nodes.size() > max_nodes) return -1;
    for (int i = 0; i < n; ++i) order[i] = prims[i].index;
    std::memcpy(nodes_out, nodes.data(), nodes.size() * sizeof(Node));
    return (int)nodes.size();
}

}  // extern "C"
