// Per-ray BVH traversal, shared by the path kernel's BVH tier
// (path_kernel.cu, F_BVH) and the scene's ray queries (intersect_kernel.cu,
// K2).
//
// Replaces the large-mesh tiers of mitsuba2_tpu/ops/megakernel.py
// (_bvh_traverse :570, closest_hit :676, any_hit :1077, the range-median
// tree :2085) and the face sweep of mitsuba2_tpu/ops/intersect_pallas.py
// (_isect_kernel :81). The TPU walks one tree per tile of rays and sweeps
// the union of the tile's leaves; here each thread walks its own ray, so a
// ray tests only the boxes and faces on its own path.
//
// The tree (ops/bvh.py pack_traversal) is the reference's binned-SAH
// builder run at a few faces per leaf over the faces in the reference's
// order, collapsed into 4-wide nodes. A node is one 128-byte line, eight
// float4 in structure-of-arrays form over its four children: lo x, lo y,
// lo z, hi x, hi y, hi z, then the four refs and the four counts as int32
// bits; an interior child has count 0 and ref its node index, a leaf has
// count > 0 and ref its first position in the tree's face order, an empty
// slot ref -1 and a box no ray hits. The leaves are the binary tree's:
// Woop rows and face ids are in the tree's face order, so a leaf's faces
// are contiguous; `prim` maps a position to the reference's face id, which
// ties and attributes use.
//
// What bounds it: chains of dependent loads, not operations. A ray's work
// is a few box tests per node and one Woop test per face of each leaf it
// reaches; nodes and Woop rows stay in L2 (biggeo's 262k faces: 12.6 MB
// of Woop rows, 4.9 MB of nodes), but which node to read next is known
// only after the slab tests of the node before, and which face rows to
// read only after the node, so a walk is a chain of L2 round trips; the
// instructions a node costs add to each link. The design:
// - 4-wide nodes halve the chain of dependent node reads against the
//   binary tree's pair nodes: a node is eight independent float4 loads
//   through the read-only path, one 128-byte line, and its four slab
//   tests are independent instructions; each axis reads its near and far
//   planes by the sign of the ray's direction, so a box test has no
//   per-axis minima and maxima;
// - a leaf's face reads its three Woop rows at once (one round trip, not
//   three: the Z row, then the face id, then the U and V rows), and its
//   face id only on an exact tie in t, and the hit's at the end;
// - the hit children are sorted by entry t with a fixed five-exchange
//   network over (t, word) pairs, a hit leaf's faces are tested when
//   reached, nearest first, and the farther interior children are pushed
//   farthest first with their entry t, so that a pop whose box begins
//   beyond the best t so far is dropped without reading its node;
// - the stack holds the wide tree's bound (ops/bvh.py STACK_DEPTH,
//   checked on the host) of 8-byte entries in local memory (one column a
//   thread in shared memory cost resident blocks and ran slower);
// - boxes are tested against [mint, best t] with `<=` so a face at an
//   equal t with a lower id is still reached, ties go to the lowest face
//   id, and any hit ends at the first occluder in [mint, maxt]: the result
//   does not depend on the visiting order, so the wide walk's hits are the
//   binary walk's bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bvh {

// children of a node (ops/bvh.py WIDTH), entries of the traversal stack
// (ops/bvh.py STACK_DEPTH, the bound a tree must keep within, checked on
// the host before every launch), and the count bits of a leaf's word
// (ops/bvh.py LEAF_BITS); tests/test_torch_bvh.py holds each equal to its
// Python twin
constexpr int WIDTH = 4;
constexpr int STACK = 48;
constexpr int LEAF_BITS = 5;

struct Tree {
    const float4* nodes;   // (P, 8) wide nodes
    const float4* woop;    // (F, 3) [Wu | Wv | Wz] in the tree's order
    const int* prim;       // (F,) reference face id of each position
};

struct Ray {
    float ox, oy, oz, dx, dy, dz;
    float ix, iy, iz;      // guarded inverse direction
    float mint;
};

__device__ __forceinline__ float guarded_inv(float d) {
    return 1.0f / (fabsf(d) > 1e-12f ? d : 1e-12f);
}

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float mint) {
    return Ray{ox, oy, oz, dx, dy, dz, guarded_inv(dx), guarded_inv(dy),
               guarded_inv(dz), mint};
}

// One Woop axis row: [p, 1] . w and [d, 0] . w.
__device__ __forceinline__ float dot_o(float4 w, float ox, float oy,
                                       float oz) {
    return ox * w.x + oy * w.y + oz * w.z + w.w;
}

__device__ __forceinline__ float dot_d(float4 w, float dx, float dy,
                                       float dz) {
    return dx * w.x + dy * w.y + dz * w.z;
}

// The path kernel's barycentric test at parameter t (the reference's
// min-form test, written as three comparisons so that NaN fails it).
__device__ __forceinline__ bool inside(float4 wu, float4 wv, float t,
                                       float ox, float oy, float oz,
                                       float dx, float dy, float dz,
                                       float& u, float& v) {
    u = dot_o(wu, ox, oy, oz) + t * dot_d(wu, dx, dy, dz);
    v = dot_o(wv, ox, oy, oz) + t * dot_d(wv, dx, dy, dz);
    return u >= 0.0f && v >= 0.0f && 1.0f - u - v >= 0.0f;
}

// K2's products and sums, each rounded on its own in the plain twin's
// order (ops/intersect.py woop_test): no fused multiply-add, so that the
// kernel's t, u and v are the twin's bit for bit. A thin face's Woop rows
// are large and its u and v differences of large products, which a fused
// multiply-add would round differently.
__device__ __forceinline__ float dot_o_rn(float4 w, float ox, float oy,
                                          float oz) {
    return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(ox, w.x),
                                         __fmul_rn(oy, w.y)),
                               __fmul_rn(oz, w.z)), w.w);
}

__device__ __forceinline__ float dot_d_rn(float4 w, float dx, float dy,
                                          float dz) {
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, w.x), __fmul_rn(dy, w.y)),
                     __fmul_rn(dz, w.z));
}

// Face test of one Woop row. K2 is _isect_kernel's form
// (intersect_pallas.py:129-137): |DZ| > 1e-12, t = -Z * (1 / DZ),
// u + v <= 1, unfused; otherwise the path kernel's: t = -Z / DZ, min-form
// test.
template <bool K2>
__device__ __forceinline__ float face_t(float4 wz, const Ray& r) {
    if constexpr (K2) {
        const float z = dot_o_rn(wz, r.ox, r.oy, r.oz);
        const float dz = dot_d_rn(wz, r.dx, r.dy, r.dz);
        // NaN fails every range test: a never-hit face
        return fabsf(dz) > 1e-12f ? __fmul_rn(-z, 1.0f / dz)
                                  : __int_as_float(0x7fc00000);
    }
    return -dot_o(wz, r.ox, r.oy, r.oz) / dot_d(wz, r.dx, r.dy, r.dz);
}

// u and v of one face at t from its U and V rows -> whether t is inside.
template <bool K2>
__device__ __forceinline__ bool face_uv(float4 wu, float4 wv, float t,
                                        const Ray& r, float& u, float& v) {
    if constexpr (K2) {
        u = __fadd_rn(dot_o_rn(wu, r.ox, r.oy, r.oz),
                      __fmul_rn(t, dot_d_rn(wu, r.dx, r.dy, r.dz)));
        v = __fadd_rn(dot_o_rn(wv, r.ox, r.oy, r.oz),
                      __fmul_rn(t, dot_d_rn(wv, r.dx, r.dy, r.dz)));
        return u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f;
    }
    return inside(wu, wv, t, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, u, v);
}

// Component c (a constant after unrolling) of a float4.
__device__ __forceinline__ float part(const float4& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The children of one node as the walk sees them: entry t (+inf where the
// box is missed or the slot empty) and w, an interior child's node index
// (>= 0) or a leaf's ~(first << LEAF_BITS | count - 1).
struct Kids {
    float t[WIDTH];
    int w[WIDTH];
};

// Float4 offsets in a node line of the near plane of each axis (lo where
// the ray's direction is positive, else hi); the far plane is the other.
struct Planes {
    int x, y, z;
};

__device__ __forceinline__ Planes near_planes(const Ray& r) {
    return Planes{r.ix >= 0.0f ? 0 : 3, r.iy >= 0.0f ? 1 : 4,
                  r.iz >= 0.0f ? 2 : 5};
}

// A float4 of a node line: through the read-only path (LDG), or a plain
// load (a line in shared memory, tools/shape_ceiling.py's box ceiling).
template <bool LDG>
__device__ __forceinline__ float4 line_load(const float4* p) {
    if constexpr (LDG) return __ldg(p);
    return *p;
}

// One node's line, eight independent float4 loads, and the slab tests of
// its four children against [mint, cap]. Each axis reads its near and far
// planes by the ray's direction, which gives slab's entry and exit t bit
// for bit (the products are monotonic in the plane, lo <= hi) without its
// per-axis minima and maxima; an empty slot's box, lo +inf and hi -inf,
// is missed.
template <bool LDG = true>
__device__ __forceinline__ Kids test_line(const Ray& r, const Planes& p,
                                          const float4* n, float cap) {
    const float4 nx = line_load<LDG>(n + p.x);
    const float4 ny = line_load<LDG>(n + p.y);
    const float4 nz = line_load<LDG>(n + p.z);
    const float4 fx = line_load<LDG>(n + 3 - p.x);
    const float4 fy = line_load<LDG>(n + 5 - p.y);
    const float4 fz = line_load<LDG>(n + 7 - p.z);
    const float4 rf = line_load<LDG>(n + 6), ct = line_load<LDG>(n + 7);
    Kids k;
#pragma unroll
    for (int c = 0; c < WIDTH; ++c) {
        const float tn = fmaxf(
            fmaxf((part(nx, c) - r.ox) * r.ix, (part(ny, c) - r.oy) * r.iy),
            fmaxf((part(nz, c) - r.oz) * r.iz, r.mint));
        const float tf = fminf(
            fminf((part(fx, c) - r.ox) * r.ix, (part(fy, c) - r.oy) * r.iy),
            fminf((part(fz, c) - r.oz) * r.iz, cap));
        const int ref = __float_as_int(part(rf, c));
        const int cnt = __float_as_int(part(ct, c));
        k.t[c] = tn <= tf ? tn : __int_as_float(0x7f800000);
        k.w[c] = cnt > 0 ? ~((ref << LEAF_BITS) | (cnt - 1)) : ref;
    }
    return k;
}

// Exchange children i and j where j's entry t is the smaller.
__device__ __forceinline__ void exchange(Kids& k, int i, int j) {
    if (k.t[j] < k.t[i]) {
        const float t = k.t[i];
        k.t[i] = k.t[j];
        k.t[j] = t;
        const int w = k.w[i];
        k.w[i] = k.w[j];
        k.w[j] = w;
    }
}

// The four children by entry t, nearest first, missed ones last
// (ops/intersect.py _sort_kids runs the same network).
__device__ __forceinline__ void sort_kids(Kids& k) {
    exchange(k, 0, 1);
    exchange(k, 2, 3);
    exchange(k, 0, 2);
    exchange(k, 1, 3);
    exchange(k, 1, 2);
}

// The walk. ANY: stop at the first face with t in [mint, maxt] (returns
// 0, else -1); otherwise the closest such face, ties to the lowest face id
// (its id, or -1), with t, u, v of the hit.
template <bool K2, bool ANY>
__device__ __forceinline__ int walk(const Tree& tr, const Ray& r, float maxt,
                                    float& t, float& u, float& v) {
    // the best tree position; t within FLT_MAX, so that a missed child's
    // +inf is never in range (no face is hit at t = inf)
    int best = -1;
    float tb = maxt > 3.4028235e38f ? 3.4028235e38f : maxt;
    const Planes planes = near_planes(r);
    // pending nodes with their entry t, in local memory (a stack in shared
    // memory, one column a thread, ran slower on the card: PERF.md §6)
    int2 stack[STACK];
    int sp = 0, node = 0;
    // the faces of leaf w; true once ANY has its occluder. A face's three
    // Woop rows are read together, its face id only on a tie in t
    auto leaf = [&](int w) -> bool {
        const int first = ~w >> LEAF_BITS;
        const int end = first + (~w & ((1 << LEAF_BITS) - 1)) + 1;
        for (int j = first; j < end; ++j) {
            const float4* rows = tr.woop + 3 * j;
            const float4 wu = __ldg(rows), wv = __ldg(rows + 1);
            const float4 wz = __ldg(rows + 2);
            const float tf = face_t<K2>(wz, r);
            float uu, vv;
            const bool in = face_uv<K2>(wu, wv, tf, r, uu, vv);
            if (!(tf >= r.mint && tf <= tb) || !in) continue;
            if (ANY) return true;
            if (tf == tb && best >= 0
                && (unsigned)__ldg(tr.prim + j)
                    >= (unsigned)__ldg(tr.prim + best))
                continue;
            best = j;
            tb = tf;
            u = uu;
            v = vv;
        }
        return false;
    };
    for (;;) {
        Kids k = test_line(r, planes, tr.nodes + 8 * node, tb);
        sort_kids(k);
        // the hit leaves, nearest first, through one copy of the face loop
        unsigned leaves = 0;
#pragma unroll
        for (int c = 0; c < WIDTH; ++c)
            leaves |= (k.w[c] < 0 && k.t[c] <= tb ? 1u : 0u) << c;
        while (leaves) {
            const int c = __ffs(leaves) - 1;
            leaves &= leaves - 1;
            const float te = c == 0 ? k.t[0] : c == 1 ? k.t[1]
                : c == 2 ? k.t[2] : k.t[3];
            const int w = c == 0 ? k.w[0] : c == 1 ? k.w[1]
                : c == 2 ? k.w[2] : k.w[3];
            if (te <= tb && leaf(w) && ANY) {
                t = tb;
                return 0;
            }
        }
        // the interior children in range, farthest pushed first; the
        // nearest is the next node
        int next = -1;
        float t_next = 0.0f;
#pragma unroll
        for (int c = WIDTH - 1; c >= 0; --c) {
            if (k.w[c] >= 0 && k.t[c] <= tb) {
                if (next >= 0)
                    stack[sp++] = make_int2(next, __float_as_int(t_next));
                next = k.w[c];
                t_next = k.t[c];
            }
        }
        // else the nearest pending node whose box begins within the best t
        while (next < 0 && sp > 0) {
            const int2 e = stack[--sp];
            if (ANY || __int_as_float(e.y) <= tb) next = e.x;
        }
        if (next < 0) break;
        node = next;
    }
    t = tb;
    return best >= 0 ? __ldg(tr.prim + best) : -1;
}

// -> the reference face id of the closest hit in [mint, maxt], -1 if none.
template <bool K2>
__device__ __forceinline__ int closest_hit(const Tree& tr, const Ray& r,
                                           float maxt, float& t, float& u,
                                           float& v) {
    return walk<K2, false>(tr, r, maxt, t, u, v);
}

// -> whether any face is hit in [mint, maxt].
template <bool K2>
__device__ __forceinline__ bool any_hit(const Tree& tr, const Ray& r,
                                        float maxt) {
    float t, u, v;
    return walk<K2, true>(tr, r, maxt, t, u, v) >= 0;
}

}  // namespace bvh
