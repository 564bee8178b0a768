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
// order. Pair node i is four float4: for each child [lo xyz, ref] [hi xyz,
// count], ref and count int32 bits; an interior child has count 0 and ref
// its pair index, a leaf has count > 0 and ref its first position in the
// tree's face order, an empty child ref -1. Woop rows and face ids are in
// the tree's face order, so a leaf's faces are contiguous; `prim` maps a
// position to the reference's face id, which ties and attributes use.
//
// What bounds it: operations and dependent loads. A ray's work is about
// two box tests per pair node it visits and one Woop t per face of each
// leaf it reaches (u and v only for a face whose t is in range); nodes and
// Woop rows are read through the read-only path and stay in L2 (biggeo's
// 262k faces: 12.6 MB of Woop rows and about 4 MB of nodes). The design:
// near child first, a far child pushed on a stack of pair indices in
// local memory (depth checked on the host), boxes tested against
// [mint, best t] with `<=` so a face at an equal t with a lower id is
// still reached, ties to the lowest face id, any-hit ending at the first
// occluder in [mint, maxt].
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bvh {

// entries of the traversal stack (ops/bvh.py STACK_DEPTH)
constexpr int STACK = 64;

struct Tree {
    const float4* nodes;   // (P, 4) pair nodes
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

// The same with the rows read through the read-only path.
template <bool K2>
__device__ __forceinline__ bool face_uv(const float4* w, float t,
                                        const Ray& r, float& u, float& v) {
    return face_uv<K2>(__ldg(w), __ldg(w + 1), t, r, u, v);
}

// Slab test of one child box against [mint, cap] -> hit, entry t.
__device__ __forceinline__ bool slab(const Ray& r, float4 lo, float4 hi,
                                     float cap, float& t_enter) {
    const float ax = (lo.x - r.ox) * r.ix, bx = (hi.x - r.ox) * r.ix;
    const float ay = (lo.y - r.oy) * r.iy, by = (hi.y - r.oy) * r.iy;
    const float az = (lo.z - r.oz) * r.iz, bz = (hi.z - r.oz) * r.iz;
    const float tn = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)),
                           fmaxf(fminf(az, bz), r.mint));
    const float tf = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)),
                           fminf(fmaxf(az, bz), cap));
    t_enter = tn;
    return tn <= tf;
}

// The walk. ANY: stop at the first face with t in [mint, maxt] (returns
// its id, else -1); otherwise the closest such face, ties to the lowest
// face id (its id, or -1), with t, u, v of the hit.
template <bool K2, bool ANY>
__device__ __forceinline__ int walk(const Tree& tr, const Ray& r, float maxt,
                                    float& t, float& u, float& v) {
    int best = -1;
    float tb = maxt;
    int stack[STACK];
    int sp = 0, node = 0;
    // faces first .. first + count - 1; true once ANY has its occluder
    auto leaf = [&](int first, int count) -> bool {
        for (int j = first; j < first + count; ++j) {
            const float4* w = tr.woop + 3 * j;
            const float tf = face_t<K2>(__ldg(w + 2), r);
            if (!(tf >= r.mint && tf <= tb)) continue;
            const int id = __ldg(tr.prim + j);
            if (!ANY && tf == tb && (unsigned)id >= (unsigned)best) continue;
            float uu, vv;
            if (!face_uv<K2>(w, tf, r, uu, vv)) continue;
            best = id;
            if (ANY) return true;
            tb = tf;
            u = uu;
            v = vv;
        }
        return false;
    };
    for (;;) {
        const float4* n = tr.nodes + 4 * node;
        const float4 a0 = __ldg(n), a1 = __ldg(n + 1);
        const float4 b0 = __ldg(n + 2), b1 = __ldg(n + 3);
        int ra = __float_as_int(a0.w), ca = __float_as_int(a1.w);
        int rb = __float_as_int(b0.w), cb = __float_as_int(b1.w);
        float ta, tbb;
        bool ha = ra >= 0 && slab(r, a0, a1, tb, ta);
        bool hb = rb >= 0 && slab(r, b0, b1, tb, tbb);
        if (ha && hb && tbb < ta) {          // the nearer child first
            int x = ra; ra = rb; rb = x;
            x = ca; ca = cb; cb = x;
            const float y = ta; ta = tbb; tbb = y;
        }
        int next = -1;
        if (ha) {
            if (ca > 0) {
                if (leaf(ra, ca) && ANY) break;
            } else {
                next = ra;
            }
        }
        if (hb && tbb <= tb) {
            if (cb > 0) {
                if (leaf(rb, cb) && ANY) break;
            } else if (next < 0) {
                next = rb;
            } else {
                stack[sp++] = rb;             // the far subtree waits
            }
        }
        if (next < 0) {
            if (sp == 0) break;
            next = stack[--sp];
        }
        node = next;
    }
    t = tb;
    return best;
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
