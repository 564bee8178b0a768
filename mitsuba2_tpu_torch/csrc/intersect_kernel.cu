// Scene ray queries (sm_90a): closest hit and any hit of a batch of rays
// against the scene's triangles.
//
// Replaces mitsuba2_tpu/ops/intersect_pallas.py::_isect_kernel
// (intersect_pallas.py:81, called at :164), the wavefront closest hit that
// sweeps every 128-face chunk against each 256-ray tile behind a chunk-box
// cull. Here one thread takes one ray and walks the scene's traversal tree
// (csrc/bvh.cuh) with _isect_kernel's face test (|DZ| > 1e-12,
// t = -Z * (1 / DZ), u >= 0, v >= 0, u + v <= 1, mint <= t <= maxt), the
// lowest t winning and ties going to the lowest face id. It reads the same
// device tables as the path kernel's BVH tier (ops/path_kernel.py
// PathTables: bvh_nodes, bvh_woop, bvh_prim). It computes exactly the plain
// version in ops/intersect.py (closest_hit_reference, any_hit_reference),
// a linear sweep over every face, bit for bit (the face test unfused).
//
// What bounds it on the H100: the walk's chain of dependent reads from L2
// (csrc/bvh.cuh: a node, then a leaf's face rows), not its operations; the
// bytes it must move are the rays in (32 B each) and 16 B (closest) or 1 B
// (any) out. The design: the 4-wide walk of csrc/bvh.cuh, which halves
// the chain of node reads against the binary tree and reads a face's rows
// at once; a thread a ray, a block per 128 rays. Persistent warps taking
// 32 rays at a time from a counter (Aila and Laine, "Understanding the
// efficiency of ray traversal on GPUs", HPG 2009) ran no faster on the
// card (slower on camera rays; PERF.md §6).
//
// The instance entries (isect_closest_inst, isect_any_inst) answer the
// same queries against shared-geometry instances: mitsuba2_tpu/render/
// scene.py:613-634 (_instance_closest_hit), which the TPU runs as one
// face sweep an instance. Each thread loops over the instance rows (a
// small table read through the read-only path), moves its ray into the
// instance's group frame (o A^T + b, d A^T: t is kept, so hits compare
// across instances) and walks that group's own 4-wide tree with the walk
// above; its maxt is the best t so far, and a later instance replaces the
// best only at a strictly smaller t, which keeps the reference's order.
// The any-hit entry stops at the first instance that occludes. The
// transform is unfused, in the plain version's order (ops/intersect.py
// to_group), so the entries are closest_hit_instanced_reference and
// any_hit_instanced_reference bit for bit. A group's tree is built once,
// however many instances place it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh.cuh"

#define BLOCK 128

// Field for field ops/intersect_kernel.py::_IsectArgs.
struct IsectArgs {
    const float4* nodes;      // (P, 8) wide nodes
    const float4* woop;       // (F, 3) Woop rows in the tree's face order
    const int* prim;          // (F,) face id of each tree position
    const float* o;           // (n, 3)
    const float* d;           // (n, 3)
    const float* mint;        // (n,)
    const float* maxt;        // (n,)
    float* t;                 // (n,) closest: inf on a miss
    float* uv;                // (n, 2) closest: 0 on a miss
    int* prim_out;            // (n,) closest: -1 on a miss
    uint8_t* hit;             // (n,) any: 1 where occluded
    int n_rays;
};

// Field for field ops/intersect_kernel.py::_InstArgs: every group's tree
// (nodes, Woop rows and face ids, one group after another; a face id is
// the group's own) and the instance rows.
struct InstArgs {
    const float4* nodes;      // (P, 8) the groups' wide nodes
    const float4* woop;       // (F, 3) the groups' Woop rows, tree order
    const int* prim;          // (F,) the group's face id of each position
    const int* group_node;    // (G,) each group's first node
    const int* group_face;    // (G,) each group's first tree position
    const float* rows;        // (I, 24) [A (9) | b (3) | B (9) | group | ..]
    int n_instances;
    int g_max;                // a prim id's stride: the largest group
};

namespace {

// One ray's query.
template <bool ANY>
__device__ __forceinline__ void query(const IsectArgs& a,
                                      const bvh::Tree& tree, int i) {
    const bvh::Ray r = bvh::make_ray(a.o[3 * i], a.o[3 * i + 1],
                                     a.o[3 * i + 2], a.d[3 * i],
                                     a.d[3 * i + 1], a.d[3 * i + 2],
                                     a.mint[i]);
    if constexpr (ANY) {
        a.hit[i] = bvh::any_hit<true>(tree, r, a.maxt[i]) ? 1 : 0;
    } else {
        float t, u, v;
        const int f = bvh::closest_hit<true>(tree, r, a.maxt[i], t, u, v);
        a.t[i] = f >= 0 ? t : __int_as_float(0x7f800000);
        a.uv[2 * i] = f >= 0 ? u : 0.0f;
        a.uv[2 * i + 1] = f >= 0 ? v : 0.0f;
        a.prim_out[i] = f;
    }
}

template <bool ANY>
__global__ void __launch_bounds__(BLOCK) isect_kernel(const IsectArgs a) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < a.n_rays)
        query<ANY>(a, bvh::Tree{a.nodes, a.woop, a.prim}, i);
}

// A ray in the frame of the instance at `row`: o A^T + b and d A^T, each
// product and sum rounded on its own, left to right.
__device__ __forceinline__ bvh::Ray to_group(const float* row, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz,
                                             float mint) {
    float a[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) a[k] = __ldg(row + k);
    float o[3], d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        o[k] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(ox, a[3 * k]),
                                             __fmul_rn(oy, a[3 * k + 1])),
                                   __fmul_rn(oz, a[3 * k + 2])),
                         a[9 + k]);
        d[k] = __fadd_rn(__fadd_rn(__fmul_rn(dx, a[3 * k]),
                                   __fmul_rn(dy, a[3 * k + 1])),
                         __fmul_rn(dz, a[3 * k + 2]));
    }
    return bvh::make_ray(o[0], o[1], o[2], d[0], d[1], d[2], mint);
}

// One ray's query against every instance, in order.
template <bool ANY>
__device__ __forceinline__ void query_inst(const IsectArgs& a,
                                           const InstArgs& g, int i) {
    const float ox = a.o[3 * i], oy = a.o[3 * i + 1], oz = a.o[3 * i + 2];
    const float dx = a.d[3 * i], dy = a.d[3 * i + 1], dz = a.d[3 * i + 2];
    const float mint = a.mint[i];
    float tb = a.maxt[i], ub = 0.0f, vb = 0.0f;
    int best = -1;
    for (int k = 0; k < g.n_instances; ++k) {
        const float* row = g.rows + 24 * k;
        const int grp = (int)__ldg(row + 21);
        const int fo = __ldg(g.group_face + grp);
        const bvh::Tree tree{g.nodes + 8 * __ldg(g.group_node + grp),
                             g.woop + 3 * fo, g.prim + fo};
        const bvh::Ray r = to_group(row, ox, oy, oz, dx, dy, dz, mint);
        if constexpr (ANY) {
            if (bvh::any_hit<true>(tree, r, tb)) {
                a.hit[i] = 1;
                return;
            }
        } else {
            float t, u, v;
            const int f = bvh::closest_hit<true>(tree, r, tb, t, u, v);
            if (f >= 0 && (best < 0 || t < tb)) {
                tb = t;
                ub = u;
                vb = v;
                best = k * g.g_max + f;
            }
        }
    }
    if constexpr (ANY) {
        a.hit[i] = 0;
    } else {
        a.t[i] = best >= 0 ? tb : __int_as_float(0x7f800000);
        a.uv[2 * i] = ub;
        a.uv[2 * i + 1] = vb;
        a.prim_out[i] = best;
    }
}

template <bool ANY>
__global__ void __launch_bounds__(BLOCK) isect_inst_kernel(
    const IsectArgs a, const InstArgs g) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < a.n_rays) query_inst<ANY>(a, g, i);
}

template <bool ANY>
int launch_inst(const IsectArgs& a, const InstArgs& g, cudaStream_t stream) {
    const int grid = (a.n_rays + BLOCK - 1) / BLOCK;
    isect_inst_kernel<ANY><<<grid, BLOCK, 0, stream>>>(a, g);
    return (int)cudaGetLastError();
}

// Launches the query on `stream`, a thread a ray -> a CUDA error code.
template <bool ANY>
int launch(const IsectArgs& a, cudaStream_t stream) {
    const int grid = (a.n_rays + BLOCK - 1) / BLOCK;
    isect_kernel<ANY><<<grid, BLOCK, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// C entry points on `stream`; each returns a CUDA error code (0 when the
// launch was accepted).
extern "C" int isect_closest(const IsectArgs* args, void* stream) {
    return launch<false>(*args, (cudaStream_t)stream);
}

extern "C" int isect_any(const IsectArgs* args, void* stream) {
    return launch<true>(*args, (cudaStream_t)stream);
}

// The instance entries: the rays and outputs in `args` (its tree fields
// unused), the groups and instances in `inst`.
extern "C" int isect_closest_inst(const IsectArgs* args,
                                  const InstArgs* inst, void* stream) {
    return launch_inst<false>(*args, *inst, (cudaStream_t)stream);
}

extern "C" int isect_any_inst(const IsectArgs* args, const InstArgs* inst,
                              void* stream) {
    return launch_inst<true>(*args, *inst, (cudaStream_t)stream);
}
