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
