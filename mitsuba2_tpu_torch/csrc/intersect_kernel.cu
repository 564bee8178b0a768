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
// a linear sweep over every face, up to float rounding.
//
// What bounds it on the H100: per ray the box and face tests of its walk
// (operations and dependent loads from L2); the bytes it must move are the
// rays in (32 B each) and 16 B (closest) or 1 B (any) out. Rays of a warp
// that diverge in the tree wait for each other; ray sorting and persistent
// threads are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh.cuh"

#define BLOCK 128

// Field for field ops/intersect_kernel.py::_IsectArgs.
struct IsectArgs {
    const float4* nodes;      // (P, 4) pair nodes
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

__device__ __forceinline__ bvh::Ray load_ray(const IsectArgs& a, int i) {
    return bvh::make_ray(a.o[3 * i], a.o[3 * i + 1], a.o[3 * i + 2],
                         a.d[3 * i], a.d[3 * i + 1], a.d[3 * i + 2],
                         a.mint[i]);
}

__global__ void __launch_bounds__(BLOCK) isect_closest_kernel(
        const IsectArgs a) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.n_rays) return;
    const bvh::Tree tree{a.nodes, a.woop, a.prim};
    float t, u, v;
    const int f = bvh::closest_hit<true>(tree, load_ray(a, i), a.maxt[i],
                                         t, u, v);
    a.t[i] = f >= 0 ? t : __int_as_float(0x7f800000);
    a.uv[2 * i] = f >= 0 ? u : 0.0f;
    a.uv[2 * i + 1] = f >= 0 ? v : 0.0f;
    a.prim_out[i] = f;
}

__global__ void __launch_bounds__(BLOCK) isect_any_kernel(
        const IsectArgs a) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.n_rays) return;
    const bvh::Tree tree{a.nodes, a.woop, a.prim};
    a.hit[i] = bvh::any_hit<true>(tree, load_ray(a, i), a.maxt[i]) ? 1 : 0;
}

}  // namespace

// C entry points: one thread per ray on `stream`; each returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int isect_closest(const IsectArgs* args, void* stream) {
    const int grid = (args->n_rays + BLOCK - 1) / BLOCK;
    isect_closest_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}

extern "C" int isect_any(const IsectArgs* args, void* stream) {
    const int grid = (args->n_rays + BLOCK - 1) / BLOCK;
    isect_any_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}
