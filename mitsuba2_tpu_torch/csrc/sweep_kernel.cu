// The face-test ceiling (sm_90a): every ray against every face of a Woop
// table, `iters` times, to measure what a face test costs on the card.
//
// Replaces the inline `kernel` of benchmarks/mxu_shape_ceiling.py (:44,
// pallas_call :58), the TPU path kernel's face sweep on its own: per chunk
// of 128 faces the Woop table (4, 3C) contracted with the rays' [o,1 | d,0]
// columns (4, 2R) through three bf16 passes (mitsuba2_tpu/ops/megakernel.py
// _dot3T), feeding an 8-row sum that only keeps the product alive. Here one
// thread takes one ray and does the same per-pair arithmetic in float32,
// with the path kernel's face test (csrc/bvh.cuh face_t<false>,
// face_uv<false>, the form the flag-free tier and the BVH tier run):
// [o,1] . w and [d,0] . w for the U, V and Z rows of each face (24
// multiply-adds, fused), t = -Z / DZ, u = U + t DU, v = V + t DV, for every
// pair, then keeps the closest face with t >= mint, u >= 0, v >= 0,
// 1 - u - v >= 0, ties to the lowest face id. Its consumer is that closest
// hit, which needs every pair. Iteration k repeats the sweep with
// mint = k * mint_step, so no two iterations are the same query; each
// ray's count of iterations that hit is written out, so every iteration
// is used. The plain version (ops/sweep_kernel.py) runs K2's unfused test
// (t = -Z * (1 / DZ), u + v <= 1), so the two agree up to float rounding.
//
// Two instantiations: SHARED stages the table in dynamic shared memory
// (the path kernel's flag-free tier; 48 B a face, up to 4,842 faces), the
// other reads its rows through the read-only path from a table in device
// memory (the BVH tier's way; a table too large for L1 streams from L2).
// Every lane of a warp reads the same face at once, a broadcast.
//
// What bounds it: operations. A pair costs 40 float32 operations (the
// three rows' [o,1] . w and [d,0] . w, 33, the division, u, v and
// 1 - u - v) plus the range tests and the selects of the closest hit; the
// table is read once per block and the rays once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh.cuh"

#define BLOCK 256

// Field for field ops/sweep_kernel.py::_SweepArgs.
struct SweepArgs {
    const float4* woop;       // (F, 3) [Wu | Wv | Wz]
    const float* o;           // (n, 3)
    const float* d;           // (n, 3)
    float* t;                 // (n,) last iteration: inf on a miss
    float* uv;                // (n, 2) last iteration: 0 on a miss
    int* prim;                // (n,) last iteration: -1 on a miss
    int* hits;                // (n,) iterations with a hit
    int n_faces;
    int n_rays;
    int iters;
    float mint_step;
};

namespace {

template <bool SHARED>
__device__ __forceinline__ float4 row(const float4* w, int i) {
    if constexpr (SHARED) return w[i];
    return __ldg(w + i);
}

template <bool SHARED>
__global__ void __launch_bounds__(BLOCK) sweep_kernel(const SweepArgs a) {
    extern __shared__ float4 s_woop[];
    const int n_faces = a.n_faces;
    if constexpr (SHARED) {
        for (int i = threadIdx.x; i < 3 * n_faces; i += blockDim.x)
            s_woop[i] = a.woop[i];
        __syncthreads();
    }
    const float4* w = SHARED ? s_woop : a.woop;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.n_rays) return;
    const bvh::Ray r = bvh::make_ray(a.o[3 * i], a.o[3 * i + 1],
                                     a.o[3 * i + 2], a.d[3 * i],
                                     a.d[3 * i + 1], a.d[3 * i + 2], 0.0f);
    int hits = 0, best = -1;
    float tb = 0.0f, ub = 0.0f, vb = 0.0f;
    for (int it = 0; it < a.iters; ++it) {
        const float mint = (float)it * a.mint_step;
        best = -1;
        tb = __int_as_float(0x7f800000);
        ub = vb = 0.0f;
#pragma unroll 4
        for (int f = 0; f < n_faces; ++f) {
            const float4 wu = row<SHARED>(w, 3 * f);
            const float4 wv = row<SHARED>(w, 3 * f + 1);
            const float4 wz = row<SHARED>(w, 3 * f + 2);
            // every pair's full arithmetic, then one branch-free pick
            const float tf = bvh::face_t<false>(wz, r);
            float u, v;
            const bool in = bvh::face_uv<false>(wu, wv, tf, r, u, v);
            const bool take = in & (tf >= mint) & (tf < tb);
            tb = take ? tf : tb;
            ub = take ? u : ub;
            vb = take ? v : vb;
            best = take ? f : best;
        }
        hits += best >= 0;
    }
    a.t[i] = best >= 0 ? tb : __int_as_float(0x7f800000);
    a.uv[2 * i] = ub;
    a.uv[2 * i + 1] = vb;
    a.prim[i] = best;
    a.hits[i] = hits;
}

template <bool SHARED>
int launch(const SweepArgs& a, cudaStream_t stream) {
    const size_t smem = SHARED ? (size_t)a.n_faces * 3 * sizeof(float4) : 0;
    if constexpr (SHARED) {
        const cudaError_t err = cudaFuncSetAttribute(
            sweep_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int grid = (a.n_rays + BLOCK - 1) / BLOCK;
    sweep_kernel<SHARED><<<grid, BLOCK, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// C entry points: one thread per ray on `stream`; each returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int sweep_shared(const SweepArgs* args, void* stream) {
    return launch<true>(*args, (cudaStream_t)stream);
}

extern "C" int sweep_global(const SweepArgs* args, void* stream) {
    return launch<false>(*args, (cudaStream_t)stream);
}
