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
// multiply-adds, fused), t = -Z / DZ (IEEE division), u = U + t DU,
// v = V + t DV, for every pair, then keeps the closest face with t >= mint,
// u >= 0, v >= 0, 1 - u - v >= 0, ties to the lowest face id (each ray
// scans the faces in order with a strict <). Its consumer is that closest
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
// table is read once per block and the rays once. What the design does
// about it: the pair's arithmetic stays the path kernels' (and so does
// its instruction count, about 50 a pair, the issue floor); the launch
// gives the SM's schedulers the most independent warps the table allows
// (shared), and the global rows are loaded two faces ahead of their test,
// so that an L2 round trip hides behind two faces' tests (Tune below).
//
// The box-test ceiling beside it (box_kernel, two instantiations of the
// same kind): every ray against every child box of a table of the walk's
// 4-wide nodes (ops/bvh.py pack_traversal's 128-byte lines), each line
// read and tested as the walk does (csrc/bvh.cuh test_line: eight float4,
// four slab tests against [mint, inf)), `iters` times, iteration k with
// mint = k * mint_step; each ray writes the nearest entry t of its last
// iteration's hit boxes and its hit boxes summed over the iterations, so
// every test is used. The plain version (ops/sweep_kernel.py
// box_sweep_reference) runs the slab test with per-axis minima and maxima,
// which pick the planes the kernel reads, so the two agree bit for bit
// (for boxes whose entry t is finite). It prices a node visit of the
// walk: 12 float32 operations a box test (six subtractions, six
// multiplications) beside the maxima and minima, 32 B a box. What bounds
// it: issue. Test_line's arithmetic and the tally take 26-28 instructions
// a box test (the bound counts 6 issue slots), so the design keeps the
// walk's test and read path and gives the schedulers the most warps and
// loads in flight (BoxTune below): the shared table under one block of
// 1,024 threads an SM (32 warps), the loop's loads at immediate offsets
// from a uniform line base; the global lines a line ahead, in registers,
// through plane pointers that move a line a turn, two rays a thread. Any
// ray-to-thread mapping and line order keeps the outputs bit for bit (a
// minimum and an integer sum).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bvh.cuh"

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

// Field for field ops/sweep_kernel.py::_BoxArgs.
struct BoxArgs {
    const float4* lines;      // (L, 8) wide nodes
    const float* o;           // (n, 3)
    const float* d;           // (n, 3)
    float* near;              // (n,) last iteration: inf where none is hit
    int* hits;                // (n,) box hits over all iterations
    int n_lines;
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

// Threads a block and how many faces ahead a face's rows are loaded (0:
// in the turn that tests it), per instantiation. From the card (PERF.md
// §6, each layout timed beside a block of 256 threads with no rows ahead,
// the earlier one, in the same calls): the loop issues about 50
// instructions a pair whatever the layout (31 of them float32; FCHK and a
// branch around the division's slow path close each pair's block), so it
// runs best with the most warps and loads in flight. Shared: 512 threads,
// two blocks over one 96 KB table an SM (32 warps), each face's rows
// loaded in its own turn: 1.05x; 2, 4 and 8 rays a thread sharing each
// face's loads (fewer warps, their pairs' blocks in a row) ran 1.0x, 0.87x
// and 0.48x, rows a face ahead slower. Global: the rows two faces ahead,
// 1.44x (one ahead 1.06x; three ahead spilled, 1.09x; four ahead 1.01x;
// six ahead one block an SM, 0.54x); 2 and 4 rays a thread ran 0.92x and
// 0.75x.
template <bool SHARED>
struct Tune;
template <>
struct Tune<true> {
    static constexpr int THREADS = 512, AHEAD = 0;
};
template <>
struct Tune<false> {
    static constexpr int THREADS = 256, AHEAD = 2;
};

template <bool SHARED>
__device__ __forceinline__ void face_rows(const float4* w, int f,
                                          float4 (&q)[3]) {
    q[0] = row<SHARED>(w, 3 * f);
    q[1] = row<SHARED>(w, 3 * f + 1);
    q[2] = row<SHARED>(w, 3 * f + 2);
}

template <bool SHARED>
__global__ void __launch_bounds__(Tune<SHARED>::THREADS)
    sweep_kernel(const SweepArgs a) {
    constexpr int A = Tune<SHARED>::AHEAD;
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
    // the rows of faces f .. f + A - 1 (past the last face, the last)
    float4 ring[A > 0 ? A : 1][3];
    for (int it = 0; it < a.iters; ++it) {
        const float mint = (float)it * a.mint_step;
        best = -1;
        tb = __int_as_float(0x7f800000);
        ub = vb = 0.0f;
#pragma unroll
        for (int p = 0; p < A; ++p)
            face_rows<SHARED>(w, min(p, n_faces - 1), ring[p]);
#pragma unroll 4
        for (int f = 0; f < n_faces; ++f) {
            float4 q[3];
            if constexpr (A > 0) {
                // face f + A's rows in flight while face f is tested
#pragma unroll
                for (int c = 0; c < 3; ++c) q[c] = ring[0][c];
                float4 next[3];
                face_rows<SHARED>(w, min(f + A, n_faces - 1), next);
#pragma unroll
                for (int c = 0; c < 3; ++c) {
#pragma unroll
                    for (int p = 0; p + 1 < A; ++p)
                        ring[p][c] = ring[p + 1][c];
                    ring[A - 1][c] = next[c];
                }
            } else {
                face_rows<SHARED>(w, f, q);
            }
            // every pair's full arithmetic, then one branch-free pick
            const float tf = bvh::face_t<false>(q[2], r);
            float u, v;
            const bool in = bvh::face_uv<false>(q[0], q[1], tf, r, u, v);
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

// Threads a block, how many lines ahead a line's planes are loaded (0: in
// the turn that tests it, by test_line itself) and rays a thread, per box
// instantiation. From the card (PERF.md §6, each layout timed beside the
// earlier one, a block of 256 threads a ray each with no lines ahead, in
// the same calls): the box loop issues 26-28 instructions a box test
// whatever the layout (12 float32, 7 minima and maxima, 3 compares and
// selects, a load and a half), so it runs best with the most warps and
// loads in flight. Shared: 1,024 threads, 32 warps an SM over the one
// table: about 1.2x; 512 threads with 2 rays a thread or with a line
// ahead ran as fast, 4 rays a thread 1.07-1.09x, unroll 4 1.07-1.10x.
// Global: a line ahead, 2 rays a thread (128 blocks of 512 rays, one an
// SM at 251 registers): 1.29-1.35x; one ray a thread 1.15-1.24x, with
// unroll 4 1.26-1.29x or the lines split between two warps a ray
// 1.27-1.31x; two lines ahead (206 registers, one block of 256 rays an
// SM) 1.14-1.19x; the split without a line ahead 0.97-0.99x.
template <bool SHARED>
struct BoxTune;
template <>
struct BoxTune<true> {
    static constexpr int THREADS = 1024, AHEAD = 0, RAYS = 1;
};
template <>
struct BoxTune<false> {
    static constexpr int THREADS = 256, AHEAD = 1, RAYS = 2;
};

// A ray's pointers to the six planes its slab tests read from line 0 of
// `lines`, in test_line's order (near x, y, z, then far x, y, z).
__device__ __forceinline__ void plane_pointers(const float4* lines,
                                               const bvh::Planes& p,
                                               const float4* (&q)[6]) {
    q[0] = lines + p.x;
    q[1] = lines + p.y;
    q[2] = lines + p.z;
    q[3] = lines + 3 - p.x;
    q[4] = lines + 5 - p.y;
    q[5] = lines + 7 - p.z;
}

// The six planes of line l through a ray's plane pointers, each read as
// the walk reads it; q[6] and q[7] stand for the children's refs and
// counts, which the ceiling never uses.
template <bool SHARED>
__device__ __forceinline__ void line_planes(const float4* const (&p)[6],
                                            int l, float4 (&q)[8]) {
#pragma unroll
    for (int c = 0; c < 6; ++c) q[c] = row<SHARED>(p[c], 8 * l);
    q[6] = q[7] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// One line's four box tests into a ray's hit count and nearest entry t.
__device__ __forceinline__ void tally(const bvh::Kids& k, int& hits,
                                      float& near) {
#pragma unroll
    for (int c = 0; c < bvh::WIDTH; ++c) {
        hits += k.t[c] < __int_as_float(0x7f800000);
        near = fminf(near, k.t[c]);
    }
}

template <bool SHARED>
__global__ void __launch_bounds__(BoxTune<SHARED>::THREADS)
    box_kernel(const BoxArgs a) {
    constexpr int T = BoxTune<SHARED>::THREADS, A = BoxTune<SHARED>::AHEAD,
                  R = BoxTune<SHARED>::RAYS;
    extern __shared__ float4 s_lines[];
    const int n_lines = a.n_lines;
    if constexpr (SHARED) {
        for (int i = threadIdx.x; i < 8 * n_lines; i += blockDim.x)
            s_lines[i] = a.lines[i];
        __syncthreads();
    }
    const float4* lines = SHARED ? s_lines : a.lines;
    // rays first + j * T, j < R (past the last ray, the last: tested, not
    // written)
    const int first = blockIdx.x * T * R + threadIdx.x;
    if (first >= a.n_rays) return;
    const float inf = __int_as_float(0x7f800000);
    // the lines [l_begin, l_end), 0 and n_lines in a form the compiler
    // does not fold: with constant bounds nvcc rebuilds each load's
    // address from the line index (27.6 and 28.7 instructions a box test,
    // the global loop at 187 registers), with these it moves pointers a
    // turn and loads at immediate offsets from them (26.0 and 27.5, 251
    // registers), 1.11x shared and 1.25x global (PERF.md §6)
    const int l_begin = min(0, n_lines);
    const int l_end = min(l_begin + n_lines, n_lines);
    bvh::Ray r[R];
    bvh::Planes planes[R];
    const float4* plane[R][6];
    int hits[R];
    float near[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
        const int i = min(first + j * T, a.n_rays - 1);
        r[j] = bvh::make_ray(a.o[3 * i], a.o[3 * i + 1], a.o[3 * i + 2],
                             a.d[3 * i], a.d[3 * i + 1], a.d[3 * i + 2],
                             0.0f);
        planes[j] = bvh::near_planes(r[j]);
        plane_pointers(lines, planes[j], plane[j]);
        hits[j] = 0;
        near[j] = inf;
    }
    for (int it = 0; it < a.iters; ++it) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
            r[j].mint = (float)it * a.mint_step;
            near[j] = inf;
        }
        if constexpr (A == 0) {
            // a shared line is read with plain loads, a global one
            // through the read-only path, as the walk reads it
#pragma unroll 2
            for (int l = l_begin; l < l_end; ++l)
#pragma unroll
                for (int j = 0; j < R; ++j)
                    tally(bvh::test_line<!SHARED>(r[j], planes[j],
                                                  lines + 8 * l, inf),
                          hits[j], near[j]);
        } else {
            // each ray's planes of lines l .. l + A - 1 (past the last
            // line, the last)
            float4 ring[A][R][8];
            // test_line's plane offsets into line_planes' registers
            const bvh::Planes in_order{0, 1, 2};
            // ray j's test of the ring's first line, the ring moved up one
            // line with `next` last
            const auto ring_step = [&](int j, const float4(&next)[8]) {
                float4 q[8];
#pragma unroll
                for (int c = 0; c < 8; ++c) {
                    q[c] = ring[0][j][c];
#pragma unroll
                    for (int p = 0; p + 1 < A; ++p)
                        ring[p][j][c] = ring[p + 1][j][c];
                    ring[A - 1][j][c] = next[c];
                }
                tally(bvh::test_line<false>(r[j], in_order, q, inf),
                      hits[j], near[j]);
            };
            // line l + A's planes in flight while line l is tested, read
            // through plane pointers that move a line a turn (so that the
            // unrolled turns' loads take immediate offsets)
            const float4* ahead[R][6];
#pragma unroll
            for (int j = 0; j < R; ++j) {
#pragma unroll
                for (int p = 0; p < A; ++p)
                    line_planes<SHARED>(plane[j], min(l_begin + p, l_end - 1),
                                        ring[p][j]);
#pragma unroll
                for (int c = 0; c < 6; ++c)
                    ahead[j][c] = plane[j][c] + 8 * (l_begin + A);
            }
            int l = l_begin;
#pragma unroll 2
            for (; l < l_end - A; ++l)
#pragma unroll
                for (int j = 0; j < R; ++j) {
                    float4 next[8];
                    line_planes<SHARED>(ahead[j], 0, next);
#pragma unroll
                    for (int c = 0; c < 6; ++c) ahead[j][c] += 8;
                    ring_step(j, next);
                }
            // the last A lines, in the ring already
            for (; l < l_end; ++l)
#pragma unroll
                for (int j = 0; j < R; ++j) ring_step(j, ring[A - 1][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
        const int i = first + j * T;
        if (i < a.n_rays) {
            a.near[i] = near[j];
            a.hits[i] = hits[j];
        }
    }
}

template <bool SHARED>
int launch_boxes(const BoxArgs& a, cudaStream_t stream) {
    const size_t smem = SHARED ? (size_t)a.n_lines * 8 * sizeof(float4) : 0;
    if constexpr (SHARED) {
        const cudaError_t err = cudaFuncSetAttribute(
            box_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    constexpr int T = BoxTune<SHARED>::THREADS;
    constexpr int RAYS = T * BoxTune<SHARED>::RAYS;
    const int grid = (a.n_rays + RAYS - 1) / RAYS;
    box_kernel<SHARED><<<grid, T, smem, stream>>>(a);
    return (int)cudaGetLastError();
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
    constexpr int T = Tune<SHARED>::THREADS;
    const int grid = (a.n_rays + T - 1) / T;
    sweep_kernel<SHARED><<<grid, T, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

// *blocks <- resident blocks an SM of kernel at threads a block and smem
// bytes of dynamic shared memory (those of a shared instantiation set).
template <class Args>
int resident_blocks(void (*kernel)(Args), bool shared, size_t smem,
                    int threads, int* blocks) {
    cudaError_t err = cudaSuccess;
    if (shared)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            threads, smem);
    return (int)err;
}

// info <- threads a block, faces (lines) ahead, rays a thread and resident
// blocks an SM of the face (box) instantiation over n faces (lines).
template <bool SHARED, bool BOXES>
int launch_info(int n, int* info) {
    using Tn = std::conditional_t<BOXES, BoxTune<SHARED>, Tune<SHARED>>;
    info[0] = Tn::THREADS;
    info[1] = Tn::AHEAD;
    info[2] = BOXES ? BoxTune<SHARED>::RAYS : 1;
    info[3] = 0;
    if constexpr (BOXES)
        return resident_blocks(box_kernel<SHARED>, SHARED,
                               SHARED ? (size_t)n * 8 * sizeof(float4) : 0,
                               Tn::THREADS, info + 3);
    else
        return resident_blocks(sweep_kernel<SHARED>, SHARED,
                               SHARED ? (size_t)n * 3 * sizeof(float4) : 0,
                               Tn::THREADS, info + 3);
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

extern "C" int sweep_launch_info(int shared, int boxes, int n, int* info) {
    if (boxes)
        return shared ? launch_info<true, true>(n, info)
                      : launch_info<false, true>(n, info);
    return shared ? launch_info<true, false>(n, info)
                  : launch_info<false, false>(n, info);
}

extern "C" int boxes_shared(const BoxArgs* args, void* stream) {
    return launch_boxes<true>(*args, (cudaStream_t)stream);
}

extern "C" int boxes_global(const BoxArgs* args, void* stream) {
    return launch_boxes<false>(*args, (cudaStream_t)stream);
}
