// Film splat of the path kernel's samples (sm_90a).
//
// Replaces the separable shift-splat at the end of
// mitsuba2_tpu/ops/megakernel.py::DiffusePathMegakernel.render_pass
// (megakernel.py:3041-3073; XLA code there, not a Pallas kernel). It
// computes exactly the plain PyTorch version splat_reference in
// ops/splat.py: each lane of a pass is one sample of pixel lane / spp, its
// film jitter (jx, jy) re-derived from the lane's TEA key at sampler
// dimension 0 bit for bit as the path kernel drew it; tap (tx, ty) of the
// K x K stencil (K = 2b + 1, offsets tx - b, ty - b) puts the sample's
// [r, g, b, 1] times f(tx - b + 1/2 - jx) f(ty - b + 1/2 - jy) into block
// pixel (px + tx, py + ty) of the (h + 2b, w + 2b, 4) block. The sums
// differ from the plain version's only in their order.
//
// What bounds it on the H100: its float operations, just ahead of its
// bytes. It must read 12 bytes a lane (50 MB for the 4,194,304 lanes of a
// 256x256x64 pass) and write 16 bytes a block pixel; per lane it computes
// 2K filter values, K x 4 products and K^2 x 4 multiply-adds (about 420
// FLOPs for K = 5, plus 13 TEA rounds of integer work), which take the
// card's fp32 peak a little longer than the bytes take its memory. The
// plain version's tap loop moves the lanes K^2 times.
//
// What the design does about that:
// - Two passes, no atomics. splat_taps: one warp per source pixel; each
//   thread takes one sample of it at a time, derives its jitter and filter
//   values once, and the warp sums the K^2 x 4 weighted values over the
//   pixel's samples (through shared memory: thread t sums outputs t, t +
//   32, ... over the warp's 32 samples, so no value moves between lanes),
//   writing them to a (w h, K^2 x 4) scratch (26 MB for K = 5, read back
//   from L2). splat_gather: one thread per block pixel adds its K^2 taps
//   from the scratch in the plain version's (ty, tx) order.
// - Lanes are read once, coalesced along the samples of a pixel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rng.cuh"

#define WARPS 4

// Field for field ops/splat.py::_SplatArgs.
struct SplatArgs {
    const float* rgb;     // (3, n) per-lane linear sRGB
    float* taps;          // (w h, K K 4) per source pixel and tap
    float* out;           // (h + 2b, w + 2b, 4) image block
    float params[8];      // the filter's float32 constants (rfilters.py)
    uint32_t seed, sample_base;
    int filter, border, spp, width, height;
};

namespace {

// filter ids (models/rfilters.py)
constexpr int BOX = 0, TENT = 1, GAUSSIAN = 2, MITCHELL = 3, LANCZOS = 4;
constexpr int MAX_TAPS = 9;                       // ops/splat.py MAX_TAPS
constexpr int MAX_OUT = MAX_TAPS * MAX_TAPS * 4;  // values a source pixel
constexpr int OUT_PER_THREAD = (MAX_OUT + 31) / 32;

__device__ __forceinline__ float sinc(float v, float pi) {
    v = fabsf(v) * pi;
    return v < 1e-5f ? 1.0f : sinf(v) / (v == 0.0f ? 1.0f : v);
}

// The filter at x, as models/rfilters.py evaluates it.
__device__ __forceinline__ float filter_eval(int id, const float* p,
                                             float x) {
    switch (id) {
        case BOX:
            return fabsf(x) <= 0.5f ? 1.0f : 0.0f;
        case TENT:
            return fmaxf(1.0f - fabsf(x / p[0]), 0.0f);
        case GAUSSIAN:
            return fmaxf(expf(p[0] * x * x) - p[1], 0.0f);
        case MITCHELL: {
            x = fabsf(x);
            const float x2 = x * x, x3 = x2 * x;
            const float inner = (p[0] * x3 + p[1] * x2 + p[2]) * p[7];
            const float outer =
                (p[3] * x3 + p[4] * x2 + p[5] * x + p[6]) * p[7];
            return x < 1.0f ? inner : (x < 2.0f ? outer : 0.0f);
        }
        case LANCZOS:  // lobes, radius, pi
            return fabsf(x) < p[1]
                ? sinc(x, p[2]) * sinc(x / p[0], p[2]) : 0.0f;
        default:
            return 0.0f;
    }
}

__global__ void __launch_bounds__(32 * WARPS) splat_taps(const SplatArgs a) {
    // per warp: each sample's K filter values along y and K x 4 weighted
    // values along x
    __shared__ float s_fy[WARPS][32][MAX_TAPS];
    __shared__ float s_u[WARPS][32][MAX_TAPS * 4];
    const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
    const int pixel = blockIdx.x * WARPS + warp;
    const int n_pixels = a.width * a.height;
    if (pixel >= n_pixels) return;
    const int K = 2 * a.border + 1, n_out = K * K * 4;
    const size_t n = (size_t)n_pixels * a.spp;
    float acc[OUT_PER_THREAD];
#pragma unroll
    for (int j = 0; j < OUT_PER_THREAD; ++j) acc[j] = 0.0f;
    for (int s0 = 0; s0 < a.spp; s0 += 32) {
        const int s = s0 + t;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float jx = 0.0f, jy = 0.0f;
        if (s < a.spp) {
            // the lane key of megakernel.py:1316-1329, then dim 0
            uint32_t ka = (uint32_t)pixel;
            uint32_t kb = (uint32_t)s + a.sample_base;
            tea(ka, kb, 4);
            uint32_t key = a.seed, unused = ka;
            tea(key, unused, 4);
            rng2(key, 0u, jx, jy);
            const size_t lane = (size_t)pixel * a.spp + s;
            v[0] = a.rgb[lane];
            v[1] = a.rgb[n + lane];
            v[2] = a.rgb[2 * n + lane];
            v[3] = 1.0f;
        }
        for (int k = 0; k < K; ++k) {
            const float o = (float)(k - a.border) + 0.5f;
            s_fy[warp][t][k] = filter_eval(a.filter, a.params, o - jy);
            const float fx = filter_eval(a.filter, a.params, o - jx);
#pragma unroll
            for (int c = 0; c < 4; ++c) s_u[warp][t][4 * k + c] = v[c] * fx;
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < OUT_PER_THREAD; ++j) {
            const int out = t + 32 * j;
            if (out < n_out) {
                const int ty = out / (4 * K), rest = out % (4 * K);
                float sum = acc[j];
                for (int l = 0; l < 32; ++l)
                    sum += s_fy[warp][l][ty] * s_u[warp][l][rest];
                acc[j] = sum;
            }
        }
        __syncwarp();
    }
    float* dst = a.taps + (size_t)pixel * n_out;
#pragma unroll
    for (int j = 0; j < OUT_PER_THREAD; ++j) {
        const int out = t + 32 * j;
        if (out < n_out) dst[out] = acc[j];
    }
}

__global__ void splat_gather(const SplatArgs a) {
    const int b = a.border, K = 2 * b + 1;
    const int bw = a.width + 2 * b, bh = a.height + 2 * b;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= bw * bh) return;
    const int X = i % bw, Y = i / bw;
    float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int ty = 0; ty < K; ++ty) {
        const int py = Y - ty;
        if (py < 0 || py >= a.height) continue;
        for (int tx = 0; tx < K; ++tx) {
            const int px = X - tx;
            if (px < 0 || px >= a.width) continue;
            const float4 tap = *reinterpret_cast<const float4*>(
                a.taps + ((size_t)(py * a.width + px) * K * K + ty * K + tx)
                * 4);
            sum[0] += tap.x;
            sum[1] += tap.y;
            sum[2] += tap.z;
            sum[3] += tap.w;
        }
    }
    reinterpret_cast<float4*>(a.out)[i] =
        make_float4(sum[0], sum[1], sum[2], sum[3]);
}

}  // namespace

// C entry point: the tap pass and the gather pass on `stream`; returns
// cudaGetLastError() (0 when both launches were accepted).
extern "C" int splat_render(const SplatArgs* args, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const SplatArgs& a = *args;
    if (a.border < 0 || 2 * a.border + 1 > MAX_TAPS || a.spp < 1)
        return (int)cudaErrorInvalidValue;
    const int n_pixels = a.width * a.height;
    splat_taps<<<(n_pixels + WARPS - 1) / WARPS, 32 * WARPS, 0, s>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n_block = (a.width + 2 * a.border) * (a.height + 2 * a.border);
    splat_gather<<<(n_block + 255) / 256, 256, 0, s>>>(a);
    return (int)cudaGetLastError();
}
