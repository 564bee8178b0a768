// Film splat of the path kernel's samples (sm_90a).
//
// Replaces the separable shift-splat at the end of
// mitsuba2_tpu/ops/megakernel.py::DiffusePathMegakernel.render_pass
// (megakernel.py:3041-3073; XLA code there, not a Pallas kernel). It
// computes the plain PyTorch version splat_reference in ops/splat.py: each
// lane of a pass is one sample of pixel lane / spp, its film jitter (jx,
// jy) re-derived from the lane's TEA key at sampler dimension 0 bit for bit
// as the path kernel drew it; tap (tx, ty) of the K x K stencil (K = 2b +
// 1, offsets tx - b, ty - b) puts the sample's [r, g, b, 1] times f(tx - b
// + 1/2 - jx) f(ty - b + 1/2 - jy) into block pixel (px + tx, py + ty) of
// the (h + 2b, w + 2b, 4) block. The sums differ from the plain version's
// in their order, and the gaussian's exponential and the lanczos window's
// divisions are the card's fast ones (__expf, __fdividef: within 2 ulp
// where the arguments are, far inside the splat's bar).
//
// What bounds it on the H100: its instruction issue. It must read 12 bytes
// a lane (50 MB for the 4,194,304 lanes of a 256x256x64 pass) and write 16
// bytes a block pixel; per lane it computes 2K filter values, K x 4
// products and K^2 x 4 multiply-adds (about 420 FLOPs for K = 5), which
// take the card's fp32 peak a little longer than the bytes take its
// memory, and 13 TEA rounds (about 130 integer instructions) that the
// bound does not count.
//
// What the design does about that: one pass over tiles of source pixels,
// each pixel's taps summed in registers, nothing but that work a sample.
// - A block owns a tile of TX x TY source pixels (Tile<b>); a thread owns
//   one pixel, or for K >= 7 one of G lanes of a pixel owns a group of R
//   stencil rows (G = 4 at K = 7, 2 at K = 9, so the accumulators fit the
//   registers). A thread reads its pixel's lanes itself, four samples a
//   turn (a float4 a channel where spp is a multiple of 4; the other half
//   of each 32-byte sector comes from L1 on the next turn), evaluates each
//   sample's 2K filter values once and does the K x 4 products and K x R x
//   4 multiply-adds on register operands. With G = 1 it derives the next
//   turn's four jitters (four TEA chains) in this turn, so their integer
//   work overlaps the float work; with G > 1 each lane derives every G-th
//   sample's jitter and filter values and the others read them by shuffle.
//   One instantiation per K and filter: the accumulators are sized by K.
// - The tile's (TY + 2b) x (TX + 2b) x 4 output lives in shared memory;
//   its pixels add their taps there in K^2 phases, one tap each, a barrier
//   between phases, so no two threads write one word and each word's sum
//   runs in the plain version's (ty, tx) order.
// - Pixels that no other tile touches go straight to the block. The 2b-wide
//   bands that neighbouring tiles share go to a per-tile scratch (`bands`,
//   about 2 MB at 256x256, K = 5), which splat_bands, one thread per block
//   pixel, sums in a fixed order (tile rows, then columns). No atomics: two
//   launches give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rng.cuh"

// Field for field ops/splat.py::_SplatArgs.
struct SplatArgs {
    const float* rgb;     // (3, n) per-lane linear sRGB
    float* bands;         // per tile its (TY + 2b) x (TX + 2b) x 4 footprint
    float* out;           // (h + 2b, w + 2b, 4) image block
    float params[8];      // the filter's float32 constants (rfilters.py)
    uint32_t seed, sample_base;
    int filter, border, spp, width, height;
    // the global id of the pass's first pixel: a band of rows starting at
    // row r passes r * width, and `height` is the band's rows (ops/splat.py
    // splat); appended last so that every field above keeps its offset
    uint32_t pixel_base;
};

namespace {

// filter ids (models/rfilters.py)
constexpr int BOX = 0, TENT = 1, GAUSSIAN = 2, MITCHELL = 3, LANCZOS = 4;
constexpr unsigned FULL = 0xffffffffu;

// A tile by border b: TX x TY source pixels, G threads a pixel, MINB blocks
// resident on an SM.
template <int B> struct Tile;
template <> struct Tile<0> {
    static constexpr int TX = 16, TY = 8, G = 1, MINB = 4; };
template <> struct Tile<1> {
    static constexpr int TX = 16, TY = 8, G = 1, MINB = 4; };
template <> struct Tile<2> {
    static constexpr int TX = 16, TY = 8, G = 1, MINB = 3; };
template <> struct Tile<3> {
    static constexpr int TX = 8, TY = 8, G = 4, MINB = 2; };
template <> struct Tile<4> {
    static constexpr int TX = 8, TY = 8, G = 2, MINB = 2; };

template <int B> struct Geo : Tile<B> {
    using T = Tile<B>;
    static constexpr int K = 2 * B + 1;
    static constexpr int NT = T::TX * T::TY * T::G;  // threads a block
    static constexpr int R = (K + T::G - 1) / T::G;  // stencil rows a thread
    static constexpr int TW = T::TX + 2 * B, TH = T::TY + 2 * B;
    static_assert(T::G == 1 || T::G == 2 || T::G == 4,
                  "a pixel's lanes within a warp and a turn's four samples");
};

__device__ __forceinline__ float sinc(float v, float pi) {
    v = fabsf(v) * pi;
    return v < 1e-5f ? 1.0f : __fdividef(sinf(v), v == 0.0f ? 1.0f : v);
}

// The filter at x, as models/rfilters.py evaluates it.
template <int F>
__device__ __forceinline__ float filter_eval(const float* p, float x) {
    if constexpr (F == BOX) {
        return fabsf(x) <= 0.5f ? 1.0f : 0.0f;
    } else if constexpr (F == TENT) {
        return fmaxf(1.0f - fabsf(x / p[0]), 0.0f);
    } else if constexpr (F == GAUSSIAN) {
        return fmaxf(__expf(p[0] * x * x) - p[1], 0.0f);
    } else if constexpr (F == MITCHELL) {
        x = fabsf(x);
        const float x2 = x * x, x3 = x2 * x;
        const float inner = (p[0] * x3 + p[1] * x2 + p[2]) * p[7];
        const float outer = (p[3] * x3 + p[4] * x2 + p[5] * x + p[6]) * p[7];
        return x < 1.0f ? inner : (x < 2.0f ? outer : 0.0f);
    } else {  // LANCZOS: lobes, radius, pi
        return fabsf(x) < p[1]
            ? sinc(x, p[2]) * sinc(__fdividef(x, p[0]), p[2]) : 0.0f;
    }
}

// The K filter values f(k - b + 1/2 - j) of one axis of a sample.
template <int F, int B, int K>
__device__ __forceinline__ void filter_row(const float* p, float j,
                                           float (&f)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k)
        f[k] = filter_eval<F>(p, (float)(k - B) + 0.5f - j);
}

// The film jitter of sample s of the film's pixel `pixel`: the lane key of
// megakernel.py:1316-1329, then sampler dimension 0.
__device__ __forceinline__ void jitter(const SplatArgs& a, uint32_t pixel,
                                       int s, float& jx, float& jy) {
    uint32_t ka = pixel, kb = (uint32_t)s + a.sample_base;
    tea(ka, kb, 4);
    uint32_t key = a.seed, unused = ka;
    tea(key, unused, 4);
    rng2(key, 0u, jx, jy);
}

// One sample's taps of stencil rows fy into the accumulators: per column
// its filter value fx[k], the products with [r, g, b, 1] and the
// multiply-adds.
template <int K, int R>
__device__ __forceinline__ void add_taps(float (&acc)[R][K][4],
                                         const float (&fx)[K],
                                         const float (&fy)[R], float v0,
                                         float v1, float v2) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const float u0 = v0 * fx[k], u1 = v1 * fx[k], u2 = v2 * fx[k];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            acc[r][k][0] += fy[r] * u0;
            acc[r][k][1] += fy[r] * u1;
            acc[r][k][2] += fy[r] * u2;
            acc[r][k][3] += fy[r] * fx[k];
        }
    }
}

template <int B, int F>
__global__ void __launch_bounds__(Geo<B>::NT, Geo<B>::MINB)
splat_tile(const SplatArgs a) {
    using T = Geo<B>;
    constexpr int K = T::K, R = T::R, G = T::G;
    extern __shared__ float4 s_mem[];
    float4* s_tile = s_mem;

    const int t = threadIdx.x, p = t / G, g = t % G;
    const int W = a.width, H = a.height, spp = a.spp;
    const int n_tx = (W + T::TX - 1) / T::TX;
    const int x0 = (int)(blockIdx.x % n_tx) * T::TX;
    const int y0 = (int)(blockIdx.x / n_tx) * T::TY;
    const int lx = p % T::TX, ly = p / T::TX;
    const bool live = x0 + lx < W && y0 + ly < H;
    const uint32_t pixel = (uint32_t)((y0 + ly) * W + x0 + lx);
    const size_t n = (size_t)W * H * spp;
    const float* src = a.rgb + (size_t)pixel * spp;
    // the film's pixel id, which keys the jitter (a band's rows count from
    // its first)
    const uint32_t film_pixel = pixel + a.pixel_base;
    // four samples of a channel as one float4
    const bool vec = spp % 4 == 0 && ((uintptr_t)a.rgb & 15) == 0;
    float prm[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) prm[i] = a.params[i];

    for (int i = t; i < T::TH * T::TW; i += T::NT)
        s_tile[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();  // the tile is zeroed

    float acc[R][K][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][k][c] = 0.0f;

    // G = 1: the jitter of this turn's four samples
    float jx[4], jy[4];
    if constexpr (G == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) jitter(a, film_pixel, i, jx[i], jy[i]);
    }
    for (int s0 = 0; s0 < spp; s0 += 4) {
        float v[3][4];
        if (live && vec) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const float4 q = __ldg(
                    reinterpret_cast<const float4*>(src + c * n + s0));
                v[c][0] = q.x;
                v[c][1] = q.y;
                v[c][2] = q.z;
                v[c][3] = q.w;
            }
        } else {
#pragma unroll
            for (int c = 0; c < 3; ++c)
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    v[c][i] = live && s0 + i < spp
                        ? __ldg(src + c * n + s0 + i) : 0.0f;
        }
        if constexpr (G == 1) {
            // the next four samples' jitter, independent of this turn's
            // taps: its integer work overlaps their float work
            float nx[4], ny[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                jitter(a, film_pixel, s0 + 4 + i, nx[i], ny[i]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                float fx[K], fy[K];
                filter_row<F, B>(prm, jx[i], fx);
                filter_row<F, B>(prm, jy[i], fy);
                // a sample past spp (a last turn of fewer than four) adds
                // nothing
#pragma unroll
                for (int k = 0; k < K; ++k)
                    fy[k] = s0 + i < spp ? fy[k] : 0.0f;
                add_taps(acc, fx, fy, v[0][i], v[1][i], v[2][i]);
                jx[i] = nx[i];
                jy[i] = ny[i];
            }
        } else {
            // G lanes a pixel: lane g derives samples s0 + qG + g, and each
            // sample's filter values reach the others by shuffle; the
            // stencil rows of lane g are gR .. gR + R - 1 (those below K)
            const int base = (t & 31) - g;
#pragma unroll
            for (int q = 0; q < 4 / G; ++q) {
                float ox, oy;
                jitter(a, film_pixel, s0 + q * G + g, ox, oy);
                float fxm[K], fym[K];
                filter_row<F, B>(prm, ox, fxm);
                filter_row<F, B>(prm, oy, fym);
#pragma unroll
                for (int h = 0; h < G; ++h) {
                    const int i = q * G + h;
                    float fx[K], fy[R];
#pragma unroll
                    for (int r = 0; r < R; ++r) fy[r] = 0.0f;
#pragma unroll
                    for (int k = 0; k < K; ++k) {
                        fx[k] = __shfl_sync(FULL, fxm[k], base + h);
                        const float y = __shfl_sync(FULL, fym[k], base + h);
                        fy[k % R] = g == k / R ? y : fy[k % R];
                    }
#pragma unroll
                    for (int r = 0; r < R; ++r)
                        fy[r] = s0 + i < spp ? fy[r] : 0.0f;
                    add_taps(acc, fx, fy, v[0][i], v[1][i], v[2][i]);
                }
            }
        }
    }

    // the taps into the output tile: phase (ty, tx) adds every pixel's tap
    // (ty, tx), so the pixels of one phase write distinct words
#pragma unroll
    for (int ty = 0; ty < K; ++ty) {
#pragma unroll
        for (int tx = 0; tx < K; ++tx) {
            if (live && g == ty / R) {
                const int i = (ly + ty) * T::TW + lx + tx;
                float4 o = s_tile[i];
                const float* c = acc[ty % R][tx];
                o.x += c[0];
                o.y += c[1];
                o.z += c[2];
                o.w += c[3];
                s_tile[i] = o;
            }
            __syncthreads();
        }
    }

    // this tile's pixels to the block, the shared bands to the scratch
    const int BW = W + 2 * B, BH = H + 2 * B;
    float4* band = reinterpret_cast<float4*>(a.bands)
        + (size_t)blockIdx.x * T::TH * T::TW;
    for (int i = t; i < T::TH * T::TW; i += T::NT) {
        const int ix = i % T::TW, iy = i / T::TW;
        const int X = x0 + ix, Y = y0 + iy;
        if (X >= BW || Y >= BH) continue;
        const bool shared_x = (ix < 2 * B && x0 > 0)
            || (ix >= T::TX && x0 + T::TX < W);
        const bool shared_y = (iy < 2 * B && y0 > 0)
            || (iy >= T::TY && y0 + T::TY < H);
        if (shared_x || shared_y)
            band[i] = s_tile[i];
        else
            reinterpret_cast<float4*>(a.out)[(size_t)Y * BW + X] = s_tile[i];
    }
}

// One thread per block pixel: a pixel that two or four tiles share is the
// sum of their partials, tile rows then columns in ascending order.
template <int B>
__global__ void splat_bands(const SplatArgs a) {
    using T = Geo<B>;
    const int W = a.width, H = a.height, BW = W + 2 * B, BH = H + 2 * B;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= BW * BH) return;
    const int X = i % BW, Y = i / BW;
    const int n_tx = (W + T::TX - 1) / T::TX, n_ty = (H + T::TY - 1) / T::TY;
    // the last and the first tile column and row whose footprint holds the
    // pixel
    const int cx = min(X / T::TX, n_tx - 1), cy = min(Y / T::TY, n_ty - 1);
    int cx0 = cx, cy0 = cy;
    while (cx0 > 0 && X - (cx0 - 1) * T::TX < T::TW) --cx0;
    while (cy0 > 0 && Y - (cy0 - 1) * T::TY < T::TH) --cy0;
    if (cx0 == cx && cy0 == cy) return;  // one tile's: written by it
    const float4* band = reinterpret_cast<const float4*>(a.bands);
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int ty = cy0; ty <= cy; ++ty) {
        for (int tx = cx0; tx <= cx; ++tx) {
            const float4 v = band[((size_t)(ty * n_tx + tx) * T::TH
                                   + Y - ty * T::TY) * T::TW
                                  + X - tx * T::TX];
            sum.x += v.x;
            sum.y += v.y;
            sum.z += v.z;
            sum.w += v.w;
        }
    }
    reinterpret_cast<float4*>(a.out)[i] = sum;
}

template <int B, int F>
int launch(const SplatArgs& a, cudaStream_t s) {
    using T = Geo<B>;
    const int n_tiles = ((a.width + T::TX - 1) / T::TX)
        * ((a.height + T::TY - 1) / T::TY);
    splat_tile<B, F><<<n_tiles, T::NT, T::TH * T::TW * sizeof(float4),
                       s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || B == 0) return (int)err;
    const int n_block = (a.width + 2 * B) * (a.height + 2 * B);
    splat_bands<B><<<(n_block + 255) / 256, 256, 0, s>>>(a);
    return (int)cudaGetLastError();
}

template <int B>
int launch_filter(const SplatArgs& a, cudaStream_t s) {
    switch (a.filter) {
        case BOX: return launch<B, BOX>(a, s);
        case TENT: return launch<B, TENT>(a, s);
        case GAUSSIAN: return launch<B, GAUSSIAN>(a, s);
        case MITCHELL: return launch<B, MITCHELL>(a, s);
        case LANCZOS: return launch<B, LANCZOS>(a, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <int B>
long long band_floats(int width, int height) {
    using T = Geo<B>;
    return (long long)((width + T::TX - 1) / T::TX)
        * ((height + T::TY - 1) / T::TY) * T::TH * T::TW * 4;
}

}  // namespace

// C entry point: the tile pass and, for K > 1, the band pass on `stream`;
// returns cudaGetLastError() (0 when the launches were accepted).
extern "C" int splat_render(const SplatArgs* args, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const SplatArgs& a = *args;
    if (a.spp < 1 || a.width < 1 || a.height < 1)
        return (int)cudaErrorInvalidValue;
    switch (a.border) {
        case 0: return launch_filter<0>(a, s);
        case 1: return launch_filter<1>(a, s);
        case 2: return launch_filter<2>(a, s);
        case 3: return launch_filter<3>(a, s);
        case 4: return launch_filter<4>(a, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// Floats of the band scratch a pass of width x height pixels needs under a
// filter of border b; -1 for a border beyond the widest stencil.
extern "C" long long splat_band_floats(int border, int width, int height) {
    switch (border) {
        case 0: return band_floats<0>(width, height);
        case 1: return band_floats<1>(width, height);
        case 2: return band_floats<2>(width, height);
        case 3: return band_floats<3>(width, height);
        case 4: return band_floats<4>(width, height);
        default: return -1;
    }
}
