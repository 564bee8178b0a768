// Path kernel (sm_90a).
//
// Replaces mitsuba2_tpu/ops/megakernel.py::_path_kernel (megakernel.py:365)
// in its K1a scope (triangle meshes, constant-albedo diffuse BSDFs,
// constant area lights, box filter), its large-mesh tiers (K1f: the
// streamed sweep and the HBM BVH walk, megakernel.py:570-675, :676-1009,
// :1077-1197, :2085, here one per-ray walk, csrc/bvh.cuh, for more than
// 1024 faces), its matpreview scopes:
// analytic spheres (K1b), one lat-long envmap with CDF-inverted NEE and
// escape MIS (K1c), isotropic GGX rough conductors with visible-normal
// sampling and checkerboard albedo (K1d), and its color modes (K1e): rgb,
// spectral hero-wavelength transport (megakernel.py:287-324 hero
// wavelengths and sigmoid reflectances, :436-463 D65 and CMF lookups,
// :1480-1503, :1553-1558, :1687-1690, :1713-1714 spectral emission, env
// and albedo, :1567-1587 conductor IOR quadratics, :1378-1393 and
// :1979-1986 the CIE develop) and mono luminance. It computes exactly the
// plain PyTorch version path_radiance_reference in ops/path_kernel.py: the
// same TEA keys and sampler dimensions, the same Woop and sphere tests, the
// same NEE arms, MIS, roulette and spawn offsets, so the two agree lane by
// lane up to float rounding.
//
// What bounds it on the H100: operations, not bytes. A lane writes 12
// bytes (50 MB for the 4,194,304 paths of a 256x256x64 render, about 15 us
// at 3.35 TB/s) and reads its tables from shared memory and L2; the path
// state stays in registers. The time goes to the O(F) face loop that every
// ray and every shadow ray runs (about 15 FLOPs per face test), to the
// shading math (a few hundred FLOPs per bounce, four channels of it in
// spectral mode), and to divergence: lanes of one warp end their paths at
// different depths and take different branches (lobe, NEE arm, escape).
// chip_smoke.py counts the FLOPs a render's paths need and prints the
// bound, max(FLOPs / 67 TFLOP/s, bytes / 3.35 TB/s), beside the time.
//
// What the design does about that, in this first version:
// - One thread per lane and the whole path in one launch, the bounce loop
//   inside the thread. Nothing of the path goes through device memory
//   between bounces (the TPU kernel relaunched per bounce and carried
//   state in HBM), and a lane whose path ends simply leaves the loop.
// - The scene content picks the instantiation (template FLAGS, the TPU
//   kernel's static has_spheres / has_env / has_ggx / has_checker gates),
//   so a scene pays only for the features it has. With no flag set (the
//   Cornell box) the kernel is the K1a kernel: Woop rows and the first
//   three attribute float4s of every face (four in spectral mode, for the
//   emitter's D65 scale) staged in shared memory.
// - The color mode is the template parameter NC (3 rgb, 4 hero wavelengths,
//   1 luminance); one library is built per mode (-DPK_NC), each with its
//   16 flag instantiations. Throughput and radiance are NC floats in
//   registers. The hero wavelengths, their D65 values and normalized
//   positions are computed once per path (the TPU kernel re-derived them
//   from the key on every bounce), and each table value is a direct two-tap
//   lerp of the 96-row D65 / CMF table, which sits in shared memory (the
//   lanes of a warp read different rows; constant memory would serialize
//   them). The CIE develop to linear sRGB is the path's epilogue, run by
//   every lane, so the output is 3 floats per lane in every mode.
// - With any flag set, only what every ray loops over is staged in shared
//   memory: the Woop rows and the sphere rows. All threads of a warp read
//   the same face at the same step of the loop, so each read is a
//   broadcast. The attribute row of the hit face or sphere (ten float4) is
//   read once per bounce from global memory through the read-only path.
// - Above 1024 faces (F_BVH) the Woop rows stay in global memory and every
//   ray and shadow ray walks the scene's traversal tree instead of the
//   loop (csrc/bvh.cuh: near child first, a stack per thread, ties to the
//   lowest face id, the shadow walk ending at the first occluder). The
//   walk's barycentrics feed the checker lookup. The sphere loop stays.
// - The env radiance is one float4 texel per 16 bytes (a bilinear fetch is
//   four loads); env sampling is two binary searches (marginal cdf, then
//   the row's conditional cdf), giving exactly the reference's
//   count(cdf <= u) index; the env pdf is a direct pmf load.
// - The closest-hit loop computes u and v only for a face whose t is in
//   range and closer than the best so far; the shadow loops stop at the
//   first occluder.
// Ray sorting, occupancy tuning and warp-coherent scheduling are later
// work. Math is exact (atan2f, acosf, sinf, cosf, logf, expf; no
// fast-math).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh.cuh"
#include "rng.cuh"
#include "shading.cuh"

// color channels of this library's instantiations: 3 rgb, 4 spectral
// (hero wavelengths), 1 mono (ops/path_kernel.py library_defines)
#ifndef PK_NC
#error "build with -DPK_NC=3, 4 or 1"
#endif

#define BLOCK 128
#define BIG 3.0e38f

// Field for field ops/path_kernel.py::_PathArgs.
struct PathArgs {
    const float4* woop;       // (F, 3) float4: [Wu | Wv | Wz]
    const float4* fattr;      // (F, 10) float4: attribute columns
    const float* lights;      // (L, 24)
    const float4* sph;        // (S,) [center, radius]
    const float4* sattr;      // (S, 10) float4
    const float4* env;        // (H, W) [r, g, b, 0]
    const float* env_marg;    // (Hs,)
    const float* env_cond;    // (Hs, Ws)
    const float* env_pmf;     // (Hs, Ws)
    const float* env_rot;     // (18,) to_world 3x3, then its transpose
    const float4* spd;        // (96,) [D65, CMF x, y, z] (spectral)
    const float4* bvh_nodes;  // (P, 4) traversal pair nodes (csrc/bvh.cuh)
    const float4* bvh_woop;   // (F, 3) Woop rows in the tree's face order
    const int* bvh_prim;      // (F,) face id of each tree position
    const float* cam;         // (16,)
    float* out;               // (3, n_lanes)
    int n_faces, n_lights, n_spheres;
    int env_w, env_h, env_ws, env_hs, env_has_rot;
    float p_env;
    uint32_t seed, sample_base;
    int spp_pass, width, height, max_depth, rr_depth, n_lanes;
    int flags, nc;
};

namespace {

// instantiation flags (ops/path_kernel.py HAS_*)
constexpr int F_SPHERES = 1, F_ENV = 2, F_GGX = 4, F_CHECKER = 8;
constexpr int F_BVH = 16;
// attribute float4s per face / sphere (ops/path_kernel.py FA / 4)
constexpr int FA4 = 10;
// rows of the D65 / CMF table (ops/path_kernel.py SPD_ROWS)
constexpr int SPD_ROWS = 96;

// float32 roundings of the reference's double constants
constexpr float INV_2PI = (float)(0.5 / 3.141592653589793);
constexpr float INV_PI = (float)(1.0 / 3.141592653589793);
constexpr float TWO_PI = (float)(2.0 * 3.141592653589793);
constexpr float TWO_PI2 = (float)(2.0 * 3.141592653589793 * 3.141592653589793);
constexpr float WL_MIN = 360.0f, WL_SPAN = 470.0f;
constexpr float SPD_STEP = (float)(94.0 / 470.0);

// Component c (a compile-time constant after unrolling) of a float4.
__device__ __forceinline__ float comp(const float4& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Jakob-Hanika sigmoid reflectance at normalized wavelength x.
__device__ __forceinline__ float sigmoid_poly(float c0, float c1, float c2,
                                              float x) {
    const float t = (c0 * x + c1) * x + c2;
    return 0.5f + t / (2.0f * sqrtf(1.0f + t * t));
}

// Column `col` of the D65 / CMF table at wavelength wl (nm): a two-tap
// lerp (megakernel.py:436-463).
__device__ __forceinline__ float spd_lerp(const float4* spd, float wl,
                                          int col) {
    const float tpos = (wl - WL_MIN) * SPD_STEP;
    const float i0 = fminf(fmaxf(floorf(tpos), 0.0f), 93.0f);
    const float w1 = fminf(fmaxf(tpos - i0, 0.0f), 1.0f);
    const int i = (int)i0;
    return comp(spd[i], col) * (1.0f - w1) + comp(spd[i + 1], col) * w1;
}

// Woop rows of one face: three float4 [Wu | Wv | Wz] (csrc/bvh.cuh).
using bvh::dot_d;
using bvh::dot_o;
using bvh::inside;

// Sphere hit parameter: the near root if above 0, else the far root;
// > 0 only on a hit (megakernel.py:917-929).
__device__ __forceinline__ float sphere_t(float4 c, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz) {
    const float lx = ox - c.x, ly = oy - c.y, lz = oz - c.z;
    const float b = lx * dx + ly * dy + lz * dz;
    const float cc = lx * lx + ly * ly + lz * lz - c.w * c.w;
    const float disc = b * b - cc;
    if (!(disc > 0.0f)) return -1.0f;
    const float sq = sqrtf(disc);
    const float t0 = -b - sq;
    return t0 > 0.0f ? t0 : -b + sq;
}

__device__ __forceinline__ int imod(int a, int m) {
    const int r = a % m;
    return r < 0 ? r + m : r;
}

// Count of entries <= x of a non-decreasing array: the reference's
// sum(cdf <= u) index, by binary search.
__device__ __forceinline__ int count_le(const float* a, int n, float x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(a + mid) <= x) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// Constant 3x3 (row-major) times v, renormalised.
__device__ __forceinline__ void rot3(const float* M, float& x, float& y,
                                     float& z) {
    const float rx = __ldg(M + 0) * x + __ldg(M + 1) * y + __ldg(M + 2) * z;
    const float ry = __ldg(M + 3) * x + __ldg(M + 4) * y + __ldg(M + 5) * z;
    const float rz = __ldg(M + 6) * x + __ldg(M + 7) * y + __ldg(M + 8) * z;
    const float inv = rsqrtf(fmaxf(rx * rx + ry * ry + rz * rz, 1e-20f));
    x = rx * inv;
    y = ry * inv;
    z = rz * inv;
}

// World direction -> env-local (u, v, sin theta) (envmap.cpp convention).
__device__ __forceinline__ void env_uv(const PathArgs& a, float dx, float dy,
                                       float dz, float& u, float& v,
                                       float& st) {
    if (a.env_has_rot) rot3(a.env_rot + 9, dx, dy, dz);
    u = atan2f(dx, -dz) * INV_2PI + 0.5f;
    v = acosf(fminf(fmaxf(dy, -1.0f), 1.0f)) * INV_PI;
    st = sqrtf(fmaxf(1.0f - dy * dy, 1e-12f));
}

// Bilinear lat-long fetch of the four texel planes with u and v wrapping
// (megakernel.py:1219).
__device__ __forceinline__ float4 env_fetch(const PathArgs& a, float u,
                                           float v) {
    const int W = a.env_w, H = a.env_h;
    const float fu = u * (float)W - 0.5f;
    const float fv = v * (float)H - 0.5f;
    const float u0 = floorf(fu), v0 = floorf(fv);
    const float wu = fu - u0, wv = fv - v0;
    const int iu0 = imod((int)u0, W), iv0 = imod((int)v0, H);
    const int iu1 = iu0 + 1 == W ? 0 : iu0 + 1;
    const int iv1 = iv0 + 1 == H ? 0 : iv0 + 1;
    const float4 t00 = __ldg(a.env + iv0 * W + iu0);
    const float4 t10 = __ldg(a.env + iv1 * W + iu0);
    const float4 t01 = __ldg(a.env + iv0 * W + iu1);
    const float4 t11 = __ldg(a.env + iv1 * W + iu1);
    float4 out;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const float c0 = (1.0f - wv) * comp(t00, c) + wv * comp(t10, c);
        const float c1 = (1.0f - wv) * comp(t01, c) + wv * comp(t11, c);
        const float r = (1.0f - wu) * c0 + wu * c1;
        if (c == 0) out.x = r;
        else if (c == 1) out.y = r;
        else if (c == 2) out.z = r;
        else out.w = r;
    }
    return out;
}

// Solid-angle density of the env NEE arm toward world direction d.
__device__ __forceinline__ float env_pdf(const PathArgs& a, float dx,
                                         float dy, float dz) {
    float u, v, st;
    env_uv(a, dx, dy, dz, u, v, st);
    const int ws = a.env_ws, hs = a.env_hs;
    const int iu = imod((int)floorf(u * (float)ws), ws);
    const int iv = min(max((int)floorf(v * (float)hs), 0), hs - 1);
    return __ldg(a.env_pmf + iv * ws + iu) * (float)(ws * hs)
        / fmaxf(TWO_PI2 * st, 1e-8f);
}

// CDF-inverted env sample -> world direction, solid-angle pdf, texel.
__device__ __forceinline__ void env_sample(const PathArgs& a, float u1,
                                           float u2, float j1, float j2,
                                           float& dx, float& dy, float& dz,
                                           float& pdf, float4& texel) {
    const int ws = a.env_ws, hs = a.env_hs;
    const int iv = min(count_le(a.env_marg, hs, u1), hs - 1);
    const int iu = min(count_le(a.env_cond + iv * ws, ws, u2), ws - 1);
    const float pmf = __ldg(a.env_pmf + iv * ws + iu);
    const float uu = ((float)iu + j1) / (float)ws;
    const float vv = ((float)iv + j2) / (float)hs;
    const float theta = vv * PI_F;
    const float phi = (uu - 0.5f) * TWO_PI;
    const float st = sinf(theta);
    dx = st * sinf(phi);
    dy = cosf(theta);
    dz = -st * cosf(phi);
    pdf = pmf * (float)(ws * hs) / fmaxf(TWO_PI2 * st, 1e-8f);
    texel = env_fetch(a, uu, vv);
    if (a.env_has_rot) rot3(a.env_rot, dx, dy, dz);
}

template <int FLAGS, int NC>
__global__ void __launch_bounds__(BLOCK) path_kernel(const PathArgs a) {
    constexpr bool SPH = FLAGS & F_SPHERES;
    constexpr bool ENV = FLAGS & F_ENV;
    constexpr bool GGX = FLAGS & F_GGX;
    constexpr bool CHK = FLAGS & F_CHECKER;
    constexpr bool SPEC = NC == 4;
    constexpr bool BVH = FLAGS & F_BVH;
    // attributes from global memory, spheres in shared memory
    constexpr bool WIDE = FLAGS != 0;
    // attribute float4s staged per face when !WIDE: [ng, lpdf_w]
    // [albedo, kind] [Le, alpha], and [eta, le_scale] in spectral mode
    constexpr int STAGE = SPEC ? 4 : 3;
    const int n_faces = a.n_faces;
    extern __shared__ float4 smem[];
    float4* s_spd = smem;                            // SPD_ROWS (spectral)
    // 3 float4 per face; none in the BVH tier
    float4* s_woop = smem + (SPEC ? SPD_ROWS : 0);
    // Cornell: STAGE attribute float4 per face; otherwise the sphere rows
    float4* s_more = s_woop + (BVH ? 0 : 3 * n_faces);
    if constexpr (!BVH) {
        for (int i = threadIdx.x; i < 3 * n_faces; i += blockDim.x)
            s_woop[i] = a.woop[i];
    }
    const bvh::Tree tree{a.bvh_nodes, a.bvh_woop, a.bvh_prim};
    if constexpr (!WIDE) {
        for (int i = threadIdx.x; i < STAGE * n_faces; i += blockDim.x)
            s_more[i] = a.fattr[(i / STAGE) * FA4 + i % STAGE];
    }
    if constexpr (SPH) {
        for (int i = threadIdx.x; i < a.n_spheres; i += blockDim.x)
            s_more[i] = a.sph[i];
    }
    if constexpr (SPEC) {
        for (int i = threadIdx.x; i < SPD_ROWS; i += blockDim.x)
            s_spd[i] = a.spd[i];
    }
    __syncthreads();
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= a.n_lanes) return;

    // ---- camera ray (megakernel.py:1315-1346) ----
    const int width = a.width, height = a.height;
    const int pixel = lane / a.spp_pass;
    uint32_t ka = (uint32_t)pixel;
    uint32_t kb = (uint32_t)(lane % a.spp_pass) + a.sample_base;
    tea(ka, kb, 4);
    uint32_t key = a.seed, unused = ka;
    tea(key, unused, 4);
    float jx, jy;
    rng2(key, 0u, jx, jy);
    const float* cam = a.cam;
    const float sx = ((float)(pixel % width) + jx) / (float)width;
    const float sy = ((float)(pixel / width) + jy) / (float)height;
    const float tan_half = cam[12];
    const float aspect = (float)((double)width / (double)height);
    const float cxs = -(2.0f * sx - 1.0f) * tan_half;
    const float cys = (1.0f - 2.0f * sy) * tan_half / aspect;
    const float inv_len = 1.0f / sqrtf(cxs * cxs + cys * cys + 1.0f);
    const float lx = cxs * inv_len, ly = cys * inv_len, lz = inv_len;
    float dx = cam[0] * lx + cam[1] * ly + cam[2] * lz;
    float dy = cam[3] * lx + cam[4] * ly + cam[5] * lz;
    float dz = cam[6] * lx + cam[7] * ly + cam[8] * lz;
    float ox = cam[9], oy = cam[10], oz = cam[11];

    float thr[NC], res[NC];
    // spectral: hero wavelengths (nm), their normalized x and D65 values,
    // constant along the path (megakernel.py:306-324)
    float wl[NC], xw[NC], d65[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        thr[c] = 1.0f;
        res[c] = 0.0f;
    }
    if constexpr (SPEC) {
        float u, u_unused;
        rng2(key, 1u, u, u_unused);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            float uc = u + (float)c * (1.0f / NC);
            uc = uc - floorf(uc);
            const float arg = 0.8569106254698279f - 1.8275019724092267f * uc;
            const float ath =
                0.5f * logf((1.0f + arg) / fmaxf(1.0f - arg, 1e-12f));
            wl[c] = 538.0f - ath * 138.88888888888889f;
            const float e = expf(0.0072f * (wl[c] - 538.0f));
            const float ch = 0.5f * (e + 1.0f / e);
            thr[c] = 253.82f * ch * ch;     // sensor weight 1 / pdf
            xw[c] = (wl[c] - WL_MIN) / WL_SPAN * 2.0f - 1.0f;
            d65[c] = spd_lerp(s_spd, wl[c], 0);
        }
    }
    float prev_pdf = 0.0f;      // 0: camera ray, no MIS at the first hit
    const float p_env = a.p_env;

    for (int depth = 0; depth < a.max_depth; ++depth) {
        const uint32_t dim0 = 2u + 8u * (uint32_t)depth;

        // ---- closest hit: lowest face id on ties, faces before spheres ----
        float t = BIG;
        int face = -1;
        float hu = 0.0f, hv = 0.0f;      // barycentrics of the face hit
        if constexpr (BVH) {
            face = bvh::closest_hit<false>(
                tree, bvh::make_ray(ox, oy, oz, dx, dy, dz, 0.0f), BIG, t,
                hu, hv);
            if (face < 0) t = BIG;
        } else {
            for (int f = 0; f < n_faces; ++f) {
                const float4 wz = s_woop[3 * f + 2];
                const float tf =
                    -dot_o(wz, ox, oy, oz) / dot_d(wz, dx, dy, dz);
                if (!(tf >= 0.0f && tf <= BIG && tf < t)) continue;
                float u, v;
                if (inside(s_woop[3 * f], s_woop[3 * f + 1], tf, ox, oy, oz,
                           dx, dy, dz, u, v)) {
                    t = tf;
                    face = f;
                    hu = u;
                    hv = v;
                }
            }
        }
        int sphere = -1;
        if constexpr (SPH) {
            float ts_best = BIG;
            for (int s = 0; s < a.n_spheres; ++s) {
                const float ts = sphere_t(s_more[s], ox, oy, oz, dx, dy, dz);
                if (ts > 0.0f && ts < BIG && ts < ts_best) {
                    ts_best = ts;
                    sphere = s;
                }
            }
            if (ts_best < t) {
                t = ts_best;
                face = -1;
            } else {
                sphere = -1;
            }
        }
        if (face < 0 && sphere < 0) {
            // ---- escaped: the environment, MIS-weighted against env NEE ----
            if constexpr (ENV) {
                float w_esc = 1.0f;
                if (depth > 0 && p_env > 0.0f && prev_pdf > 0.0f)
                    w_esc = mis(prev_pdf, env_pdf(a, dx, dy, dz) * p_env);
                float u, v, st;
                env_uv(a, dx, dy, dz, u, v, st);
                const float4 e = env_fetch(a, u, v);
#pragma unroll
                for (int c = 0; c < NC; ++c) {
                    const float L = SPEC
                        ? sigmoid_poly(e.x, e.y, e.z, xw[c]) * e.w * d65[c]
                        : comp(e, c);
                    res[c] += w_esc * thr[c] * L;
                }
            }
            break;
        }
        const float4* A = sphere >= 0 ? a.sattr + FA4 * sphere
                                      : a.fattr + FA4 * face;
        float4 a0, a1, a2;
        if constexpr (WIDE) {
            a0 = __ldg(A);
            a1 = __ldg(A + 1);
            a2 = __ldg(A + 2);
        } else {
            a0 = s_more[STAGE * face];
            a1 = s_more[STAGE * face + 1];
            a2 = s_more[STAGE * face + 2];
        }
        float nx = a0.x, ny = a0.y, nz = a0.z;
        if constexpr (SPH) {
            if (sphere >= 0) {       // outward normal of the hit sphere
                const float4 c = s_more[sphere];
                const float inv_r = 1.0f / fmaxf(c.w, 1e-20f);
                nx = (ox + t * dx - c.x) * inv_r;
                ny = (oy + t * dy - c.y) * inv_r;
                nz = (oz + t * dz - c.z) * inv_r;
            }
        }

        // ---- emission, MIS-weighted against NEE after the camera ----
        const float cos_hit = -(dx * nx + dy * ny + dz * nz);
        if (!(cos_hit > 0.0f)) break;        // back face: FrontSide only
        float em_w = 1.0f;
        if (depth > 0) {
            const float pdf_l_hit = cos_hit > 1e-6f
                ? t * t * a0.w / fmaxf(cos_hit, 1e-6f) : 0.0f;
            em_w = prev_pdf > 0.0f ? mis(prev_pdf, pdf_l_hit) : 1.0f;
        }
        if constexpr (SPEC) {
            // Le = sigmoid(coefficients) * D65 * le_scale; 0 off emitters
            const float le_scale = WIDE ? __ldg(A + 3).w
                                        : s_more[STAGE * face + 3].w;
            if (le_scale != 0.0f) {
#pragma unroll
                for (int c = 0; c < NC; ++c)
                    res[c] += em_w * thr[c]
                        * (sigmoid_poly(a2.x, a2.y, a2.z, xw[c]) * d65[c]
                           * le_scale);
            }
        } else {
#pragma unroll
            for (int c = 0; c < NC; ++c) res[c] += em_w * thr[c] * comp(a2, c);
        }
        if (depth == a.max_depth - 1) break; // last bounce: emission only

        // ---- albedo payload; checkerboard: parity of floor(u') + floor(v')
        float4 pay = a1;
        if constexpr (CHK) {
            if (a1.w > 1.5f && a1.w < 2.5f) {
                float bu, bv;
                if (sphere >= 0) {           // spherical uv
                    bu = atan2f(ny, nx) * INV_2PI + 0.5f;
                    bv = acosf(fminf(fmaxf(nz, -1.0f), 1.0f)) * INV_PI;
                } else {                     // barycentrics of the hit
                    bu = hu;
                    bv = hv;
                }
                const float4 a6 = __ldg(A + 6), a7 = __ldg(A + 7);
                const float4 a8 = __ldg(A + 8), a9 = __ldg(A + 9);
                const float uu = a6.x + bu * a6.z + bv * a7.x;
                const float vv = a6.y + bu * a6.w + bv * a7.y;
                const float u2 = a8.x * uu + a8.y * vv + a8.z;
                const float v2 = a9.x * uu + a9.y * vv + a9.z;
                const float sum = floorf(u2) + floorf(v2);
                if (sum - 2.0f * floorf(0.5f * sum) > 0.5f) pay = __ldg(A + 5);
            }
        }
        float alb[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c)
            alb[c] = SPEC ? sigmoid_poly(pay.x, pay.y, pay.z, xw[c])
                          : comp(pay, c);
        bool is_ggx = false;
        if constexpr (GGX) is_ggx = a1.w > 0.5f && a1.w < 1.5f;

        const float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
        const float eps =
            (1.0f + fmaxf(fabsf(px), fmaxf(fabsf(py), fabsf(pz)))) * 1.8e-4f;
        // branchless orthonormal basis around n (Duff et al.)
        const float s = nz >= 0.0f ? 1.0f : -1.0f;
        const float oa = -1.0f / (s + nz);
        const float ob = nx * ny * oa;
        const float txx = 1.0f + s * nx * nx * oa, txy = s * ob, txz = -s * nx;
        const float tyx = ob, tyy = s + ny * ny * oa, tyz = -ny;

        // ---- Russian roulette (path.cpp:133-141) ----
        float thr_[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) thr_[c] = thr[c];
        if (depth + 1 > a.rr_depth) {
            float rr_u, rr_unused;
            rng2(key, dim0 + 0u, rr_u, rr_unused);
            float mx = thr[0];
#pragma unroll
            for (int c = 1; c < NC; ++c) mx = fmaxf(mx, thr[c]);
            const float q = fminf(mx, 0.95f);
            if (!(rr_u < q)) break;
            const float inv_q = 1.0f / fmaxf(q, 1e-8f);
#pragma unroll
            for (int c = 0; c < NC; ++c) thr_[c] = thr[c] * inv_q;
        }

        // the incident direction in the local frame and the conductor's
        // complex IOR per channel (GGX lobes)
        float wix = 0.0f, wiy = 0.0f, wiz = 1.0f, alpha = 1.0f;
        float eta[NC], kap[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) eta[c] = kap[c] = 0.0f;
        if constexpr (GGX) {
            if (is_ggx) {
                wix = -dx * txx - dy * txy - dz * txz;
                wiy = -dx * tyx - dy * tyy - dz * tyz;
                wiz = fmaxf(-dx * nx - dy * ny - dz * nz, 1e-6f);
                alpha = fmaxf(a2.w, 1e-3f);
                const float4 a3 = __ldg(A + 3), a4 = __ldg(A + 4);
                if constexpr (SPEC) {
                    // quadratics in x, clamped to the fit span [x_lo, x_hi]
                    const float x_lo = a4.w, x_hi = __ldg(A + 5).w;
#pragma unroll
                    for (int c = 0; c < NC; ++c) {
                        const float xc = fminf(fmaxf(xw[c], x_lo), x_hi);
                        eta[c] = (a3.x * xc + a3.y) * xc + a3.z;
                        kap[c] = (a4.x * xc + a4.y) * xc + a4.z;
                    }
                } else {
#pragma unroll
                    for (int c = 0; c < NC; ++c) {
                        eta[c] = comp(a3, c);
                        kap[c] = comp(a4, c);
                    }
                }
            }
        }

        // ---- NEE: env with probability p_env, else an area light face ----
        float u_sel, u_b1, u_b2, nee_unused;
        rng2(key, dim0 + 1u, u_sel, u_b1);
        rng2(key, dim0 + 2u, u_b2, nee_unused);
        bool use_env = false;
        float u_area = u_sel;
        if constexpr (ENV) {
            if (p_env > 0.0f) {
                use_env = u_sel < p_env;
                u_area = (u_sel - p_env) / fmaxf(1.0f - p_env, 1e-8f);
            }
        }
        float dlx, dly, dlz, dist, pdf_l, lrad[NC];
        if (use_env) {
            float ej1, ej2, epdf;
            float4 e;
            rng2(key, dim0 + 5u, ej1, ej2);
            env_sample(a, u_b1, u_b2, ej1, ej2, dlx, dly, dlz, epdf, e);
#pragma unroll
            for (int c = 0; c < NC; ++c)
                lrad[c] = SPEC
                    ? sigmoid_poly(e.x, e.y, e.z, xw[c]) * e.w * d65[c]
                    : comp(e, c);
            pdf_l = epdf * p_env;
            dist = 1e7f;                     // the whole open segment
        } else {
            const float* lights = a.lights;
            const int n_lights = a.n_lights;
            int li = 0;
            for (int l = 0; l < n_lights; ++l)
                li += lights[24 * l + 12] <= u_area;
            const float* LT = lights + 24 * min(li, n_lights - 1);
            const float s_t = sqrtf(fmaxf(1.0f - u_b1, 0.0f));
            const float bu = 1.0f - s_t;
            const float bv = u_b2 * s_t;
            dlx = LT[0] + LT[3] * bu + LT[6] * bv - px;
            dly = LT[1] + LT[4] * bu + LT[7] * bv - py;
            dlz = LT[2] + LT[5] * bu + LT[8] * bv - pz;
            const float dist2 = dlx * dlx + dly * dly + dlz * dlz;
            dist = sqrtf(fmaxf(dist2, 1e-20f));
            const float inv_dist = 1.0f / dist;
            dlx *= inv_dist;
            dly *= inv_dist;
            dlz *= inv_dist;
            const float cos_l = -(dlx * LT[9] + dly * LT[10] + dlz * LT[11]);
            pdf_l = cos_l > 1e-6f
                ? dist2 * LT[13] / fmaxf(cos_l, 1e-6f) : 0.0f;
#pragma unroll
            for (int c = 0; c < NC; ++c)
                lrad[c] = SPEC
                    ? sigmoid_poly(LT[14], LT[15], LT[16], xw[c]) * d65[c]
                        * LT[17]
                    : LT[14 + c];
        }
        const float cos_s = dlx * nx + dly * ny + dlz * nz;
        if (pdf_l > 0.0f && cos_s > 0.0f) {
            const float sox = px + nx * eps, soy = py + ny * eps,
                        soz = pz + nz * eps;
            const float maxt = dist * 0.999f;
            bool occluded = false;
            if constexpr (BVH) {
                occluded = bvh::any_hit<false>(
                    tree, bvh::make_ray(sox, soy, soz, dlx, dly, dlz, 0.0f),
                    maxt);
            } else {
                for (int f = 0; f < n_faces && !occluded; ++f) {
                    const float4 wz = s_woop[3 * f + 2];
                    const float tf = -dot_o(wz, sox, soy, soz)
                        / dot_d(wz, dlx, dly, dlz);
                    if (!(tf >= 0.0f && tf <= maxt)) continue;
                    float u, v;
                    occluded = inside(s_woop[3 * f], s_woop[3 * f + 1], tf,
                                      sox, soy, soz, dlx, dly, dlz, u, v);
                }
            }
            if constexpr (SPH) {
                for (int k = 0; k < a.n_spheres && !occluded; ++k) {
                    const float ts = sphere_t(s_more[k], sox, soy, soz,
                                              dlx, dly, dlz);
                    occluded = ts > 0.0f && ts < maxt;
                }
            }
            if (!occluded) {
                // BSDF toward the light: f * cos (albedo included) and pdf
                float pdf_bsdf = fmaxf(cos_s, 0.0f) / PI_F;
                float fcos[NC];
                const float fd = cos_s / PI_F;
#pragma unroll
                for (int c = 0; c < NC; ++c) fcos[c] = alb[c] * fd;
                if constexpr (GGX) {
                    if (is_ggx) {
                        const float wox = dlx * txx + dly * txy + dlz * txz;
                        const float woy = dlx * tyx + dly * tyy + dlz * tyz;
                        const float woz = cos_s;
                        float hx = wix + wox, hy = wiy + woy, hz = wiz + woz;
                        const float hinv =
                            rsqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-20f));
                        hx *= hinv;
                        hy *= hinv;
                        hz *= hinv;
                        const float ci_h =
                            fmaxf(wix * hx + wiy * hy + wiz * hz, 0.0f);
                        const float D = ggx_d(hz, alpha);
                        const float g1i = ggx_g1(wiz, alpha);
                        const float spec =
                            D * (g1i * ggx_g1(fmaxf(woz, 1e-6f), alpha))
                            / fmaxf(4.0f * wiz, 1e-20f);
                        pdf_bsdf = g1i * D / fmaxf(4.0f * wiz, 1e-20f);
#pragma unroll
                        for (int c = 0; c < NC; ++c)
                            fcos[c] = alb[c] * spec
                                * fresnel_cond(ci_h, eta[c], kap[c]);
                    }
                }
                const float base = mis(pdf_l, pdf_bsdf) / fmaxf(pdf_l, 1e-20f);
#pragma unroll
                for (int c = 0; c < NC; ++c)
                    res[c] += thr_[c] * base * fcos[c] * lrad[c];
            }
        }

        // ---- BSDF sample ----
        float u_c1, u_c2;
        rng2(key, dim0 + 4u, u_c1, u_c2);
        float wx, wy, wz, bsdf_pdf;
        bool ok_lobe;
        if (is_ggx) {
            // GGX visible normals (Heitz 2018); throughput albedo F G1(wo)
            float vhx = alpha * wix, vhy = alpha * wiy, vhz = wiz;
            const float vinv =
                rsqrtf(fmaxf(vhx * vhx + vhy * vhy + vhz * vhz, 1e-20f));
            vhx *= vinv;
            vhy *= vinv;
            vhz *= vinv;
            const float lensq = vhx * vhx + vhy * vhy;
            const float linv = rsqrtf(fmaxf(lensq, 1e-20f));
            const float t1x = lensq > 1e-12f ? -vhy * linv : 1.0f;
            const float t1y = lensq > 1e-12f ? vhx * linv : 0.0f;
            const float t2x = -vhz * t1y, t2y = vhz * t1x;
            const float t2z = vhx * t1y - vhy * t1x;
            const float rr = sqrtf(fmaxf(u_c1, 0.0f));
            const float phi = TWO_PI * u_c2;
            const float p1 = rr * cosf(phi);
            float p2 = rr * sinf(phi);
            const float s_ = 0.5f * (1.0f + vhz);
            p2 = (1.0f - s_) * sqrtf(fmaxf(1.0f - p1 * p1, 0.0f)) + s_ * p2;
            const float pzz = sqrtf(fmaxf(1.0f - p1 * p1 - p2 * p2, 0.0f));
            float mhx = alpha * (p1 * t1x + p2 * t2x + pzz * vhx);
            float mhy = alpha * (p1 * t1y + p2 * t2y + pzz * vhy);
            float mhz = fmaxf(p2 * t2z + pzz * vhz, 1e-6f);
            const float minv = rsqrtf(mhx * mhx + mhy * mhy + mhz * mhz);
            mhx *= minv;
            mhy *= minv;
            mhz *= minv;
            const float wm = wix * mhx + wiy * mhy + wiz * mhz;
            wx = 2.0f * wm * mhx - wix;
            wy = 2.0f * wm * mhy - wiy;
            wz = 2.0f * wm * mhz - wiz;
            bsdf_pdf = ggx_g1(wiz, alpha) * ggx_d(mhz, alpha)
                / fmaxf(4.0f * wiz, 1e-20f);
            ok_lobe = wz > 1e-6f && wm > 0.0f;
            const float g1o = ggx_g1(fmaxf(wz, 1e-6f), alpha);
            const float cm = fmaxf(wm, 0.0f);
#pragma unroll
            for (int c = 0; c < NC; ++c)
                thr[c] = thr_[c]
                    * (alb[c] * fresnel_cond(cm, eta[c], kap[c]) * g1o);
        } else {
            // cosine-weighted diffuse
            concentric(u_c1, u_c2, wx, wy);
            wz = sqrtf(fmaxf(1.0f - wx * wx - wy * wy, 0.0f));
            bsdf_pdf = wz / PI_F;
            ok_lobe = wz > 0.0f;
#pragma unroll
            for (int c = 0; c < NC; ++c) thr[c] = thr_[c] * alb[c];
        }
        float thr_sum = thr[0];
#pragma unroll
        for (int c = 1; c < NC; ++c) thr_sum += thr[c];
        if (!(ok_lobe && bsdf_pdf > 0.0f && thr_sum > 0.0f)) break;
        dx = wx * txx + wy * tyx + wz * nx;
        dy = wx * txy + wy * tyy + wz * ny;
        dz = wx * txz + wy * tyz + wz * nz;
        // wz > 0: the new ray leaves on the normal's side
        ox = px + nx * eps;
        oy = py + ny * eps;
        oz = pz + nz * eps;
        prev_pdf = bsdf_pdf;
    }

    // ---- epilogue: linear sRGB out, 3 floats per lane ----
    float out[3];
    if constexpr (SPEC) {
        // CIE develop (megakernel.py:1378-1393): CMFs at the hero
        // wavelengths, averaged over the channels, then XYZ -> sRGB
        float xyz[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const float ok = wl[c] >= WL_MIN && wl[c] <= WL_MIN + WL_SPAN
                ? 1.0f : 0.0f;
#pragma unroll
            for (int k = 0; k < 3; ++k)
                xyz[k] += spd_lerp(s_spd, wl[c], 1 + k) * ok * res[c];
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) xyz[k] *= 1.0f / NC;
        out[0] = 3.240479f * xyz[0] + -1.537150f * xyz[1]
            + -0.498535f * xyz[2];
        out[1] = -0.969256f * xyz[0] + 1.875991f * xyz[1]
            + 0.041556f * xyz[2];
        out[2] = 0.055648f * xyz[0] + -0.204043f * xyz[1]
            + 1.057311f * xyz[2];
    } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) out[k] = res[NC == 1 ? 0 : k];
    }
    // 64-bit offsets: 2 * n_lanes overflows int from 2^30 lanes on
    const size_t n = (size_t)a.n_lanes;
    a.out[lane] = out[0];
    a.out[n + lane] = out[1];
    a.out[2 * n + lane] = out[2];
}

template <int FLAGS, int NC>
int launch(const PathArgs& a, cudaStream_t stream) {
    // Cornell: Woop rows and STAGE attribute float4s per face; otherwise
    // Woop rows (none in the BVH tier) and the sphere rows; the SPD table
    // first in spectral mode
    constexpr size_t stage = NC == 4 ? 4 : 3;
    const size_t woop = (FLAGS & F_BVH) ? 0 : (size_t)a.n_faces * 3;
    const size_t smem = ((NC == 4 ? (size_t)SPD_ROWS : 0)
        + (FLAGS == 0 ? (size_t)a.n_faces * (3 + stage)
                      : woop + (size_t)a.n_spheres))
        * sizeof(float4);
    cudaError_t err = cudaFuncSetAttribute(
        path_kernel<FLAGS, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = (a.n_lanes + BLOCK - 1) / BLOCK;
    path_kernel<FLAGS, NC><<<grid, BLOCK, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// C entry point: launches the instantiation of args->flags in this
// library's color mode (args->nc must be PK_NC), one thread per lane, on
// `stream`, and returns cudaGetLastError() (0 when the launch was
// accepted).
extern "C" int path_render(const PathArgs* args, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (args->nc != PK_NC) return (int)cudaErrorInvalidValue;
    switch (args->flags) {
        case 0: return launch<0, PK_NC>(*args, s);
        case 1: return launch<1, PK_NC>(*args, s);
        case 2: return launch<2, PK_NC>(*args, s);
        case 3: return launch<3, PK_NC>(*args, s);
        case 4: return launch<4, PK_NC>(*args, s);
        case 5: return launch<5, PK_NC>(*args, s);
        case 6: return launch<6, PK_NC>(*args, s);
        case 7: return launch<7, PK_NC>(*args, s);
        case 8: return launch<8, PK_NC>(*args, s);
        case 9: return launch<9, PK_NC>(*args, s);
        case 10: return launch<10, PK_NC>(*args, s);
        case 11: return launch<11, PK_NC>(*args, s);
        case 12: return launch<12, PK_NC>(*args, s);
        case 13: return launch<13, PK_NC>(*args, s);
        case 14: return launch<14, PK_NC>(*args, s);
        case 15: return launch<15, PK_NC>(*args, s);
        case 16: return launch<16, PK_NC>(*args, s);
        case 17: return launch<17, PK_NC>(*args, s);
        case 18: return launch<18, PK_NC>(*args, s);
        case 19: return launch<19, PK_NC>(*args, s);
        case 20: return launch<20, PK_NC>(*args, s);
        case 21: return launch<21, PK_NC>(*args, s);
        case 22: return launch<22, PK_NC>(*args, s);
        case 23: return launch<23, PK_NC>(*args, s);
        case 24: return launch<24, PK_NC>(*args, s);
        case 25: return launch<25, PK_NC>(*args, s);
        case 26: return launch<26, PK_NC>(*args, s);
        case 27: return launch<27, PK_NC>(*args, s);
        case 28: return launch<28, PK_NC>(*args, s);
        case 29: return launch<29, PK_NC>(*args, s);
        case 30: return launch<30, PK_NC>(*args, s);
        case 31: return launch<31, PK_NC>(*args, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
