// Path kernel (sm_90a).
//
// Replaces mitsuba2_tpu/ops/megakernel.py::_path_kernel in its K1a scope
// (triangle meshes of at most 1024 faces, constant-albedo diffuse BSDFs,
// constant area lights, rgb, box filter) and its matpreview scopes: analytic
// spheres (K1b), one lat-long envmap with CDF-inverted NEE and escape MIS
// (K1c), isotropic GGX rough conductors with visible-normal sampling and
// checkerboard albedo (K1d). It computes exactly the plain PyTorch version
// path_radiance_reference in ops/path_kernel.py: the same TEA keys and
// sampler dimensions, the same Woop and sphere tests, the same NEE arms,
// MIS, roulette and spawn offsets, so the two agree lane by lane up to
// float rounding.
//
// What bounds it on the H100: not bytes. A lane reads 12 floats of tables
// per face it tests, a few hundred bytes of attributes and env texels per
// bounce (which stay in L2), and writes 12 bytes at the end; the path state
// stays in registers. The time goes to the O(F) face loop that every ray
// and every shadow ray runs, to the shading math, and to divergence: lanes
// of one warp end their paths at different depths and take different
// branches (lobe, NEE arm, escape).
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
//   three attribute float4s of every face staged in shared memory.
// - With any flag set, only what every ray loops over is staged in shared
//   memory: the Woop rows and the sphere rows. All threads of a warp read
//   the same face at the same step of the loop, so each read is a
//   broadcast. The attribute row of the hit face or sphere (ten float4) is
//   read once per bounce from global memory through the read-only path.
// - The env radiance is one float4 texel per 16 bytes (a bilinear fetch is
//   four loads); env sampling is two binary searches (marginal cdf, then
//   the row's conditional cdf), giving exactly the reference's
//   count(cdf <= u) index; the env pdf is a direct pmf load.
// - The closest-hit loop computes u and v only for a face whose t is in
//   range and closer than the best so far; the shadow loops stop at the
//   first occluder.
// Ray sorting, a BVH, occupancy tuning and warp-coherent scheduling are
// later work. Math is exact (atan2f, acosf, sinf, cosf; no fast-math).

#include <cuda_runtime.h>
#include <stdint.h>

#include "rng.cuh"

#define BLOCK 128
#define BIG 3.0e38f
#define PI_F 3.14159265358979f

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
    const float* cam;         // (16,)
    float* out;               // (3, n_lanes)
    int n_faces, n_lights, n_spheres;
    int env_w, env_h, env_ws, env_hs, env_has_rot;
    float p_env;
    uint32_t seed, sample_base;
    int spp_pass, width, height, max_depth, rr_depth, n_lanes;
    int flags;
};

namespace {

// instantiation flags (ops/path_kernel.py HAS_*)
constexpr int F_SPHERES = 1, F_ENV = 2, F_GGX = 4, F_CHECKER = 8;
// attribute float4s per face / sphere (ops/path_kernel.py FA / 4)
constexpr int FA4 = 10;

// float32 roundings of the reference's double constants
constexpr float INV_2PI = (float)(0.5 / 3.141592653589793);
constexpr float INV_PI = (float)(1.0 / 3.141592653589793);
constexpr float TWO_PI = (float)(2.0 * 3.141592653589793);
constexpr float TWO_PI2 = (float)(2.0 * 3.141592653589793 * 3.141592653589793);

// Woop row of one face: three float4 [Wu | Wv | Wz].
__device__ __forceinline__ float dot_o(float4 w, float ox, float oy, float oz) {
    return ox * w.x + oy * w.y + oz * w.z + w.w;
}

__device__ __forceinline__ float dot_d(float4 w, float dx, float dy, float dz) {
    return dx * w.x + dy * w.y + dz * w.z;
}

// Barycentric test of face f at parameter t (min-form test of the
// reference, written as three comparisons so that NaN fails it).
__device__ __forceinline__ bool inside(const float4* wp, float t,
                                       float ox, float oy, float oz,
                                       float dx, float dy, float dz) {
    const float4 wu = wp[0];
    const float4 wv = wp[1];
    const float u = dot_o(wu, ox, oy, oz) + t * dot_d(wu, dx, dy, dz);
    const float v = dot_o(wv, ox, oy, oz) + t * dot_d(wv, dx, dy, dz);
    return u >= 0.0f && v >= 0.0f && 1.0f - u - v >= 0.0f;
}

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

// Bilinear lat-long fetch with u and v wrapping (megakernel.py:1219).
__device__ __forceinline__ void env_fetch(const PathArgs& a, float u,
                                          float v, float* rgb) {
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
    const float c0x = (1.0f - wv) * t00.x + wv * t10.x;
    const float c0y = (1.0f - wv) * t00.y + wv * t10.y;
    const float c0z = (1.0f - wv) * t00.z + wv * t10.z;
    const float c1x = (1.0f - wv) * t01.x + wv * t11.x;
    const float c1y = (1.0f - wv) * t01.y + wv * t11.y;
    const float c1z = (1.0f - wv) * t01.z + wv * t11.z;
    rgb[0] = (1.0f - wu) * c0x + wu * c1x;
    rgb[1] = (1.0f - wu) * c0y + wu * c1y;
    rgb[2] = (1.0f - wu) * c0z + wu * c1z;
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

// CDF-inverted env sample -> world direction, solid-angle pdf, radiance.
__device__ __forceinline__ void env_sample(const PathArgs& a, float u1,
                                           float u2, float j1, float j2,
                                           float& dx, float& dy, float& dz,
                                           float& pdf, float* rgb) {
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
    env_fetch(a, uu, vv, rgb);
    if (a.env_has_rot) rot3(a.env_rot, dx, dy, dz);
}

// Exact unpolarized conductor Fresnel (megakernel.py:255).
__device__ __forceinline__ float fresnel_cond(float c, float eta, float k) {
    const float c2 = c * c;
    const float s2 = 1.0f - c2;
    const float eta2 = eta * eta - k * k;
    const float etak2 = 2.0f * eta * k;
    const float t0 = eta2 - s2;
    const float a2b2 = sqrtf(fmaxf(t0 * t0 + etak2 * etak2, 0.0f));
    const float t1 = a2b2 + c2;
    const float a = sqrtf(fmaxf(0.5f * (a2b2 + t0), 0.0f));
    const float t2 = 2.0f * a * c;
    const float rs = (t1 - t2) / fmaxf(t1 + t2, 1e-20f);
    const float t3 = c2 * a2b2 + s2 * s2;
    const float t4 = t2 * s2;
    const float rp = rs * (t3 - t4) / fmaxf(t3 + t4, 1e-20f);
    return 0.5f * (rp + rs);
}

__device__ __forceinline__ float ggx_d(float hz, float a) {
    const float a2 = a * a;
    const float d = hz * hz * (a2 - 1.0f) + 1.0f;
    return a2 / fmaxf(PI_F * d * d, 1e-20f);
}

// Smith G1 of isotropic GGX from the cosine alone.
__device__ __forceinline__ float ggx_g1(float cz, float a) {
    cz = fmaxf(cz, 1e-6f);
    const float a2 = a * a;
    const float t2 = (1.0f - cz * cz) / (cz * cz);
    return 2.0f / (1.0f + sqrtf(1.0f + a2 * t2));
}

template <int FLAGS>
__global__ void __launch_bounds__(BLOCK) path_kernel(const PathArgs a) {
    constexpr bool SPH = FLAGS & F_SPHERES;
    constexpr bool ENV = FLAGS & F_ENV;
    constexpr bool GGX = FLAGS & F_GGX;
    constexpr bool CHK = FLAGS & F_CHECKER;
    // attributes from global memory, spheres in shared memory
    constexpr bool WIDE = FLAGS != 0;
    const int n_faces = a.n_faces;
    extern __shared__ float4 smem[];
    float4* s_woop = smem;                 // 3 float4 per face
    // Cornell: [ng, lpdf_w] [albedo, kind] [Le, alpha] per face;
    // otherwise the sphere rows
    float4* s_more = smem + 3 * n_faces;
    for (int i = threadIdx.x; i < 3 * n_faces; i += blockDim.x) {
        s_woop[i] = a.woop[i];
        if constexpr (!WIDE) s_more[i] = a.fattr[(i / 3) * FA4 + i % 3];
    }
    if constexpr (SPH) {
        for (int i = threadIdx.x; i < a.n_spheres; i += blockDim.x)
            s_more[i] = a.sph[i];
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

    float thr[3] = {1.0f, 1.0f, 1.0f};
    float res[3] = {0.0f, 0.0f, 0.0f};
    float prev_pdf = 0.0f;      // 0: camera ray, no MIS at the first hit
    const float p_env = a.p_env;

    for (int depth = 0; depth < a.max_depth; ++depth) {
        const uint32_t dim0 = 2u + 8u * (uint32_t)depth;

        // ---- closest hit: lowest face id on ties, faces before spheres ----
        float t = BIG;
        int face = -1;
        for (int f = 0; f < n_faces; ++f) {
            const float4 wz = s_woop[3 * f + 2];
            const float tf = -dot_o(wz, ox, oy, oz) / dot_d(wz, dx, dy, dz);
            if (!(tf >= 0.0f && tf <= BIG && tf < t)) continue;
            if (inside(s_woop + 3 * f, tf, ox, oy, oz, dx, dy, dz)) {
                t = tf;
                face = f;
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
                float u, v, st, L[3];
                env_uv(a, dx, dy, dz, u, v, st);
                env_fetch(a, u, v, L);
                for (int c = 0; c < 3; ++c) res[c] += w_esc * thr[c] * L[c];
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
            a0 = s_more[3 * face];
            a1 = s_more[3 * face + 1];
            a2 = s_more[3 * face + 2];
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
        float alb[3] = {a1.x, a1.y, a1.z};

        // ---- emission, MIS-weighted against NEE after the camera ----
        const float cos_hit = -(dx * nx + dy * ny + dz * nz);
        if (!(cos_hit > 0.0f)) break;        // back face: FrontSide only
        float em_w = 1.0f;
        if (depth > 0) {
            const float pdf_l_hit = cos_hit > 1e-6f
                ? t * t * a0.w / fmaxf(cos_hit, 1e-6f) : 0.0f;
            em_w = prev_pdf > 0.0f ? mis(prev_pdf, pdf_l_hit) : 1.0f;
        }
        res[0] += em_w * thr[0] * a2.x;
        res[1] += em_w * thr[1] * a2.y;
        res[2] += em_w * thr[2] * a2.z;
        if (depth == a.max_depth - 1) break; // last bounce: emission only

        // ---- checkerboard albedo: parity of floor(u') + floor(v') ----
        if constexpr (CHK) {
            if (a1.w > 1.5f && a1.w < 2.5f) {
                float bu, bv;
                if (sphere >= 0) {           // spherical uv
                    bu = atan2f(ny, nx) * INV_2PI + 0.5f;
                    bv = acosf(fminf(fmaxf(nz, -1.0f), 1.0f)) * INV_PI;
                } else {                     // barycentrics of the hit
                    const float4 wu = s_woop[3 * face];
                    const float4 wv = s_woop[3 * face + 1];
                    bu = dot_o(wu, ox, oy, oz) + t * dot_d(wu, dx, dy, dz);
                    bv = dot_o(wv, ox, oy, oz) + t * dot_d(wv, dx, dy, dz);
                }
                const float4 a6 = __ldg(A + 6), a7 = __ldg(A + 7);
                const float4 a8 = __ldg(A + 8), a9 = __ldg(A + 9);
                const float uu = a6.x + bu * a6.z + bv * a7.x;
                const float vv = a6.y + bu * a6.w + bv * a7.y;
                const float u2 = a8.x * uu + a8.y * vv + a8.z;
                const float v2 = a9.x * uu + a9.y * vv + a9.z;
                const float sum = floorf(u2) + floorf(v2);
                if (sum - 2.0f * floorf(0.5f * sum) > 0.5f) {
                    const float4 a5 = __ldg(A + 5);
                    alb[0] = a5.x;
                    alb[1] = a5.y;
                    alb[2] = a5.z;
                }
            }
        }
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
        float thr_[3] = {thr[0], thr[1], thr[2]};
        if (depth + 1 > a.rr_depth) {
            float rr_u, rr_unused;
            rng2(key, dim0 + 0u, rr_u, rr_unused);
            const float q = fminf(fmaxf(fmaxf(thr[0], thr[1]), thr[2]), 0.95f);
            if (!(rr_u < q)) break;
            const float inv_q = 1.0f / fmaxf(q, 1e-8f);
            for (int c = 0; c < 3; ++c) thr_[c] = thr[c] * inv_q;
        }

        // the incident direction in the local frame (GGX lobes)
        float wix = 0.0f, wiy = 0.0f, wiz = 1.0f, alpha = 1.0f;
        float3 eta = {0.0f, 0.0f, 0.0f}, kap = {0.0f, 0.0f, 0.0f};
        if constexpr (GGX) {
            if (is_ggx) {
                wix = -dx * txx - dy * txy - dz * txz;
                wiy = -dx * tyx - dy * tyy - dz * tyz;
                wiz = fmaxf(-dx * nx - dy * ny - dz * nz, 1e-6f);
                alpha = fmaxf(a2.w, 1e-3f);
                const float4 a3 = __ldg(A + 3), a4 = __ldg(A + 4);
                eta = make_float3(a3.x, a3.y, a3.z);
                kap = make_float3(a4.x, a4.y, a4.z);
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
        float dlx, dly, dlz, dist, pdf_l, lrad[3];
        if (use_env) {
            float ej1, ej2, epdf;
            rng2(key, dim0 + 5u, ej1, ej2);
            env_sample(a, u_b1, u_b2, ej1, ej2, dlx, dly, dlz, epdf, lrad);
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
            lrad[0] = LT[14];
            lrad[1] = LT[15];
            lrad[2] = LT[16];
        }
        const float cos_s = dlx * nx + dly * ny + dlz * nz;
        if (pdf_l > 0.0f && cos_s > 0.0f) {
            const float sox = px + nx * eps, soy = py + ny * eps,
                        soz = pz + nz * eps;
            const float maxt = dist * 0.999f;
            bool occluded = false;
            for (int f = 0; f < n_faces && !occluded; ++f) {
                const float4 wz = s_woop[3 * f + 2];
                const float tf = -dot_o(wz, sox, soy, soz)
                    / dot_d(wz, dlx, dly, dlz);
                if (!(tf >= 0.0f && tf <= maxt)) continue;
                occluded = inside(s_woop + 3 * f, tf, sox, soy, soz,
                                  dlx, dly, dlz);
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
                float fcos[3];
                const float fd = cos_s / PI_F;
                for (int c = 0; c < 3; ++c) fcos[c] = alb[c] * fd;
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
                        fcos[0] = alb[0] * spec
                            * fresnel_cond(ci_h, eta.x, kap.x);
                        fcos[1] = alb[1] * spec
                            * fresnel_cond(ci_h, eta.y, kap.y);
                        fcos[2] = alb[2] * spec
                            * fresnel_cond(ci_h, eta.z, kap.z);
                    }
                }
                const float base = mis(pdf_l, pdf_bsdf) / fmaxf(pdf_l, 1e-20f);
                for (int c = 0; c < 3; ++c)
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
            thr[0] = thr_[0] * (alb[0] * fresnel_cond(cm, eta.x, kap.x) * g1o);
            thr[1] = thr_[1] * (alb[1] * fresnel_cond(cm, eta.y, kap.y) * g1o);
            thr[2] = thr_[2] * (alb[2] * fresnel_cond(cm, eta.z, kap.z) * g1o);
        } else {
            // cosine-weighted diffuse
            concentric(u_c1, u_c2, wx, wy);
            wz = sqrtf(fmaxf(1.0f - wx * wx - wy * wy, 0.0f));
            bsdf_pdf = wz / PI_F;
            ok_lobe = wz > 0.0f;
            for (int c = 0; c < 3; ++c) thr[c] = thr_[c] * alb[c];
        }
        if (!(ok_lobe && bsdf_pdf > 0.0f && thr[0] + thr[1] + thr[2] > 0.0f))
            break;
        dx = wx * txx + wy * tyx + wz * nx;
        dy = wx * txy + wy * tyy + wz * ny;
        dz = wx * txz + wy * tyz + wz * nz;
        // wz > 0: the new ray leaves on the normal's side
        ox = px + nx * eps;
        oy = py + ny * eps;
        oz = pz + nz * eps;
        prev_pdf = bsdf_pdf;
    }
    // 64-bit offsets: 2 * n_lanes overflows int from 2^30 lanes on
    const size_t n = (size_t)a.n_lanes;
    a.out[lane] = res[0];
    a.out[n + lane] = res[1];
    a.out[2 * n + lane] = res[2];
}

template <int FLAGS>
int launch(const PathArgs& a, cudaStream_t stream) {
    // Cornell: Woop rows and three attribute float4s per face; otherwise
    // Woop rows and the sphere rows
    const size_t smem = FLAGS == 0
        ? (size_t)a.n_faces * 6 * sizeof(float4)
        : ((size_t)a.n_faces * 3 + (size_t)a.n_spheres) * sizeof(float4);
    cudaError_t err = cudaFuncSetAttribute(
        path_kernel<FLAGS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = (a.n_lanes + BLOCK - 1) / BLOCK;
    path_kernel<FLAGS><<<grid, BLOCK, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// C entry point: launches the instantiation of args->flags, one thread per
// lane, on `stream` and returns cudaGetLastError() (0 when the launch was
// accepted).
extern "C" int path_render(const PathArgs* args, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (args->flags) {
        case 0: return launch<0>(*args, s);
        case 1: return launch<1>(*args, s);
        case 2: return launch<2>(*args, s);
        case 3: return launch<3>(*args, s);
        case 4: return launch<4>(*args, s);
        case 5: return launch<5>(*args, s);
        case 6: return launch<6>(*args, s);
        case 7: return launch<7>(*args, s);
        case 8: return launch<8>(*args, s);
        case 9: return launch<9>(*args, s);
        case 10: return launch<10>(*args, s);
        case 11: return launch<11>(*args, s);
        case 12: return launch<12>(*args, s);
        case 13: return launch<13>(*args, s);
        case 14: return launch<14>(*args, s);
        case 15: return launch<15>(*args, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
