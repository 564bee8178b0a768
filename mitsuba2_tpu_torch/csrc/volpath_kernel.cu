// Volumetric path kernel (sm_90a).
//
// Replaces mitsuba2_tpu/ops/volmegakernel.py::_volpath_kernel
// (volmegakernel.py:186, launched from VolPathMegakernel.render_pass at
// :1123) in its whole scope: one heterogeneous medium (a sigma_t grid or
// constant, constant rgb albedo, HG or isotropic phase) inside a null-BSDF
// box, opaque triangles with diffuse, isotropic GGX conductor or smooth
// dielectric BSDFs, constant area lights, and both estimators (volpath's
// NEE-only one and volpathmis's MIS). It computes exactly the plain PyTorch
// version volpath_radiance_reference in ops/volpath_kernel.py: the same TEA
// lane keys and mix32 tracking streams in the same per-round windows, the
// same budgets (16 delta-tracking and 16 ratio-tracking steps per round,
// max_depth + 2 rounds, a stalled walk carrying its march point to the
// next round), the same Woop tests, box intervals, trilinear fetch, NEE,
// lobes and roulette, so the two agree lane by lane up to float rounding.
//
// What bounds it on the H100: operations, not bytes. A lane writes 12
// bytes (12.6 MB for the 1,048,576 paths of a 256x256x16 render, under 4
// us at 3.35 TB/s); the 16^3 grid (16 KB) and the tables stay in L1/L2.
// Per round a path tests every opaque face, walks up to 16 delta-tracking
// steps with an 8-tap trilinear fetch each, and its NEE walks up to 16
// ratio-tracking steps; a fetch is about 40 FLOPs and a logf. The larger
// cost is divergence: path lengths in a medium vary far more than on
// surfaces (up to 18 rounds, up to 32 fetches a round), and a warp runs as
// long as its longest path and its longest walk.
// chip_smoke.py counts the FLOPs a render's paths need and prints the
// bound, max(FLOPs / 67 TFLOP/s, bytes / 3.35 TB/s), beside the time.
//
// What the design does about that, in this first version:
// - One thread per path, all rounds in one launch: a loop over rounds
//   replaces the reference's max_depth + 2 launches and its 64 B per lane
//   of state in HBM; a thread leaves the loop when its path ends. The
//   reference's live-lane compaction between launches, its permutation and
//   its tile gate have no counterpart: they exist because TPU tiles run in
//   lockstep.
// - Walks are sequential and stop at the first escape or real collision
//   (ratio tracking: at the segment's end or T = 0). The reference draws
//   all 16 candidates and fetches them in one batched matmul; the
//   candidates depend on the random numbers alone, so a sequential walk
//   draws the same numbers and reaches the same event with fewer fetches.
// - The trilinear fetch reads the grid directly (8 taps, __ldg through the
//   read-only cache), not the reference's MXU one-hot factorization; a
//   128^3 grid (8 MB) stays in global memory behind L2.
// - The opaque faces' Woop rows sit in shared memory (every thread of a
//   warp reads the same face at the same step: a broadcast); the hit
//   face's six attribute float4s are read from global memory once a round.
// - The content picks the instantiation (template FLAGS, the reference's
//   static has_hg / mis_mode / has_ggx / has_diel): 16 instantiations.
// Ray sorting, regrouping paths by length, and occupancy tuning are later
// work. Math is exact (logf, sinf, cosf, sqrtf; no fast-math).

#include <cuda_runtime.h>
#include <stdint.h>

#include "rng.cuh"
#include "shading.cuh"

#define BLOCK 128
#define BIG 3.0e38f

// Field for field ops/volpath_kernel.py::_VolArgs.
struct VolArgs {
    const float4* woop;       // (F, 3) float4: [Wu | Wv | Wz]
    const float4* fattr;      // (F, 6) float4: the VFA attribute columns
    const float* lights;      // (L, 24)
    const float* grid;        // (D, H, W) sigma_t
    const float* cam;         // (16,)
    float* out;               // (3, n_lanes)
    int n_faces, n_lights, grid_d, grid_h, grid_w;
    float med[12];            // world -> medium-local: 3x3 row-major, shift
    float albedo[3];          // the medium's single-scattering albedo
    float inv_maj, scale;     // 1 / majorant, the sigma_t scale
    // HG terms: 1 + g^2, 2g, (1 - g^2) / (4 pi), 1 - g^2, 1 - g; 1 / (4 pi)
    float hg_a, hg_b, hg_c, hg_d, hg_e, inv4pi;
    uint32_t seed, sample_base;
    int spp_pass, width, height, max_depth, rr_depth, n_lanes;
    int flags;
};

namespace {

// instantiation flags (ops/volpath_kernel.py HAS_HG, MIS, HAS_GGX, HAS_DIEL)
constexpr int F_HG = 1, F_MIS = 2, F_GGX = 4, F_DIEL = 8;
// the reference's budgets (volmegakernel.py:80-86)
constexpr int NULL_BUDGET = 16, TR_BUDGET = 16, LAUNCH_SLACK = 2;
// attribute float4s per face (ops/volpath_kernel.py VFA / 4)
constexpr int VFA4 = 6;
constexpr float TWO_PI = (float)(2.0 * 3.141592653589793);

__device__ __forceinline__ float dot_o(float4 w, float ox, float oy, float oz) {
    return ox * w.x + oy * w.y + oz * w.z + w.w;
}

__device__ __forceinline__ float dot_d(float4 w, float dx, float dy, float dz) {
    return dx * w.x + dy * w.y + dz * w.z;
}

// Barycentric test of a face at parameter t (the reference's min-form
// test, written as three comparisons so that NaN fails it).
__device__ __forceinline__ bool inside(const float4* wp, float t,
                                       float ox, float oy, float oz,
                                       float dx, float dy, float dz) {
    const float4 wu = wp[0];
    const float4 wv = wp[1];
    const float u = dot_o(wu, ox, oy, oz) + t * dot_d(wu, dx, dy, dz);
    const float v = dot_o(wv, ox, oy, oz) + t * dot_d(wv, dx, dy, dz);
    return u >= 0.0f && v >= 0.0f && 1.0f - u - v >= 0.0f;
}

// Free-flight distance of a uniform: -log(max(1 - u, 1e-38)) / majorant.
__device__ __forceinline__ float flight(float u, float inv_maj) {
    return -logf(fmaxf(1.0f - u, 1e-38f)) * inv_maj;
}

// [t0, t1] of the ray against the medium's local [0,1]^3; empty for a ray
// parallel to a slab and outside it (volmegakernel.py:229-249).
__device__ __forceinline__ void box_interval(const VolArgs& a, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, float& t0,
                                             float& t1) {
    const float* M = a.med;
    t0 = -BIG;
    t1 = BIG;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const float o_l =
            M[3 * i] * ox + M[3 * i + 1] * oy + M[3 * i + 2] * oz + M[9 + i];
        const float d_l = M[3 * i] * dx + M[3 * i + 1] * dy + M[3 * i + 2] * dz;
        const bool small = fabsf(d_l) <= 1e-12f;
        const float inv = 1.0f / (small ? 1e-12f : d_l);
        const float ta = (0.0f - o_l) * inv;
        const float tb = (1.0f - o_l) * inv;
        const bool par_out = small && (o_l < 0.0f || o_l > 1.0f);
        t0 = fmaxf(t0, par_out ? BIG : fminf(ta, tb));
        t1 = fminf(t1, par_out ? -BIG : fmaxf(ta, tb));
    }
}

// One axis of the clamped lerp: lower index, upper index, weight.
__device__ __forceinline__ void lerp_axis(float l, int n, int& i0, int& i1,
                                          float& t) {
    const float f = l * (float)n - 0.5f;
    const float fi = fminf(fmaxf(floorf(f), 0.0f), (float)(n - 1));
    t = fminf(fmaxf(f - fi, 0.0f), 1.0f);
    i0 = (int)fi;
    i1 = min(i0 + 1, n - 1);
}

// sigma_t at a world point: the grid's clamped trilinear lerp at the
// medium-local point (coordinates clipped to [-1, 2] first; lerps along z,
// then y, then x), times scale, and 0 outside [0,1]^3
// (volmegakernel.py:118-183).
__device__ __forceinline__ float sigma_at(const VolArgs& a, float px,
                                          float py, float pz) {
    const float* M = a.med;
    float l[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
        l[i] = fminf(fmaxf(M[3 * i] * px + M[3 * i + 1] * py
                           + M[3 * i + 2] * pz + M[9 + i], -1.0f), 2.0f);
    if (!(l[0] >= 0.0f && l[0] <= 1.0f && l[1] >= 0.0f && l[1] <= 1.0f
          && l[2] >= 0.0f && l[2] <= 1.0f))
        return 0.0f;
    const int D = a.grid_d, H = a.grid_h, W = a.grid_w;
    int ix, ix1, iy, iy1, iz, iz1;
    float tx, ty, tz;
    lerp_axis(l[0], W, ix, ix1, tx);
    lerp_axis(l[1], H, iy, iy1, ty);
    lerp_axis(l[2], D, iz, iz1, tz);
    const float* g0 = a.grid + (size_t)iz * H * W;
    const float* g1 = a.grid + (size_t)iz1 * H * W;
    const int r0 = iy * W, r1 = iy1 * W;
    const float c00 = __ldg(g0 + r0 + ix) * (1.0f - tz) + __ldg(g1 + r0 + ix) * tz;
    const float c10 = __ldg(g0 + r1 + ix) * (1.0f - tz) + __ldg(g1 + r1 + ix) * tz;
    const float c01 = __ldg(g0 + r0 + ix1) * (1.0f - tz) + __ldg(g1 + r0 + ix1) * tz;
    const float c11 = __ldg(g0 + r1 + ix1) * (1.0f - tz) + __ldg(g1 + r1 + ix1) * tz;
    const float cx0 = c00 * (1.0f - ty) + c10 * ty;
    const float cx1 = c01 * (1.0f - ty) + c11 * ty;
    return (cx0 * (1.0f - tx) + cx1 * tx) * a.scale;
}

// HG phase value at cosine c between -d and the new direction, or
// 1 / (4 pi) without HG.
template <bool HG>
__device__ __forceinline__ float phase_value(const VolArgs& a, float c) {
    if constexpr (HG) {
        const float temp = a.hg_a + a.hg_b * c;
        return a.hg_c / fmaxf(temp * sqrtf(fmaxf(temp, 1e-8f)), 1e-8f);
    } else {
        return a.inv4pi;
    }
}

template <int FLAGS>
__global__ void __launch_bounds__(BLOCK) volpath_kernel(const VolArgs a) {
    constexpr bool HG = FLAGS & F_HG;
    constexpr bool MISM = FLAGS & F_MIS;
    constexpr bool GGX = FLAGS & F_GGX;
    constexpr bool DIEL = FLAGS & F_DIEL;
    const int n_faces = a.n_faces;
    extern __shared__ float4 s_woop[];      // 3 float4 per opaque face
    for (int i = threadIdx.x; i < 3 * n_faces; i += blockDim.x)
        s_woop[i] = a.woop[i];
    __syncthreads();
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= a.n_lanes) return;

    // ---- camera ray (volmegakernel.py:332-359) ----
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

    float thr[3] = {1.0f, 1.0f, 1.0f}, res[3] = {0.0f, 0.0f, 0.0f};
    int depth = 0;
    bool spec = true;          // specular chain (emission counted, !MIS)
    float prev_pdf = 0.0f;     // MIS: 0 is the camera ray (weight 1)
    const float inv_maj = a.inv_maj;
    const int max_depth = a.max_depth;

    for (int r = 0; r < max_depth + LAUNCH_SLACK; ++r) {
        const uint32_t dim0 = 2u + 64u * (uint32_t)r;

        // ---- closest opaque hit: lowest face id on ties ----
        float t_surf = BIG;
        int face = -1;
        for (int f = 0; f < n_faces; ++f) {
            const float4 wz = s_woop[3 * f + 2];
            const float tf = -dot_o(wz, ox, oy, oz) / dot_d(wz, dx, dy, dz);
            if (!(tf >= 0.0f && tf <= BIG && tf < t_surf)) continue;
            if (inside(s_woop + 3 * f, tf, ox, oy, oz, dx, dy, dz)) {
                t_surf = tf;
                face = f;
            }
        }

        // ---- delta tracking inside [t0, t1] of the box, up to t_surf ----
        float tb0, tb1;
        box_interval(a, ox, oy, oz, dx, dy, dz, tb0, tb1);
        tb0 = fmaxf(tb0, 0.0f);
        const float cap = fminf(tb1, t_surf);
        bool walking = cap > tb0, scattered = false;
        float t_cur = tb0, t_scat = 0.0f;
        if (walking) {
            float t_cum = tb0;
            for (int k = 0; k < NULL_BUDGET; ++k) {
                const float dt =
                    flight(u01(mix32(key, dim0 + 2u * (uint32_t)k)), inv_maj);
                t_cum = fminf(t_cum + dt, BIG);
                if (t_cum > cap) {               // escaped the medium
                    walking = false;
                    break;
                }
                const float u_real =
                    u01(mix32(key, dim0 + 2u * (uint32_t)k + 1u));
                const float sig = sigma_at(a, ox + t_cum * dx,
                                           oy + t_cum * dy, oz + t_cum * dz);
                t_cur = t_cum;
                if (u_real < sig * inv_maj) {    // a real collision
                    scattered = true;
                    t_scat = t_cum;
                    walking = false;
                    break;
                }
            }
        }
        if (walking) {
            // the budget ran out: carry the march point to the next round
            if (!(depth < max_depth)) break;
            ox = ox + t_cur * dx;
            oy = oy + t_cur * dy;
            oz = oz + t_cur * dz;
            continue;
        }
        if (!scattered && face < 0) break;       // left the scene

        float thr_[3] = {thr[0], thr[1], thr[2]};
        float px, py, pz, eps = 0.0f;
        float nx = 0.0f, ny = 0.0f, nz = 0.0f;
        float alb[3] = {0.0f, 0.0f, 0.0f};
        float t1x = 0.0f, t1y = 0.0f, t1z = 0.0f, t2x = 0.0f, t2y = 0.0f,
              t2z = 0.0f;
        float wix = 0.0f, wiy = 0.0f, wiz_r = 0.0f, wiz = 1e-6f;
        float alpha = 1e-3f;
        bool is_ggx = false, is_diel = false;
        const float4* A = a.fattr + VFA4 * (face < 0 ? 0 : face);
        if (scattered) {
            // ---- real scatter: albedo, depth ----
#pragma unroll
            for (int c = 0; c < 3; ++c) thr_[c] *= a.albedo[c];
            depth += 1;
            if (!(depth < max_depth)) break;
            px = ox + t_scat * dx;
            py = oy + t_scat * dy;
            pz = oz + t_scat * dz;
        } else {
            // ---- surface event: emission, then FrontSide / two-sided ----
            const float4 a0 = __ldg(A), a1 = __ldg(A + 1), a2 = __ldg(A + 2);
            nx = a0.x;
            ny = a0.y;
            nz = a0.z;
            alb[0] = a0.w;
            alb[1] = a1.x;
            alb[2] = a1.y;
            const float cos_hit = -(dx * nx + dy * ny + dz * nz);
            if constexpr (GGX) is_ggx = a2.z > 0.5f && a2.z < 1.5f;
            if constexpr (DIEL) is_diel = a2.z > 2.5f && a2.z < 3.5f;
            alpha = fmaxf(a2.w, 1e-3f);
            const float le[3] = {a1.z, a1.w, a2.x};
            if constexpr (MISM) {
                if (cos_hit > 0.0f) {
                    const float pdf_l_hit = cos_hit > 1e-6f
                        ? t_surf * t_surf * a2.y / fmaxf(cos_hit, 1e-6f)
                        : 0.0f;
                    const float em_w =
                        prev_pdf > 0.0f ? mis(prev_pdf, pdf_l_hit) : 1.0f;
#pragma unroll
                    for (int c = 0; c < 3; ++c) res[c] += em_w * thr_[c] * le[c];
                }
            } else {
                if (spec && cos_hit > 0.0f) {
#pragma unroll
                    for (int c = 0; c < 3; ++c) res[c] += thr_[c] * le[c];
                }
            }
            if (!(cos_hit > 0.0f || is_diel)) break;
            px = ox + t_surf * dx;
            py = oy + t_surf * dy;
            pz = oz + t_surf * dz;
            eps = (1.0f + fmaxf(fabsf(px), fmaxf(fabsf(py), fabsf(pz))))
                * 1.8e-4f;
            // local shading frame around ng (Duff et al.)
            const float s_n = nz >= 0.0f ? 1.0f : -1.0f;
            const float oan = -1.0f / (s_n + nz);
            const float obn = nx * ny * oan;
            t1x = 1.0f + s_n * nx * nx * oan;
            t1y = s_n * obn;
            t1z = -s_n * nx;
            t2x = obn;
            t2y = s_n + ny * ny * oan;
            t2z = -ny;
            wix = -dx * t1x + -dy * t1y + -dz * t1z;
            wiy = -dx * t2x + -dy * t2y + -dz * t2z;
            wiz_r = -dx * nx + -dy * ny + -dz * nz;
            wiz = fmaxf(wiz_r, 1e-6f);
        }

        // ---- unified NEE: a light face, shadow any-hit, ratio tracking ----
        if (scattered || (depth + 1 < max_depth && !is_diel)) {
            float u_sel, u_b1, u_b2, nee_unused;
            rng2(key, dim0 + 16u, u_sel, u_b1);
            rng2(key, dim0 + 17u, u_b2, nee_unused);
            const float* lights = a.lights;
            const int n_lights = a.n_lights;
            int li = 0;
            for (int l = 0; l < n_lights; ++l)
                li += __ldg(lights + 24 * l + 12) <= u_sel;
            const float* LT = lights + 24 * min(li, n_lights - 1);
            const float s_t = sqrtf(fmaxf(1.0f - u_b1, 0.0f));
            const float bu = 1.0f - s_t;
            const float bv = u_b2 * s_t;
            const float sox = scattered ? px : px + nx * eps;
            const float soy = scattered ? py : py + ny * eps;
            const float soz = scattered ? pz : pz + nz * eps;
            float dlx = __ldg(LT + 0) + __ldg(LT + 3) * bu + __ldg(LT + 6) * bv - sox;
            float dly = __ldg(LT + 1) + __ldg(LT + 4) * bu + __ldg(LT + 7) * bv - soy;
            float dlz = __ldg(LT + 2) + __ldg(LT + 5) * bu + __ldg(LT + 8) * bv - soz;
            const float dist2 = dlx * dlx + dly * dly + dlz * dlz;
            const float dist = sqrtf(fmaxf(dist2, 1e-20f));
            const float inv_dist = 1.0f / dist;
            dlx *= inv_dist;
            dly *= inv_dist;
            dlz *= inv_dist;
            const float cos_l = -(dlx * __ldg(LT + 9) + dly * __ldg(LT + 10)
                                  + dlz * __ldg(LT + 11));
            const float pdf_l = cos_l > 1e-6f
                ? dist2 * __ldg(LT + 13) / fmaxf(cos_l, 1e-6f) : 0.0f;
            // f toward the light (phase, or BSDF * cos with the albedo) and
            // the continuation strategy's density in that direction
            float f[3], pdf_dir, cos_s = 1.0f;
            if (scattered) {
                const float ph =
                    phase_value<HG>(a, -(dx * dlx + dy * dly + dz * dlz));
                f[0] = f[1] = f[2] = ph;
                pdf_dir = ph;
            } else {
                cos_s = dlx * nx + dly * ny + dlz * nz;
                const float fcos_diff = fmaxf(cos_s, 0.0f) / PI_F;
                pdf_dir = fcos_diff;
#pragma unroll
                for (int c = 0; c < 3; ++c) f[c] = fcos_diff * alb[c];
                if constexpr (GGX) {
                    if (is_ggx) {
                        const float wox = dlx * t1x + dly * t1y + dlz * t1z;
                        const float woy = dlx * t2x + dly * t2y + dlz * t2z;
                        const float woz = dlx * nx + dly * ny + dlz * nz;
                        float hx = wix + wox, hy = wiy + woy, hz = wiz + woz;
                        const float hinv =
                            rsqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-20f));
                        hx *= hinv;
                        hy *= hinv;
                        hz *= hinv;
                        const float ci_h =
                            fmaxf(wix * hx + wiy * hy + wiz * hz, 0.0f);
                        const float D_l = ggx_d(hz, alpha);
                        const float G_l = ggx_g1(wiz, alpha)
                            * ggx_g1(fmaxf(woz, 1e-6f), alpha);
                        const float spec_common =
                            D_l * G_l / fmaxf(4.0f * wiz, 1e-20f);
                        pdf_dir = ggx_g1(wiz, alpha) * D_l
                            / fmaxf(4.0f * wiz, 1e-20f);
                        const float ggx_ok = woz > 0.0f ? 1.0f : 0.0f;
                        const float4 a3 = __ldg(A + 3), a4 = __ldg(A + 4);
                        const float eta[3] = {a3.x, a3.y, a3.z};
                        const float kap[3] = {a3.w, a4.x, a4.y};
#pragma unroll
                        for (int c = 0; c < 3; ++c)
                            f[c] = spec_common
                                * fresnel_cond(ci_h, eta[c], kap[c]) * ggx_ok
                                * alb[c];
                    }
                }
            }
            if (pdf_l > 0.0f && cos_s > 0.0f) {
                const float maxt = dist * 0.999f;
                bool occluded = false;
                for (int fc = 0; fc < n_faces && !occluded; ++fc) {
                    const float4 wz = s_woop[3 * fc + 2];
                    const float tf = -dot_o(wz, sox, soy, soz)
                        / dot_d(wz, dlx, dly, dlz);
                    if (!(tf >= 1e-4f && tf <= maxt)) continue;
                    occluded = inside(s_woop + 3 * fc, tf, sox, soy, soz,
                                      dlx, dly, dlz);
                }
                if (!occluded) {
                    // ratio tracking across the shadow ray's box interval;
                    // a walk that runs out of budget keeps its partial T
                    float sb0, sb1;
                    box_interval(a, sox, soy, soz, dlx, dly, dlz, sb0, sb1);
                    sb0 = fmaxf(sb0, 0.0f);
                    sb1 = fminf(sb1, dist);
                    float T = 1.0f;
                    if (sb1 > sb0) {
                        float s = sb0;
                        for (int k = 0; k < TR_BUDGET; ++k) {
                            s = fminf(s + flight(u01(mix32(
                                key, dim0 + 38u + (uint32_t)k)), inv_maj), BIG);
                            if (s > sb1) break;
                            T = T * fmaxf(1.0f - sigma_at(a, sox + s * dlx,
                                                          soy + s * dly,
                                                          soz + s * dlz)
                                          * inv_maj, 0.0f);
                            if (!(T > 0.0f)) break;
                        }
                    }
                    const float w_nee = MISM ? mis(pdf_l, pdf_dir) : 1.0f;
                    const float base = w_nee * T / fmaxf(pdf_l, 1e-20f);
#pragma unroll
                    for (int c = 0; c < 3; ++c)
                        res[c] += thr_[c] * base * f[c] * __ldg(LT + 14 + c);
                }
            }
        }

        if (scattered) {
            // ---- phase sample around d (HG or the uniform sphere) ----
            float u_p1, u_p2;
            rng2(key, dim0 + 34u, u_p1, u_p2);
            float cth;
            if constexpr (HG) {
                const float sq = a.hg_d / (a.hg_e + a.hg_b * u_p1);
                cth = (a.hg_a - sq * sq) / a.hg_b;
            } else {
                cth = 1.0f - 2.0f * u_p1;
            }
            cth = fminf(fmaxf(cth, -1.0f), 1.0f);
            const float sth = sqrtf(fmaxf(1.0f - cth * cth, 0.0f));
            const float phi = TWO_PI * u_p2;
            const float cph = cosf(phi), sph = sinf(phi);
            const float s_d = dz >= 0.0f ? 1.0f : -1.0f;
            const float oa = -1.0f / (s_d + dz);
            const float ob = dx * dy * oa;
            const float f1x = 1.0f + s_d * dx * dx * oa, f1y = s_d * ob;
            const float f1z = -s_d * dx;
            const float f2x = ob, f2y = s_d + dy * dy * oa, f2z = -dy;
            const float ndx = sth * cph * f1x + sth * sph * f2x + cth * dx;
            const float ndy = sth * cph * f1y + sth * sph * f2y + cth * dy;
            const float ndz = sth * cph * f1z + sth * sph * f2z + cth * dz;
            if constexpr (MISM) {
                if constexpr (HG) {
                    const float tmp_o = a.hg_a - a.hg_b * cth;
                    prev_pdf = a.hg_c
                        / fmaxf(tmp_o * sqrtf(fmaxf(tmp_o, 1e-8f)), 1e-8f);
                } else {
                    prev_pdf = a.inv4pi;
                }
            }
            ox = px;
            oy = py;
            oz = pz;
            dx = ndx;
            dy = ndy;
            dz = ndz;
            spec = false;
        } else {
            // ---- surface lobe: cosine, GGX visible normals, dielectric ----
            float u_c1, u_c2;
            rng2(key, dim0 + 35u, u_c1, u_c2);
            float wx, wy, wz, mm[3], pdf_bounce;
            bool ok_lobe;
            if (DIEL && is_diel) {
                // two delta lobes by Fresnel; transmission scales the
                // radiance by eta_ti^2 (dielectric.cpp)
                float u_lobe, lobe_unused;
                rng2(key, dim0 + 37u, u_lobe, lobe_unused);
                const float4 a4 = __ldg(A + 4), a5 = __ldg(A + 5);
                const float eta = fmaxf(a5.y, 1e-3f);
                const bool outside = wiz_r >= 0.0f;
                const float rcp = 1.0f / eta;
                const float eta_it = outside ? eta : rcp;
                const float eta_ti = outside ? rcp : eta;
                const float c2t =
                    1.0f - eta_ti * eta_ti * (1.0f - wiz_r * wiz_r);
                const float aci = fabsf(wiz_r);
                const float act = sqrtf(fmaxf(c2t, 0.0f));
                const float a_s = (aci - eta_it * act)
                    / fmaxf(aci + eta_it * act, 1e-20f);
                const float a_p = (eta_it * aci - act)
                    / fmaxf(eta_it * aci + act, 1e-20f);
                float F = 0.5f * (a_s * a_s + a_p * a_p);
                F = eta == 1.0f ? 0.0f : (c2t <= 0.0f ? 1.0f : F);
                const float cos_t = wiz_r <= 0.0f ? act : -act;
                const bool refl = u_lobe <= F;
                wx = refl ? -wix : -eta_ti * wix;
                wy = refl ? -wiy : -eta_ti * wiy;
                wz = refl ? wiz_r : cos_t;
                const float c2[3] = {a4.z, a4.w, a5.x};
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    mm[c] = refl ? alb[c] : c2[c] * eta_ti * eta_ti;
                ok_lobe = true;
                pdf_bounce = 0.0f;
            } else if (GGX && is_ggx) {
                float vhx = alpha * wix, vhy = alpha * wiy, vhz = wiz;
                const float vinv =
                    rsqrtf(fmaxf(vhx * vhx + vhy * vhy + vhz * vhz, 1e-20f));
                vhx *= vinv;
                vhy *= vinv;
                vhz *= vinv;
                const float lensq = vhx * vhx + vhy * vhy;
                const float linv = rsqrtf(fmaxf(lensq, 1e-20f));
                const float v1x = lensq > 1e-12f ? -vhy * linv : 1.0f;
                const float v1y = lensq > 1e-12f ? vhx * linv : 0.0f;
                const float v2x = -vhz * v1y, v2y = vhz * v1x;
                const float v2z = vhx * v1y - vhy * v1x;
                const float rr = sqrtf(fmaxf(u_c1, 0.0f));
                const float phiv = TWO_PI * u_c2;
                const float p1 = rr * cosf(phiv);
                float p2 = rr * sinf(phiv);
                const float s_v = 0.5f * (1.0f + vhz);
                p2 = (1.0f - s_v) * sqrtf(fmaxf(1.0f - p1 * p1, 0.0f))
                    + s_v * p2;
                const float pzz = sqrtf(fmaxf(1.0f - p1 * p1 - p2 * p2, 0.0f));
                float mhx = alpha * (p1 * v1x + p2 * v2x + pzz * vhx);
                float mhy = alpha * (p1 * v1y + p2 * v2y + pzz * vhy);
                float mhz = fmaxf(p2 * v2z + pzz * vhz, 1e-6f);
                const float minv = rsqrtf(mhx * mhx + mhy * mhy + mhz * mhz);
                mhx *= minv;
                mhy *= minv;
                mhz *= minv;
                const float wm = wix * mhx + wiy * mhy + wiz * mhz;
                wx = 2.0f * wm * mhx - wix;
                wy = 2.0f * wm * mhy - wiy;
                wz = 2.0f * wm * mhz - wiz;
                pdf_bounce = ggx_g1(wiz, alpha) * ggx_d(mhz, alpha)
                    / fmaxf(4.0f * wiz, 1e-20f);
                ok_lobe = wz > 1e-6f && wm > 0.0f;
                const float g1o = ggx_g1(fmaxf(wz, 1e-6f), alpha);
                const float cm = fmaxf(wm, 0.0f);
                const float4 a3 = __ldg(A + 3), a4 = __ldg(A + 4);
                const float eta[3] = {a3.x, a3.y, a3.z};
                const float kap[3] = {a3.w, a4.x, a4.y};
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    mm[c] = alb[c] * fresnel_cond(cm, eta[c], kap[c]) * g1o;
            } else {
                concentric(u_c1, u_c2, wx, wy);
                wz = sqrtf(fmaxf(1.0f - wx * wx - wy * wy, 0.0f));
                ok_lobe = wz > 0.0f;
                pdf_bounce = fmaxf(wz, 0.0f) / PI_F;
#pragma unroll
                for (int c = 0; c < 3; ++c) mm[c] = alb[c];
            }
            if (!(ok_lobe && mm[0] + mm[1] + mm[2] > 0.0f)) break;
#pragma unroll
            for (int c = 0; c < 3; ++c) thr_[c] *= mm[c];
            depth += 1;
            // leave on the side the new ray goes (transmission crosses)
            const float offs = wz >= 0.0f ? eps : 0.0f - eps;
            ox = px + nx * offs;
            oy = py + ny * offs;
            oz = pz + nz * offs;
            dx = wx * t1x + wy * t2x + wz * nx;
            dy = wx * t1y + wy * t2y + wz * ny;
            dz = wx * t1z + wy * t2z + wz * nz;
            spec = spec && is_diel;
            if constexpr (MISM) prev_pdf = pdf_bounce;
        }
        if (!(depth < max_depth)) break;
        if (!(thr_[0] + thr_[1] + thr_[2] > 0.0f)) break;

        // ---- Russian roulette (volpath.cpp) ----
        if (depth > a.rr_depth) {
            float rr_u, rr_unused;
            rng2(key, dim0 + 36u, rr_u, rr_unused);
            const float q = fminf(fmaxf(thr_[0], fmaxf(thr_[1], thr_[2])),
                                  0.95f);
            if (!(rr_u < q)) break;
            const float inv_q = 1.0f / fmaxf(q, 1e-8f);
#pragma unroll
            for (int c = 0; c < 3; ++c) thr_[c] *= inv_q;
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) thr[c] = thr_[c];
    }

    // 64-bit offsets: 2 * n_lanes overflows int from 2^30 lanes on
    const size_t n = (size_t)a.n_lanes;
    a.out[lane] = res[0];
    a.out[n + lane] = res[1];
    a.out[2 * n + lane] = res[2];
}

template <int FLAGS>
int launch(const VolArgs& a, cudaStream_t stream) {
    const size_t smem = (size_t)a.n_faces * 3 * sizeof(float4);
    cudaError_t err = cudaFuncSetAttribute(
        volpath_kernel<FLAGS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = (a.n_lanes + BLOCK - 1) / BLOCK;
    volpath_kernel<FLAGS><<<grid, BLOCK, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// C entry point: launches the instantiation of args->flags, one thread per
// lane, on `stream`, and returns cudaGetLastError() (0 when the launch was
// accepted).
extern "C" int volpath_render(const VolArgs* args, void* stream) {
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
