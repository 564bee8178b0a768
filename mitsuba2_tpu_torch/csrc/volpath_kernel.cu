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
// A path's cost is its rounds' event code (closest hit, box interval, the
// NEE's set-up and shadow sweep, the continuation: TEA draws, sinf, cosf)
// and its tracking steps (about 10 on the bench slab, 94 at 16 times its
// density), each a mix32, an exact logf, the point, eight dependent taps
// and a test, some 200 instructions (tools/sass_loops.py). Path lengths
// in a medium vary widely (1 to 18 rounds), so what loses most is SIMT
// divergence: PR 4's design, a thread a path, kept 46% of a warp's lane
// slots busy a round and 22.7% a step (PERF.md section 5).
//
// What the design does about that (PR 11, each step measured against PR
// 4's kernel in the same call; PERF.md section 6):
// - Persistent warps that refill finished paths: a grid of the card's SMs
//   times the blocks resident on each; at each round's start a warp's
//   empty slots take the next lanes from a counter (a ballot of the empty
//   slots, one atomicAdd by the warp's leader), so a slot runs paths back
//   to back instead of idling until its warp's longest path ends.
//   Refilled lanes of a warp are consecutive samples of a pixel.
// - A warp runs a round at a time, its two walks nested as in PR 4: the
//   closest hit, the delta walk, the event, the NEE's ratio walk. A
//   round's continuation is drawn before its NEE's ratio walk (its dims do
//   not depend on T), so a lane carries its next ray and the queued NEE
//   term through the walk. One loop of tracking steps for both walks, with
//   the event code run once a number of lanes wait (Aila and Laine's
//   while-while loop, HPG 2009), measured slower at 8, 16 and 32 waiting
//   lanes: on the bench slab a walk is 1-2 steps, and the lanes that walk
//   idle through the event code of the others.
// - The eight taps' offsets are 32-bit ints (the grid caps keep a grid
//   under 2^21 floats): a step's integer instructions fall by a third.
// - A lane's arithmetic is PR 4's, operation for operation: the same dims
//   (delta step k at dim0 + 2k and + 1, ratio step k at dim0 + 38 + k),
//   budgets and order of the additions into the radiance, so outputs are
//   bit-identical to PR 4's kernel at equal seed (tools/time_paths.py
//   --compare), whatever order lanes reach threads in.
// - The opaque faces' Woop rows sit in shared memory (a warp's lanes read
//   the same face at the same step: a broadcast); the grid is read with
//   __ldg through the read-only cache (in shared memory it ran no faster).
// - The content picks the instantiation (template FLAGS, the reference's
//   static has_hg / mis_mode / has_ggx / has_diel): 16 instantiations.
// Math is exact (logf, sinf, cosf, sqrtf; no fast-math).

#include <cuda_runtime.h>
#include <stdint.h>

#include "rng.cuh"
#include "shading.cuh"

#define BLOCK 128
#define BIG 3.0e38f
// VK_PROFILE=1 (tools/prof_volpath.py --phases) sums each lane slot's
// clock cycles by phase (P_* below) into counter[2..]; without it nothing
// is counted.
#ifndef VK_PROFILE
#define VK_PROFILE 0
#endif
// volpath_render's own error codes (ops/volpath_kernel.py LAUNCH_ERRORS):
// no block fits on an SM; the lane counter could wrap
#define NO_BLOCK_FITS -1
#define COUNTER_WRAPS -2

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
    // [0]: the next lane to start (zeroed by the wrapper); [2..]: the
    // profiled build's 64-bit sums
    uint32_t* counter;
};

namespace {

// instantiation flags (ops/volpath_kernel.py HAS_HG, MIS, HAS_GGX, HAS_DIEL)
constexpr int F_HG = 1, F_MIS = 2, F_GGX = 4, F_DIEL = 8;
// the reference's budgets (volmegakernel.py:80-86)
constexpr int NULL_BUDGET = 16, TR_BUDGET = 16, LAUNCH_SLACK = 2;
// attribute float4s per face (ops/volpath_kernel.py VFA / 4)
constexpr int VFA4 = 6;
constexpr float TWO_PI = (float)(2.0 * 3.141592653589793);
constexpr unsigned FULL = 0xffffffffu;

// The loop's compile-time choices, from the card (PERF.md section 6, NVIDIA
// H100 80GB HBM3 at 700 W): the blocks of 128 threads that must fit on an
// SM, which caps the registers at 80 (64 B spilled; 5 blocks at 96
// registers ran 0.96x, 8 at 64 registers 0.95x on the bench slab and on
// the dense one 0.99x and 0.95x; blocks of 256 threads at the same cap
// 1.00x), and the empty slots of a warp that make it refill (8 ran 0.97x
// and 1.00x, 16 0.90x and 0.88x).
constexpr int MIN_BLOCKS = 6;
constexpr int REFILL_AT = 1;

// the profile's phases (ops/volpath_kernel.py PHASES): camera set-up;
// closest hit and box interval; delta walk; scatter or surface event with
// the NEE set-up; shadow sweep; ratio walk and the NEE term; continuation
// and roulette; a live lane waiting for the others of its warp at the
// round's end; a slot without a path while its warp runs on
enum { P_CAMERA, P_HIT, P_DELTA, P_EVENT, P_SHADOW, P_RATIO, P_CONT,
       P_IDLE, P_EMPTY, N_PHASES };
#if VK_PROFILE
#define MARK(k) { const long long now_ = clock64(); \
    prof[k] += (unsigned)(now_ - t_last); t_last = now_; }
// every lane of the warp, at one point: the lanes' phase k, or idle
#define MARK_ALL(k) { __syncwarp(); const long long now_ = clock64(); \
    const unsigned dt_ = (unsigned)(now_ - t_last); t_last = now_; \
    const int k_ = (k); \
    _Pragma("unroll") for (int j_ = 0; j_ < N_PHASES; ++j_) \
        prof[j_] += j_ == k_ ? dt_ : 0u; }
#define PROF_PARAMS , unsigned* prof, long long& t_last
#define PROF_ARGS , prof, t_last
#else
#define MARK(k)
#define MARK_ALL(k)
#define PROF_PARAMS
#define PROF_ARGS
#endif

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
    // 32-bit tap offsets: the caps keep a grid under 2^21 floats
    const float* g = a.grid;
    const int b0 = iz * H * W, b1 = iz1 * H * W;
    const int r0 = iy * W, r1 = iy1 * W;
    const float c00 = __ldg(g + (b0 + r0 + ix)) * (1.0f - tz) + __ldg(g + (b1 + r0 + ix)) * tz;
    const float c10 = __ldg(g + (b0 + r1 + ix)) * (1.0f - tz) + __ldg(g + (b1 + r1 + ix)) * tz;
    const float c01 = __ldg(g + (b0 + r0 + ix1)) * (1.0f - tz) + __ldg(g + (b1 + r0 + ix1)) * tz;
    const float c11 = __ldg(g + (b0 + r1 + ix1)) * (1.0f - tz) + __ldg(g + (b1 + r1 + ix1)) * tz;
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


// Where a path is in its round: S_ROUND, the round r starts with the
// closest hit; S_DELTA, S_RATIO: on its delta walk or its NEE's ratio
// walk; S_STALLED, S_ESCAPED, S_SCATTERED: the delta walk ran out of
// steps, left the medium (or never entered it) or found a real collision;
// S_RATIO_END: the ratio walk ended (T in x), the NEE term is due.
enum : int { S_ROUND, S_RATIO_END, S_STALLED, S_ESCAPED, S_SCATTERED,
             S_DELTA, S_RATIO };

struct Path {
    int lane;                 // -1: the slot is empty
    int state, r, k, depth;   // k: the walk's next step
    uint32_t key;
    bool spec;                // specular chain (emission counted, !MIS)
    bool ends;                // the path ends once its queued NEE is added
    float ox, oy, oz, dx, dy, dz;
    float thr[3], res[3];
    float prev_pdf;           // MIS: 0 is the camera ray (weight 1)
    // the walk: origin, direction, its t so far and its end
    float wox, woy, woz, wdx, wdy, wdz, wt, wend;
    // delta walk: the closest opaque hit's t and face; ratio walk: T and
    // the NEE's light row
    float x;
    int id;
    // the queued NEE term: the throughput before the continuation, f, the
    // MIS weight and the light pdf
    float nthr[3], nf[3], w_nee, pdf_l;
};

// Camera ray of `lane` (volmegakernel.py:332-359); the path starts its
// first round.
__device__ __forceinline__ void start_path(const VolArgs& a, int lane,
                                           Path& p) {
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
    p.dx = cam[0] * lx + cam[1] * ly + cam[2] * lz;
    p.dy = cam[3] * lx + cam[4] * ly + cam[5] * lz;
    p.dz = cam[6] * lx + cam[7] * ly + cam[8] * lz;
    p.ox = cam[9];
    p.oy = cam[10];
    p.oz = cam[11];
    p.key = key;
    p.lane = lane;
    p.state = S_ROUND;
    p.r = 0;
    p.depth = 0;
    p.spec = true;
    p.prev_pdf = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        p.thr[c] = 1.0f;
        p.res[c] = 0.0f;
    }
}

// The path's radiance out; its slot is empty.
__device__ __forceinline__ void finish(const VolArgs& a, Path& p) {
    // 64-bit offsets: 2 * n_lanes overflows int from 2^30 lanes on
    const size_t n = (size_t)a.n_lanes;
    a.out[p.lane] = p.res[0];
    a.out[n + p.lane] = p.res[1];
    a.out[2 * n + p.lane] = p.res[2];
    p.lane = -1;
}

// The next round, or the end of a path whose event ended it.
__device__ __forceinline__ void next_round(const VolArgs& a, Path& p) {
    if (p.ends) {
        finish(a, p);
    } else {
        ++p.r;
        p.state = S_ROUND;
    }
}

// The queued NEE term with transmittance T = p.x, then the next round.
template <bool MISM>
__device__ __forceinline__ void ratio_end(const VolArgs& a, Path& p) {
    const float* LT = a.lights + 24 * p.id;
    const float w_nee = MISM ? p.w_nee : 1.0f;
    const float base = w_nee * p.x / fmaxf(p.pdf_l, 1e-20f);
#pragma unroll
    for (int c = 0; c < 3; ++c)
        p.res[c] += p.nthr[c] * base * p.nf[c] * __ldg(LT + 14 + c);
    next_round(a, p);
}

// A delta walk that ran out of steps carries its march point (the last
// fetch) to the next round.
__device__ __forceinline__ void stalled(const VolArgs& a, Path& p) {
    if (!(p.depth < a.max_depth)) {
        finish(a, p);
        return;
    }
    p.ox = p.ox + p.wt * p.dx;
    p.oy = p.oy + p.wt * p.dy;
    p.oz = p.oz + p.wt * p.dz;
    p.ends = false;
    next_round(a, p);
}

// Round r: the closest opaque hit (lowest face id on ties) and the ray's
// interval in the medium box; a delta walk in [t0, min(t1, t_surf)], or
// none if that is empty.
__device__ __forceinline__ void round_start(const VolArgs& a,
                                            const float4* s_woop, Path& p) {
    if (p.r >= a.max_depth + LAUNCH_SLACK) {
        finish(a, p);
        return;
    }
    const float ox = p.ox, oy = p.oy, oz = p.oz;
    const float dx = p.dx, dy = p.dy, dz = p.dz;
    float t_surf = BIG;
    int face = -1;
    for (int f = 0; f < a.n_faces; ++f) {
        const float4 wz = s_woop[3 * f + 2];
        const float tf = -dot_o(wz, ox, oy, oz) / dot_d(wz, dx, dy, dz);
        if (!(tf >= 0.0f && tf <= BIG && tf < t_surf)) continue;
        if (inside(s_woop + 3 * f, tf, ox, oy, oz, dx, dy, dz)) {
            t_surf = tf;
            face = f;
        }
    }
    float tb0, tb1;
    box_interval(a, ox, oy, oz, dx, dy, dz, tb0, tb1);
    tb0 = fmaxf(tb0, 0.0f);
    const float cap = fminf(tb1, t_surf);
    p.x = t_surf;
    p.id = face;
    p.wox = ox;
    p.woy = oy;
    p.woz = oz;
    p.wdx = dx;
    p.wdy = dy;
    p.wdz = dz;
    p.wt = tb0;
    p.wend = cap;
    p.k = 0;
    p.state = cap > tb0 ? S_DELTA : S_ESCAPED;
}

// One tracking step of a delta or a ratio walk: a flight, the escape
// test, one grid fetch, the real-collision test or the transmittance.
__device__ __forceinline__ void walk_step(const VolArgs& a, Path& p) {
    const bool delta = p.state == S_DELTA;
    const uint32_t dim0 = 2u + 64u * (uint32_t)p.r;
    const uint32_t dim = dim0 + (delta ? 2u * (uint32_t)p.k
                                       : 38u + (uint32_t)p.k);
    const float inv_maj = a.inv_maj;
    const float t = fminf(p.wt + flight(u01(mix32(p.key, dim)), inv_maj),
                          BIG);
    if (t > p.wend) {             // left the medium, or the segment's end
        p.state = delta ? S_ESCAPED : S_RATIO_END;
        return;
    }
    const float u_real = delta ? u01(mix32(p.key, dim + 1u)) : 0.0f;
    const float sig = sigma_at(a, p.wox + t * p.wdx, p.woy + t * p.wdy,
                               p.woz + t * p.wdz);
    p.wt = t;
    ++p.k;
    if (delta) {
        if (u_real < sig * inv_maj)
            p.state = S_SCATTERED;
        else if (p.k == NULL_BUDGET)
            p.state = S_STALLED;
    } else {
        // a walk that runs out of budget keeps its partial T
        p.x = p.x * fmaxf(1.0f - sig * inv_maj, 0.0f);
        if (!(p.x > 0.0f) || p.k == TR_BUDGET) p.state = S_RATIO_END;
    }
}

// The event of a round whose delta walk ended (S_ESCAPED or S_SCATTERED):
// scatter or surface hit, emission, the unified NEE's set-up and shadow
// sweep, the continuation and roulette. The NEE term, if any, is queued:
// its ratio walk (S_RATIO) or, on an empty segment, S_RATIO_END with
// T = 1; otherwise the path ends or takes its next round.
template <int FLAGS>
__device__ __forceinline__ void event(const VolArgs& a, const float4* s_woop,
                                      Path& p PROF_PARAMS) {
    constexpr bool HG = FLAGS & F_HG;
    constexpr bool MISM = FLAGS & F_MIS;
    constexpr bool GGX = FLAGS & F_GGX;
    constexpr bool DIEL = FLAGS & F_DIEL;
    const bool scattered = p.state == S_SCATTERED;
    const int face = p.id;
    const float t_surf = p.x;
    if (!scattered && face < 0) {              // left the scene
        finish(a, p);
        MARK(P_EVENT);
        return;
    }
    const uint32_t key = p.key;
    const uint32_t dim0 = 2u + 64u * (uint32_t)p.r;
    const int max_depth = a.max_depth;
    const float dx = p.dx, dy = p.dy, dz = p.dz;
    float thr_[3] = {p.thr[0], p.thr[1], p.thr[2]};
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
        p.depth += 1;
        if (!(p.depth < max_depth)) {
            finish(a, p);
            MARK(P_EVENT);
            return;
        }
        px = p.ox + p.wt * dx;
        py = p.oy + p.wt * dy;
        pz = p.oz + p.wt * dz;
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
                    p.prev_pdf > 0.0f ? mis(p.prev_pdf, pdf_l_hit) : 1.0f;
#pragma unroll
                for (int c = 0; c < 3; ++c) p.res[c] += em_w * thr_[c] * le[c];
            }
        } else {
            if (p.spec && cos_hit > 0.0f) {
#pragma unroll
                for (int c = 0; c < 3; ++c) p.res[c] += thr_[c] * le[c];
            }
        }
        if (!(cos_hit > 0.0f || is_diel)) {
            finish(a, p);
            MARK(P_EVENT);
            return;
        }
        px = p.ox + t_surf * dx;
        py = p.oy + t_surf * dy;
        pz = p.oz + t_surf * dz;
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

    // ---- unified NEE: a light face, shadow any-hit; its ratio walk is
    // queued ----
    bool nee = false, walk = false;
    if (scattered || (p.depth + 1 < max_depth && !is_diel)) {
        float u_sel, u_b1, u_b2, nee_unused;
        rng2(key, dim0 + 16u, u_sel, u_b1);
        rng2(key, dim0 + 17u, u_b2, nee_unused);
        const float* lights = a.lights;
        const int n_lights = a.n_lights;
        int li = 0;
        for (int l = 0; l < n_lights; ++l)
            li += __ldg(lights + 24 * l + 12) <= u_sel;
        li = min(li, n_lights - 1);
        const float* LT = lights + 24 * li;
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
        MARK(P_EVENT);
        if (pdf_l > 0.0f && cos_s > 0.0f) {
            const float maxt = dist * 0.999f;
            bool occluded = false;
            for (int fc = 0; fc < a.n_faces && !occluded; ++fc) {
                const float4 wz = s_woop[3 * fc + 2];
                const float tf = -dot_o(wz, sox, soy, soz)
                    / dot_d(wz, dlx, dly, dlz);
                if (!(tf >= 1e-4f && tf <= maxt)) continue;
                occluded = inside(s_woop + 3 * fc, tf, sox, soy, soz,
                                  dlx, dly, dlz);
            }
            MARK(P_SHADOW);
            if (!occluded) {
                // ratio tracking across the shadow ray's box interval
                float sb0, sb1;
                box_interval(a, sox, soy, soz, dlx, dly, dlz, sb0, sb1);
                sb0 = fmaxf(sb0, 0.0f);
                sb1 = fminf(sb1, dist);
                nee = true;
                walk = sb1 > sb0;
                p.wox = sox;
                p.woy = soy;
                p.woz = soz;
                p.wdx = dlx;
                p.wdy = dly;
                p.wdz = dlz;
                p.wt = sb0;
                p.wend = sb1;
                p.k = 0;
                p.x = 1.0f;
                p.id = li;
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    p.nthr[c] = thr_[c];
                    p.nf[c] = f[c];
                }
                if constexpr (MISM) p.w_nee = mis(pdf_l, pdf_dir);
                p.pdf_l = pdf_l;
            }
        }
    } else {
        MARK(P_EVENT);
    }

    // ---- the continuation: drawn before the NEE's ratio walk, whose T
    // it does not need ----
    bool ends = false;
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
                p.prev_pdf = a.hg_c
                    / fmaxf(tmp_o * sqrtf(fmaxf(tmp_o, 1e-8f)), 1e-8f);
            } else {
                p.prev_pdf = a.inv4pi;
            }
        }
        p.ox = px;
        p.oy = py;
        p.oz = pz;
        p.dx = ndx;
        p.dy = ndy;
        p.dz = ndz;
        p.spec = false;
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
        if (!(ok_lobe && mm[0] + mm[1] + mm[2] > 0.0f)) {
            ends = true;
        } else {
#pragma unroll
            for (int c = 0; c < 3; ++c) thr_[c] *= mm[c];
            p.depth += 1;
            // leave on the side the new ray goes (transmission crosses)
            const float offs = wz >= 0.0f ? eps : 0.0f - eps;
            p.ox = px + nx * offs;
            p.oy = py + ny * offs;
            p.oz = pz + nz * offs;
            p.dx = wx * t1x + wy * t2x + wz * nx;
            p.dy = wx * t1y + wy * t2y + wz * ny;
            p.dz = wx * t1z + wy * t2z + wz * nz;
            p.spec = p.spec && is_diel;
            if constexpr (MISM) p.prev_pdf = pdf_bounce;
        }
    }
    if (!ends) ends = !(p.depth < max_depth)
                   || !(thr_[0] + thr_[1] + thr_[2] > 0.0f);
    // ---- Russian roulette (volpath.cpp) ----
    if (!ends && p.depth > a.rr_depth) {
        float rr_u, rr_unused;
        rng2(key, dim0 + 36u, rr_u, rr_unused);
        const float q = fminf(fmaxf(thr_[0], fmaxf(thr_[1], thr_[2])), 0.95f);
        if (!(rr_u < q)) {
            ends = true;
        } else {
            const float inv_q = 1.0f / fmaxf(q, 1e-8f);
#pragma unroll
            for (int c = 0; c < 3; ++c) thr_[c] *= inv_q;
        }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) p.thr[c] = thr_[c];
    p.ends = ends;
    if (nee) {
        p.state = walk ? S_RATIO : S_RATIO_END;
    } else {
        next_round(a, p);
    }
    MARK(P_CONT);
}

#if VK_PROFILE
// Adds the warp's sums of its lanes' cycles by phase to counter[2..].
__device__ void add_profile(const VolArgs& a, const unsigned* prof) {
#pragma unroll
    for (int k = 0; k < N_PHASES; ++k) {
        unsigned long long v = prof[k];
        for (int o = 16; o > 0; o >>= 1)
            v += __shfl_down_sync(FULL, v, o);
        if ((threadIdx.x & 31) == 0)
            atomicAdd((unsigned long long*)(a.counter + 2) + k, v);
    }
}
#endif

// Refills the warp's empty slots from the lane counter once REFILL_AT of
// them are empty (one atomicAdd by the warp's leader); refilled lanes of a
// warp are consecutive samples of a pixel. `spent`: the counter has passed
// n_lanes (uniform over the warp).
__device__ __forceinline__ void refill(const VolArgs& a, Path& p,
                                       bool& spent PROF_PARAMS) {
    if (spent) return;
    const uint32_t n = (uint32_t)a.n_lanes;
    const int lane_w = threadIdx.x & 31;
    __syncwarp();
    const unsigned empty = __ballot_sync(FULL, p.lane < 0);
    if (__popc(empty) < REFILL_AT) return;
    const int leader = __ffs(empty) - 1;
    uint32_t base = 0;
    if (lane_w == leader) base = atomicAdd(a.counter, (uint32_t)__popc(empty));
    base = __shfl_sync(FULL, base, leader);
    spent = (uint64_t)base + __popc(empty) >= n;
    const uint32_t lane = base + __popc(empty & ((1u << lane_w) - 1u));
    if (p.lane < 0 && lane < n) {
        start_path(a, (int)lane, p);
        MARK(P_CAMERA);
    }
    MARK_ALL(p.lane >= 0 ? P_IDLE : P_EMPTY);
}

// One whole round of a path, its two walks nested (PR 4's round): the
// closest hit, the delta walk, the event, the NEE's ratio walk.
template <int FLAGS>
__device__ __forceinline__ void round(const VolArgs& a, const float4* s_woop,
                                      Path& p PROF_PARAMS) {
    round_start(a, s_woop, p);
    MARK(P_HIT);
    if (p.lane < 0) return;
    while (p.state == S_DELTA) walk_step(a, p);
    MARK(P_DELTA);
    if (p.state == S_STALLED) {
        stalled(a, p);
        MARK(P_CONT);
        return;
    }
    event<FLAGS>(a, s_woop, p PROF_ARGS);
    if (p.lane < 0) return;
    while (p.state == S_RATIO) walk_step(a, p);
    if (p.state == S_RATIO_END) ratio_end<(bool)(FLAGS & F_MIS)>(a, p);
    MARK(P_RATIO);
}

template <int FLAGS>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
    volpath_kernel(const VolArgs a) {
    extern __shared__ float4 s_woop[];      // 3 float4 per opaque face
    for (int i = threadIdx.x; i < 3 * a.n_faces; i += blockDim.x)
        s_woop[i] = a.woop[i];
    __syncthreads();
    Path p;
    p.lane = -1;
    p.state = S_ROUND;
    bool spent = false;
#if VK_PROFILE
    unsigned prof[N_PHASES] = {};
    long long t_last = clock64();
#endif
    for (;;) {
        refill(a, p, spent PROF_ARGS);
        if (!__any_sync(FULL, p.lane >= 0)) break;
        if (p.lane >= 0) round<FLAGS>(a, s_woop, p PROF_ARGS);
        MARK_ALL(p.lane >= 0 ? P_IDLE : P_EMPTY);
    }
#if VK_PROFILE
    add_profile(a, prof);
#endif
}

// Sets the instantiation's dynamic shared memory, fills info (LAUNCH_INFO
// ints: blocks resident an SM, SMs, dynamic shared bytes a block, grid)
// and launches it on `stream`: one persistent block per resident slot of
// the card. Returns a CUDA error code, or NO_BLOCK_FITS, or COUNTER_WRAPS.
template <int FLAGS>
int launch(const VolArgs& a, cudaStream_t stream, int* info) {
    const size_t smem = (size_t)a.n_faces * 3 * sizeof(float4);
    cudaError_t err = cudaFuncSetAttribute(
        volpath_kernel<FLAGS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, blocks = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess
        || (err = cudaDeviceGetAttribute(
                &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess
        || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, volpath_kernel<FLAGS>, BLOCK, smem))
            != cudaSuccess)
        return (int)err;
    const int grid = sms * blocks;
    info[0] = blocks;
    info[1] = sms;
    info[2] = (int)smem;
    info[3] = grid;
    if (grid < 1) return NO_BLOCK_FITS;
    // each slot's last fetch may pass n_lanes by at most a warp
    if ((uint64_t)a.n_lanes + (uint64_t)grid * BLOCK > 0xffffffffull)
        return COUNTER_WRAPS;
    volpath_kernel<FLAGS><<<grid, BLOCK, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// C entry point: launches the instantiation of args->flags on `stream`,
// fills `info` (see launch) and returns a CUDA error code (0 when the
// launch was accepted).
extern "C" int volpath_render(const VolArgs* args, void* stream, int* info) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (args->flags) {
        case 0: return launch<0>(*args, s, info);
        case 1: return launch<1>(*args, s, info);
        case 2: return launch<2>(*args, s, info);
        case 3: return launch<3>(*args, s, info);
        case 4: return launch<4>(*args, s, info);
        case 5: return launch<5>(*args, s, info);
        case 6: return launch<6>(*args, s, info);
        case 7: return launch<7>(*args, s, info);
        case 8: return launch<8>(*args, s, info);
        case 9: return launch<9>(*args, s, info);
        case 10: return launch<10>(*args, s, info);
        case 11: return launch<11>(*args, s, info);
        case 12: return launch<12>(*args, s, info);
        case 13: return launch<13>(*args, s, info);
        case 14: return launch<14>(*args, s, info);
        case 15: return launch<15>(*args, s, info);
        default: return (int)cudaErrorInvalidValue;
    }
}
