// Path kernel (sm_90a).
//
// Replaces mitsuba2_tpu/ops/megakernel.py::_path_kernel (megakernel.py:365)
// in its whole scope: triangle meshes, constant area lights (K1a); its
// large-mesh tiers (K1f: the streamed sweep and the HBM BVH walk,
// megakernel.py:570-675, :676-1009, :1077-1197, :2085, here one per-ray
// walk, csrc/bvh.cuh, for more than 1024 faces); analytic spheres, disks
// and cylinders (K1b: :909-1058, :1194); one lat-long envmap with
// CDF-inverted NEE and escape MIS (K1c); the BSDFs of K1d: diffuse with
// constant, checkerboard (:1417-1427) or bitmap albedo (:1428-1470),
// isotropic GGX rough conductors with visible-normal sampling, smooth
// dielectrics (two-sided, :1588-1612, :1871-1894), smooth and rough
// plastics (:1773-1793, :1895-1952) and the eta-aware roulette (:1648,
// :1960); and its color modes (K1e): rgb, spectral hero-wavelength
// transport (megakernel.py:287-324 hero wavelengths and sigmoid
// reflectances, :436-463 D65 and CMF lookups, :1480-1503, :1553-1558,
// :1687-1690, :1713-1714 spectral emission, env and albedo, :1567-1587
// conductor IOR quadratics, :1378-1393 and :1979-1986 the CIE develop) and
// mono luminance. It computes exactly the plain PyTorch version
// path_radiance_reference in ops/path_kernel.py: the same TEA keys and
// sampler dimensions, the same Woop, sphere and quad tests, the same NEE
// arms, MIS, lobe choices, roulette and spawn offsets, so the two agree
// lane by lane up to float rounding.
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
// What the design does about that:
// - The whole path in one launch, the bounce loop inside the thread.
//   Nothing of the path goes through device memory between bounces (the
//   TPU kernel relaunched per bounce and carried state in HBM).
// - Persistent blocks that refill finished paths: the grid is the card's
//   SMs times the blocks of the instantiation resident on each, and each
//   thread holds one path slot. A slot whose path has ended (escape, back
//   face, last bounce, roulette, dead lobe) writes its lane's output and
//   takes the next lane index from a 32-bit counter in device memory: in
//   the warp (a ballot of the empty slots, one atomicAdd by the leader,
//   ranks by the popcount of the lower lanes, so a warp's refilled slots
//   take consecutive lanes, samples of one pixel, whose camera rays stay
//   coherent). With one thread a lane, a warp ran until its longest path
//   ended, its finished lanes idle (a third of the lane slots of Cornell's
//   bounce loop; PERF.md §5).
//   The registers of each family are capped and the warp's refill
//   batched, as measured (min_blocks, refill_at below).
// - In the lobes instantiations the loop is block-synchronous and
//   regroups live paths by the hit's kind between the closest hit and the
//   shading: a block refills its empty slots with one atomicAdd, traces,
//   counting-sorts its slots by (kind, escaped, empty) through a shared
//   histogram and one warp's scan, and moves each path's state and hit
//   record into the shared slot of its rank (one row a field, one bank a
//   thread), so that warps shade one BSDF kind each but at the seams:
//   SIMT otherwise runs each kind's arm in turn (Hopper has no hardware
//   reordering of threads). There the spectral mode's per-path
//   wavelengths and D65 values stay in the slot arrays, read where used,
//   out of the registers of the widest instantiations.
// - A lane's result depends on its key alone, so the order in which
//   lanes reach threads changes no output bit.
// - The scene content picks the instantiation (template FLAGS, the TPU
//   kernel's static has_spheres / has_env / has_ggx / has_checker gates,
//   the BVH tier, and one flag, "lobes", for the dielectric, plastic,
//   roughplastic and bitmap lobes, told apart by kind at run time, and for
//   disks and cylinders, looped over by their run-time count beside the
//   spheres), so a scene pays only for the features it has, and the code
//   of the lobes flag is in no instantiation without it. With no flag set
//   (the Cornell box) the kernel is the K1a kernel: Woop rows and the first
//   three attribute float4s of every face (four in spectral mode, for the
//   emitter's D65 scale) staged in shared memory.
// - The color mode is the template parameter NC (3 rgb, 4 hero wavelengths,
//   1 luminance); two libraries are built per mode (-DPK_NC, and -DPK_LOBES
//   for the lobes flag), each with its 32 instantiations of the other flags.
//   Throughput and radiance are NC floats in registers. The hero
//   wavelengths, their D65 values and normalized positions are computed
//   once per path (the TPU kernel re-derived them from the key on every
//   bounce), and each table value is a direct two-tap lerp of the 96-row
//   D65 / CMF table, which sits in shared memory (the lanes of a warp read
//   different rows; constant memory would serialize them). The CIE develop
//   to linear sRGB is the path's epilogue, run by every lane, so the output
//   is 3 floats per lane in every mode.
// - With any flag set, only what every ray loops over is staged in shared
//   memory: the Woop rows, the sphere rows and the disk and cylinder rows
//   (four float4 each). All threads of a warp read the same row at the same
//   step of a loop, so each read is a broadcast. The attribute row of the
//   hit face, sphere or quad (twelve float4) is read once per bounce from
//   global memory through the read-only path, a float4 where a branch needs
//   it. The disk and cylinder solve is not contracted into fused
//   multiply-adds, so that its hit points near a silhouette, where the
//   quadratic is ill-conditioned, are the plain version's.
// - Above 1024 faces (F_BVH) the Woop rows stay in global memory and every
//   ray and shadow ray walks the scene's traversal tree instead of the
//   loop (csrc/bvh.cuh: 4-wide nodes of one 128-byte line, children
//   nearest first, a stack per thread, ties to the lowest face id, the
//   shadow walk ending at the first occluder). The
//   walk's barycentrics feed the checker and bitmap lookups. The sphere and
//   quad loops stay.
// - The env radiance is one float4 texel per 16 bytes (a bilinear fetch is
//   four loads); env sampling is two binary searches (marginal cdf, then
//   the row's conditional cdf), giving exactly the reference's
//   count(cdf <= u) index; the env pdf is a direct pmf load. A bitmap is a
//   run of float4 texels in one flat buffer, fetched bilinearly with four
//   loads at the texture's offset (the TPU kernel's atlas and its matmul
//   gather have no counterpart).
// - The closest-hit loop computes u and v only for a face whose t is in
//   range and closer than the best so far; the shadow loops stop at the
//   first occluder.
// - In the shared-memory families without the lobes flag (the Cornell
//   box, matpreview) and in the mono ones with it (the materials box
//   under scalar_mono; fused() below) a bounce's shadow ray leaves from
//   the next ray's origin, and the next direction does not depend on
//   whether it is blocked. So the bounce queues it (direction, maxt and
//   the radiance the path has if it is unoccluded) and the next iteration
//   traces both rays in one sweep (trace()): each face's Woop rows are
//   read from shared memory once, [o, 1] . w is computed once for both,
//   and the shadow sweep leaves the shading, where it ran under the
//   shading's divergence and at its register peak (and, in the lobes
//   loop, stopped at a lane's first occluder, so that warps reached the
//   block's next barrier at different times). A path that ends with a
//   shadow ray queued keeps its slot for one more sweep. The queued
//   radiance is the sum the bounce would have made, in its operations
//   and order, so the outputs are those of a shadow test in the bounce,
//   bit for bit. Each ray still pays a correctly rounded division a
//   face: a test that skips it where a lane's face cannot win ran slower
//   (PERF.md §6), since a warp divides whenever one of its lanes keeps
//   the face.
// Math is exact (atan2f, acosf, sinf, cosf, logf, expf; no fast-math).

#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <type_traits>
#include <utility>

#include "bvh.cuh"
#include "rng.cuh"
#include "shading.cuh"

// color channels of this library's instantiations: 3 rgb, 4 spectral
// (hero wavelengths), 1 mono; and whether they carry the lobes flag
// (ops/path_kernel.py library_defines)
#if !defined(PK_NC) || !defined(PK_LOBES)
#error "build with -DPK_NC=3, 4 or 1 and -DPK_LOBES=0 or 1"
#endif

#define BLOCK 128
#define BIG 3.0e38f
// PK_PROFILE=1 (tools/loop_profile.py) sums each warp's clock cycles by
// phase of the loop into counter[2..13] (refill, closest hit, regroup,
// shade, the shadow sweep inside the shading, iterations); without it
// nothing is counted.
#ifndef PK_PROFILE
#define PK_PROFILE 0
#endif
// path_render's own error codes (ops/path_kernel.py LAUNCH_ERRORS): no
// block of the instantiation fits on an SM; the lane counter could wrap
#define NO_BLOCK_FITS -1
#define COUNTER_WRAPS -2

// Field for field ops/path_kernel.py::_PathArgs.
struct PathArgs {
    const float4* woop;       // (F, 3) float4: [Wu | Wv | Wz]
    const float4* fattr;      // (F, 12) float4: attribute columns
    const float* lights;      // (L, 24)
    const float4* sph;        // (S,) [center, radius]
    const float4* sattr;      // (S, 12) float4
    const float4* env;        // (H, W) [r, g, b, 0]
    const float* env_marg;    // (Hs,)
    const float* env_cond;    // (Hs, Ws)
    const float* env_pmf;     // (Hs, Ws)
    const float* env_rot;     // (18,) to_world 3x3, then its transpose
    const float4* spd;        // (96,) [D65, CMF x, y, z] (spectral)
    const float4* bvh_nodes;  // (P, 8) traversal wide nodes (csrc/bvh.cuh)
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
    // the lobes flag's tables, last so that the fields above keep their
    // offsets in the kernel parameters (and the earlier instantiations
    // their registers)
    const float4* qd;         // (Q, 4) float4: disk / cylinder rows
    const float4* qattr;      // (Q, 12) float4
    const float4* tex;        // (T,) bitmap texels [payload, 0]
    int n_quads;
    // the next lane to start: zeroed by the caller before each launch
    uint32_t* counter;
    // the global id of the pass's first pixel: a band of rows starting at
    // row r passes r * width (ops/path_kernel.py path_radiance); appended
    // last so that every field above keeps its offset
    uint32_t pixel_base;
};

namespace {

// instantiation flags (ops/path_kernel.py HAS_*)
constexpr int F_SPHERES = 1, F_ENV = 2, F_GGX = 4, F_CHECKER = 8;
constexpr int F_BVH = 16, F_LOBES = 32;

// The fused families: shared-memory faces, and no lobes flag (flags
// within spheres, env, ggx and checker: the Cornell box, matpreview) or
// the lobes flag in mono mode (the materials box under scalar_mono). There
// a bounce's shadow ray and its next ray leave the same point (every lobe
// that takes NEE sends its next ray to the normal's side), so the bounce
// queues the shadow ray and the next iteration traces both in one sweep
// (trace below). The rgb and spectral lobes families keep the shadow test
// in the bounce.
template <int FLAGS, int NC>
__host__ __device__ constexpr bool fused() {
    return !(FLAGS & F_BVH) && (!(FLAGS & F_LOBES) || NC == 1);
}

// attribute float4s per face / sphere / quad (ops/path_kernel.py FA / 4)
constexpr int FA4 = 12;
// float4s of a disk or cylinder row (ops/path_kernel.py QD / 4)
constexpr int QD4 = 4;
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

// The face test of the fused sweep with [o, 1] . wu and [o, 1] . wv given
// (shared by the sweep's two rays): inside() at parameter t, the same
// operations.
__device__ __forceinline__ bool inside_at(float4 wu, float4 wv, float ou,
                                          float ov, float t, float dx,
                                          float dy, float dz, float& u,
                                          float& v) {
    u = ou + t * dot_d(wu, dx, dy, dz);
    v = ov + t * dot_d(wv, dx, dy, dz);
    return u >= 0.0f && v >= 0.0f && 1.0f - u - v >= 0.0f;
}

// Products and sums rounded once each and never fused, in the plain
// version's order: the quadric solve is ill-conditioned near a silhouette,
// where a fused multiply-add moves the hit point visibly.
__device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
}
// (a0 x + a1 y) + a2 z
__device__ __forceinline__ float row3(float a0, float a1, float a2, float x,
                                      float y, float z) {
    return add(add(mul(a0, x), mul(a1, y)), mul(a2, z));
}

// A disk's or cylinder's rows: the to_object rows [A00 A01 A02 A10]
// [A11 A12 A20 A21] [A22 bx by bz] and [kind r length 0].
// The point v (w = 1) or direction (w = 0) in the object frame.
__device__ __forceinline__ void quad_frame(const float4* Q, float x, float y,
                                           float z, bool point,
                                           float out[3]) {
    const float4 q0 = Q[0], q1 = Q[1], q2 = Q[2];
    out[0] = row3(q0.x, q0.y, q0.z, x, y, z);
    out[1] = row3(q0.w, q1.x, q1.y, x, y, z);
    out[2] = row3(q1.z, q1.w, q2.x, x, y, z);
    if (point) {
        out[0] = add(out[0], q2.y);
        out[1] = add(out[1], q2.z);
        out[2] = add(out[2], q2.w);
    }
}

// Disk or cylinder hit parameter in (0, maxt), else -1, in the quad's
// canonical frame (megakernel.py:1010-1058): the unit disk at z = 0, or the
// cylinder of radius r around z in [0, length], its near root unless that
// leaves the span.
__device__ __forceinline__ float quad_t(const float4* Q, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz, float maxt) {
    float o[3], d[3];
    quad_frame(Q, ox, oy, oz, true, o);
    quad_frame(Q, dx, dy, dz, false, d);
    const float4 q3 = Q[3];
    float t;
    bool ok;
    if (q3.x < 1.5f) {                       // disk
        const bool dz_ok = fabsf(d[2]) > 1e-12f;
        t = __fdiv_rn(-o[2], dz_ok ? d[2] : 1.0f);
        const float hx = add(o[0], mul(t, d[0]));
        const float hy = add(o[1], mul(t, d[1]));
        ok = dz_ok && add(mul(hx, hx), mul(hy, hy)) <= 1.0f;
    } else {                                 // cylinder
        const float a2 = add(mul(d[0], d[0]), mul(d[1], d[1]));
        const float b2 = mul(2.0f, add(mul(d[0], o[0]), mul(d[1], o[1])));
        const float c2 = sub(add(mul(o[0], o[0]), mul(o[1], o[1])),
                             mul(q3.y, q3.y));
        const float disc = sub(mul(b2, b2), mul(mul(4.0f, a2), c2));
        const float sqd = __fsqrt_rn(fmaxf(disc, 0.0f));
        const bool a2ok = fabsf(a2) > 1e-20f;
        const float inv2a = __fdiv_rn(1.0f, a2ok ? mul(2.0f, a2) : 1.0f);
        const float t_n = mul(sub(-b2, sqd), inv2a);
        const float t_f = mul(add(-b2, sqd), inv2a);
        const float zn = add(o[2], mul(d[2], t_n));
        const float zf = add(o[2], mul(d[2], t_f));
        const bool n_ok = zn >= 0.0f && zn <= q3.z && t_n > 0.0f
            && t_n < maxt;
        const bool f_ok = zf >= 0.0f && zf <= q3.z && t_f > 0.0f
            && t_f < maxt;
        ok = a2ok && disc > 0.0f && (n_ok || f_ok);
        t = n_ok ? t_n : t_f;
    }
    return ok && t > 0.0f && t < maxt ? t : -1.0f;
}

// The hit point o + t d of a disk or cylinder, in its object frame.
__device__ __forceinline__ void quad_local(const float4* Q, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, float t,
                                          float ql[3]) {
    quad_frame(Q, add(ox, mul(t, dx)), add(oy, mul(t, dy)),
               add(oz, mul(t, dz)), true, ql);
}

// A cylinder's normal A^T (x, y, 0) / r at the local hit point, times flip
// (A is rigid).
__device__ __forceinline__ void quad_normal(const float4* Q,
                                           const float ql[3], float flip,
                                           float& nx, float& ny, float& nz) {
    const float4 q0 = Q[0], q1 = Q[1];
    const float inv_r = __fdiv_rn(1.0f, fmaxf(Q[3].y, 1e-20f));
    nx = mul(mul(add(mul(q0.x, ql[0]), mul(q0.w, ql[1])), inv_r), flip);
    ny = mul(mul(add(mul(q0.y, ql[0]), mul(q1.x, ql[1])), inv_r), flip);
    nz = mul(mul(add(mul(q0.z, ql[0]), mul(q1.y, ql[1])), inv_r), flip);
}

// The analytic uv of a disk hit (r, phi / 2 pi) or of a cylinder hit
// (phi / 2 pi, z / length) (megakernel.py:992-1007).
__device__ __forceinline__ void quad_uv(const float4* Q, float ox, float oy,
                                       float oz, float dx, float dy,
                                       float dz, float t, float& u,
                                       float& v) {
    float ql[3];
    quad_local(Q, ox, oy, oz, dx, dy, dz, t, ql);
    float phi = atan2f(ql[1], ql[0]) * INV_2PI;
    phi = phi < 0.0f ? phi + 1.0f : phi;
    if (Q[3].x > 1.5f) {
        u = phi;
        v = ql[2] * (1.0f / fmaxf(Q[3].z, 1e-20f));
    } else {
        u = sqrtf(fmaxf(ql[0] * ql[0] + ql[1] * ql[1], 0.0f));
        v = phi;
    }
}

__device__ __forceinline__ int imod(int a, int m) {
    const int r = a % m;
    return r < 0 ? r + m : r;
}

// Bilinear fetch, u and v wrapping, of the W x H texels at T:
// interpolated along v, then u (megakernel.py:1219, :1428-1470).
__device__ __forceinline__ float4 bilinear(const float4* T, int W, int H,
                                           float u, float v) {
    const float fu = u * (float)W - 0.5f;
    const float fv = v * (float)H - 0.5f;
    const float u0 = floorf(fu), v0 = floorf(fv);
    const float wu = fu - u0, wv = fv - v0;
    const int iu0 = imod((int)u0, W), iv0 = imod((int)v0, H);
    const int iu1 = iu0 + 1 == W ? 0 : iu0 + 1;
    const int iv1 = iv0 + 1 == H ? 0 : iv0 + 1;
    const float4 t00 = __ldg(T + iv0 * W + iu0);
    const float4 t10 = __ldg(T + iv1 * W + iu0);
    const float4 t01 = __ldg(T + iv0 * W + iu1);
    const float4 t11 = __ldg(T + iv1 * W + iu1);
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
    return bilinear(a.env, a.env_w, a.env_h, u, v);
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

// Isotropic GGX toward the local direction wo (wi's z clamped): the
// incident cosine to the half vector, f * cos without the Fresnel term,
// D G / (4 wi_z), and the visible-normal pdf G1(wi) D / (4 wi_z).
__device__ __forceinline__ void ggx_eval(float wix, float wiy, float wiz,
                                         float wox, float woy, float woz,
                                         float alpha, float& ci_h,
                                         float& spec, float& pdf) {
    float hx = wix + wox, hy = wiy + woy, hz = wiz + woz;
    const float hinv = rsqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-20f));
    hx *= hinv;
    hy *= hinv;
    hz *= hinv;
    ci_h = fmaxf(wix * hx + wiy * hy + wiz * hz, 0.0f);
    const float D = ggx_d(hz, alpha);
    const float g1i = ggx_g1(wiz, alpha);
    spec = D * (g1i * ggx_g1(fmaxf(woz, 1e-6f), alpha))
        / fmaxf(4.0f * wiz, 1e-20f);
    pdf = g1i * D / fmaxf(4.0f * wiz, 1e-20f);
}

// GGX visible-normal sample (Heitz 2018) of the local incident direction
// wi with clamped z: the reflected direction w, wi . m and m_z.
__device__ __forceinline__ void vndf_sample(float wix, float wiy, float wiz,
                                            float alpha, float u1, float u2,
                                            float& wx, float& wy, float& wz,
                                            float& wm, float& mhz_out) {
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
    const float rr = sqrtf(fmaxf(u1, 0.0f));
    const float phi = TWO_PI * u2;
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
    wm = wix * mhx + wiy * mhy + wiz * mhz;
    wx = 2.0f * wm * mhx - wix;
    wy = 2.0f * wm * mhy - wiy;
    wz = 2.0f * wm * mhz - wiz;
    mhz_out = mhz;
}

// ---------------------------------------------------------------------------
// the path kernel: one path per thread slot, refilled as paths end
// ---------------------------------------------------------------------------

// A path in flight: its lane (-1: the slot is empty), the bounce it is at,
// its TEA key, its ray, throughput, radiance, the pdf of the lobe that
// sampled the ray (0: camera ray or delta lobe, no MIS) and the relative
// IOR crossed so far (roulette weighs by its square). In the fused
// families (fused() below) also the shadow ray its last bounce queued
// from the ray's origin (lmaxt > 0; 0: none), with the radiance the path
// has if that ray is unoccluded, and whether the ray (o, d) is traced too
// (false once the path has ended with its shadow ray still queued).
template <int NC>
struct Path {
    int lane, depth;
    uint32_t key;
    float prev_pdf, eta_st;
    float ox, oy, oz, dx, dy, dz;
    float thr[NC], res[NC];
    float ldx, ldy, ldz, lmaxt, lres[NC];
    bool alive;
#if PK_PROFILE
    // this iteration's cycles in the shadow sweep of bounce()
    long long shadow_clk;
#endif
};

// The closest hit of a ray: t, the face, sphere or disk / cylinder hit
// (-1 where not), and the face hit's barycentrics.
struct Hit {
    float t;
    int face, sphere, quad;
    float hu, hv;
};

// What a block stages in shared memory, and the BVH tier's tables.
struct Staged {
    const float4* woop;     // 3 float4 per face (none in the BVH tier)
    const float4* more;     // Cornell: STAGE attribute float4 per face;
                            // else spheres, then QD4 float4 per quad
    const float4* spd;      // SPD_ROWS (spectral)
    bvh::Tree tree;
};

// Spectral mode: a path's hero wavelengths (nm), their normalized x and
// their D65 values, constant along the path (megakernel.py:306-324). In
// registers (RegWl), or in the block's slot arrays (SlotWl, the lobes
// instantiations: the kernel's widest, where 12 more live registers
// spill), read where they are used.
template <int NC>
struct RegWl {
    float wl_[NC], xw_[NC], d65_[NC];
    __device__ __forceinline__ void set(int c, float wl, float d65) {
        wl_[c] = wl;
        xw_[c] = (wl - WL_MIN) / WL_SPAN * 2.0f - 1.0f;
        d65_[c] = d65;
    }
    __device__ __forceinline__ float wl(int c) const { return wl_[c]; }
    __device__ __forceinline__ float xw(int c) const { return xw_[c]; }
    __device__ __forceinline__ float d65(int c) const { return d65_[c]; }
};

// `base` is the thread's column of the slot arrays' hero-wavelength rows:
// NC rows of wavelengths, then NC of D65 values, BLOCK floats apart.
// Volatile, so that each use loads it and nothing keeps it in a register.
template <int NC>
struct SlotWl {
    volatile float* base;
    __device__ __forceinline__ void set(int c, float wl, float d65) const {
        base[c * BLOCK] = wl;
        base[(NC + c) * BLOCK] = d65;
    }
    __device__ __forceinline__ float wl(int c) const {
        return base[c * BLOCK];
    }
    __device__ __forceinline__ float xw(int c) const {
        return (wl(c) - WL_MIN) / WL_SPAN * 2.0f - 1.0f;
    }
    __device__ __forceinline__ float d65(int c) const {
        return base[(NC + c) * BLOCK];
    }
};

// Starts the path of `lane` in slot p: its camera ray
// (megakernel.py:1315-1346) and, in spectral mode, its hero wavelengths.
template <int NC, class W>
__device__ __forceinline__ void start_path(const PathArgs& a,
                                           const float4* s_spd, int lane,
                                           Path<NC>& p, W& w) {
    const int width = a.width, height = a.height;
    // the film's pixel: a band's lanes count from its first row
    const int pixel = lane / a.spp_pass + (int)a.pixel_base;
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
    p.lane = lane;
    p.depth = 0;
    p.key = key;
    p.prev_pdf = 0.0f;
    p.eta_st = 1.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        p.thr[c] = 1.0f;
        p.res[c] = 0.0f;
    }
    if constexpr (NC == 4) {
        float u, u_unused;
        rng2(key, 1u, u, u_unused);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            float uc = u + (float)c * (1.0f / NC);
            uc = uc - floorf(uc);
            const float arg = 0.8569106254698279f - 1.8275019724092267f * uc;
            const float ath =
                0.5f * logf((1.0f + arg) / fmaxf(1.0f - arg, 1e-12f));
            const float wl = 538.0f - ath * 138.88888888888889f;
            const float e = expf(0.0072f * (wl - 538.0f));
            const float ch = 0.5f * (e + 1.0f / e);
            p.thr[c] = 253.82f * ch * ch;     // sensor weight 1 / pdf
            w.set(c, wl, spd_lerp(s_spd, wl, 0));
        }
    }
}

// The closest hit of p's ray: lowest id on ties; faces, spheres, quads.
template <int FLAGS, int NC>
__device__ __forceinline__ Hit closest(const PathArgs& a, const Staged& st,
                                       const Path<NC>& p) {
    constexpr bool SPH = FLAGS & F_SPHERES;
    constexpr bool BVH = FLAGS & F_BVH;
    constexpr bool QUADS = SPH && (FLAGS & F_LOBES);
    const float ox = p.ox, oy = p.oy, oz = p.oz;
    const float dx = p.dx, dy = p.dy, dz = p.dz;
    const int n_faces = a.n_faces;
    const float4* s_woop = st.woop;
    const float4* s_more = st.more;
    const bvh::Tree& tree = st.tree;
    // ---- closest hit: lowest id on ties; faces, spheres, quads ----
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
    int quad = -1;
    if constexpr (QUADS) {
        float tq_best = BIG;
        for (int q = 0; q < a.n_quads; ++q) {
            const float tq = quad_t(s_more + a.n_spheres + QD4 * q, ox,
                                    oy, oz, dx, dy, dz, BIG);
            if (tq > 0.0f && tq < tq_best) {
                tq_best = tq;
                quad = q;
            }
        }
        if (tq_best < t) {
            t = tq_best;
            face = sphere = -1;
        } else {
            quad = -1;
        }
    }
    return Hit{t, face, sphere, quad, hu, hv};
}

// The fused families' sweep (fused()): p's ray (o, d), while the path is
// alive, for its closest hit as closest() finds it, and the shadow ray its
// last bounce queued from the same origin, (o, l) on [0, lmaxt], for any
// hit, in one pass over the staged faces, then the spheres, then (lobes)
// the disk and cylinder rows. A face's Woop rows are read once and
// [o, 1] . w serves both rays; the shadow ray's tests stop at its first
// occluder. Then the queued radiance replaces p.res if the shadow ray is
// unoccluded, as the bounce would have added it.
template <int FLAGS, int NC>
__device__ __forceinline__ Hit trace(const PathArgs& a, const Staged& st,
                                     Path<NC>& p) {
    constexpr bool SPH = FLAGS & F_SPHERES;
    constexpr bool QUADS = SPH && (FLAGS & F_LOBES);
    const float ox = p.ox, oy = p.oy, oz = p.oz;
    const float dx = p.dx, dy = p.dy, dz = p.dz;
    const float lx = p.ldx, ly = p.ldy, lz = p.ldz, maxt = p.lmaxt;
    const float4* s_woop = st.woop;
    const float4* s_more = st.more;
    // t = 0 takes no hit: the path has ended, its shadow ray is left
    float t = p.alive ? BIG : 0.0f;
    bool shadow = maxt > 0.0f, occluded = false;
    int face = -1;
    float hu = 0.0f, hv = 0.0f;
    for (int f = 0; f < a.n_faces; ++f) {
        const float4 wz = s_woop[3 * f + 2];
        const float z = -dot_o(wz, ox, oy, oz);
        const float dd = dot_d(wz, dx, dy, dz);
        const float tf = z / dd;
        // lanes without a shadow ray skip its division (a warp skips it
        // when none of its lanes has one)
        float ts = -1.0f;
        if (shadow) ts = z / dot_d(wz, lx, ly, lz);
        const bool near = tf >= 0.0f && tf <= BIG && tf < t;
        const bool block = ts >= 0.0f && ts <= maxt;
        if (near || block) {
            const float4 wu = s_woop[3 * f], wv = s_woop[3 * f + 1];
            const float ou = dot_o(wu, ox, oy, oz);
            const float ov = dot_o(wv, ox, oy, oz);
            float u, v;
            if (near && inside_at(wu, wv, ou, ov, tf, dx, dy, dz, u, v)) {
                t = tf;
                face = f;
                hu = u;
                hv = v;
            }
            if (block && inside_at(wu, wv, ou, ov, ts, lx, ly, lz, u, v))
                occluded = true, shadow = false;
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
            if (shadow) {
                const float tl = sphere_t(s_more[s], ox, oy, oz, lx, ly, lz);
                if (tl > 0.0f && tl < maxt) occluded = true, shadow = false;
            }
        }
        if (ts_best < t) {
            t = ts_best;
            face = -1;
        } else {
            sphere = -1;
        }
    }
    int quad = -1;
    if constexpr (QUADS) {
        float tq_best = BIG;
        for (int q = 0; q < a.n_quads; ++q) {
            const float4* Q = s_more + a.n_spheres + QD4 * q;
            const float tq = quad_t(Q, ox, oy, oz, dx, dy, dz, BIG);
            if (tq > 0.0f && tq < tq_best) {
                tq_best = tq;
                quad = q;
            }
            if (shadow && quad_t(Q, ox, oy, oz, lx, ly, lz, maxt) > 0.0f)
                occluded = true, shadow = false;
        }
        if (tq_best < t) {
            t = tq_best;
            face = sphere = -1;
        } else {
            quad = -1;
        }
    }
    if (maxt > 0.0f) {
        if (!occluded) {
#pragma unroll
            for (int c = 0; c < NC; ++c) p.res[c] = p.lres[c];
        }
        p.lmaxt = 0.0f;
    }
    return Hit{t, face, sphere, quad, hu, hv};
}

// One bounce of p from its hit h: escape, emission, NEE, the BSDF sample
// and roulette -> whether the path goes on (p then holds the next ray and
// bounce); a path that ends leaves its radiance in p.res.
template <int FLAGS, int NC, class W>
__device__ __forceinline__ bool bounce(const PathArgs& a, const Staged& st,
                                       Path<NC>& p, const Hit& h,
                                       const W& w) {
    constexpr bool SPH = FLAGS & F_SPHERES;
    constexpr bool ENV = FLAGS & F_ENV;
    constexpr bool GGX = FLAGS & F_GGX;
    constexpr bool CHK = FLAGS & F_CHECKER;
    constexpr bool SPEC = NC == 4;
    constexpr bool BVH = FLAGS & F_BVH;
    constexpr bool LOBES = FLAGS & F_LOBES;
    constexpr bool QUADS = SPH && LOBES;
    constexpr bool FUSED = fused<FLAGS, NC>();
    // attributes from global memory, spheres in shared memory
    constexpr bool WIDE = FLAGS != 0;
    constexpr int STAGE = SPEC ? 4 : 3;
    if (p.depth >= a.max_depth) return false;
    const int depth = p.depth;
    const uint32_t dim0 = 2u + 8u * (uint32_t)depth;
    const uint32_t key = p.key;
    const float t = h.t, hu = h.hu, hv = h.hv;
    const int face = h.face, sphere = h.sphere, quad = h.quad;
    float &ox = p.ox, &oy = p.oy, &oz = p.oz;
    float &dx = p.dx, &dy = p.dy, &dz = p.dz;
    float &prev_pdf = p.prev_pdf, &eta_st = p.eta_st;
    float (&thr)[NC] = p.thr;
    float (&res)[NC] = p.res;
    const float p_env = a.p_env;
    const int n_faces = a.n_faces;
    const float4* s_woop = st.woop;
    const float4* s_more = st.more;
    const bvh::Tree& tree = st.tree;

    if (face < 0 && sphere < 0 && quad < 0) {
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
                    ? sigmoid_poly(e.x, e.y, e.z, w.xw(c)) * e.w * w.d65(c)
                    : comp(e, c);
                res[c] += w_esc * thr[c] * L;
            }
        }
        return false;
    }
    const float4* A = sphere >= 0 ? a.sattr + FA4 * sphere
                    : quad >= 0 ? a.qattr + FA4 * quad
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
    if constexpr (QUADS) {
        // a cylinder's normal A^T (x, y, 0) / r at the local hit point,
        // times flip; a disk's is in its attribute row
        if (quad >= 0 && s_more[a.n_spheres + QD4 * quad + 3].x > 1.5f) {
            float ql[3];
            quad_local(s_more + a.n_spheres + QD4 * quad, ox, oy, oz, dx,
                       dy, dz, t, ql);
            quad_normal(s_more + a.n_spheres + QD4 * quad, ql,
                        __ldg(A + 7).z, nx, ny, nz);
        }
    }

    // ---- emission, MIS-weighted against NEE after the camera ----
    const float cos_hit = -(dx * nx + dy * ny + dz * nz);
    // dielectrics are two-sided; every other lobe FrontSide only
    const bool is_diel = LOBES && a1.w > 2.5f && a1.w < 3.5f;
    if (!(cos_hit > 0.0f) && !is_diel) return false;  // back face
    if (!LOBES || cos_hit > 0.0f) {
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
                    * (sigmoid_poly(a2.x, a2.y, a2.z, w.xw(c)) * w.d65(c)
                       * le_scale);
        }
    } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) res[c] += em_w * thr[c] * comp(a2, c);
    }
    }
    if (depth == a.max_depth - 1) return false; // last bounce: emission only

    // ---- albedo payload; checkerboard: parity of floor(u') + floor(v')
    float4 pay = a1;
    if constexpr (CHK) {
        if (a1.w > 1.5f && a1.w < 2.5f) {
            float bu, bv;
            if (sphere >= 0) {           // spherical uv
                bu = atan2f(ny, nx) * INV_2PI + 0.5f;
                bv = acosf(fminf(fmaxf(nz, -1.0f), 1.0f)) * INV_PI;
            } else if (quad >= 0) {      // polar or cylindrical uv
                quad_uv(s_more + a.n_spheres + QD4 * quad, ox, oy, oz,
                        dx, dy, dz, t, bu, bv);
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
    if constexpr (LOBES) {
        if (a1.w > 5.5f) {
            // bitmap: a bilinear fetch at the uv, repeat wrap
            float bu = hu, bv = hv;
            if (sphere >= 0) {
                bu = atan2f(ny, nx) * INV_2PI + 0.5f;
                bv = acosf(fminf(fmaxf(nz, -1.0f), 1.0f)) * INV_PI;
            } else if (quad >= 0) {
                quad_uv(s_more + a.n_spheres + QD4 * quad, ox, oy, oz,
                        dx, dy, dz, t, bu, bv);
            }
            const float4 a6 = __ldg(A + 6), a7 = __ldg(A + 7);
            const float uu = a6.x + bu * a6.z + bv * a7.x;
            const float vv = a6.y + bu * a6.w + bv * a7.y;
            // [nonlinear, first texel, width, height]
            const float4 r = __ldg(A + 11);
            pay = bilinear(a.tex + (int)r.y, (int)fmaxf(r.z, 1.0f),
                           (int)fmaxf(r.w, 1.0f), uu, vv);
        }
    }
    float alb[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c)
        alb[c] = SPEC ? sigmoid_poly(pay.x, pay.y, pay.z, w.xw(c))
                      : comp(pay, c);
    bool is_ggx = false;
    if constexpr (GGX) is_ggx = a1.w > 0.5f && a1.w < 1.5f;
    const bool is_plas = LOBES && a1.w > 3.5f && a1.w < 5.5f;
    const bool is_rplas = LOBES && a1.w > 4.5f && a1.w < 5.5f;

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
        const float q = fminf(LOBES ? mx * eta_st * eta_st : mx, 0.95f);
        if (!(rr_u < q)) return false;
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
                    const float xc = fminf(fmaxf(w.xw(c), x_lo), x_hi);
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
    // the dielectric's and the plastics' parameters, payload and the
    // coat's terms at wi (lobes)
    float wiz_r = 1.0f, eta_d = 1.0f, inv_eta2 = 0.0f, Fp_i = 0.0f;
    float prob_sp = 0.0f, c2[NC], den[NC];
    if constexpr (LOBES) {
        if (is_diel || is_plas) {
            wix = -dx * txx - dy * txy - dz * txz;
            wiy = -dx * tyx - dy * tyy - dz * tyz;
            wiz_r = -dx * nx - dy * ny - dz * nz;
            wiz = fmaxf(wiz_r, 1e-6f);
            alpha = fmaxf(a2.w, 1e-3f);
            const float4 a5 = __ldg(A + 5), a10 = __ldg(A + 10);
#pragma unroll
            for (int c = 0; c < NC; ++c)
                c2[c] = SPEC ? sigmoid_poly(a5.x, a5.y, a5.z, w.xw(c))
                             : comp(a5, c);
            eta_d = fmaxf(a10.x, 1e-3f);
            inv_eta2 = a10.w;
            if (is_plas) {
                // the coat's sampling probability and the base's
                // internal-scattering denominator (plastic.cpp)
                const float ssw = a10.y, fdr = a10.z;
                const bool nonlin = __ldg(A + 11).x > 0.5f;
                Fp_i = fresnel_diel(wiz, eta_d);
                prob_sp = Fp_i * ssw / fmaxf(
                    Fp_i * ssw + (1.0f - Fp_i) * (1.0f - ssw), 1e-8f);
#pragma unroll
                for (int c = 0; c < NC; ++c)
                    den[c] = 1.0f - (nonlin ? alb[c] * fdr : fdr);
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
                ? sigmoid_poly(e.x, e.y, e.z, w.xw(c)) * e.w * w.d65(c)
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
                ? sigmoid_poly(LT[14], LT[15], LT[16], w.xw(c)) * w.d65(c)
                    * LT[17]
                : LT[14 + c];
    }
    const float cos_s = dlx * nx + dly * ny + dlz * nz;
    // delta lobes take no NEE
    if (pdf_l > 0.0f && cos_s > 0.0f && !is_diel) {
        const float sox = px + nx * eps, soy = py + ny * eps,
                    soz = pz + nz * eps;
        const float maxt = dist * 0.999f;
        bool occluded = false;
        // the fused families trace the shadow ray in the next sweep
        if constexpr (!FUSED) {
#if PK_PROFILE
            const long long t_sh = clock64();
#endif
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
            if constexpr (QUADS) {
                for (int q = 0; q < a.n_quads && !occluded; ++q)
                    occluded = quad_t(s_more + a.n_spheres + QD4 * q, sox,
                                      soy, soz, dlx, dly, dlz, maxt) > 0.0f;
            }
#if PK_PROFILE
            p.shadow_clk += clock64() - t_sh;
#endif
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
                    float ci_h, spec, pdf_g;
                    ggx_eval(wix, wiy, wiz, dlx * txx + dly * txy
                             + dlz * txz, dlx * tyx + dly * tyy
                             + dlz * tyz, cos_s, alpha, ci_h, spec,
                             pdf_g);
                    pdf_bsdf = pdf_g;
#pragma unroll
                    for (int c = 0; c < NC; ++c)
                        fcos[c] = alb[c] * spec
                            * fresnel_cond(ci_h, eta[c], kap[c]);
                }
            }
            if constexpr (LOBES) {
                if (is_plas) {
                    // the diffuse base behind the coat, plus the rough
                    // one's GGX coat (plastic.cpp, roughplastic.cpp)
                    const float woz = fmaxf(cos_s, 0.0f);
                    const float dcom = INV_PI * inv_eta2 * woz
                        * (1.0f - Fp_i)
                        * (1.0f - fresnel_diel(woz, eta_d));
                    float sp = 0.0f;
                    pdf_bsdf = woz / PI_F * (1.0f - prob_sp);
                    if (is_rplas) {
                        float ci_h, spec, pdf_g;
                        ggx_eval(wix, wiy, wiz, dlx * txx + dly * txy
                                 + dlz * txz, dlx * tyx + dly * tyy
                                 + dlz * tyz, cos_s, alpha, ci_h, spec,
                                 pdf_g);
                        sp = spec * fresnel_diel(ci_h, eta_d);
                        pdf_bsdf += pdf_g * prob_sp;
                    }
#pragma unroll
                    for (int c = 0; c < NC; ++c) {
                        fcos[c] = alb[c] / fmaxf(den[c], 1e-8f) * dcom;
                        if (is_rplas) fcos[c] += c2[c] * sp;
                    }
                }
            }
            const float base = mis(pdf_l, pdf_bsdf) / fmaxf(pdf_l, 1e-20f);
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                // fused: the radiance if the queued shadow ray is clear
                if constexpr (FUSED)
                    p.lres[c] = res[c] + thr_[c] * base * fcos[c] * lrad[c];
                else
                    res[c] += thr_[c] * base * fcos[c] * lrad[c];
            }
            if constexpr (FUSED) {
                p.ldx = dlx;
                p.ldy = dly;
                p.ldz = dlz;
                p.lmaxt = maxt;
            }
        }
    }

    // ---- BSDF sample ----
    float u_c1, u_c2;
    rng2(key, dim0 + 4u, u_c1, u_c2);
    float wx, wy, wz, bsdf_pdf;
    bool ok_lobe;
    // the pdf an emission hit is weighed against (0 after a delta
    // lobe), and the relative IOR the ray crosses
    float mis_pdf = -1.0f, eta_mul = 1.0f;
    if (is_ggx) {
        // GGX visible normals (Heitz 2018); throughput albedo F G1(wo)
        float wm, mhz;
        vndf_sample(wix, wiy, wiz, alpha, u_c1, u_c2, wx, wy, wz, wm,
                    mhz);
        bsdf_pdf = ggx_g1(wiz, alpha) * ggx_d(mhz, alpha)
            / fmaxf(4.0f * wiz, 1e-20f);
        ok_lobe = wz > 1e-6f && wm > 0.0f;
        const float g1o = ggx_g1(fmaxf(wz, 1e-6f), alpha);
        const float cm = fmaxf(wm, 0.0f);
#pragma unroll
        for (int c = 0; c < NC; ++c)
            thr[c] = thr_[c]
                * (alb[c] * fresnel_cond(cm, eta[c], kap[c]) * g1o);
    } else if (LOBES && is_diel) {
        // reflect or refract by the Fresnel term, from either side;
        // transmission scales radiance by eta_ti^2 (dielectric.cpp)
        float u_lobe, u_unused;
        rng2(key, dim0 + 3u, u_lobe, u_unused);
        float cos_t, eta_it, eta_ti;
        const float F = fresnel_diel(wiz_r, eta_d, cos_t, eta_it, eta_ti);
        const bool refl = u_lobe <= F;
        wx = refl ? -wix : -eta_ti * wix;
        wy = refl ? -wiy : -eta_ti * wiy;
        wz = refl ? wiz_r : cos_t;
#pragma unroll
        for (int c = 0; c < NC; ++c)
            thr[c] = thr_[c] * (refl ? alb[c] : c2[c] * eta_ti * eta_ti);
        bsdf_pdf = refl ? F : 1.0f - F;
        mis_pdf = 0.0f;
        ok_lobe = true;
        eta_mul = refl ? 1.0f : eta_it;
    } else if (LOBES && is_plas) {
        // the coat with probability prob_sp (a mirror, or the rough
        // one's GGX sample), else the cosine-sampled base
        float u_lobe, u_unused;
        rng2(key, dim0 + 3u, u_lobe, u_unused);
        const bool sel_sp = u_lobe < prob_sp;
        concentric(u_c1, u_c2, wx, wy);
        wz = sqrtf(fmaxf(1.0f - wx * wx - wy * wy, 0.0f));
        if (sel_sp && is_rplas) {
            float wm, mhz;
            vndf_sample(wix, wiy, wiz, alpha, u_c1, u_c2, wx, wy, wz, wm,
                        mhz);
        } else if (sel_sp) {
            wx = -wix;
            wy = -wiy;
            wz = wiz;
        }
        const float ppz = fmaxf(wz, 0.0f);
        const float dcom = INV_PI * inv_eta2 * ppz * (1.0f - Fp_i)
            * (1.0f - fresnel_diel(ppz, eta_d));
        const float pdf_base = ppz / PI_F * (1.0f - prob_sp);
        if (is_rplas) {
            // eval(wo) / pdf(wo) over the mixture pdf
            const float h2x = wix + wx, h2y = wiy + wy, h2z = wiz + wz;
            const float h2inv = rsqrtf(
                fmaxf(h2x * h2x + h2y * h2y + h2z * h2z, 1e-20f));
            const float ci_h2 = fmaxf(
                (wix * h2x + wiy * h2y + wiz * h2z) * h2inv, 0.0f);
            const float D2 = ggx_d(h2z * h2inv, alpha);
            const float g1i = ggx_g1(wiz, alpha);
            const float spec2 = D2
                * (g1i * ggx_g1(fmaxf(wz, 1e-6f), alpha))
                * fresnel_diel(ci_h2, eta_d) / fmaxf(4.0f * wiz, 1e-20f);
            const float pdf_g2 = g1i * D2 / fmaxf(4.0f * wiz, 1e-20f);
            bsdf_pdf = pdf_g2 * prob_sp + pdf_base;
            const float inv_prp = 1.0f / fmaxf(bsdf_pdf, 1e-20f);
#pragma unroll
            for (int c = 0; c < NC; ++c)
                thr[c] = thr_[c]
                    * ((c2[c] * spec2
                        + alb[c] / fmaxf(den[c], 1e-8f) * dcom)
                       * inv_prp);
        } else {
            // the per-lobe weights in closed form
            const float inv_ps = 1.0f / fmaxf(prob_sp, 1e-8f);
            const float inv_pd = 1.0f / fmaxf(pdf_base, 1e-20f);
#pragma unroll
            for (int c = 0; c < NC; ++c)
                thr[c] = thr_[c]
                    * (sel_sp ? c2[c] * Fp_i * inv_ps
                              : alb[c] / fmaxf(den[c], 1e-8f) * dcom
                                  * inv_pd);
            bsdf_pdf = sel_sp ? prob_sp : pdf_base;
            mis_pdf = sel_sp ? 0.0f : pdf_base;
        }
        ok_lobe = wz > 1e-6f;
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
    if constexpr (FUSED) {
        p.alive = ok_lobe && bsdf_pdf > 0.0f && thr_sum > 0.0f;
        if (!p.alive) {
            // the path ends; a queued shadow ray is traced in one more
            // sweep, from the origin the next ray would have had
            if (!(p.lmaxt > 0.0f)) return false;
            ox = px + nx * eps;
            oy = py + ny * eps;
            oz = pz + nz * eps;
            return true;
        }
    } else if (!(ok_lobe && bsdf_pdf > 0.0f && thr_sum > 0.0f)) {
        return false;
    }
    dx = wx * txx + wy * tyx + wz * nx;
    dy = wx * txy + wy * tyy + wz * ny;
    dz = wx * txz + wy * tyz + wz * nz;
    if constexpr (LOBES) {
        eta_st *= eta_mul;
        // a refraction leaves on the far side
        const float off = wz >= 0.0f ? eps : -eps;
        ox = px + nx * off;
        oy = py + ny * off;
        oz = pz + nz * off;
        prev_pdf = mis_pdf < 0.0f ? bsdf_pdf : mis_pdf;
    } else {
        // wz > 0: the new ray leaves on the normal's side
        ox = px + nx * eps;
        oy = py + ny * eps;
        oz = pz + nz * eps;
        prev_pdf = bsdf_pdf;
    }
    ++p.depth;
    return true;
}

// The path's epilogue: linear sRGB, 3 floats, into out[lane].
template <int NC, class W>
__device__ __forceinline__ void finish(const PathArgs& a, const float4* s_spd,
                                       const Path<NC>& p, const W& w) {
    float out[3];
    if constexpr (NC == 4) {
        // CIE develop (megakernel.py:1378-1393): CMFs at the hero
        // wavelengths, averaged over the channels, then XYZ -> sRGB
        float xyz[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const float wl = w.wl(c);
            const float ok = wl >= WL_MIN && wl <= WL_MIN + WL_SPAN
                ? 1.0f : 0.0f;
#pragma unroll
            for (int k = 0; k < 3; ++k)
                xyz[k] += spd_lerp(s_spd, wl, 1 + k) * ok * p.res[c];
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
        for (int k = 0; k < 3; ++k) out[k] = p.res[NC == 1 ? 0 : k];
    }
    // 64-bit offsets: 2 * n_lanes overflows int from 2^30 lanes on
    const size_t n = (size_t)a.n_lanes;
    a.out[p.lane] = out[0];
    a.out[n + p.lane] = out[1];
    a.out[2 * n + p.lane] = out[2];
}

// Every family runs persistent blocks. The BVH tier without the env
// (biggeo) ran a thread a lane while its walk was the binary one (a
// refilled camera ray walked beside the warp's incoherent bounce rays and
// the walk's warp-max grew); with the 4-wide walk it runs faster
// persistent (PERF.md §6).
//
// Per family, from the card (PERF.md §6): the blocks of an instantiation
// that must fit on an SM, which caps its registers (ptxas spills past the
// cap: the loop is latency-bound, and 10 blocks at 48 registers with
// spills beat 5-7 without; 8 at 64 in spectral mode, faster than 6 at 80
// on both spectral paths, and for the BVH walk without the env, whose
// stack spills; with the 4-wide walk, 10 blocks for it and 8 for hero's
// family ran within the spread of these caps), and how many slots of a
// warp must be empty before the warp loop refills them (a refill runs the
// camera ray's set-up with the rest of the warp idle; with the env or the
// BVH tier it pays to batch 16).
template <int FLAGS, int NC>
__host__ __device__ constexpr int min_blocks() {
    return (FLAGS & F_LOBES) ? 5
        : NC == 4 || ((FLAGS & F_BVH) && !(FLAGS & F_ENV)) ? 8 : 10;
}

template <int FLAGS>
__host__ __device__ constexpr int refill_at() {
    return (FLAGS & (F_ENV | F_BVH)) ? 16 : 1;
}

// Regroup keys: the hit's kind (ops/path_kernel.py KIND_*: 0 diffuse,
// 1 GGX, 3 dielectric, 4 plastic, 5 rough plastic, 6 bitmap), the
// checkerboard's with the diffuse ones, 2 for an escaped ray, and the empty
// slot last.
constexpr int KIND_CHECKER = 2;
constexpr int KEY_ESCAPED = 2, KEY_EMPTY = 7, KEYS = 8;
constexpr int WARPS = BLOCK / 32;
static_assert(KEYS * WARPS == 32, "the regroup scans one warp of counts");
constexpr unsigned FULL = 0xffffffffu;

// The slot arrays of the lobes instantiations: one row of BLOCK words per
// field, a path's fields in its slot's column (one bank per thread).
template <int NC>
struct Slots {
    static constexpr int LANE = 0, DEPTH = 1, KEY = 2, PREV = 3, ETA = 4,
        O = 5, D = 8, T = 11, PRIM = 12, HU = 13, HV = 14, THR = 15,
        RES = THR + NC, WL = RES + NC;
    // the hero wavelengths and their D65 values (spectral mode)
    static constexpr int WORDS = WL + (NC == 4 ? 2 * NC : 0);
};

template <int FLAGS, int NC>
__global__ void __launch_bounds__(BLOCK, (min_blocks<FLAGS, NC>()))
    path_kernel(const PathArgs a) {
    constexpr bool SPH = FLAGS & F_SPHERES;
    constexpr bool SPEC = NC == 4;
    constexpr bool BVH = FLAGS & F_BVH;
    // the dielectric, plastic, roughplastic and bitmap lobes, and the disk
    // and cylinder rows (with the spheres' flag); everything they add
    // compiles only into these instantiations
    constexpr bool LOBES = FLAGS & F_LOBES;
    constexpr bool QUADS = SPH && LOBES;
    constexpr bool FUSED = fused<FLAGS, NC>();
    constexpr bool WIDE = FLAGS != 0;
    // attribute float4s staged per face when !WIDE: [ng, lpdf_w]
    // [albedo, kind] [Le, alpha], and [eta, le_scale] in spectral mode
    constexpr int STAGE = SPEC ? 4 : 3;
    const int n_faces = a.n_faces;
    extern __shared__ float4 smem[];
    float4* s_spd = smem;                            // SPD_ROWS (spectral)
    // 3 float4 per face; none in the BVH tier
    float4* s_woop = smem + (SPEC ? SPD_ROWS : 0);
    // Cornell: STAGE attribute float4 per face; otherwise the sphere rows,
    // then QD4 float4 per disk or cylinder (s_more + n_spheres)
    float4* s_more = s_woop + (BVH ? 0 : 3 * n_faces);
    if constexpr (!BVH) {
        for (int i = threadIdx.x; i < 3 * n_faces; i += blockDim.x)
            s_woop[i] = a.woop[i];
    }
    if constexpr (!WIDE) {
        for (int i = threadIdx.x; i < STAGE * n_faces; i += blockDim.x)
            s_more[i] = a.fattr[(i / STAGE) * FA4 + i % STAGE];
    }
    if constexpr (SPH) {
        for (int i = threadIdx.x; i < a.n_spheres; i += blockDim.x)
            s_more[i] = a.sph[i];
    }
    if constexpr (QUADS) {
        for (int i = threadIdx.x; i < QD4 * a.n_quads; i += blockDim.x)
            s_more[a.n_spheres + i] = a.qd[i];
    }
    if constexpr (SPEC) {
        for (int i = threadIdx.x; i < SPD_ROWS; i += blockDim.x)
            s_spd[i] = a.spd[i];
    }
    __syncthreads();
    const Staged st{s_woop, s_more, s_spd,
                    bvh::Tree{a.bvh_nodes, a.bvh_woop, a.bvh_prim}};
    const uint32_t n = (uint32_t)a.n_lanes;
    const int lane_w = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned lower = (1u << lane_w) - 1u;
    Path<NC> p;
    p.lane = -1;
#if PK_PROFILE
    p.shadow_clk = 0;
#endif
    // whether the lane counter has passed n_lanes (uniform over the warp;
    // in the lobes instantiations, thread 0's)
    bool spent = false;
#if PK_PROFILE
    long long prof[6] = {0, 0, 0, 0, 0, 0};
    long long t_last = clock64();
    // the shading's phase ends with the warp's longest shadow sweep moved
    // to its own phase
#define PROF(k) { __syncwarp(); const long long now = clock64(); \
    long long dt = now - t_last; t_last = now; \
    if (k == 3) { \
        const long long sh = (long long)__reduce_max_sync( \
            FULL, (unsigned)p.shadow_clk); \
        p.shadow_clk = 0; prof[4] += sh; dt -= sh; ++prof[5]; } \
    prof[k] += dt; }
#else
#define PROF(k)
#endif

    if constexpr (!LOBES) {
        // ---- warp-synchronous: an empty slot takes the next lane ----
        RegWl<NC> w;
        for (;;) {
            if (!spent) {
                __syncwarp();
                const unsigned empty = __ballot_sync(FULL, p.lane < 0);
                if (__popc(empty) >= refill_at<FLAGS>()) {
                    const int leader = __ffs(empty) - 1;
                    uint32_t base = 0;
                    if (lane_w == leader)
                        base = atomicAdd(a.counter, (uint32_t)__popc(empty));
                    base = __shfl_sync(FULL, base, leader);
                    spent = (uint64_t)base + __popc(empty) >= n;
                    const uint32_t lane = base + __popc(empty & lower);
                    if (p.lane < 0 && lane < n) {
                        start_path(a, s_spd, (int)lane, p, w);
                        if constexpr (FUSED) {
                            p.lmaxt = 0.0f;
                            p.alive = true;
                        }
                    }
                }
            }
            // refilled lanes of a warp are consecutive samples of a pixel
            if (!__any_sync(FULL, p.lane >= 0)) break;
            PROF(0);
            Hit h;
            if constexpr (FUSED) {
                if (p.lane >= 0) h = trace<FLAGS, NC>(a, st, p);
            } else {
                if (p.lane >= 0) h = closest<FLAGS, NC>(a, st, p);
            }
            PROF(1);
            if constexpr (FUSED) {
                // a path whose last bounce ended it with a shadow ray
                // queued ends once the sweep has traced that ray
                if (p.lane >= 0
                    && !(p.alive && bounce<FLAGS, NC>(a, st, p, h, w))) {
                    finish(a, s_spd, p, w);
                    p.lane = -1;
                }
            } else if (p.lane >= 0 && !bounce<FLAGS, NC>(a, st, p, h, w)) {
                finish(a, s_spd, p, w);
                p.lane = -1;
            }
            PROF(3);
        }
    } else {
        // ---- block-synchronous: refill the block, trace, regroup by
        // the hit's kind, shade ----
        using S = Slots<NC>;
        float* slots = (float*)(s_more + (SPH ? a.n_spheres : 0)
                                + (QUADS ? QD4 * a.n_quads : 0));
        float* mine = slots + threadIdx.x;
        __shared__ int s_count[KEYS * WARPS];
        // the block's refill: its first lane and the lanes it took
        __shared__ uint32_t s_base, s_fill;
        // the hero wavelengths live in the slot arrays (SlotWl)
        using W = std::conditional_t<SPEC, SlotWl<NC>, RegWl<NC>>;
        W w{};
        if constexpr (SPEC) w = SlotWl<NC>{mine + S::WL * BLOCK};
        // fused: no shadow ray queued in any thread after each sweep, so
        // a thread that picks up another's path at the regroup holds none
        if constexpr (FUSED) p.lmaxt = 0.0f;
        for (;;) {
            // ---- refill: one atomicAdd for the block's empty slots ----
            const unsigned empty = __ballot_sync(FULL, p.lane < 0);
            if (lane_w == 0) s_count[warp] = __popc(empty);
            __syncthreads();
            // read before the next barrier: a warp that runs ahead zeroes
            // the counts for the regroup once every thread has passed it
            uint32_t rank = __popc(empty & lower);
            for (int k = 0; k < warp; ++k) rank += s_count[k];
            if (threadIdx.x == 0) {
                uint32_t total = 0;
                for (int k = 0; k < WARPS; ++k) total += s_count[k];
                uint32_t base = 0, fill = 0;
                if (!spent && total) {
                    base = atomicAdd(a.counter, total);
                    fill = base < n ? min(total, n - base) : 0u;
                    // each block's last fetch passes n by < BLOCK
                    spent = (uint64_t)base + total >= n;
                }
                s_base = base;
                s_fill = fill;
            }
            __syncthreads();
            if (p.lane < 0 && rank < s_fill) {
                start_path(a, s_spd, (int)(s_base + rank), p, w);
                if constexpr (FUSED) {
                    p.lmaxt = 0.0f;
                    p.alive = true;
                }
            }
            PROF(0);

            // ---- closest hit (fused: and the queued shadow ray), then
            // the regroup key ----
            Hit h{BIG, -1, -1, -1, 0.0f, 0.0f};
            int rkey = KEY_EMPTY;
            if constexpr (FUSED) {
                // a path whose last bounce ended it with a shadow ray
                // queued ends once the sweep has traced that ray, and
                // enters the regroup as an empty slot: the queue never
                // outlives the sweep, so no slot row carries it
                if (p.lane >= 0) {
                    h = trace<FLAGS, NC>(a, st, p);
                    if (!p.alive) {
                        finish(a, s_spd, p, w);
                        p.lane = -1;
                    }
                }
            }
            if (p.lane >= 0) {
                if constexpr (!FUSED) h = closest<FLAGS, NC>(a, st, p);
                rkey = KEY_ESCAPED;
                if (h.face >= 0 || h.sphere >= 0 || h.quad >= 0) {
                    const float4* A = h.sphere >= 0
                        ? a.sattr + FA4 * h.sphere
                        : h.quad >= 0 ? a.qattr + FA4 * h.quad
                                      : a.fattr + FA4 * h.face;
                    const int kind =
                        min(max((int)(__ldg(A + 1).w + 0.5f), 0), 6);
                    rkey = kind == KIND_CHECKER ? 0 : kind;
                }
            }
            PROF(1);
            // spectral: the wavelengths leave this slot's column before
            // any thread writes its new one
            float wl[SPEC ? 2 * NC : 1];
            if constexpr (SPEC) {
#pragma unroll
                for (int c = 0; c < 2 * NC; ++c)
                    wl[c] = mine[(S::WL + c) * BLOCK];
            }

            // ---- counting sort of the block's slots by key: counts by
            // (key, warp), one warp's exclusive scan, rank in the warp ----
            const unsigned same = __match_any_sync(FULL, rkey);
            if (lane_w < KEYS) s_count[lane_w * WARPS + warp] = 0;
            __syncwarp();
            if (lane_w == __ffs(same) - 1)
                s_count[rkey * WARPS + warp] = __popc(same);
            __syncthreads();
            if (warp == 0) {
                const int c = s_count[lane_w];
                int incl = c;
#pragma unroll
                for (int o = 1; o < 32; o <<= 1) {
                    const int v = __shfl_up_sync(FULL, incl, o);
                    if (lane_w >= o) incl += v;
                }
                s_count[lane_w] = incl - c;
            }
            __syncthreads();
            // the slots before the first empty one hold the live paths;
            // none once the lanes are spent and every path has ended
            if (s_count[KEY_EMPTY * WARPS] == 0) break;
            float* dst = slots
                + (s_count[rkey * WARPS + warp] + __popc(same & lower));
            dst[S::LANE * BLOCK] = __int_as_float(p.lane);
            dst[S::DEPTH * BLOCK] = __int_as_float(p.depth);
            dst[S::KEY * BLOCK] = __uint_as_float(p.key);
            dst[S::PREV * BLOCK] = p.prev_pdf;
            dst[S::ETA * BLOCK] = p.eta_st;
            dst[(S::O + 0) * BLOCK] = p.ox;
            dst[(S::O + 1) * BLOCK] = p.oy;
            dst[(S::O + 2) * BLOCK] = p.oz;
            dst[(S::D + 0) * BLOCK] = p.dx;
            dst[(S::D + 1) * BLOCK] = p.dy;
            dst[(S::D + 2) * BLOCK] = p.dz;
            dst[S::T * BLOCK] = h.t;
            // the face, sphere or quad as one id: F + sphere, F + S + quad
            const int prim = h.sphere >= 0 ? n_faces + h.sphere
                : h.quad >= 0 ? n_faces + a.n_spheres + h.quad : h.face;
            dst[S::PRIM * BLOCK] = __int_as_float(prim);
            dst[S::HU * BLOCK] = h.hu;
            dst[S::HV * BLOCK] = h.hv;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                dst[(S::THR + c) * BLOCK] = p.thr[c];
                dst[(S::RES + c) * BLOCK] = p.res[c];
            }
            if constexpr (SPEC) {
#pragma unroll
                for (int c = 0; c < 2 * NC; ++c)
                    dst[(S::WL + c) * BLOCK] = wl[c];
            }
            __syncthreads();
            // ---- pick up the path now in this thread's slot ----
            p.lane = __float_as_int(mine[S::LANE * BLOCK]);
            p.depth = __float_as_int(mine[S::DEPTH * BLOCK]);
            p.key = __float_as_uint(mine[S::KEY * BLOCK]);
            p.prev_pdf = mine[S::PREV * BLOCK];
            p.eta_st = mine[S::ETA * BLOCK];
            p.ox = mine[(S::O + 0) * BLOCK];
            p.oy = mine[(S::O + 1) * BLOCK];
            p.oz = mine[(S::O + 2) * BLOCK];
            p.dx = mine[(S::D + 0) * BLOCK];
            p.dy = mine[(S::D + 1) * BLOCK];
            p.dz = mine[(S::D + 2) * BLOCK];
            const int pid = __float_as_int(mine[S::PRIM * BLOCK]);
            h.t = mine[S::T * BLOCK];
            h.face = pid < n_faces ? pid : -1;
            h.sphere = pid >= n_faces && pid < n_faces + a.n_spheres
                ? pid - n_faces : -1;
            h.quad = pid >= n_faces + a.n_spheres
                ? pid - n_faces - a.n_spheres : -1;
            h.hu = mine[S::HU * BLOCK];
            h.hv = mine[S::HV * BLOCK];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                p.thr[c] = mine[(S::THR + c) * BLOCK];
                p.res[c] = mine[(S::RES + c) * BLOCK];
            }
            // every path that entered the regroup goes on
            if constexpr (FUSED) p.alive = true;
            PROF(2);

            // ---- shade: warps now hold one kind each but at the seams ----
            if (p.lane >= 0 && !bounce<FLAGS, NC>(a, st, p, h, w)) {
                finish(a, s_spd, p, w);
                p.lane = -1;
            }
            PROF(3);
        }
    }
#if PK_PROFILE
    if (lane_w == 0)
        for (int k = 0; k < 6; ++k)
            atomicAdd((unsigned long long*)(a.counter + 2) + k,
                      (unsigned long long)prof[k]);
#endif
}

// Dynamic shared memory of one block of path_kernel<FLAGS, NC>: the SPD
// table first in spectral mode; Cornell: Woop rows and STAGE attribute
// float4s per face; otherwise Woop rows (none in the BVH tier), the sphere
// rows and (lobes) QD4 float4s per disk or cylinder; then (lobes) the slot
// arrays.
template <int FLAGS, int NC>
size_t smem_bytes(const PathArgs& a) {
    constexpr size_t stage = NC == 4 ? 4 : 3;
    constexpr bool LOBES = FLAGS & F_LOBES;
    const size_t woop = (FLAGS & F_BVH) ? 0 : (size_t)a.n_faces * 3;
    const size_t spheres = (FLAGS & F_SPHERES) ? (size_t)a.n_spheres : 0;
    const size_t quads = (FLAGS & F_SPHERES) && LOBES
        ? (size_t)QD4 * a.n_quads : 0;
    return ((NC == 4 ? (size_t)SPD_ROWS : 0)
        + (FLAGS == 0 ? (size_t)a.n_faces * (3 + stage)
                      : woop + spheres + quads))
        * sizeof(float4)
        + (LOBES ? (size_t)Slots<NC>::WORDS * BLOCK * sizeof(float) : 0);
}

// Sets the instantiation's dynamic shared memory, fills info (LAUNCH_INFO
// ints: blocks resident an SM, SMs, dynamic shared bytes a block, grid)
// and launches it on `stream`: one persistent block per resident slot of
// the card.
// Returns a CUDA error code, or NO_BLOCK_FITS, or COUNTER_WRAPS.
template <int FLAGS, int NC>
int run(const PathArgs& a, cudaStream_t stream, int* info) {
    const size_t smem = smem_bytes<FLAGS, NC>(a);
    cudaError_t err = cudaFuncSetAttribute(
        path_kernel<FLAGS, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, blocks = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess
        || (err = cudaDeviceGetAttribute(
                &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess
        || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, path_kernel<FLAGS, NC>, BLOCK, smem))
            != cudaSuccess)
        return (int)err;
    const int grid = sms * blocks;
    info[0] = blocks;
    info[1] = sms;
    info[2] = (int)smem;
    info[3] = grid;
    if (grid < 1) return NO_BLOCK_FITS;
    // each slot's last fetch may pass n_lanes by at most a block
    if ((uint64_t)a.n_lanes + (uint64_t)grid * BLOCK > 0xffffffffull)
        return COUNTER_WRAPS;
    path_kernel<FLAGS, NC><<<grid, BLOCK, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

// The 32 instantiations of this library: every combination of the five
// flags below the lobes flag, with the lobes flag as PK_LOBES says.
constexpr int LIB = PK_LOBES ? F_LOBES : 0;
using RunFn = int (*)(const PathArgs&, cudaStream_t, int*);

template <int... F>
constexpr std::array<RunFn, sizeof...(F)> run_table(
    std::integer_sequence<int, F...>) {
    return {&run<LIB | F, PK_NC>...};
}
constexpr auto RUN = run_table(std::make_integer_sequence<int, 32>{});

}  // namespace

// C entry point: launches the instantiation of args->flags in this
// library's color mode (args->nc must be PK_NC, and the lobes bit of
// args->flags PK_LOBES) on `stream`, fills `info` (see run) and returns a
// CUDA error code (0 when the launch was accepted).
extern "C" int path_render(const PathArgs* args, void* stream, int* info) {
    const int f = args->flags & ~F_LOBES;
    if (args->nc != PK_NC || (args->flags & F_LOBES) != LIB || f < 0
        || f >= (int)RUN.size())
        return (int)cudaErrorInvalidValue;
    return RUN[f](*args, (cudaStream_t)stream, info);
}
