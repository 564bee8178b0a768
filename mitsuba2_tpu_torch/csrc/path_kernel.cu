// Path kernel for the Cornell-box slice (sm_90a).
//
// Replaces mitsuba2_tpu/ops/megakernel.py::_path_kernel in its K1a scope:
// triangle meshes of at most 1024 faces, constant-albedo diffuse BSDFs,
// constant area lights, rgb, box filter. It computes exactly the plain
// PyTorch version path_radiance_reference in ops/path_kernel.py: the same
// TEA keys and sampler dimensions, the same Woop test, the same NEE, MIS,
// roulette and spawn offsets, so the two agree lane by lane up to float
// rounding.
//
// What bounds it on the H100: not bytes. A lane reads 12 floats of tables
// per face it tests and writes 12 bytes at the end; the path state stays
// in registers. The time goes to the O(F) face loop that every ray and
// every shadow ray runs, and to divergence: lanes of one warp end their
// paths at different depths and take different branches.
//
// What the design does about that, in this first version:
// - One thread per lane and the whole path in one launch, the bounce loop
//   inside the thread. Nothing of the path goes through device memory
//   between bounces (the TPU kernel relaunched per bounce and carried
//   state in HBM), and a lane whose path ends simply leaves the loop.
// - The face tables are staged once per block into shared memory. All
//   threads of a warp read the same face at the same step of the loop, so
//   each read is a broadcast.
// - The closest-hit loop computes u and v only for a face whose t is in
//   range and closer than the best so far; the shadow loop stops at the
//   first occluder.
// Ray sorting, a BVH, occupancy tuning and warp-coherent scheduling are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rng.cuh"

#define BLOCK 128
#define BIG 3.0e38f
#define PI_F 3.14159265358979f

namespace {

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

__global__ void __launch_bounds__(BLOCK)
path_kernel(const float4* __restrict__ woop, const float4* __restrict__ fattr,
            const float* __restrict__ lights, const float* __restrict__ cam,
            float* __restrict__ out, int n_faces, int n_lights, uint32_t seed,
            uint32_t sample_base, int spp_pass, int width, int height,
            int max_depth, int rr_depth, int n_lanes) {
    extern __shared__ float4 smem[];
    float4* s_woop = smem;                 // 3 float4 per face
    float4* s_attr = smem + 3 * n_faces;   // [ng, lpdf_w] [albedo, 0] [Le, 0]
    for (int i = threadIdx.x; i < 3 * n_faces; i += blockDim.x) {
        s_woop[i] = woop[i];
        s_attr[i] = fattr[i];
    }
    __syncthreads();
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n_lanes) return;

    // ---- camera ray (megakernel.py:1315-1346) ----
    const int pixel = lane / spp_pass;
    uint32_t a = (uint32_t)pixel;
    uint32_t b = (uint32_t)(lane % spp_pass) + sample_base;
    tea(a, b, 4);
    uint32_t key = seed, unused = a;
    tea(key, unused, 4);
    float jx, jy;
    rng2(key, 0u, jx, jy);
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

    for (int depth = 0; depth < max_depth; ++depth) {
        const uint32_t dim0 = 2u + 8u * (uint32_t)depth;

        // ---- closest hit: lowest face id on ties ----
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
        if (face < 0) break;                 // escaped: no environment
        const float4 a0 = s_attr[3 * face];
        const float4 a1 = s_attr[3 * face + 1];
        const float4 a2 = s_attr[3 * face + 2];
        const float nx = a0.x, ny = a0.y, nz = a0.z;
        const float alb[3] = {a1.x, a1.y, a1.z};

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
        if (depth == max_depth - 1) break;   // last bounce: emission only

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
        if (depth + 1 > rr_depth) {
            float rr_u, rr_unused;
            rng2(key, dim0 + 0u, rr_u, rr_unused);
            const float q = fminf(fmaxf(fmaxf(thr[0], thr[1]), thr[2]), 0.95f);
            if (!(rr_u < q)) break;
            const float inv_q = 1.0f / fmaxf(q, 1e-8f);
            for (int c = 0; c < 3; ++c) thr_[c] = thr[c] * inv_q;
        }

        // ---- NEE: area-weighted light face, uniform point on it ----
        float u_sel, u_b1, u_b2, nee_unused;
        rng2(key, dim0 + 1u, u_sel, u_b1);
        rng2(key, dim0 + 2u, u_b2, nee_unused);
        int li = 0;
        for (int l = 0; l < n_lights; ++l) li += lights[24 * l + 12] <= u_sel;
        const float* LT = lights + 24 * min(li, n_lights - 1);
        const float s_t = sqrtf(fmaxf(1.0f - u_b1, 0.0f));
        const float bu = 1.0f - s_t;
        const float bv = u_b2 * s_t;
        float dlx = LT[0] + LT[3] * bu + LT[6] * bv - px;
        float dly = LT[1] + LT[4] * bu + LT[7] * bv - py;
        float dlz = LT[2] + LT[5] * bu + LT[8] * bv - pz;
        const float dist2 = dlx * dlx + dly * dly + dlz * dlz;
        const float dist = sqrtf(fmaxf(dist2, 1e-20f));
        const float inv_dist = 1.0f / dist;
        dlx *= inv_dist;
        dly *= inv_dist;
        dlz *= inv_dist;
        const float cos_l = -(dlx * LT[9] + dly * LT[10] + dlz * LT[11]);
        const float pdf_l = cos_l > 1e-6f
            ? dist2 * LT[13] / fmaxf(cos_l, 1e-6f) : 0.0f;
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
            if (!occluded) {
                const float pdf_bsdf = fmaxf(cos_s, 0.0f) / PI_F;
                const float fcos = cos_s / PI_F;
                const float base = mis(pdf_l, pdf_bsdf) / fmaxf(pdf_l, 1e-20f);
                for (int c = 0; c < 3; ++c)
                    res[c] += thr_[c] * base * (alb[c] * fcos) * LT[14 + c];
            }
        }

        // ---- cosine-weighted diffuse sample ----
        float u_c1, u_c2, cx, cy;
        rng2(key, dim0 + 4u, u_c1, u_c2);
        concentric(u_c1, u_c2, cx, cy);
        const float cz = sqrtf(fmaxf(1.0f - cx * cx - cy * cy, 0.0f));
        const float bsdf_pdf = cz / PI_F;
        for (int c = 0; c < 3; ++c) thr[c] = thr_[c] * alb[c];
        if (!(cz > 0.0f && bsdf_pdf > 0.0f && thr[0] + thr[1] + thr[2] > 0.0f))
            break;
        dx = cx * txx + cy * tyx + cz * nx;
        dy = cx * txy + cy * tyy + cz * ny;
        dz = cx * txz + cy * tyz + cz * nz;
        // cz >= 0: the new ray leaves on the normal's side
        ox = px + nx * eps;
        oy = py + ny * eps;
        oz = pz + nz * eps;
        prev_pdf = bsdf_pdf;
    }
    // 64-bit offsets: 2 * n_lanes overflows int from 2^30 lanes on
    out[lane] = res[0];
    out[(size_t)n_lanes + lane] = res[1];
    out[2 * (size_t)n_lanes + lane] = res[2];
}

}  // namespace

// C entry point: launches one thread per lane on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int path_render(const void* woop, const void* fattr,
                           const void* lights, const void* cam, void* out,
                           int n_faces, int n_lights, uint32_t seed,
                           uint32_t sample_base, int spp_pass, int width,
                           int height, int max_depth, int rr_depth,
                           int n_lanes, void* stream) {
    const size_t smem = (size_t)n_faces * 6 * sizeof(float4);
    cudaError_t err = cudaFuncSetAttribute(
        path_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = (n_lanes + BLOCK - 1) / BLOCK;
    path_kernel<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
        (const float4*)woop, (const float4*)fattr, (const float*)lights,
        (const float*)cam, (float*)out, n_faces, n_lights, seed, sample_base,
        spp_pass, width, height, max_depth, rr_depth, n_lanes);
    return (int)cudaGetLastError();
}
