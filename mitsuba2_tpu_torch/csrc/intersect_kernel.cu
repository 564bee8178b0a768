// Scene ray queries (sm_90a): closest hit and any hit of a batch of rays
// against the scene's triangles.
//
// Replaces mitsuba2_tpu/ops/intersect_pallas.py::_isect_kernel
// (intersect_pallas.py:81, called at :164), the wavefront closest hit that
// sweeps every 128-face chunk against each 256-ray tile behind a chunk-box
// cull. Here one thread takes one ray and walks the scene's traversal tree
// (csrc/bvh.cuh) with _isect_kernel's face test (|DZ| > 1e-12,
// t = -Z * (1 / DZ), u >= 0, v >= 0, u + v <= 1, mint <= t <= maxt), the
// lowest t winning and ties going to the lowest face id. It reads the same
// device tables as the path kernel's BVH tier (ops/path_kernel.py
// PathTables: bvh_nodes, bvh_woop, bvh_prim). It computes exactly the plain
// version in ops/intersect.py (closest_hit_reference, any_hit_reference),
// a linear sweep over every face, bit for bit (the face test unfused).
//
// What bounds it on the H100: the walk's chain of dependent reads from L2
// (csrc/bvh.cuh: a node, then a leaf's face rows), not its operations; the
// bytes it must move are the rays in (32 B each) and 16 B (closest) or 1 B
// (any) out. The design: the 4-wide walk of csrc/bvh.cuh, which halves
// the chain of node reads against the binary tree and reads a face's rows
// at once; a thread a ray, a block per 128 rays. Persistent warps taking
// 32 rays at a time from a counter (Aila and Laine, "Understanding the
// efficiency of ray traversal on GPUs", HPG 2009) ran no faster on the
// card (slower on camera rays; PERF.md §6).
//
// The instance entries (isect_closest_inst, isect_any_inst) answer the
// same queries against shared-geometry instances: mitsuba2_tpu/render/
// scene.py:613-634 (_instance_closest_hit), which the TPU runs as one
// face sweep an instance, every instance in index order. What bounds
// them on the H100 is the same chain of dependent reads, now in two
// levels, and the moves into a group's frame (a row of 12 floats, 18
// products and 15 sums, three reciprocals and the group's root line
// before its walk can start), not operations. A loop over every
// instance row pays a move and a root read for each instance, even one
// the ray misses by metres, and in index order, not depth order, so a
// farther instance's walk runs to its hit before the nearer one cuts it
// short; its cost grows with the instance count. The design is a
// two-level walk:
// - a top tree over the instances' world boxes (ops/intersect_kernel.py
//   instance_boxes and top_tree: 4-wide nodes in csrc/bvh.cuh's 128-byte
//   format, one instance a leaf, a leaf's ref the instance's index),
//   walked in the world frame as csrc/bvh.cuh walks a group: the world
//   ray's reciprocals once, child boxes against [mint, best t] with
//   `<=`, hit children nearest first, the farther ones pushed with their
//   entry t onto a stack of its own (TOP_STACK entries, apart from the
//   group walk's; the any-hit walk pushes the node alone, since it reads
//   no t back) and a pop whose box begins beyond the best t dropped; so
//   a ray moves only into the instances whose box it enters before its
//   best hit, nearest first;
// - at an instance leaf, the move into the group frame (o A^T + b, d A^T:
//   t is kept, so hits compare across instances; unfused, in the plain
//   version's order, ops/intersect.py to_group) and the group's own
//   4-wide walk, its maxt the best t so far;
// - out of index order the plain version's tie rule (a later instance
//   replaces the best only at a strictly smaller t) becomes: replace at a
//   smaller t, or at an equal t from a lower instance index; the group
//   walk accepts a face at t == maxt, so an equal-t hit of a lower index
//   visited later is still found;
// - the any-hit entry walks the same tree against [mint, maxt] and stops
//   at the first instance that occludes, which does not depend on the
//   order; a masked ray (maxt < mint, or NaN) returns the miss before any
//   table read.
// A world box holds every hit the plain version can find in its instance
// (ops/intersect_kernel.py INST_PAD), so the entries are
// closest_hit_instanced_reference and any_hit_instanced_reference bit for
// bit. A group's tree is built once, however many instances place it. On
// a forest of instances a ray's cost follows the instances it crosses,
// not their count; where a few instances overlap and rays graze them, a
// launch's longest walks set its time and both designs run alike
// (PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bvh.cuh"

#define BLOCK 128

// Field for field ops/intersect_kernel.py::_IsectArgs.
struct IsectArgs {
    const float4* nodes;      // (P, 8) wide nodes
    const float4* woop;       // (F, 3) Woop rows in the tree's face order
    const int* prim;          // (F,) face id of each tree position
    const float* o;           // (n, 3)
    const float* d;           // (n, 3)
    const float* mint;        // (n,)
    const float* maxt;        // (n,)
    float* t;                 // (n,) closest: inf on a miss
    float* uv;                // (n, 2) closest: 0 on a miss
    int* prim_out;            // (n,) closest: -1 on a miss
    uint8_t* hit;             // (n,) any: 1 where occluded
    int n_rays;
};

// Field for field ops/intersect_kernel.py::_InstArgs: every group's tree
// (nodes, Woop rows and face ids, one group after another; a face id is
// the group's own), the instance rows and the top tree over the
// instances' world boxes.
struct InstArgs {
    const float4* nodes;      // (P, 8) the groups' wide nodes
    const float4* woop;       // (F, 3) the groups' Woop rows, tree order
    const int* prim;          // (F,) the group's face id of each position
    const int* group_node;    // (G,) each group's first node
    const int* group_face;    // (G,) each group's first tree position
    const float* rows;        // (I, 24) [A (9) | b (3) | B (9) | group | ..]
    const float4* top;        // (T, 8) wide nodes over the world boxes, a
                              // leaf's ref its instance
    int n_instances;
    int g_max;                // a prim id's stride: the largest group
};

// entries of the top walk's stack (ops/intersect_kernel.py
// TOP_STACK_DEPTH, the top tree's bound checked on the host)
constexpr int TOP_STACK = 28;

namespace {

// One ray's query.
template <bool ANY>
__device__ __forceinline__ void query(const IsectArgs& a,
                                      const bvh::Tree& tree, int i) {
    const bvh::Ray r = bvh::make_ray(a.o[3 * i], a.o[3 * i + 1],
                                     a.o[3 * i + 2], a.d[3 * i],
                                     a.d[3 * i + 1], a.d[3 * i + 2],
                                     a.mint[i]);
    if constexpr (ANY) {
        a.hit[i] = bvh::any_hit<true>(tree, r, a.maxt[i]) ? 1 : 0;
    } else {
        float t, u, v;
        const int f = bvh::closest_hit<true>(tree, r, a.maxt[i], t, u, v);
        a.t[i] = f >= 0 ? t : __int_as_float(0x7f800000);
        a.uv[2 * i] = f >= 0 ? u : 0.0f;
        a.uv[2 * i + 1] = f >= 0 ? v : 0.0f;
        a.prim_out[i] = f;
    }
}

template <bool ANY>
__global__ void __launch_bounds__(BLOCK) isect_kernel(const IsectArgs a) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < a.n_rays)
        query<ANY>(a, bvh::Tree{a.nodes, a.woop, a.prim}, i);
}

// A ray in the frame of the instance at `row`: o A^T + b and d A^T, each
// product and sum rounded on its own, left to right.
__device__ __forceinline__ bvh::Ray to_group(const float* row, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz,
                                             float mint) {
    float a[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) a[k] = __ldg(row + k);
    float o[3], d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        o[k] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(ox, a[3 * k]),
                                             __fmul_rn(oy, a[3 * k + 1])),
                                   __fmul_rn(oz, a[3 * k + 2])),
                         a[9 + k]);
        d[k] = __fadd_rn(__fadd_rn(__fmul_rn(dx, a[3 * k]),
                                   __fmul_rn(dy, a[3 * k + 1])),
                         __fmul_rn(dz, a[3 * k + 2]));
    }
    return bvh::make_ray(o[0], o[1], o[2], d[0], d[1], d[2], mint);
}

// One ray's query against the instances: the top tree's walk in the
// world frame, each instance leaf reached moving the ray into its group's
// frame for the group's walk.
template <bool ANY>
__device__ __forceinline__ void query_inst(const IsectArgs& a,
                                           const InstArgs& g, int i) {
    const float mint = a.mint[i], maxt = a.maxt[i];
    // the best t, within FLT_MAX so that a missed child's +inf is never
    // in range; its instance and prim id
    float tb = maxt > 3.4028235e38f ? 3.4028235e38f : maxt;
    float ub = 0.0f, vb = 0.0f;
    int best = -1, best_k = 0;
    // a masked ray misses every face, as in the plain version
    if (maxt >= mint && g.n_instances > 0) {
        const float ox = a.o[3 * i], oy = a.o[3 * i + 1],
                    oz = a.o[3 * i + 2];
        const float dx = a.d[3 * i], dy = a.d[3 * i + 1],
                    dz = a.d[3 * i + 2];
        const bvh::Ray w = bvh::make_ray(ox, oy, oz, dx, dy, dz, mint);
        const bvh::Planes planes = bvh::near_planes(w);
        // a pending node, with its entry t for closest hit
        std::conditional_t<ANY, int, int2> stack[TOP_STACK];
        int sp = 0, node = 0;
        for (;;) {
            bvh::Kids k = bvh::test_line(w, planes, g.top + 8 * node, tb);
            bvh::sort_kids(k);
            // the hit instances, nearest first
            unsigned leaves = 0;
#pragma unroll
            for (int c = 0; c < bvh::WIDTH; ++c)
                leaves |= (k.w[c] < 0 && k.t[c] <= tb ? 1u : 0u) << c;
            while (leaves) {
                const int c = __ffs(leaves) - 1;
                leaves &= leaves - 1;
                const float te = c == 0 ? k.t[0] : c == 1 ? k.t[1]
                    : c == 2 ? k.t[2] : k.t[3];
                const int wd = c == 0 ? k.w[0] : c == 1 ? k.w[1]
                    : c == 2 ? k.w[2] : k.w[3];
                if (!(te <= tb)) continue;
                const int inst = ~wd >> bvh::LEAF_BITS;
                const float* row = g.rows + 24 * inst;
                const int grp = (int)__ldg(row + 21);
                const int fo = __ldg(g.group_face + grp);
                const bvh::Tree tree{g.nodes + 8 * __ldg(g.group_node + grp),
                                     g.woop + 3 * fo, g.prim + fo};
                const bvh::Ray r = to_group(row, ox, oy, oz, dx, dy, dz,
                                            mint);
                if constexpr (ANY) {
                    if (bvh::any_hit<true>(tree, r, maxt)) {
                        a.hit[i] = 1;
                        return;
                    }
                } else {
                    float t, u, v;
                    const int f = bvh::closest_hit<true>(tree, r, tb, t, u,
                                                         v);
                    // t <= tb: an equal t replaces from a lower index
                    if (f >= 0 && (best < 0 || t < tb || inst < best_k)) {
                        tb = t;
                        ub = u;
                        vb = v;
                        best = inst * g.g_max + f;
                        best_k = inst;
                    }
                }
            }
            // the interior children in range, farthest pushed first; the
            // nearest is the next node
            int next = -1;
            float t_next = 0.0f;
#pragma unroll
            for (int c = bvh::WIDTH - 1; c >= 0; --c) {
                if (k.w[c] >= 0 && k.t[c] <= tb) {
                    if constexpr (ANY) {
                        if (next >= 0) stack[sp++] = next;
                    } else if (next >= 0) {
                        stack[sp++] = make_int2(next,
                                                __float_as_int(t_next));
                    }
                    next = k.w[c];
                    t_next = k.t[c];
                }
            }
            // else the nearest pending node whose box begins within the
            // best t
            while (next < 0 && sp > 0) {
                if constexpr (ANY) {
                    next = stack[--sp];
                } else {
                    const int2 e = stack[--sp];
                    if (__int_as_float(e.y) <= tb) next = e.x;
                }
            }
            if (next < 0) break;
            node = next;
        }
    }
    if constexpr (ANY) {
        a.hit[i] = 0;
    } else {
        a.t[i] = best >= 0 ? tb : __int_as_float(0x7f800000);
        a.uv[2 * i] = ub;
        a.uv[2 * i + 1] = vb;
        a.prim_out[i] = best;
    }
}

template <bool ANY>
__global__ void __launch_bounds__(BLOCK) isect_inst_kernel(
    const IsectArgs a, const InstArgs g) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < a.n_rays) query_inst<ANY>(a, g, i);
}

template <bool ANY>
int launch_inst(const IsectArgs& a, const InstArgs& g, cudaStream_t stream) {
    const int grid = (a.n_rays + BLOCK - 1) / BLOCK;
    isect_inst_kernel<ANY><<<grid, BLOCK, 0, stream>>>(a, g);
    return (int)cudaGetLastError();
}

// Launches the query on `stream`, a thread a ray -> a CUDA error code.
template <bool ANY>
int launch(const IsectArgs& a, cudaStream_t stream) {
    const int grid = (a.n_rays + BLOCK - 1) / BLOCK;
    isect_kernel<ANY><<<grid, BLOCK, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// C entry points on `stream`; each returns a CUDA error code (0 when the
// launch was accepted).
extern "C" int isect_closest(const IsectArgs* args, void* stream) {
    return launch<false>(*args, (cudaStream_t)stream);
}

extern "C" int isect_any(const IsectArgs* args, void* stream) {
    return launch<true>(*args, (cudaStream_t)stream);
}

// The instance entries: the rays and outputs in `args` (its tree fields
// unused), the groups and instances in `inst`.
extern "C" int isect_closest_inst(const IsectArgs* args,
                                  const InstArgs* inst, void* stream) {
    return launch_inst<false>(*args, *inst, (cudaStream_t)stream);
}

extern "C" int isect_any_inst(const IsectArgs* args, const InstArgs* inst,
                              void* stream) {
    return launch_inst<true>(*args, *inst, (cudaStream_t)stream);
}
