"""The path kernel's persistent loop, run on the CPU: csrc/path_kernel.cu
compiled by the host C++ compiler against a small emulation of the CUDA
features the loop uses (``EMU_HEADER`` below: one std::thread per CUDA
thread, std::barrier for ``__syncthreads`` and for the warp collectives,
a block's ``__shared__`` variables in its own context; every block of the
grid runs at once, so blocks race for the lane counter as on the card),
loaded through ctypes and called through the wrapper's own argument
builder on CPU tensors. This holds what no other CPU test can see, the
loop's scheduling: the warp refill, the lobes instantiations' block
refill and regroup by kind, the lane counter running out mid-warp and
while other blocks still take lanes, and the BVH tier's 4-wide walk
(csrc/bvh.cuh) on meshes above 1024 faces. Each lane's output (prefilled
with NaN, so that a lost lane shows) must agree with the plain version,
and two runs must be bit-identical. The arithmetic is the host's (no
fused multiply-adds), so the bar is PERF.md's §2 one of kernel against
plain version. The fused families (the shared-memory loops without the
lobes flag, which trace each bounce's shadow ray in the next iteration's
sweep) run in every color mode, at a depth whose last iteration traces a
queued shadow ray, and with a black wall, on which paths end with their
shadow ray still queued; so does the mono lobes family, the one lobes
family that queues the shadow ray, whose sweep then also runs the disk and
cylinder rows and whose paths that end after queuing enter the regroup as
empty slots. The same emulation runs the scene's ray queries
(csrc/intersect_kernel.cu, K2) and the box-test ceiling
(csrc/sweep_kernel.cu), each held bit for bit against its plain
version."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import build
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.ops import bvh, intersect, intersect_kernel as ik
from mitsuba2_tpu_torch.python.test.scenes import (bumpy_sphere_dict,
                                                   clustered_mesh_dict,
                                                   cornell_box_dict,
                                                   cornell_materials_dict,
                                                   hero_serialized_dict,
                                                   log_uniform_points,
                                                   matpreview_dict)
from tests.test_torch_path_kernel import (PIX_RTOL, PIX_SHARE, box_develop,
                                          cpu_device_fixture, pixel_errors)

_on_cpu = cpu_device_fixture()

SEED, MAX_DEPTH, RR_DEPTH = 3, 5, 2
# the emulated card: SMs and resident blocks of every instantiation
SMS, BLOCKS_PER_SM = 3, 1

EMU_HEADER = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct float4 { float x, y, z, w; };
struct int2 { int x, y; };
inline float4 make_float4(float x, float y, float z, float w) {
    return float4{x, y, z, w}; }
inline int2 make_int2(int x, int y) { return int2{x, y}; }
struct uint3 { unsigned x, y, z; };
struct dim3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute,
                                                    int) { return 0; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* b, F, int, size_t) { *b = EMU_BLOCKS; return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
    *v = EMU_SMS; return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
template <class T> T __ldg(const T* p) { return *p; }
struct EmuBlock {
    int n;
    std::barrier<> block;
    std::vector<std::barrier<>*> warps;
    std::vector<uint64_t> xv;
    std::vector<char> dyn;
    // the kernel's __shared__ variables (emulated_source)
    int s_count[32];
    uint32_t s_base, s_fill;
    EmuBlock(int n_, size_t smem)
        : n(n_), block(n_), xv(n_), dyn(smem + 16) {
        for (int w = 0; w < n / 32; ++w)
            warps.push_back(new std::barrier<>(32));
    }
    ~EmuBlock() { for (auto* b : warps) delete b; }
};
inline thread_local EmuBlock* emu;
inline int emu_t() { return threadIdx.x; }
inline void __syncthreads() { emu->block.arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
    emu->warps[emu_t() / 32]->arrive_and_wait(); }
inline int __syncthreads_count(int p) {
    emu->xv[emu_t()] = p != 0; __syncthreads();
    int r = 0; for (int i = 0; i < emu->n; ++i) r += (int)emu->xv[i];
    __syncthreads(); return r; }
inline int __syncthreads_or(int p) { return __syncthreads_count(p) > 0; }
template <class T> uint64_t emu_bits(T v) {
    uint64_t b = 0; std::memcpy(&b, &v, sizeof(T)); return b; }
template <class T> T emu_from(uint64_t b) {
    T v; std::memcpy(&v, &b, sizeof(T)); return v; }
inline uint64_t* emu_wv() { return emu->xv.data() + emu_t() / 32 * 32; }
inline unsigned __ballot_sync(unsigned, int p) {
    emu_wv()[emu_t() % 32] = p != 0; __syncwarp();
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r |= (emu_wv()[i] ? 1u : 0u) << i;
    __syncwarp(); return r; }
inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
template <class T> T __shfl_sync(unsigned, T v, int src, int = 32) {
    emu_wv()[emu_t() % 32] = emu_bits(v); __syncwarp();
    T r = emu_from<T>(emu_wv()[src]); __syncwarp(); return r; }
template <class T> T __shfl_up_sync(unsigned, T v, unsigned d, int = 32) {
    const int l = emu_t() % 32;
    emu_wv()[l] = emu_bits(v); __syncwarp();
    T r = l >= (int)d ? emu_from<T>(emu_wv()[l - d]) : v;
    __syncwarp(); return r; }
inline unsigned __match_any_sync(unsigned, int v) {
    emu_wv()[emu_t() % 32] = (uint32_t)v; __syncwarp();
    unsigned r = 0;
    for (int i = 0; i < 32; ++i)
        r |= (emu_wv()[i] == (uint64_t)(uint32_t)v ? 1u : 0u) << i;
    __syncwarp(); return r; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
    return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
    return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline long long clock64() { return 0; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float rsqrtf(float a) { return 1.0f / std::sqrt(a); }
inline float __int_as_float(int v) { return emu_from<float>(emu_bits(v)); }
inline float __uint_as_float(unsigned v) {
    return emu_from<float>(emu_bits(v)); }
inline int __float_as_int(float v) { return emu_from<int>(emu_bits(v)); }
inline unsigned __float_as_uint(float v) {
    return emu_from<unsigned>(emu_bits(v)); }
using std::max;
using std::min;
template <class K, class... A>
void emu_launch(K kernel, int grid, int block, size_t smem, void*,
                const A&... a) {
    gridDim = dim3{(unsigned)grid, 1, 1};
    blockDim = dim3{(unsigned)block, 1, 1};
    std::vector<std::unique_ptr<EmuBlock>> ctx;
    for (int b = 0; b < grid; ++b)
        ctx.emplace_back(new EmuBlock(block, smem));
    std::vector<std::thread> ts;
    for (int b = 0; b < grid; ++b)
        for (int t = 0; t < block; ++t)
            ts.emplace_back([&, b, t] {
                emu = ctx[b].get();
                threadIdx = uint3{(unsigned)t, 0, 0};
                blockIdx = uint3{(unsigned)b, 0, 0};
                kernel(a...);
            });
    for (auto& t : ts) t.join();
}
"""


def emulated_source():
    """csrc/path_kernel.cu with its launch and its shared memory rewritten
    for the emulation: each ``__shared__`` variable in the block's context
    (an unknown one fails the build)."""
    src = (build.CSRC / "path_kernel.cu").read_text()
    counts = []
    for pattern, repl in (
            (r"(path_kernel<FLAGS, NC>)<<<([^>]*)>>>\((\w+)\)",
             r"emu_launch(\1, \2, \3)"),
            (r"extern __shared__ float4 smem\[\];",
             "float4* smem = (float4*)emu->dyn.data();"),
            (r"__shared__ int s_count\[KEYS \* WARPS\];",
             "int* s_count = emu->s_count;"),
            (r"__shared__ uint32_t s_base, s_fill;",
             "uint32_t &s_base = emu->s_base, &s_fill = emu->s_fill;")):
        src, n = re.subn(pattern, repl, src)
        counts.append(n)
    assert counts == [1, 1, 1, 1], counts
    return src


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """nc -> path_render of the emulated rgb or spectral library with
    the lobes flag and without, built on first use."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("the emulation needs g++ (the BVH builder's compiler)")
    d = tmp_path_factory.mktemp("emulated_path_kernel")
    (d / "cuda_runtime.h").write_text(EMU_HEADER)
    (d / "path_kernel.cpp").write_text(emulated_source())
    libs = {}

    def get(nc, lobes):
        key = (nc, lobes)
        if key not in libs:
            out = d / f"path_kernel_{nc}_{int(lobes)}.so"
            subprocess.run(
                [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                 "-shared", "-pthread", "-w", f"-I{d}", f"-I{build.CSRC}",
                 f"-DPK_NC={nc}", f"-DPK_LOBES={int(lobes)}",
                 f"-DEMU_SMS={SMS}", f"-DEMU_BLOCKS={BLOCKS_PER_SM}",
                 "-o", str(out), str(d / "path_kernel.cpp")],
                check=True, capture_output=True)
            fn = ctypes.CDLL(str(out)).path_render
            fn.argtypes = [ctypes.POINTER(pk._PathArgs), ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
            libs[key] = fn
        return libs[key]
    return get


def run_emulated(fn, tables, cam, width, height, spp, max_depth=MAX_DEPTH):
    n = width * height * spp
    out = torch.full((3, n), float("nan"))
    counter = torch.zeros(1, dtype=torch.int32)
    info = (ctypes.c_int * len(pk.LAUNCH_INFO))()
    err = fn(ctypes.byref(pk._path_args(
        tables, cam, SEED, 0, spp, width, height, max_depth, RR_DEPTH, out,
        counter)), None, info)
    assert err == 0
    info = dict(zip(pk.LAUNCH_INFO, info))
    assert info["grid"] == info["sms"] * info["blocks_per_sm"] \
        == SMS * BLOCKS_PER_SM
    # every slot's last fetch passes n by less than a block
    assert n <= int(counter[0]) < n + info["grid"] * pk.BLOCK
    return out


def cornell_depth_2(width, height, spp, max_depth):
    """The Cornell box at max_depth 2: the shadow ray of the first bounce
    is traced in the last iteration, whose bounce adds emission only."""
    return cornell_box_dict(width, height, spp, cornell_depth_2.max_depth)


cornell_depth_2.max_depth = 2


def cornell_black_wall(width, height, spp, max_depth):
    """The Cornell box with a black left wall: a path that reaches it
    queues its shadow ray and ends at the BSDF sample (throughput 0), so
    its slot traces the shadow ray alone before it refills."""
    d = cornell_box_dict(width, height, spp, max_depth)
    d["left"]["bsdf"]["reflectance"]["value"] = [0.0, 0.0, 0.0]
    return d


def materials_depth_2(width, height, spp, max_depth):
    """The materials box at max_depth 2: the first bounce's queued shadow
    ray (mono) is traced in the last iteration's sweep, before the
    regroup."""
    return cornell_materials_dict(width, height, spp,
                                  materials_depth_2.max_depth)


materials_depth_2.max_depth = 2


def materials_black_wall(width, height, spp, max_depth):
    """The materials box with a black left wall: a mono path that reaches
    it queues its shadow ray and ends at the BSDF sample, so its slot
    traces the shadow ray alone and enters the next regroup empty."""
    d = cornell_materials_dict(width, height, spp, max_depth)
    d["left"]["bsdf"]["reflectance"]["value"] = [0.0, 0.0, 0.0]
    return d


@pytest.mark.parametrize("variant, make_dict, width, spp, force", [
    ("scalar_rgb", cornell_box_dict, 8, 4, 0),           # warp refill
    ("scalar_rgb", cornell_box_dict, 5, 3, pk.HAS_LOBES),  # regroup, 75
    ("scalar_rgb", cornell_materials_dict, 12, 4, 0),    # regroup by kind
    ("scalar_spectral", cornell_materials_dict, 8, 4, 0),  # SlotWl
    ("scalar_rgb", matpreview_dict, 8, 4, 0),            # refill at 16
    ("scalar_rgb", cornell_box_dict, 9, 3, pk.HAS_BVH),  # BVH forced
    # 1,216 and 1,218 faces: the BVH tier of biggeo's family and of
    # hero's (with the env), on a real mesh
    ("scalar_rgb", lambda w, h, spp, depth: bumpy_sphere_dict(
        w, h, spp, depth, 32, 20), 6, 3, 0),
    ("scalar_rgb", lambda w, h, spp, depth: hero_serialized_dict(
        w, h, spp, depth, 32, 20), 6, 4, 0),
    # the fused families' loop with 4 and 1 channels
    ("scalar_spectral", cornell_box_dict, 8, 4, 0),
    ("scalar_mono", cornell_box_dict, 8, 4, 0),
    ("scalar_rgb", cornell_depth_2, 8, 4, 0),
    ("scalar_rgb", cornell_black_wall, 8, 4, 0),
    # the mono lobes family: the regroup with the queued shadow ray
    ("scalar_mono", cornell_materials_dict, 12, 4, 0),
    ("scalar_mono", materials_depth_2, 12, 4, 0),
    ("scalar_mono", materials_black_wall, 12, 4, 0),
])
def test_emulated_loop_matches_plain_version(emulated, variant, make_dict,
                                             width, spp, force):
    depth = getattr(make_dict, "max_depth", MAX_DEPTH)
    mt.set_variant(variant)
    try:
        scene = mt.load_dict(make_dict(width, width, spp, depth))
    finally:
        mt.set_variant("scalar_rgb")
    tables = (pk.with_bvh_tier(scene.tables) if force == pk.HAS_BVH
              else scene.tables._replace(flags=scene.tables.flags | force))
    if make_dict not in (cornell_box_dict, cornell_materials_dict,
                         matpreview_dict, cornell_depth_2,
                         cornell_black_wall, materials_depth_2,
                         materials_black_wall):
        assert tables.flags & pk.HAS_BVH and tables.n_faces > 1024
    cam = pk.camera_row(scene.sensors[0], scene.device)
    fn = emulated(tables.nc, bool(tables.flags & pk.HAS_LOBES))
    got = run_emulated(fn, tables, cam, width, width, spp, depth)
    assert not bool(torch.isnan(got).any()), "a lane was never written"
    assert torch.equal(got, run_emulated(fn, tables, cam, width, width,
                                         spp, depth))
    want = pk.path_radiance_reference(tables, cam, SEED, 0, spp, width,
                                      width, depth, RR_DEPTH)
    lane_rel = ((got - want).abs() / want.abs().clamp(min=1e-3)).amax(0)
    assert float((lane_rel > PIX_RTOL).float().mean()) <= 1 - PIX_SHARE
    err = pixel_errors(box_develop(got, width, width, spp).numpy(),
                       box_develop(want, width, width, spp).numpy())
    assert (err <= PIX_RTOL).mean() >= PIX_SHARE, np.quantile(err, 0.99)


@pytest.mark.parametrize("variant, make_dict", [
    ("scalar_rgb", cornell_box_dict), ("scalar_rgb", cornell_materials_dict),
    ("scalar_mono", cornell_materials_dict)])
def test_emulated_band_is_the_films_rows(emulated, variant, make_dict):
    """A band of film rows (``pixel_base``, parallel/mesh.py's pixel axis):
    its lanes are those rows of the whole film's launch, bit for bit, in
    the shared-memory and the lobes families (the mono one with its
    queued shadow ray)."""
    width, spp, row0, n_rows = 8, 3, 3, 4
    mt.set_variant(variant)
    try:
        scene = mt.load_dict(make_dict(width, width, spp, MAX_DEPTH))
    finally:
        mt.set_variant("scalar_rgb")
    tables = scene.tables
    cam = pk.camera_row(scene.sensors[0], scene.device)
    fn = emulated(tables.nc, bool(tables.flags & pk.HAS_LOBES))
    full = run_emulated(fn, tables, cam, width, width, spp)
    band = torch.full((3, width * n_rows * spp), float("nan"))
    counter = torch.zeros(1, dtype=torch.int32)
    info = (ctypes.c_int * len(pk.LAUNCH_INFO))()
    assert fn(ctypes.byref(pk._path_args(
        tables, cam, SEED, 0, spp, width, width, MAX_DEPTH, RR_DEPTH, band,
        counter, row0 * width)), None, info) == 0
    lanes = slice(row0 * width * spp, (row0 + n_rows) * width * spp)
    assert torch.equal(band, full[:, lanes])


def emulated_isect_source():
    """csrc/intersect_kernel.cu with its two launches (the scene's faces,
    the shared instances) rewritten for the emulation."""
    src = (build.CSRC / "intersect_kernel.cu").read_text()
    src, n = re.subn(r"(isect_(?:inst_)?kernel<ANY>)<<<([^>]*)>>>\(([^)]*)\)",
                     r"emu_launch(\1, \2, \3)", src)
    assert n == 2
    return src


@pytest.fixture(scope="module")
def emulated_isect(tmp_path_factory):
    """The emulated K2 library."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("the emulation needs g++ (the BVH builder's compiler)")
    d = tmp_path_factory.mktemp("emulated_isect_kernel")
    (d / "cuda_runtime.h").write_text(EMU_HEADER)
    (d / "intersect_kernel.cpp").write_text(emulated_isect_source())
    out = d / "isect.so"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", "-w", f"-I{d}", f"-I{build.CSRC}", f"-DEMU_SMS={SMS}",
         f"-DEMU_BLOCKS={BLOCKS_PER_SM}", "-o", str(out),
         str(d / "intersect_kernel.cpp")],
        check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for name in ("isect_closest", "isect_any", "isect_closest_inst",
                 "isect_any_inst"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ik._IsectArgs)] + (
            [ctypes.POINTER(ik._InstArgs)] if name.endswith("_inst")
            else []) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def clustered_rays(v0, e1, e2, n, seed):
    """Rays at a clustered mesh: half aimed at the centroids of faces drawn
    at random, from 0.5 to 50 away, half from those points in any
    direction -> (o, d) (n, 3) float32 tensors."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, len(v0), n)
    target = v0[k] + (e1[k] + e2[k]) / 3.0
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o = target + u * 10.0 ** rng.uniform(-0.3, 1.7, (n, 1))
    d = -u
    d[n // 2:] = rng.normal(size=(n - n // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32),
            torch.tensor(d, dtype=torch.float32))


@pytest.mark.parametrize("mesh,n_rays", [
    pytest.param("bumpy", 600, id="600"), pytest.param("bumpy", 257, id="257"),
    ("clustered", 300), ("clustered_capped", 300)])
def test_emulated_isect_kernel_matches_plain_version(emulated_isect, mesh,
                                                     n_rays):
    """K2 (csrc/intersect_kernel.cu) against its plain twin, the linear
    sweep, on a 1,216-face mesh and on 16,384-face clustered meshes (faces
    at log-uniform distances up to 1e4, and up to 1e6, whose SAH trees
    exceed the stack: the walk reads ops/bvh.py ``traversal_bvh``'s tree,
    the SAH tree collapsed level by level, and for the wider mesh SAH
    capped at a depth with object medians below): face ids, t and uv bit
    for bit and the same occluded rays, every block of the grid at once,
    the last one ragged. Outputs prefilled with NaN (and -2 and 2 for the
    integer ones), so that a lost ray shows; two runs bit-identical."""
    from tests.test_torch_bvh import _rays, bumpy_triangles
    if mesh == "bumpy":
        scene = mt.load_dict(bumpy_sphere_dict(4, 4, 1, 2, 32, 20))
        o, d = _rays(bumpy_triangles(), n_rays, 9)
    else:
        scale, seed = (1e4, 1) if mesh == "clustered" else (1e6, 0)
        scene = mt.load_dict(clustered_mesh_dict(4, 4, 1, 2, n=16384,
                                                 scale=scale, seed=seed))
        sah = bvh.build_bvh(scene.v0, scene.e1, scene.e2,
                            bvh.TRAVERSAL_LEAF)
        assert scene.traversal.by_level
        assert (bvh._interior_depth(scene.traversal)
                < bvh._interior_depth(sah)) == (mesh == "clustered_capped")
        o, d = clustered_rays(scene.v0, scene.e1, scene.e2, n_rays, 9)
    tables = scene.tables
    assert tables.n_faces > 1024 and tables.bvh_depth <= bvh.STACK_DEPTH
    n = o.shape[0]
    mint = torch.full((n,), 1e-4)
    maxt = torch.full((n,), float("inf"))
    maxt[::4] = 2.5
    t = torch.full((n,), float("nan"))
    uv = torch.full((n, 2), float("nan"))
    prim = torch.full((n,), -2, dtype=torch.int32)
    hit = torch.full((n,), 2, dtype=torch.uint8)
    runs = []
    for _ in range(2):
        for entry, outs in (("isect_closest", dict(t=t, uv=uv, prim=prim)),
                            ("isect_any", dict(hit=hit))):
            args = ik._IsectArgs(*(0 if x is None else x.data_ptr() for x in (
                tables.bvh_nodes, tables.bvh_woop, tables.bvh_prim, o, d,
                mint, maxt, outs.get("t"), outs.get("uv"), outs.get("prim"),
                outs.get("hit"))), n)
            assert getattr(emulated_isect, entry)(ctypes.byref(args),
                                                  None) == 0
        runs.append((t.view(torch.int32).clone(),
                     uv.view(torch.int32).clone(), prim.clone(),
                     hit.clone()))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    woop = pk.face_woop(tables)
    rt, ruv, rprim = intersect.closest_hit_reference(woop, o, d, mint, maxt)
    assert not bool(torch.isnan(t).any() or torch.isnan(uv).any())
    assert torch.equal(prim, rprim)
    assert 0.2 < float((rprim >= 0).float().mean()) < 0.9
    assert torch.equal(t.view(torch.int32), rt.view(torch.int32))
    assert torch.equal(uv.view(torch.int32), ruv.view(torch.int32))
    assert hit.max() <= 1
    assert torch.equal(hit.bool(), intersect.any_hit_reference(
        woop, o, d, mint, maxt))


def instance_rows(placed):
    """[(group, Transform)] -> the instances' rows (I, 24) float32, as the
    scene packs them: to-group A, b, to-world B, group, shape 0, 0."""
    rows = []
    for g, trafo in placed:
        M = np.asarray(trafo.matrix, np.float64)
        A = np.linalg.inv(M[:3, :3])
        rows.append(np.concatenate([A.reshape(9), -A @ M[:3, 3],
                                    M[:3, :3].reshape(9), [g, 0, 0]]))
    return np.stack(rows).astype(np.float32)


def fan_group():
    """A 10-face unit fan in the plane z = 0, around the z axis."""
    ang = np.linspace(0, 2 * np.pi, 11)
    rim = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], 1)
    v0 = np.zeros((10, 3))
    return tuple(np.asarray(x, np.float32)
                 for x in (v0, rim[:-1] - v0, rim[1:] - v0))


def instanced_placement():
    """Two groups in their own frames -- the 1,216-face bumpy sphere and a
    10-face fan -- and five instances: the fan twice under one transform
    (every ray that hits one ties with the other), the sphere three times
    (one of them rotated and scaled) -> (groups, placed)."""
    from tests.test_torch_bvh import bumpy_triangles
    from mitsuba2_tpu_torch.core.transform import Transform as T
    groups = [tuple(np.asarray(x, np.float32) for x in bumpy_triangles()),
              fan_group()]
    placed = [(1, T.translate([0.2, 0.1, 1.5])),
              (0, T.translate([-1.0, 0.0, 0.0])),
              (1, T.translate([0.2, 0.1, 1.5])),
              (0, T.translate([1.2, 0.3, -0.5])
               @ T.rotate([0, 1, 1], 30) @ T.scale([0.6, 0.8, 0.7])),
              (0, T.translate([0.0, -1.5, 0.2]) @ T.scale(0.5))]
    return groups, placed


def instanced_groups():
    """``instanced_placement``'s InstanceTables on the CPU."""
    groups, placed = instanced_placement()
    return ik.instance_tables(groups, instance_rows(placed), "cpu")


def inst_args(inst):
    """``_InstArgs`` of InstanceTables on the CPU."""
    return ik._InstArgs(*(x.data_ptr() for x in (
        inst.nodes, inst.woop, inst.prim, inst.group_node, inst.group_face,
        inst.rows, inst.top)), inst.n_instances, inst.g_max)


def run_inst_entries(lib, inst, o, d, mint, maxt):
    """Both emulated instance entries on the rays, twice, outputs
    prefilled with NaN, -2 and 2 so that a lost ray shows -> (t, uv, prim,
    hit) of the first run, the second bit-identical."""
    n = o.shape[0]
    iargs = inst_args(inst)
    runs = []
    for _ in range(2):
        t = torch.full((n,), float("nan"))
        uv = torch.full((n, 2), float("nan"))
        prim = torch.full((n,), -2, dtype=torch.int32)
        hit = torch.full((n,), 2, dtype=torch.uint8)
        for entry, outs in (("isect_closest_inst",
                             dict(t=t, uv=uv, prim=prim)),
                            ("isect_any_inst", dict(hit=hit))):
            args = ik._IsectArgs(*(0 if x is None else x.data_ptr() for x in (
                None, None, None, o, d, mint, maxt, outs.get("t"),
                outs.get("uv"), outs.get("prim"), outs.get("hit"))), n)
            assert getattr(lib, entry)(
                ctypes.byref(args), ctypes.byref(iargs), None) == 0
        runs.append((t, uv, prim, hit))
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)
    return runs[0]


def assert_inst_plain(inst, o, d, mint, maxt, got):
    """The entries' outputs ``got`` bit for bit against the plain version
    -> its prim ids."""
    t, uv, prim, hit = got
    woops = ik.group_woops(inst)
    rt, ruv, rprim = intersect.closest_hit_instanced_reference(
        woops, inst.rows, inst.g_max, o, d, mint, maxt)
    assert not bool(torch.isnan(t).any() or torch.isnan(uv).any())
    assert torch.equal(prim, rprim)
    assert torch.equal(t.view(torch.int32), rt.view(torch.int32))
    assert torch.equal(uv.view(torch.int32), ruv.view(torch.int32))
    assert hit.max() <= 1
    assert torch.equal(hit.bool(), intersect.any_hit_instanced_reference(
        woops, inst.rows, o, d, mint, maxt))
    return rprim


@pytest.mark.parametrize("n_rays", [600, 257])
def test_emulated_isect_instance_entries_match_plain_version(emulated_isect,
                                                             n_rays):
    """K2's instance entries (csrc/intersect_kernel.cu) on 2 groups and 5
    instances against their plain version: t, uv and prims bit for bit,
    the same occluded rays; rays through the two coincident fan instances
    keep the first (a later instance replaces the best only at a smaller
    t). Outputs prefilled with NaN, -2 and 2; two runs bit-identical."""
    from tests.test_torch_bvh import _rays, bumpy_triangles
    inst = instanced_groups()
    o, d = _rays(bumpy_triangles(), n_rays, 11)
    n = o.shape[0]
    # a third of the rays straight down through the fan instances
    o[::3] = torch.tensor([0.2, 0.1, 4.0]) + 0.4 * torch.rand(
        (len(o[::3]), 3), generator=torch.Generator().manual_seed(5)) - 0.2
    d[::3] = torch.tensor([0.0, 0.0, -1.0])
    mint = torch.full((n,), 1e-4)
    maxt = torch.full((n,), float("inf"))
    maxt[1::4] = 3.0
    got = run_inst_entries(emulated_isect, inst, o, d, mint, maxt)
    rprim = assert_inst_plain(inst, o, d, mint, maxt, got)
    # every instance is hit, the fans only through the first of the two
    hit_inst = set((rprim[rprim >= 0] // inst.g_max).tolist())
    assert hit_inst == {0, 1, 3, 4}, hit_inst
    assert 0.2 < float((rprim >= 0).float().mean()) < 0.95


def reversed_depth_case():
    """Eight overlapping spheres 0.4 apart along x (radius 0.45, as
    instanced_shared), half the rays travelling -x, whose nearest sphere
    is the last instance, half +x; the spheres' boxes overlap, so a ray
    reaches a farther one before the nearer one's hit cuts it short."""
    from tests.test_torch_bvh import bumpy_triangles
    from mitsuba2_tpu_torch.core.transform import Transform as T
    groups = [tuple(np.asarray(x, np.float32)
                    for x in bumpy_triangles(16, 10))]
    placed = [(0, T.translate([0.4 * k - 1.4, 0.0, 0.0]) @ T.scale(0.45))
              for k in range(8)]
    rng = np.random.default_rng(21)
    n = 512
    o = np.zeros((n, 3))
    o[:, 0] = np.where(np.arange(n) % 2, 6.0, -6.0)
    o[:, 1:] = rng.uniform(-0.5, 0.5, (n, 2))
    d = np.zeros((n, 3))
    d[:, 0] = -np.sign(o[:, 0])
    d[:, 1:] = rng.normal(size=(n, 2)) * 0.02
    return groups, placed, o, d, {}


def coincident_case():
    """Two instances under one transform whose fans coincide: instance 0
    the fan alone, instance 1 the fan and a triangle 1 above it and off to
    the side, which no ray reaches. Rays straight down: instance 1's box
    begins nearer, so the walk moves into it first, and the equal-t hit of
    the lower index, reached second, must win."""
    from mitsuba2_tpu_torch.core.transform import Transform as T
    fan = fan_group()
    tri = (np.array([[5.0, 0.0, 1.0]], np.float32),
           np.array([[1.0, 0.0, 0.0]], np.float32),
           np.array([[0.0, 1.0, 0.0]], np.float32))
    groups = [fan, tuple(np.concatenate(x) for x in zip(fan, tri))]
    trafo = T.translate([0.2, 0.1, 1.5]) @ T.rotate([1, 0, 0], 10)
    placed = [(0, trafo), (1, trafo)]
    rng = np.random.default_rng(22)
    n = 256
    o = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)) + [0.2, 0.1],
                        np.full((n, 1), 4.0)], 1)
    d = np.tile([[0.0, 0.0, -1.0]], (n, 1))
    return groups, placed, o, d, {"winners": {0}, "first": 1}


def grazing_case():
    """``instanced_placement``'s five instances and rays that graze their
    world boxes and their geometry: aimed at each instance's extreme
    vertices along each axis (the points nearest its box faces) from
    directions almost parallel to that face, from 3 and from 300 away,
    lying in the box's face planes, and aimed at its corners and edge
    midpoints."""
    groups, placed = instanced_placement()
    rows = instance_rows(placed)
    lo, hi = ik.instance_boxes(
        [bvh.build_bvh(*g, leaf_size=bvh.TRAVERSAL_LEAF) for g in groups],
        rows)
    rng = np.random.default_rng(23)
    o, d = [], []
    for k, (g, trafo) in enumerate(placed):
        M = np.asarray(trafo.matrix, np.float64)
        w = group_vertices(groups[g]) @ M[:3, :3].T + M[:3, 3]
        for axis in range(3):
            for p in (w[w[:, axis].argmin()], w[w[:, axis].argmax()]):
                u = rng.normal(size=(6, 3))
                u[:, axis] = rng.normal(size=6) * 1e-3
                u /= np.linalg.norm(u, axis=1, keepdims=True)
                o.append(p + np.array([[3.0]] * 3 + [[300.0]] * 3) * u)
                d.append(-u)
            # in the face planes of the box, parallel to them
            for plane in (lo[k, axis], hi[k, axis]):
                q = rng.uniform(lo[k], hi[k], (4, 3))
                q[:, axis] = plane
                v = rng.normal(size=(4, 3))
                v[:, axis] = 0.0
                o.append(q - 3.0 * v)
                d.append(v)
        corners = np.array([[hi[k, j] if c >> j & 1 else lo[k, j]
                             for j in range(3)] for c in range(8)])
        mids = 0.5 * (corners[:, None] + corners[None]).reshape(-1, 3)
        for p in (corners, mids):
            v = rng.normal(size=p.shape)
            o.append(p + 3.0 * v)
            d.append(-v)
    o, d = np.concatenate(o), np.concatenate(d)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return groups, placed, o, d, {}


def masked_case():
    """``instanced_placement``'s instances, rays aimed at them, most of
    them masked as the scene masks inactive rays (maxt -inf), with maxt
    below mint, or with a NaN maxt or mint."""
    from tests.test_torch_bvh import _rays, bumpy_triangles
    groups, placed = instanced_placement()
    o, d = _rays(bumpy_triangles(), 256, 24)
    n = o.shape[0]
    mint = torch.full((n,), 1e-4)
    maxt = torch.full((n,), float("inf"))
    maxt[0::5] = float("-inf")
    mint[1::5], maxt[1::5] = 2.0, 1.0
    maxt[2::5] = float("nan")
    mint[3::5] = float("nan")
    return groups, placed, o.numpy(), d.numpy(), {"mint": mint,
                                                  "maxt": maxt}


def grid_case():
    """64 instances of two groups (a 360-face bumpy sphere and the fan,
    some rotated and scaled) in a 4 x 4 x 4 grid: a top tree of several
    levels, rays from outside the grid and from inside it."""
    from tests.test_torch_bvh import bumpy_triangles
    from mitsuba2_tpu_torch.core.transform import Transform as T
    groups = [tuple(np.asarray(x, np.float32)
                    for x in bumpy_triangles(16, 10)), fan_group()]
    placed = []
    for k, (i, j, m) in enumerate(np.ndindex(4, 4, 4)):
        trafo = T.translate([1.1 * i, 1.1 * j, 1.1 * m]) @ T.rotate(
            [1, 1, 0], 25.0 * k) @ T.scale(0.3 + 0.05 * (k % 4))
        placed.append((k % 2, trafo))
    rng = np.random.default_rng(25)
    n = 512
    target = rng.uniform(-0.2, 3.5, (n, 3))
    o = target + rng.normal(size=(n, 3)) * 4.0
    o[::4] = rng.uniform(0.0, 3.3, (n // 4, 3))
    d = target - o + rng.normal(size=(n, 3)) * 0.05
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return groups, placed, o, d, {"levels": 3}


def group_vertices(group):
    """A group's (v0, e1, e2) -> its vertices (3F, 3) in float64."""
    v0, e1, e2 = (np.asarray(x, np.float64) for x in group)
    return np.concatenate([v0, v0 + e1, v0 + e2])


def sah_top_bound(inst):
    """The stack bound of the top tree of ``inst``'s instance boxes as the
    SAH build alone gives it (one box a leaf)."""
    lo, hi = ik.instance_boxes(inst.trees, inst.rows.numpy())
    tree = bvh.build_bvh(lo, hi - lo, np.zeros_like(lo), leaf_size=1)
    return bvh.pack_traversal(bvh.split_leaves(tree, lo, hi))[1]


def clustered_scatter_case():
    """512 instances of the fan, rotated and scaled by 0.45, at log-uniform
    distances up to 1e4 from the origin (a smaller kin of
    scenes.instance_scatter_dict's): the SAH top tree's stack bound exceeds
    TOP_STACK_DEPTH, so the entries walk ops/bvh.py ``traversal_bvh``'s
    fallback top tree. Half the rays aimed at instances drawn at random,
    half through the dense middle."""
    from mitsuba2_tpu_torch.core.transform import Transform as T
    c = log_uniform_points(512, 1e4, 0)
    placed = [(0, T.translate(p.tolist()) @ T.rotate([1, 1, 0], 37.0 * k)
               @ T.scale(0.45)) for k, p in enumerate(c)]
    rng = np.random.default_rng(26)
    n = 384
    target = c[rng.integers(0, len(c), n)].astype(np.float64)
    target[n // 2:] = rng.normal(size=(n - n // 2, 3)) * 2.0
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o = target + u * 10.0 ** rng.uniform(0.0, 2.0, (n, 1))
    return [fan_group()], placed, o, -u, {"sah_top": True}


INSTANCE_CASES = {"reversed_depth": reversed_depth_case,
                  "coincident_ties": coincident_case,
                  "grazing": grazing_case, "masked": masked_case,
                  "grid64": grid_case,
                  "clustered_scatter": clustered_scatter_case}


@pytest.mark.parametrize("case", list(INSTANCE_CASES))
def test_emulated_isect_instance_cases_match_plain_version(emulated_isect,
                                                           case):
    """Both instance entries, a two-level walk (the top tree over the
    instances' world boxes, nearest first), bit for bit against their
    plain version, which takes the instances in index order: index order
    the reverse of depth order, an equal t in two instances whose lower
    index is reached second, rays grazing the world boxes and the
    geometry's extremes, masked rays, and 64 instances under a top tree
    of several levels. The step-for-step walk of ops/intersect.py
    (``traverse_instances``) gets the same hits and counts the moves."""
    groups, placed, o, d, extra = INSTANCE_CASES[case]()
    inst = ik.instance_tables(groups, instance_rows(placed), "cpu")
    o = torch.as_tensor(o, dtype=torch.float32).contiguous()
    d = torch.as_tensor(d, dtype=torch.float32).contiguous()
    n = o.shape[0]
    mint = extra.get("mint", torch.full((n,), 1e-4))
    maxt = extra.get("maxt", torch.full((n,), float("inf")))
    got = run_inst_entries(emulated_isect, inst, o, d, mint, maxt)
    rprim = assert_inst_plain(inst, o, d, mint, maxt, got)
    own = intersect.instance_hits(ik.group_woops(inst), inst.rows, o, d,
                                  mint, maxt)
    walk = intersect.traverse_instances(inst.top, own, inst.g_max, o, d,
                                        mint, maxt)
    assert torch.equal(walk["prim"], rprim)
    assert torch.equal(walk["t"].view(torch.int32), got[0].view(torch.int32))
    # the binary two-level walk the bounds count: the same hits
    top = ik.top_bvh(*ik.instance_boxes(inst.trees, inst.rows.numpy()))
    pairs = intersect.traverse_instance_pairs(
        torch.as_tensor(bvh.pack_pairs(top)[0]),
        torch.as_tensor(top.order).long(), own, inst.g_max, o, d, mint,
        maxt)
    assert torch.equal(pairs["prim"], rprim)
    assert len(pairs["visits"][0]) == int(pairs["moves"].sum())
    hit_inst = set((rprim[rprim >= 0] // inst.g_max).tolist())
    share = float((rprim >= 0).float().mean())
    if case == "masked":
        live = maxt >= mint
        assert not bool((rprim[~live] >= 0).any() or got[3][~live].any())
        assert int(walk["moves"][~live].sum()) == 0
        assert 0.2 < float((rprim[live] >= 0).float().mean()) < 0.95
    elif case == "coincident_ties":
        _, hi = ik.instance_boxes(inst.trees, inst.rows.numpy())
        assert hi[extra["first"], 2] > hi[0, 2] + 0.5
        assert hit_inst == extra["winners"] and share > 0.5
        # both instances reached by every hitting ray
        assert bool((walk["moves"][rprim >= 0] == 2).all())
    elif extra.get("sah_top"):
        assert inst.top_depth <= ik.TOP_STACK_DEPTH < sah_top_bound(inst)
        assert 0.1 < share < 0.98, share
        assert len(hit_inst) >= 0.2 * n
        assert float(walk["moves"].float().mean()) < 0.01 * inst.n_instances
    else:
        assert 0.1 < share < 0.98, share
        # most of the instances take part, each ray moving into few
        assert len(hit_inst) >= 0.5 * inst.n_instances, hit_inst
        assert float(walk["moves"].float().mean()) < 0.5 * inst.n_instances
    if case == "grid64":
        assert inst.top.shape[0] >= 1 + 4 + 16 // 2
        assert inst.top_depth >= extra["levels"]


@pytest.mark.parametrize("case", ["groups"] + list(INSTANCE_CASES))
def test_instance_boxes_and_top_tree(case):
    """Every instance's world box (ops/intersect_kernel.py
    ``instance_boxes``) holds all its group's vertices moved to world in
    float64 with room to spare; the top tree names each instance in
    exactly one leaf, each leaf's box holds its instance's world box, each
    interior child's box holds its node's children, and the tree's stack
    bound within TOP_STACK_DEPTH (a deeper one is refused)."""
    if case == "groups":
        groups, placed = instanced_placement()
    else:
        groups, placed = INSTANCE_CASES[case]()[:2]
    inst = ik.instance_tables(groups, instance_rows(placed), "cpu")
    lo, hi = ik.instance_boxes(inst.trees, inst.rows.numpy())
    for k, (g, trafo) in enumerate(placed):
        M = np.asarray(trafo.matrix, np.float64)
        w = group_vertices(groups[g]) @ M[:3, :3].T + M[:3, 3]
        room = ik.INST_PAD * (1.0 + np.abs(w).max()) * 0.5
        assert (w.min(0) - lo[k] >= room).all(), (k, w.min(0) - lo[k])
        assert (hi[k] - w.max(0) >= room).all(), (k, hi[k] - w.max(0))
    W = bvh.WIDTH
    P = inst.top.numpy()
    ints = P.view(np.int32)
    ref, cnt = ints[:, 6 * W:7 * W], ints[:, 7 * W:]
    box_lo = P[:, :3 * W].reshape(-1, 3, W).transpose(0, 2, 1)
    box_hi = P[:, 3 * W:6 * W].reshape(-1, 3, W).transpose(0, 2, 1)
    leaf = cnt > 0
    assert (cnt[leaf] == 1).all()
    assert sorted(ref[leaf].tolist()) == list(range(inst.n_instances))
    assert (box_lo[leaf] <= lo[ref[leaf]]).all()
    assert (box_hi[leaf] >= hi[ref[leaf]]).all()
    inner = (cnt == 0) & (ref >= 0)
    for node, c in zip(*np.nonzero(inner)):
        kid = ref[node, c]
        used = ref[kid] >= 0
        assert (box_lo[node, c] <= box_lo[kid][used]).all()
        assert (box_hi[node, c] >= box_hi[kid][used]).all()
    assert 0 <= inst.top_depth <= ik.TOP_STACK_DEPTH
    ik._check_inst(inst)
    with pytest.raises(ValueError, match="top tree"):
        ik._check_inst(inst._replace(top_depth=ik.TOP_STACK_DEPTH + 1))


@pytest.mark.parametrize("placement", ["grid", "random", "log_uniform-0",
                                       "log_uniform-1", "log_uniform-2"])
def test_top_tree_stack_holds_a_large_forest(placement):
    """The top tree over 65,536 unit instance boxes, on a 256x256 grid or
    placed at random in a cube of that side, or over 4,096 of them at
    log-uniform distances up to 100 (seeds 0-2, whose SAH trees exceed the
    stack), keeps its stack bound within TOP_STACK_DEPTH, as
    ops/intersect_kernel.py's note on it says."""
    side = 256
    if placement == "grid":
        ij = np.stack(np.meshgrid(np.arange(side), np.arange(side),
                                  indexing="ij"), -1).reshape(-1, 2)
        lo = np.zeros((side * side, 3), np.float32)
        lo[:, :2] = ij
    elif placement == "random":
        lo = np.random.default_rng(7).uniform(
            0, side, (side * side, 3)).astype(np.float32)
    else:
        lo = log_uniform_points(4096, 100.0, int(placement[-1]))
        hi = lo + np.float32(0.9)
        sah = bvh.build_bvh(lo, hi - lo, np.zeros_like(lo), leaf_size=1)
        assert bvh.pack_traversal(bvh.split_leaves(sah, lo, hi))[1] \
            > ik.TOP_STACK_DEPTH
    nodes, depth = ik.top_tree(lo, lo + np.float32(0.9))
    refs = nodes.view(np.int32)[:, 6 * bvh.WIDTH:]
    leaf = refs[:, bvh.WIDTH:] > 0
    assert leaf.sum() == len(lo)
    assert 0 < depth <= ik.TOP_STACK_DEPTH, depth


def test_inst_args_match_the_kernel_struct():
    """``struct InstArgs`` and ``struct IsectArgs`` of
    csrc/intersect_kernel.cu field for field against ``_InstArgs`` and
    ``_IsectArgs``, and its top stack the host's TOP_STACK_DEPTH."""
    from tests.test_torch_persistent import struct_fields
    src = (build.CSRC / "intersect_kernel.cu").read_text()
    assert struct_fields(src, "InstArgs") == ik._InstArgs._fields_
    assert struct_fields(src, "IsectArgs") == ik._IsectArgs._fields_
    assert re.findall(r"constexpr int TOP_STACK = (\d+);", src) == [
        str(ik.TOP_STACK_DEPTH)]


@pytest.fixture(scope="module")
def emulated_sweep(tmp_path_factory):
    """csrc/sweep_kernel.cu built under the emulation (its launches and
    its shared tables rewritten) -> the loaded library."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("the emulation needs g++ (the BVH builder's compiler)")
    d = tmp_path_factory.mktemp("emulated_sweep")
    src = (build.CSRC / "sweep_kernel.cu").read_text()
    counts = []
    for pattern, repl in (
            (r"((?:sweep|box)_kernel<SHARED>)<<<([^>]*)>>>\((\w+)\)",
             r"emu_launch(\1, \2, \3)"),
            (r"extern __shared__ float4 (s_\w+)\[\];",
             r"float4* \1 = (float4*)emu->dyn.data();")):
        src, n = re.subn(pattern, repl, src)
        counts.append(n)
    assert counts == [2, 2], counts
    (d / "cuda_runtime.h").write_text(EMU_HEADER)
    (d / "sweep_kernel.cpp").write_text(src)
    out = d / "sweep.so"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", "-w", f"-I{d}", f"-I{build.CSRC}",
         f"-DEMU_SMS={SMS}", f"-DEMU_BLOCKS={BLOCKS_PER_SM}", "-o",
         str(out), str(d / "sweep_kernel.cpp")],
        check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def box_geometry():
    """{instantiation ('true': shared, 'false': global): (threads a block,
    lines ahead, rays a thread)} of csrc/sweep_kernel.cu's ``BoxTune``
    lines."""
    src = (build.CSRC / "sweep_kernel.cu").read_text()
    found = re.findall(
        r"struct BoxTune<(true|false)> \{\s*static constexpr int THREADS = "
        r"(\d+), AHEAD = (\d+), RAYS = (\d+)", src)
    assert {k for k, *_ in found} == {"true", "false"}, found
    return {k: tuple(int(x) for x in v) for k, *v in found}


@pytest.mark.parametrize("n_lines", [37, 1])
def test_emulated_box_kernel_matches_plain_version(emulated_sweep, n_lines):
    """The box-test ceiling (csrc/sweep_kernel.cu box_kernel, the walk's
    ``test_line``: each axis's near and far planes read by the ray's
    direction) against its plain version (per-axis minima and maxima),
    bit for bit, in both instantiations, 3 iterations: the line count
    ragged against the loop's unroll of 2 and the lines ahead (one line:
    every line ahead past the last), the ray count against a block's rays
    (threads times rays a thread), outputs prefilled with NaN and -1, and
    two runs bit-identical."""
    from mitsuba2_tpu_torch.ops import sweep_kernel as sk
    from mitsuba2_tpu_torch.tools import shape_ceiling as sc
    iters = 3
    for entry, key in (("boxes_shared", "true"), ("boxes_global", "false")):
        threads, _, rays = box_geometry()[key]
        block = threads * rays
        n = block + block // 3 + 7
        lines, o, d = sc.box_inputs(n_lines, n, "cpu", seed=4)
        # some rays along an axis: the guarded inverse on both signs
        d[:8] = torch.tensor([[1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0],
                              [0, -1.0, 0], [0, 0, 1.0], [0, 0, -1.0],
                              [-1e-13, 1.0, 0], [1e-13, 0, -1.0]])
        want = sk.box_sweep_reference(lines, o, d, iters)
        fn = getattr(emulated_sweep, entry)
        fn.argtypes = [ctypes.POINTER(sk._BoxArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        runs = []
        for _ in range(2):
            near = torch.full((n,), float("nan"))
            hits = torch.full((n,), -1, dtype=torch.int32)
            args = sk._BoxArgs(*(x.data_ptr() for x in (lines, o, d, near,
                                                        hits)),
                               n_lines, n, iters, sk.MINT_STEP)
            assert fn(ctypes.byref(args), None) == 0
            runs.append((near.view(torch.int32), hits))
        for a, b in zip(*runs):
            assert torch.equal(a, b), entry
        assert torch.equal(runs[0][1], want[1]), entry
        assert torch.equal(runs[0][0], want[0].view(torch.int32)), entry
        assert bool(torch.isfinite(want[0]).any()) and int(want[1].sum()) > 0
        assert bool((want[1] == 0).any()), entry


def numpy_face_sweep(woop, o, d, iters):
    """Every ray against every face of ``woop`` (F, 12) in numpy float32,
    each product and sum rounded on its own in csrc/bvh.cuh's order
    (``dot_o``, ``dot_d``, ``face_t<false>``: t = -Z / DZ, ``inside``:
    u = U + t DU, 1 - u - v >= 0), the closest face of each iteration
    k >= mint = k * MINT_STEP, ties to the lowest face id -> the last
    iteration's (t, uv, prim) and the iterations that hit."""
    from mitsuba2_tpu_torch.ops import sweep_kernel as sk
    f32 = np.float32
    W = woop.reshape(-1, 3, 4)
    ox, oy, oz = (o[:, c:c + 1] for c in range(3))
    dx, dy, dz = (d[:, c:c + 1] for c in range(3))

    def dot_o(w):
        return ((ox * w[:, 0] + oy * w[:, 1]) + oz * w[:, 2]) + w[:, 3]

    def dot_d(w):
        return (dx * w[:, 0] + dy * w[:, 1]) + dz * w[:, 2]

    with np.errstate(all="ignore"):
        t = -dot_o(W[:, 2]) / dot_d(W[:, 2])
        u = dot_o(W[:, 0]) + t * dot_d(W[:, 0])
        v = dot_o(W[:, 1]) + t * dot_d(W[:, 1])
        inside = (u >= 0) & (v >= 0) & ((f32(1) - u) - v >= 0)
    assert t.dtype == u.dtype == v.dtype == np.float32
    rows = np.arange(len(o))
    hits = np.zeros(len(o), np.int32)
    for k in range(iters):
        ok = inside & (t >= f32(k * sk.MINT_STEP))
        best = np.where(ok, t, f32(np.inf)).argmin(1)
        hit = ok[rows, best]
        hits += hit
    t_out = np.where(hit, t[rows, best], f32(np.inf))
    uv = np.where(hit[:, None], np.stack([u[rows, best], v[rows, best]], 1),
                  f32(0))
    return t_out, uv, np.where(hit, best, -1).astype(np.int32), hits


def test_emulated_sweep_kernel_matches_host_arithmetic(emulated_sweep):
    """The face-test ceiling (csrc/sweep_kernel.cu sweep_kernel: a thread's
    ray against each face's rows, the global ones loaded ahead) in both
    instantiations, at a ray count ragged against a block and a face count
    against the loop's unroll, 3 iterations, outputs prefilled with NaN
    and -2: bit for bit a numpy float32 evaluation of the path kernel's
    face test (the emulation's arithmetic is the host's, unfused), and two
    runs bit-identical."""
    from mitsuba2_tpu_torch.ops import sweep_kernel as sk
    from mitsuba2_tpu_torch.tools import shape_ceiling as sc
    src = (build.CSRC / "sweep_kernel.cu").read_text()
    threads = dict(re.findall(
        r"struct Tune<(true|false)> \{\s*static constexpr int THREADS = "
        r"(\d+),", src))
    assert set(threads) == {"true", "false"}, threads
    n_faces, iters = 37, 3
    for entry, key in (("sweep_shared", "true"), ("sweep_global", "false")):
        block = int(threads[key])
        n = block + block // 3 + 7
        woop, o, d = sc.inputs(n_faces, n, "cpu", seed=6)
        # rays from the origin along z (1), y (3) and x (4); faces inside
        # at u = v = 0.25 for them: at t = 0.0005 along z (hit at mint 0,
        # not at mint 2^-10), the last face at t = 0.01 along z, two equal
        # faces at t = 0.02 along y (the tie goes to the lower id), and at
        # t = 2^-131 / 2^-130 = 0.5 along x (subnormal operands)
        uv_rows = [0, 0, 0, 0.25, 0, 0, 0, 0.25]
        for f, z_row in ((5, [0, 0, 1, -0.0005]),
                         (n_faces - 1, [0, 0, 1, -0.01]),
                         (8, [0, 1, 0, -0.02]), (20, [0, 1, 0, -0.02]),
                         (12, [2.0 ** -130, 0, 0, -2.0 ** -131])):
            woop[f] = torch.tensor(uv_rows + z_row)
        for k, axis in ((1, 2), (3, 1), (4, 0)):
            o[k], d[k] = torch.zeros(3), torch.zeros(3)
            d[k, axis] = 1.0
        # a ray with no direction hits nothing (t = +-inf or NaN)
        d[2] = 0.0
        want = numpy_face_sweep(woop.numpy(), o.numpy(), d.numpy(), iters)
        fn = getattr(emulated_sweep, entry)
        fn.argtypes = [ctypes.POINTER(sk._SweepArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        runs = []
        for _ in range(2):
            t = torch.full((n,), float("nan"))
            uv = torch.full((n, 2), float("nan"))
            prim = torch.full((n,), -2, dtype=torch.int32)
            hits = torch.full((n,), -2, dtype=torch.int32)
            args = sk._SweepArgs(*(x.data_ptr() for x in (
                woop, o, d, t, uv, prim, hits)), n_faces, n, iters,
                sk.MINT_STEP)
            assert fn(ctypes.byref(args), None) == 0
            runs.append([x.numpy().view(np.int32) for x in (t, uv, prim,
                                                            hits)])
        for a, b in zip(*runs):
            np.testing.assert_array_equal(a, b, err_msg=entry)
        for got, w in zip(runs[0], want):
            np.testing.assert_array_equal(
                got, np.ascontiguousarray(w).view(np.int32), err_msg=entry)
        prims, counts = want[2], want[3]
        assert (counts == 0).any() and (counts == iters).any(), entry
        assert counts[2] == 0 and prims[2] == -1
        assert prims[1] == n_faces - 1 and prims[3] == 8, prims[:5]
        assert prims[4] == 12 and want[0][4] == 0.5, prims[:5]
        assert len(set(prims.tolist())) >= 10, entry
