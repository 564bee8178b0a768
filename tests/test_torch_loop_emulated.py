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
shadow ray still queued. The same emulation runs the scene's ray queries
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
                                                   cornell_box_dict,
                                                   cornell_materials_dict,
                                                   hero_serialized_dict,
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
                         cornell_black_wall):
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
    ("scalar_rgb", cornell_box_dict), ("scalar_rgb", cornell_materials_dict)])
def test_emulated_band_is_the_films_rows(emulated, variant, make_dict):
    """A band of film rows (``pixel_base``, parallel/mesh.py's pixel axis):
    its lanes are those rows of the whole film's launch, bit for bit, in
    the shared-memory and the lobes families."""
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


@pytest.mark.parametrize("n_rays", [600, 257])
def test_emulated_isect_kernel_matches_plain_version(emulated_isect,
                                                     n_rays):
    """K2 (csrc/intersect_kernel.cu) on a 1,216-face mesh against its plain
    twin, the linear sweep: face ids, t and uv bit for bit and the same
    occluded rays, every block of the grid at once, the last one ragged.
    Outputs prefilled with NaN (and -2 and 2 for the integer ones), so that
    a lost ray shows; two runs bit-identical."""
    from tests.test_torch_bvh import _rays, bumpy_triangles
    scene = mt.load_dict(bumpy_sphere_dict(4, 4, 1, 2, 32, 20))
    tables = scene.tables
    assert tables.n_faces > 1024 and tables.bvh_depth <= bvh.STACK_DEPTH
    o, d = _rays(bumpy_triangles(), n_rays, 9)
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


def instanced_groups():
    """Two groups in their own frames -- the 1,216-face bumpy sphere and a
    10-face fan -- and five instances: the fan twice under one transform
    (every ray that hits one ties with the other), the sphere three times
    (one of them rotated and scaled) -> InstanceTables on the CPU."""
    from tests.test_torch_bvh import bumpy_triangles
    from mitsuba2_tpu_torch.core.transform import Transform as T
    ang = np.linspace(0, 2 * np.pi, 11)
    rim = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], 1)
    fan = (np.zeros((10, 3), np.float32), rim[:-1].astype(np.float32),
           rim[1:].astype(np.float32))
    fan = (fan[0], fan[1] - fan[0], fan[2] - fan[0])
    groups = [tuple(np.asarray(x, np.float32) for x in bumpy_triangles()),
              fan]
    rows = []
    for g, trafo in ((1, T.translate([0.2, 0.1, 1.5])),
                     (0, T.translate([-1.0, 0.0, 0.0])),
                     (1, T.translate([0.2, 0.1, 1.5])),
                     (0, T.translate([1.2, 0.3, -0.5])
                      @ T.rotate([0, 1, 1], 30) @ T.scale([0.6, 0.8, 0.7])),
                     (0, T.translate([0.0, -1.5, 0.2]) @ T.scale(0.5))):
        M = np.asarray(trafo.matrix, np.float64)
        A = np.linalg.inv(M[:3, :3])
        rows.append(np.concatenate([A.reshape(9), -A @ M[:3, 3],
                                    M[:3, :3].reshape(9), [g, 0, 0]]))
    return ik.instance_tables(groups, np.stack(rows).astype(np.float32),
                              "cpu")


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
    t = torch.full((n,), float("nan"))
    uv = torch.full((n, 2), float("nan"))
    prim = torch.full((n,), -2, dtype=torch.int32)
    hit = torch.full((n,), 2, dtype=torch.uint8)
    iargs = ik._InstArgs(*(x.data_ptr() for x in (
        inst.nodes, inst.woop, inst.prim, inst.group_node, inst.group_face,
        inst.rows)), inst.n_instances, inst.g_max)
    runs = []
    for _ in range(2):
        for entry, outs in (("isect_closest_inst",
                             dict(t=t, uv=uv, prim=prim)),
                            ("isect_any_inst", dict(hit=hit))):
            args = ik._IsectArgs(*(0 if x is None else x.data_ptr() for x in (
                None, None, None, o, d, mint, maxt, outs.get("t"),
                outs.get("uv"), outs.get("prim"), outs.get("hit"))), n)
            assert getattr(emulated_isect, entry)(
                ctypes.byref(args), ctypes.byref(iargs), None) == 0
        runs.append((t.view(torch.int32).clone(),
                     uv.view(torch.int32).clone(), prim.clone(),
                     hit.clone()))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    woops = ik.group_woops(inst)
    rt, ruv, rprim = intersect.closest_hit_instanced_reference(
        woops, inst.rows, inst.g_max, o, d, mint, maxt)
    assert not bool(torch.isnan(t).any() or torch.isnan(uv).any())
    assert torch.equal(prim, rprim)
    assert torch.equal(t.view(torch.int32), rt.view(torch.int32))
    assert torch.equal(uv.view(torch.int32), ruv.view(torch.int32))
    assert torch.equal(hit.bool(), intersect.any_hit_instanced_reference(
        woops, inst.rows, o, d, mint, maxt))
    # every instance is hit, the fans only through the first of the two
    hit_inst = set((rprim[rprim >= 0] // inst.g_max).tolist())
    assert hit_inst == {0, 1, 3, 4}, hit_inst
    assert 0.2 < float((rprim >= 0).float().mean()) < 0.95


def test_inst_args_match_the_kernel_struct():
    """``struct InstArgs`` and ``struct IsectArgs`` of
    csrc/intersect_kernel.cu field for field against ``_InstArgs`` and
    ``_IsectArgs``."""
    from tests.test_torch_persistent import struct_fields
    src = (build.CSRC / "intersect_kernel.cu").read_text()
    assert struct_fields(src, "InstArgs") == ik._InstArgs._fields_
    assert struct_fields(src, "IsectArgs") == ik._IsectArgs._fields_


def test_emulated_box_kernel_matches_plain_version(tmp_path):
    """The box-test ceiling (csrc/sweep_kernel.cu box_kernel, the walk's
    ``test_line``: each axis's near and far planes read by the ray's
    direction) against its plain version (per-axis minima and maxima),
    bit for bit, in both instantiations, with the ray count ragged."""
    from mitsuba2_tpu_torch.ops import sweep_kernel as sk
    from mitsuba2_tpu_torch.tools import shape_ceiling as sc
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("the emulation needs g++ (the BVH builder's compiler)")
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
    (tmp_path / "cuda_runtime.h").write_text(EMU_HEADER)
    (tmp_path / "sweep_kernel.cpp").write_text(src)
    out = tmp_path / "sweep.so"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", "-w", f"-I{tmp_path}", f"-I{build.CSRC}",
         f"-DEMU_SMS={SMS}", f"-DEMU_BLOCKS={BLOCKS_PER_SM}", "-o",
         str(out), str(tmp_path / "sweep_kernel.cpp")],
        check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lines, o, d = sc.box_inputs(24, 300, "cpu", seed=4)
    # some rays along an axis: the guarded inverse on both signs
    d[:8] = torch.tensor([[1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0],
                          [0, -1.0, 0], [0, 0, 1.0], [0, 0, -1.0],
                          [-1e-13, 1.0, 0], [1e-13, 0, -1.0]])
    want = sk.box_sweep_reference(lines, o, d, 3)
    for entry in ("boxes_shared", "boxes_global"):
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.POINTER(sk._BoxArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        near = torch.full((300,), float("nan"))
        hits = torch.full((300,), -1, dtype=torch.int32)
        args = sk._BoxArgs(*(x.data_ptr() for x in (lines, o, d, near, hits)),
                           24, 300, 3, sk.MINT_STEP)
        assert fn(ctypes.byref(args), None) == 0
        assert torch.equal(hits, want[1]), entry
        assert torch.equal(near.view(torch.int32), want[0].view(torch.int32))
    assert bool(torch.isfinite(want[0]).any()) and int(want[1].sum()) > 0
