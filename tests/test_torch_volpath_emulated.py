"""The volumetric kernel's loop (K3), run on the CPU: csrc/volpath_kernel.cu
compiled by the host C++ compiler against the emulation of the CUDA
features it uses (``EMU_HEADER`` of tests/test_torch_loop_emulated.py: one
std::thread per CUDA thread, std::barrier for the warp collectives), its
launch and its ``__shared__`` rows rewritten for the emulation, loaded
through ctypes and called through the wrapper's own argument builder on
CPU tensors. This holds the loop's scheduling, which no other CPU test
sees: persistent warps that refill finished paths from the lane counter,
and the one tracking-step loop that advances the lanes on delta and on
ratio walks while the others wait for the event code. Each lane's output
(prefilled with NaN, so that a lost lane shows) must agree with the plain
version ``volpath_radiance_reference`` at PERF.md section 2's bar (99% of
lanes within 1e-4 relative, the images' pixels as well; the host's
arithmetic has no fused multiply-adds), and two runs must be
bit-identical. The emulated card has one SM holding one block of 128
threads, so every scene has more lanes than slots and its warps refill;
no JAX kernel is rendered.
"""

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
from mitsuba2_tpu_torch.ops import volpath_kernel as vk
from mitsuba2_tpu_torch.python.test.scenes import volpath_slab_dict
from tests.test_torch_loop_emulated import EMU_HEADER
from tests.test_torch_persistent import struct_fields
from tests.test_torch_path_kernel import (PIX_RTOL, PIX_SHARE, box_develop,
                                          cpu_device_fixture, pixel_errors)
from tests.test_torch_volpath import surfaces

_on_cpu = cpu_device_fixture()

SEED, RR_DEPTH = 3, 5
# the emulated card: SMs and resident blocks
SMS, BLOCKS_PER_SM = 1, 1


def emulated_source():
    """csrc/volpath_kernel.cu with its launch and its shared rows rewritten
    for the emulation (an unknown ``__shared__`` declaration fails the
    build)."""
    src = (build.CSRC / "volpath_kernel.cu").read_text()
    counts = []
    for pattern, repl in (
            (r"(volpath_kernel<FLAGS>)<<<([^>]*)>>>\((\w+)\)",
             r"emu_launch(\1, \2, \3)"),
            (r"extern __shared__ float4 s_woop\[\];",
             "float4* s_woop = (float4*)emu->dyn.data();")):
        src, n = re.subn(pattern, repl, src)
        counts.append(n)
    assert counts == [1, 1], counts
    return src


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """volpath_render of the emulated library."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("the emulation needs g++ (the BVH builder's compiler)")
    d = tmp_path_factory.mktemp("emulated_volpath_kernel")
    (d / "cuda_runtime.h").write_text(EMU_HEADER)
    (d / "volpath_kernel.cpp").write_text(emulated_source())
    out = d / "volpath_kernel.so"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", "-w", f"-I{d}", f"-I{build.CSRC}", f"-DEMU_SMS={SMS}",
         f"-DEMU_BLOCKS={BLOCKS_PER_SM}", "-o", str(out),
         str(d / "volpath_kernel.cpp")],
        check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).volpath_render
    fn.argtypes = [ctypes.POINTER(vk._VolArgs), ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def run_emulated(fn, tables, cam, width, spp, max_depth, mis):
    n = width * width * spp
    out = torch.full((3, n), float("nan"))
    counter = torch.zeros(1, dtype=torch.int32)
    info = (ctypes.c_int * len(vk.LAUNCH_INFO))()
    err = fn(ctypes.byref(vk._vol_args(
        tables, cam, SEED, 0, spp, width, width, max_depth, RR_DEPTH, mis,
        out, counter)), None, info)
    assert err == 0
    info = dict(zip(vk.LAUNCH_INFO, info))
    assert info["grid"] == info["sms"] * info["blocks_per_sm"] \
        == SMS * BLOCKS_PER_SM
    # every warp's last fetch passes n by less than a warp
    assert n <= int(counter[0]) < n + info["grid"] * vk.BLOCK
    assert n > info["grid"] * vk.BLOCK, "the warps must refill"
    return out


def spiky_grid():
    """A 16^3 sigma_t grid of the slab's range with one voxel 30 times its
    largest value: the majorant is that voxel's, so nearly every step is a
    null collision; delta walks run out of their 16 steps and ratio walks
    are cut with T > 0."""
    grid = np.random.default_rng(1).uniform(
        0.2, 2.0, (16, 16, 16)).astype(np.float32)
    grid[8, 8, 8] = 60.0
    return grid


def slab(width, spp, depth):
    return volpath_slab_dict(width, width, spp, depth)


def surfaces_slab(width, spp, depth):
    """The slab behind a glass pane above a GGX floor (the GGX and
    dielectric instantiation)."""
    return volpath_slab_dict(width, width, spp, depth,
                             **surfaces(mt.Transform))


def isotropic_mis(width, spp, depth):
    d = volpath_slab_dict(width, width, spp, depth, g=0.0)
    d["integrator"]["type"] = "volpathmis"
    return d


def dense_slab(width, spp, depth):
    d = volpath_slab_dict(width, width, spp, depth, grid=spiky_grid())
    d["slab"]["interior"]["scale"] = 4.0
    return d


@pytest.mark.parametrize("make_dict, width, spp, depth, flags", [
    (slab, 8, 4, 16, vk.HAS_HG),                         # the bench slab
    (surfaces_slab, 8, 4, 8, vk.HAS_HG | vk.HAS_GGX | vk.HAS_DIEL),
    (isotropic_mis, 8, 4, 8, vk.MIS),
    (dense_slab, 6, 4, 8, vk.HAS_HG),                    # both budgets
    (slab, 7, 3, 6, vk.HAS_HG),                          # 147 lanes
])
def test_emulated_volpath_loop_matches_plain_version(emulated, make_dict,
                                                     width, spp, depth,
                                                     flags):
    mt.set_variant("scalar_rgb")
    d = make_dict(width, spp, depth)
    d["integrator"]["rr_depth"] = RR_DEPTH
    scene = mt.load_dict(d)
    mis = scene.integrator.USE_MIS
    tables = vk.build_vol_tables(scene)
    assert tables.flags | (vk.MIS if mis else 0) == flags
    cam = pk.camera_row(scene.sensors[0], scene.device)
    got = run_emulated(emulated, tables, cam, width, spp, depth, mis)
    assert not bool(torch.isnan(got).any()), "a lane was never written"
    assert torch.equal(got, run_emulated(emulated, tables, cam, width, spp,
                                         depth, mis))
    stats = {}
    want = vk.volpath_radiance_reference(tables, cam, SEED, 0, spp, width,
                                         width, depth, RR_DEPTH, mis=mis,
                                         stats=stats)
    if make_dict is dense_slab:
        assert stats["stalled"] > 0 and stats["ratio_cut"] > 0, stats
    assert stats["delta_steps"] > 0 and stats["ratio_steps"] > 0
    lane_rel = ((got - want).abs() / want.abs().clamp(min=1e-3)).amax(0)
    assert float((lane_rel > PIX_RTOL).float().mean()) <= 1 - PIX_SHARE
    err = pixel_errors(box_develop(got, width, width, spp).numpy(),
                       box_develop(want, width, width, spp).numpy())
    assert (err <= PIX_RTOL).mean() >= PIX_SHARE, np.quantile(err, 0.99)


def test_vol_args_match_the_kernel_struct():
    """``struct VolArgs`` of csrc/volpath_kernel.cu field for field against
    ``_VolArgs``, the lane counter last."""
    fields = []
    for name, t in struct_fields(
            (build.CSRC / "volpath_kernel.cu").read_text(), "VolArgs"):
        m = re.fullmatch(r"(\w+)\[(\d+)\]", name)
        fields.append((m.group(1), t * int(m.group(2))) if m else (name, t))
    assert fields == vk._VolArgs._fields_
    assert vk._VolArgs._fields_[-1] == ("counter", ctypes.c_void_p)
