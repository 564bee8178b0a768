"""The path kernel's launch contract: ``struct PathArgs`` in
csrc/path_kernel.cu field for field against ``_PathArgs`` (CPU), and on the
card the persistent launch (a grid of SMs x resident blocks, finished
paths' slots refilled from a lane counter, every family) against the
plain version at lane counts that stress the
refill: fewer lanes than one block, a count that is no multiple of the
grid, a pass with a sample offset, and the lobes (regrouped by kind),
spectral and BVH instantiations. The second launch of each check writes
into an output prefilled with NaN, so that a lane no thread wrote shows. The bar is
PERF.md's §2: at least 99% of pixels within 1e-4 relative, image means
within 1e-5, or 1e-4 on the materials box, whose glass decides by float
rounding whether about one lane in 10^4 reaches the light."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.python.test.scenes import (cornell_box_dict,
                                                   cornell_materials_dict)
from tests.test_torch_path_kernel import (MEAN_RTOL, PIX_RTOL, PIX_SHARE,
                                          box_develop, cpu_device_fixture,
                                          pixel_errors)

_on_cpu = cpu_device_fixture()

SEED, MAX_DEPTH, RR_DEPTH = 3, 6, 3
# the image means' bar on the materials box (PERF.md §2)
CAUSTIC_MEAN_RTOL = 1e-4
C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
           "uint32_t": ctypes.c_uint32}


def struct_fields(source, name):
    """(field, ctypes type) of a C struct of plain fields, in order:
    pointers as c_void_p, a fixed array ``name[N]`` as its type times N."""
    body = re.search(r"struct " + name + r" \{(.*?)\n\};", source,
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        ctype, names = re.match(r"((?:const )?\w+\*?)\s+(.*)", decl,
                                re.S).groups()
        t = ctypes.c_void_p if ctype.endswith("*") else C_TYPES[ctype]
        for n in names.split(","):
            field, count = re.fullmatch(r"\s*(\w+)(?:\[(\d+)\])?\s*",
                                        n).groups()
            fields.append((field, t * int(count) if count else t))
    return fields


def test_path_args_match_the_kernel_struct():
    src = (Path(pk.__file__).resolve().parent.parent / "csrc"
           / "path_kernel.cu").read_text()
    assert struct_fields(src, "PathArgs") == pk._PathArgs._fields_
    # the lane counter comes after the lobes flag's tables, and the band's
    # first pixel last, so that every earlier field keeps its offset
    assert pk._PathArgs._fields_[-2:] == [("counter", ctypes.c_void_p),
                                          ("pixel_base", ctypes.c_uint32)]


def card_scene(make_dict, variant, width, height, spp):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mt.set_variant(variant)
    prev = mt.device()
    try:
        mt.set_device("cuda")
        return mt.load_dict(make_dict(width, height, spp, MAX_DEPTH))
    finally:
        mt.set_device(prev)
        mt.set_variant("scalar_rgb")


def launch_into_nan(args):
    """The kernel's lanes for ``path_radiance``'s arguments, written into
    an output prefilled with NaN."""
    tables = args[0]
    out = torch.full((3, args[4] * args[5] * args[6]), float("nan"),
                     device=tables.device)
    counter = torch.zeros(1, dtype=torch.int32, device=tables.device)
    info = (ctypes.c_int * len(pk.LAUNCH_INFO))()
    err = pk._path_render(pk.library_defines(
        tables.nc, bool(tables.flags & pk.HAS_LOBES)))(
        ctypes.byref(pk._path_args(*args, out, counter)),
        torch.cuda.current_stream(tables.device).cuda_stream, info)
    assert err == 0, err
    torch.cuda.synchronize()
    return out


def check_launch(tables, cam, sample_base, spp, width, height):
    """Kernel against plain version at one pass; the launch's grid is the
    card's SMs x the resident blocks, and a second launch into an output of
    NaN is bit-identical. -> the kernel's lanes."""
    args = (tables, cam, SEED, sample_base, spp, width, height, MAX_DEPTH,
            RR_DEPTH)
    got = pk.path_radiance(*args)
    torch.cuda.synchronize()
    flags = tables.flags & pk.TEMPLATE_FLAGS
    info = pk.path_radiance.last_launch[(flags, tables.nc)]
    assert info["blocks_per_sm"] >= 1
    assert info["grid"] == info["sms"] * info["blocks_per_sm"]
    again = launch_into_nan(args)
    assert not bool(torch.isnan(again).any()), "a lane was never written"
    assert torch.equal(got, again)
    want = pk.path_radiance_reference(*args)
    a = box_develop(got, width, height, spp).cpu().numpy()
    b = box_develop(want, width, height, spp).cpu().numpy()
    err = pixel_errors(a, b)
    assert (err <= PIX_RTOL).mean() >= PIX_SHARE, np.quantile(err, 0.99)
    mean_rtol = (CAUSTIC_MEAN_RTOL if tables.flags & pk.HAS_LOBES
                 and tables.n_quads else MEAN_RTOL)
    assert abs(a.mean() - b.mean()) <= mean_rtol * abs(b.mean()), \
        (a.mean(), b.mean())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("make_dict", [cornell_box_dict,
                                       cornell_materials_dict])
def test_fewer_lanes_than_a_block(make_dict):
    scene = card_scene(make_dict, "scalar_rgb", 5, 4, 3)    # 60 lanes
    check_launch(scene.tables, pk.camera_row(scene.sensors[0],
                                             scene.device), 0, 3, 5, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("make_dict", [cornell_box_dict,
                                       cornell_materials_dict])
def test_lanes_no_multiple_of_the_grid(make_dict):
    """More lanes than the grid's slots, and no multiple of them: every
    slot refills, and the last refills run out mid-warp."""
    scene = card_scene(make_dict, "scalar_rgb", 211, 97, 13)
    cam = pk.camera_row(scene.sensors[0], scene.device)
    got = check_launch(scene.tables, cam, 0, 13, 211, 97)
    info = pk.path_radiance.last_launch[(scene.tables.flags
                                         & pk.TEMPLATE_FLAGS, 3)]
    slots = info["grid"] * pk.BLOCK
    assert got.shape[1] > slots and got.shape[1] % slots


@pytest.mark.cuda
def test_sample_base_offset():
    """Samples 8..15 of every pixel as their own pass are those lanes of
    the whole pass."""
    scene = card_scene(cornell_materials_dict, "scalar_rgb", 24, 24, 16)
    cam = pk.camera_row(scene.sensors[0], scene.device)
    full = check_launch(scene.tables, cam, 0, 16, 24, 24)
    second = check_launch(scene.tables, cam, 8, 8, 24, 24)
    assert torch.equal(full.reshape(3, 24 * 24, 16)[:, :, 8:],
                       second.reshape(3, 24 * 24, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("variant, make_dict, force", [
    ("scalar_rgb", cornell_materials_dict, 0),
    ("scalar_spectral", cornell_materials_dict, 0),
    ("scalar_mono", cornell_materials_dict, 0),
    ("scalar_spectral", cornell_box_dict, 0),
    ("scalar_rgb", cornell_box_dict, pk.HAS_BVH),
    ("scalar_rgb", cornell_box_dict, pk.HAS_LOBES),
])
def test_instantiations(variant, make_dict, force):
    """The lobes instantiations in every color mode, the flag-free spectral
    one, and the BVH tier and the lobes flag forced on the Cornell box."""
    scene = card_scene(make_dict, variant, 32, 32, 16)
    tables = scene.tables
    if force == pk.HAS_BVH:
        tables = pk.with_bvh_tier(tables)
    elif force:
        tables = tables._replace(flags=tables.flags | force)
    check_launch(tables, pk.camera_row(scene.sensors[0], scene.device), 0,
                 16, 32, 32)
