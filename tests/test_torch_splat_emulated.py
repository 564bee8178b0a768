"""The film splat's tiled kernel (csrc/splat_kernel.cu), run on the CPU in
two ways, each held against the plain version ``splat_reference`` at the
splat's bar (PERF.md section 2: every block pixel within 1e-5 relative or
1e-6 absolute; for a filter whose weights change sign 1e-6 of the block's
largest value, as the card test holds it):

- ``tiled_order``: the kernel's order of sums in plain torch. The tiles of
  ``Tile<b>`` (read from the source), each pixel's K x K x 4 taps summed
  over its samples in sample order (a thread's registers), the K^2 phases
  that add one tap of every pixel of a tile into its shared output tile,
  and the band pass's merge of the tiles that share a block pixel, tile
  rows then columns. A product and its sum are rounded apart here, where
  the card fuses them.
- The kernel's source itself, compiled by the host C++ compiler against
  the emulation of the CUDA features it uses (``EMU_HEADER`` of
  tests/test_torch_loop_emulated.py: one std::thread per CUDA thread,
  std::barrier for ``__syncthreads`` and the shuffles that hand a sample's
  filter values to a pixel's other lanes at K = 7 and 9), its launches and
  its dynamic shared memory rewritten for the emulation, loaded through
  ctypes and bound by
  the wrapper's own ``bind``. The block and the band scratch are
  prefilled with NaN, so that a block pixel that no pass wrote shows, and
  two runs must be bit-identical.

Shapes that are no multiple of a tile (37 x 11, smaller than a tile, one
tile exactly), spp of 1, 3 and 48 (render/integrator.py takes any divisor
of spp as a pass), every filter type, and every K from 1 to 9.
"""

import ctypes
import math
import re
import shutil
import subprocess

import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import build
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.ops import splat as sp
from mitsuba2_tpu_torch.render.film import border
from tests.test_torch_loop_emulated import EMU_HEADER
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_persistent import struct_fields

_on_cpu = cpu_device_fixture()

SEED, SAMPLE_BASE = 6, 48
# (filter dict, K): every filter type, and each K from 1 to 9
FILTERS = [
    ({"type": "box"}, 1),
    ({"type": "tent"}, 3),
    ({"type": "gaussian"}, 5),
    ({"type": "mitchell"}, 5),
    ({"type": "catmullrom"}, 5),
    ({"type": "lanczos"}, 7),
    ({"type": "gaussian", "stddev": 1.125}, 9),
    ({"type": "lanczos", "lobes": 4}, 9),
    ({"type": "tent", "radius": 4.5}, 9),
]
SIGNED = ("mitchell", "catmullrom", "lanczos")
FILTER_IDS = [f"{d['type']}-K{k}" for d, k in FILTERS]
# (width, height, spp): no multiple of a tile, in three pass sizes
SHAPES = [(37, 11, 1), (37, 11, 3), (37, 11, 48)]


def tile_geometry():
    """{b: (TX, TY, G)} of the kernel's ``Tile<b>`` specialisations."""
    src = (build.CSRC / "splat_kernel.cu").read_text()
    geo = {int(m.group(1)): tuple(int(g) for g in m.groups()[1:4])
           for m in re.finditer(
               r"struct Tile<(\d)> \{\s*static constexpr int TX = (\d+), "
               r"TY = (\d+), G = (\d+), MINB = \d+; \};", src)}
    assert sorted(geo) == list(range(sp.MAX_TAPS // 2 + 1)), geo
    return geo


def filter_of(d):
    mt.set_variant("scalar_rgb")
    return mt.load_dict(dict(d))


def lanes(width, height, spp):
    g = torch.Generator().manual_seed(width * 1000 + height * 10 + spp)
    return torch.rand(3, width * height * spp, generator=g)


def assert_within_bar(got, want, signed):
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all()), "a block pixel was not written"
    err = (got - want).abs()
    atol = 1e-6 * (float(want.abs().max()) if signed else 1.0)
    ok = (err <= 1e-5 * want.abs()) | (err <= atol)
    assert bool(ok.all()), (float(err.max()),
                            float((err / want.abs().clamp(min=1e-30)).max()))


def tiled_order(rgb, seed, sample_base, spp, width, height, rfilter):
    """The block in the tiled kernel's order of sums (module docstring)."""
    b = border(rfilter)
    K = 2 * b + 1
    TX, TY, _ = tile_geometry()[b]
    n = width * height * spp
    key, _ = pk.lane_keys(seed, sample_base, spp, torch.arange(n))
    jx, jy = pk._rng2(key, 0)
    offs = [(k - b) + 0.5 for k in range(K)]
    fx = torch.stack([rfilter.eval(o - jx) for o in offs])
    fy = torch.stack([rfilter.eval(o - jy) for o in offs])
    # a thread's registers: per pixel and tap, its samples in order
    v = torch.cat([rgb, torch.ones(1, n)]).reshape(4, width * height, spp)
    fx = fx.reshape(K, width * height, spp)
    fy = fy.reshape(K, width * height, spp)
    acc = torch.zeros(height, width, K, K, 4)
    for s in range(spp):
        u = v[None, :, :, s] * fx[:, None, :, s]         # (tx, c, pixel)
        prod = fy[:, None, None, :, s] * u[None]         # (ty, tx, c, pixel)
        acc += prod.permute(3, 0, 1, 2).reshape(height, width, K, K, 4)
    # each tile's output in K^2 phases, then the tiles in row-major order:
    # a pixel one tile owns is its value, a shared one the sum of the
    # partials from zero, tile rows then columns
    block = torch.zeros(height + 2 * b, width + 2 * b, 4)
    for y0 in range(0, height, TY):
        for x0 in range(0, width, TX):
            h, w = min(TY, height - y0), min(TX, width - x0)
            tile = torch.zeros(TY + 2 * b, TX + 2 * b, 4)
            for ty in range(K):
                for tx in range(K):
                    tile[ty:ty + h, tx:tx + w] += \
                        acc[y0:y0 + h, x0:x0 + w, ty, tx]
            block[y0:y0 + h + 2 * b, x0:x0 + w + 2 * b] += \
                tile[:h + 2 * b, :w + 2 * b]
    return block


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("fdict, k", FILTERS, ids=FILTER_IDS)
def test_tiled_order_matches_plain_version(fdict, k, shape):
    rf = filter_of(fdict)
    assert 2 * border(rf) + 1 == k
    w, h, spp = shape
    rgb = lanes(w, h, spp)
    got = tiled_order(rgb, SEED, SAMPLE_BASE, spp, w, h, rf)
    want = sp.splat_reference(rgb, SEED, SAMPLE_BASE, spp, w, h, rf)
    assert_within_bar(got, want, fdict["type"] in SIGNED)


# CUDA's fast exponential and division, which EMU_HEADER lacks: the host's
# exact ones stand in (the card's are within 2 ulp, PERF.md section 6)
FAST_MATH = r"""
#include <cmath>
inline float __expf(float x) { return std::exp(x); }
inline float __fdividef(float a, float b) { return a / b; }
"""


def emulated_source():
    """csrc/splat_kernel.cu with its two launches and its dynamic shared
    memory rewritten for the emulation."""
    src = FAST_MATH + (build.CSRC / "splat_kernel.cu").read_text()
    counts = []
    for pattern, repl in (
            (r"(splat_tile<B, F>)<<<([^>]*)>>>\((\w+)\)",
             r"emu_launch(\1, \2, \3)"),
            (r"(splat_bands<B>)<<<([^>]*)>>>\((\w+)\)",
             r"emu_launch(\1, \2, \3)"),
            (r"extern __shared__ float4 s_mem\[\];",
             "float4* s_mem = (float4*)emu->dyn.data();")):
        src, n = re.subn(pattern, repl, src)
        counts.append(n)
    assert counts == [1, 1, 1], counts
    return src


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """(splat_render, splat_band_floats) of the emulated library."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("the emulation needs g++ (the BVH builder's compiler)")
    d = tmp_path_factory.mktemp("emulated_splat_kernel")
    (d / "cuda_runtime.h").write_text(EMU_HEADER)
    (d / "splat_kernel.cpp").write_text(emulated_source())
    out = d / "splat_kernel.so"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", "-w", f"-I{d}", f"-I{build.CSRC}", "-DEMU_SMS=1",
         "-DEMU_BLOCKS=1", "-o", str(out), str(d / "splat_kernel.cpp")],
        check=True, capture_output=True)
    return sp.bind(ctypes.CDLL(str(out)))


def run_emulated(fns, rgb, spp, width, height, rfilter, pixel_base=0):
    """The emulated kernel's block, block and bands prefilled with NaN;
    ``height`` rows whose first is the film's pixel ``pixel_base``."""
    render, band_floats = fns
    b = border(rfilter)
    fid, params = rfilter.kernel_params()
    out = torch.full((height + 2 * b, width + 2 * b, 4), float("nan"))
    bands = torch.full((band_floats(b, width, height),), float("nan"))
    args = sp._SplatArgs(rgb.data_ptr(), bands.data_ptr(), out.data_ptr(),
                         (ctypes.c_float * sp.MAX_PARAMS)(*params), SEED,
                         SAMPLE_BASE, fid, b, spp, width, height,
                         pixel_base)
    assert render(ctypes.byref(args), None) == 0
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("fdict, k", FILTERS, ids=FILTER_IDS)
def test_emulated_kernel_matches_plain_version(emulated, fdict, k, shape):
    rf = filter_of(fdict)
    w, h, spp = shape
    rgb = lanes(w, h, spp)
    got = run_emulated(emulated, rgb, spp, w, h, rf)
    want = sp.splat_reference(rgb, SEED, SAMPLE_BASE, spp, w, h, rf)
    assert_within_bar(got, want, fdict["type"] in SIGNED)
    assert torch.equal(got, run_emulated(emulated, rgb, spp, w, h, rf))


@pytest.mark.parametrize("shape", [(16, 8, 4), (5, 3, 2), (33, 17, 2)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("fdict, k", [FILTERS[2], FILTERS[5], FILTERS[6]],
                         ids=[FILTER_IDS[2], FILTER_IDS[5], FILTER_IDS[6]])
def test_emulated_kernel_at_tile_edges(emulated, fdict, k, shape):
    """One tile exactly, less than a tile, and one pixel past two tiles
    in each direction."""
    rf = filter_of(fdict)
    w, h, spp = shape
    rgb = lanes(w, h, spp)
    want = sp.splat_reference(rgb, SEED, SAMPLE_BASE, spp, w, h, rf)
    assert_within_bar(run_emulated(emulated, rgb, spp, w, h, rf), want,
                      fdict["type"] in SIGNED)
    assert_within_bar(tiled_order(rgb, SEED, SAMPLE_BASE, spp, w, h, rf),
                      want, fdict["type"] in SIGNED)


@pytest.mark.parametrize("fdict, k", [FILTERS[0], FILTERS[2], FILTERS[5]],
                         ids=[FILTER_IDS[0], FILTER_IDS[2], FILTER_IDS[5]])
def test_emulated_band_matches_plain_version(emulated, fdict, k):
    """A band of film rows (``pixel_base``, parallel/mesh.py's pixel
    axis): its lanes' jitter keyed on their film pixels, its block the
    plain version's band block."""
    rf = filter_of(fdict)
    w, h, spp, row0, n_rows = 19, 13, 4, 5, 6
    rgb = lanes(w, n_rows, spp)
    got = run_emulated(emulated, rgb, spp, w, n_rows, rf, row0 * w)
    want = sp.splat_reference(rgb, SEED, SAMPLE_BASE, spp, w, h, rf,
                              row0=row0, n_rows=n_rows)
    assert_within_bar(got, want, fdict["type"] in SIGNED)


def test_band_scratch_is_a_footprint_a_tile(emulated):
    """``splat_band_floats``: per tile its (TY + 2b) x (TX + 2b) x 4
    footprint, some 2 MB at the main path's 256 x 256 under K = 5, where
    the parent's tap scratch was (w h, K^2 x 4); -1 past the widest
    stencil."""
    _, band_floats = emulated
    for b, (tx, ty, _) in tile_geometry().items():
        for w, h in ((256, 256), (37, 11)):
            tiles = math.ceil(w / tx) * math.ceil(h / ty)
            assert band_floats(b, w, h) == \
                tiles * (tx + 2 * b) * (ty + 2 * b) * 4
    assert band_floats(2, 256, 256) * 4 < 2.1e6
    assert band_floats(2, 256, 256) < 256 * 256 * 25 * 4 / 12
    assert band_floats(sp.MAX_TAPS // 2 + 1, 8, 8) == -1


def test_splat_args_match_the_kernel_struct():
    src = (build.CSRC / "splat_kernel.cu").read_text()
    assert struct_fields(src, "SplatArgs") == sp._SplatArgs._fields_
