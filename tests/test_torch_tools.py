"""The port's tooling against the JAX package's: Bitmap conversions and
quantization (utils/bitmap.py), the spiral's block order
(render/spiral.py), stream bytes (core/stream.py), the viewer's tonemap
and HTML page (viewer.py), the chi^2 harness's tables and the port's
BSDFs and phase functions under it (python/chi2.py, render/testutil.py),
and the plugin reference's registry (tools/plugin_docs.py). All on the
CPU; the JAX package is imported inside the tests.

Tolerance. Spiral windows, stream bytes, quantized bitmaps, 8-bit files
and the page's payload are bit for bit, and so are Bitmap conversions and
the tonemap off the sRGB curve. Through the curve they agree within 2e-5
absolute (SRGB_TOL): the JAX package's float32 power is XLA's, which
differs from numpy's in the last bit on about a fifth of the inputs; the
XYZ matrices (row sums of magnitudes up to about 5) carry that ulp of
values up to 1.9 into their products, and the curve's slope of 12.92 near
black multiplies it again (2.4e-7 x 5 x 12.92 = 1.5e-5). The
chi^2 tables: both harnesses draw the same points (the counter-based
streams), which the two packages' BSDFs map within float rounding, so at
most 0.2% of the samples land in another bin, and the pdf tables agree
within 1e-4 relative. The chi^2 tests run as
tests/test_bsdf.py runs them (80,000 samples, 21 rows, Sidak-corrected
over 30 tests at 1%).
"""

import gzip
import base64
import json
import zlib

import numpy as np
import pytest
import torch

from mitsuba2_tpu_torch.core import stream as st
from mitsuba2_tpu_torch.python.chi2 import (ChiSquareTest, LineDomain,
                                            PlanarDomain, SphericalDomain,
                                            BSDFAdapter,
                                            PhaseFunctionAdapter)
from mitsuba2_tpu_torch.render.spiral import Spiral
from mitsuba2_tpu_torch.utils.bitmap import PIXEL_FORMATS, Bitmap
from mitsuba2_tpu_torch import viewer

SAMPLES, RES = 80000, 21
SRGB_TOL = dict(rtol=0.0, atol=2e-5)


def pixels(channels, seed=0, h=7, w=9):
    return np.random.default_rng(seed).uniform(
        -0.1, 1.3, (h, w, channels)).astype(np.float32)


SOURCES = [("y", 1), ("ya", 2), ("rgb", 3), ("rgba", 4), ("xyz", 3),
           ("xyza", 4)]


@pytest.mark.parametrize("src, ch", SOURCES, ids=[s for s, _ in SOURCES])
def test_bitmap_convert_is_the_jax_packages(src, ch):
    from mitsuba2_tpu.utils.bitmap import Bitmap as BJ
    data = pixels(ch)
    for gamma_in in (False, True):
        a, b = Bitmap(data, src, gamma_in), BJ(data, src, gamma_in)
        for fmt in PIXEL_FORMATS:
            for gamma in (False, True):
                for pre in (None, True):
                    got = a.convert(fmt, gamma, pre)
                    want = b.convert(fmt, gamma, pre)
                    assert got.pixel_format == want.pixel_format == fmt
                    if gamma_in or gamma:
                        np.testing.assert_allclose(got.data, want.data,
                                                   **SRGB_TOL)
                    else:
                        np.testing.assert_array_equal(got.data, want.data)
    with pytest.raises(ValueError, match="unknown pixel format"):
        Bitmap(data, src).convert("hsv")


def test_bitmap_quantize_is_the_jax_packages():
    from mitsuba2_tpu.utils.bitmap import Bitmap as BJ
    data = pixels(3, 1, 300, 270)
    for dither in (True, False):
        got = Bitmap(data).quantize(dither)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, BJ(data).quantize(dither))


def test_bitmap_write_and_read(tmp_path):
    """An 8-bit file is the JAX package's byte for byte; EXR and PFM read
    back as written; ``write_async`` writes the same file."""
    from mitsuba2_tpu.utils.bitmap import Bitmap as BJ
    data = pixels(3, 2)
    Bitmap(data).write(str(tmp_path / "a.png"))
    BJ(data).write(str(tmp_path / "b.png"))
    assert (tmp_path / "a.png").read_bytes() == \
        (tmp_path / "b.png").read_bytes()
    Bitmap(data, "xyz").write_async(str(tmp_path / "c.png")).join()
    BJ(data, "xyz").write(str(tmp_path / "d.png"))
    assert (tmp_path / "c.png").read_bytes() == \
        (tmp_path / "d.png").read_bytes()
    Bitmap(data).write(str(tmp_path / "e.pfm"))
    np.testing.assert_array_equal(Bitmap.read(str(tmp_path / "e.pfm")).data,
                                  data)
    back = Bitmap.read(str(tmp_path / "a.png"))
    assert back.size() == (9, 7) and back.pixel_format == "rgb"
    with pytest.raises(ValueError, match="unsupported image format"):
        Bitmap(data).write(str(tmp_path / "x.tiff"))


@pytest.mark.parametrize("size, block", [((100, 60), 32), ((7, 9), 2),
                                         ((256, 256), 64), ((1, 1), 8)])
def test_spiral_order_is_the_jax_packages(size, block):
    from mitsuba2_tpu.render.spiral import Spiral as SJ
    got, want = list(Spiral(size, block)), list(SJ(size, block))
    assert got == want
    assert len(got) == Spiral(size, block).block_count
    assert sum(w * h for _, (w, h) in got) == size[0] * size[1]


def write_record(s):
    s.write_u8(7)
    s.write_u16(65000)
    s.write_u32(4000000000)
    s.write_u64(2 ** 60 + 3)
    s.write_i32(-5)
    s.write_i64(-2 ** 40)
    s.write_f32(1.5)
    s.write_f64(-2.25)
    s.write_string("mesh ü")
    s.write_array(np.arange(6, dtype=np.float32))


def test_stream_bytes_are_the_jax_packages(tmp_path):
    from mitsuba2_tpu.core import stream as sj
    a, b = st.MemoryStream(), sj.MemoryStream()
    write_record(a)
    write_record(b)
    assert a.raw() == b.raw() and a.size() == len(a.raw())
    a.seek(0)
    assert (a.read_u8(), a.read_u16(), a.read_u32(), a.read_u64(),
            a.read_i32(), a.read_i64(), a.read_f32(), a.read_f64(),
            a.read_string()) == (7, 65000, 4000000000, 2 ** 60 + 3, -5,
                                 -2 ** 40, 1.5, -2.25, "mesh ü")
    np.testing.assert_array_equal(a.read_array(np.float32, 6), np.arange(6))
    # deflated into a file, as a .serialized payload
    for mod, name in ((st, "a.z"), (sj, "b.z")):
        f = mod.FStream(str(tmp_path / name), "wb")
        z = mod.ZStream(f, "w")
        write_record(z)
        z.close()
        f.close()
    raw = (tmp_path / "a.z").read_bytes()
    assert raw == (tmp_path / "b.z").read_bytes()
    assert zlib.decompress(raw) == b.raw()
    f = st.FStream(str(tmp_path / "a.z"))
    assert f.size() == len(raw)
    z = st.ZStream(f)
    assert z.read(len(b.raw())) == b.raw()
    d = st.DummyStream()
    write_record(d)
    assert d.size() == len(b.raw())
    with pytest.raises(IOError):
        z.seek(0)


def test_tonemap_and_html_are_the_jax_packages():
    """The tonemap as the JAX package's; the HTML page's template, layer
    table and float16 planes the JAX page's (its gzip header carries the
    time of day, the port's a zero time stamp)."""
    from mitsuba2_tpu import viewer as vj
    img = pixels(9, 3) * 4.0
    names = ["R", "G", "B", "albedo.R", "albedo.G", "albedo.B", "depth.Y",
             "nn.X", "nn.Y"]
    for exposure in (0.0, 1.5, -2.0):
        np.testing.assert_array_equal(viewer.tonemap(img, exposure, False),
                                      vj.tonemap(img, exposure, False))
        np.testing.assert_allclose(viewer.tonemap(img, exposure),
                                   vj.tonemap(img, exposure), **SRGB_TOL)

    def parts(html):
        head, rest = html.split("const META = ", 1)
        meta, rest = rest.split(";\nconst B64 = \"", 1)
        b64, tail = rest.split("\";", 1)
        return head, json.loads(meta), gzip.decompress(
            base64.b64decode(b64)), tail

    for c, nm in ((3, None), (9, names)):
        got, want = parts(viewer.make_html(img[..., :c], nm)), \
            parts(vj.make_html(img[..., :c], nm))
        assert got == want
    assert viewer.make_html(img, names) == viewer.make_html(img, names)
    assert set(parts(viewer.make_html(img, names))[1]["layers"]) == {
        "rgb", "albedo", "depth", "nn"}


def test_viewer_writes_png_and_html(tmp_path, capsys):
    from mitsuba2_tpu_torch.utils.io_image import write_image
    exr = tmp_path / "out.exr"
    write_image(str(exr), pixels(3, 4))
    viewer.main([str(exr), "-o", str(tmp_path / "p.png"), "--html",
                 str(tmp_path / "v.html"), "--exposure", "0.5"])
    assert (tmp_path / "p.png").read_bytes()[:4] == b"\x89PNG"
    assert "const META" in (tmp_path / "v.html").read_text()
    viewer.main([str(exr)])
    assert "9x7 x3ch" in capsys.readouterr().out


def jax_tables(bsdf_type, extra, wi, seed):
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.python import chi2 as cj
    mj.set_variant("scalar_rgb")
    sample_func, pdf_func = cj.BSDFAdapter(bsdf_type, extra, wi=wi)
    test = cj.ChiSquareTest(cj.SphericalDomain(), sample_func, pdf_func,
                            sample_dim=3, sample_count=SAMPLES, res=RES,
                            ires=16, seed=seed)
    return test.tabulate_histogram(), test.tabulate_pdf()


@pytest.mark.parametrize("bsdf_type, extra, wi", [
    ("diffuse", {"reflectance": 0.7}, (0.3, 0.3, 0.9)),
    ("roughconductor", {"material": "Au", "alpha": 0.4,
                        "distribution": "ggx"}, (0.5, 0.0, 0.866))],
    ids=["diffuse", "roughconductor"])
def test_chi2_tables_are_the_jax_harnesses(bsdf_type, extra, wi):
    import mitsuba2_tpu_torch as mt
    mt.set_variant("scalar_rgb")
    want_hist, want_pdf = jax_tables(bsdf_type, extra, wi, seed=4)
    sample_func, pdf_func = BSDFAdapter(bsdf_type, extra, wi=wi)
    test = ChiSquareTest(SphericalDomain(), sample_func, pdf_func,
                         sample_dim=3, sample_count=SAMPLES, res=RES,
                         ires=16, seed=4)
    hist, pdf = test.tabulate_histogram(), test.tabulate_pdf()
    assert hist.shape == want_hist.shape == (22, 44)
    assert hist.sum() == want_hist.sum()
    assert np.abs(hist - want_hist).sum() <= 2e-3 * SAMPLES
    np.testing.assert_allclose(pdf, want_pdf, rtol=1e-4, atol=1e-6)


CHI2_CASES = [
    ("diffuse", {"reflectance": 0.7}, (0.3, 0.3, 0.9)),
    ("roughconductor", {"material": "Au", "alpha": 0.1,
                        "distribution": "ggx"}, (0.5, 0.0, 0.866)),
    ("roughconductor", {"material": "Au", "alpha": 0.4,
                        "distribution": "beckmann"}, (0.5, 0.0, 0.866)),
    ("roughconductor", {"material": "Cu", "alpha_u": 0.1, "alpha_v": 0.4,
                        "distribution": "ggx"}, (0.4, -0.3, 0.86)),
    ("roughdielectric", {"alpha": 0.3, "distribution": "ggx"},
     (0.3, 0.0, 0.954)),
    ("roughdielectric", {"alpha": 0.35, "distribution": "ggx"},
     (0.3, 0.1, -0.95)),
    ("plastic", {"diffuse_reflectance": 0.5}, (0.4, 0.0, 0.917)),
    ("roughplastic", {"diffuse_reflectance": 0.5, "alpha": 0.3,
                      "distribution": "ggx"}, (0.4, 0.0, 0.917)),
    ("blendbsdf", {"weight": 0.4,
                   "a": {"type": "diffuse", "reflectance": 0.9},
                   "b": {"type": "roughconductor", "alpha": 0.3,
                         "material": "Au", "distribution": "ggx"}},
     (0.2, 0.1, 0.97)),
    ("twosided", {"a": {"type": "diffuse", "reflectance": 0.8}},
     (0.3, 0.3, -0.9)),
    ("normalmap", {"a": {"type": "diffuse", "reflectance": 0.8},
                   "normal": {"type": "srgb", "color": [0.55, 0.5, 0.85]}},
     (0.1, 0.2, 0.97)),
]
CHI2_IDS = ["diffuse", "roughconductor_ggx", "roughconductor_beckmann",
            "roughconductor_anisotropic", "roughdielectric",
            "roughdielectric_inside", "plastic", "roughplastic", "blend",
            "twosided_back", "normalmap"]


@pytest.mark.parametrize("bsdf_type, extra, wi", CHI2_CASES, ids=CHI2_IDS)
def test_port_bsdfs_pass_chi2(bsdf_type, extra, wi):
    import mitsuba2_tpu_torch as mt
    mt.set_variant("scalar_rgb")
    sample_func, pdf_func = BSDFAdapter(bsdf_type, extra, wi=wi)
    test = ChiSquareTest(SphericalDomain(), sample_func, pdf_func,
                         sample_dim=3, sample_count=SAMPLES, res=RES,
                         ires=16, seed=0)
    assert test.run(0.01, test_count=30), test.messages


@pytest.mark.parametrize("phase_type, extra", [("hg", {"g": 0.6}),
                                               ("isotropic", {})])
def test_port_phase_functions_pass_chi2(phase_type, extra):
    import mitsuba2_tpu_torch as mt
    mt.set_variant("scalar_rgb")
    sample_func, pdf_func = PhaseFunctionAdapter(phase_type, extra,
                                                 wi=(0, 0, 1))
    test = ChiSquareTest(SphericalDomain(), sample_func, pdf_func,
                         sample_dim=2, sample_count=SAMPLES, res=RES,
                         ires=8, seed=1)
    assert test.run(0.01, test_count=30), test.messages


def test_chi2_rejects_a_wrong_pdf():
    """The harness fails a sampler against a pdf it does not draw from."""
    import mitsuba2_tpu_torch as mt
    mt.set_variant("scalar_rgb")
    sample_func, _ = BSDFAdapter("diffuse", {}, wi=(0, 0, 1))
    _, wrong = PhaseFunctionAdapter("isotropic", {})
    test = ChiSquareTest(SphericalDomain(), sample_func, wrong, sample_dim=3,
                         sample_count=SAMPLES, res=RES, ires=8)
    assert not test.run(0.01) and "rejected" in test.messages


def test_planar_and_line_domains():
    """A uniform square passes on the planar domain; the line domain's
    maps embed a segment as the x axis, as the JAX package's do."""
    from mitsuba2_tpu.python.chi2 import LineDomain as LJ
    test = ChiSquareTest(PlanarDomain(), lambda u: u * 2.0 - 1.0,
                         lambda p: torch.full(p.shape[:-1], 0.25),
                         sample_count=20000, res=11)
    assert test.run(0.01), test.messages
    line = LineDomain((0.0, 2.0))
    assert line.bounds() == LJ((0.0, 2.0)).bounds() == ((0.0, 2.0),
                                                        (-0.5, 0.5))
    xy = line.map_backward(torch.tensor([0.5, 1.5]))
    assert torch.equal(xy, torch.tensor([[0.5, 0.0], [1.5, 0.0]]))
    np.testing.assert_array_equal(
        xy.numpy(), np.asarray(LJ().map_backward(np.asarray([0.5, 1.5]))))
    assert torch.equal(line.map_forward(xy), torch.tensor([0.5, 1.5]))


def test_plugin_docs_registry_is_the_jax_generators(tmp_path):
    """The port registers every plugin the JAX generator lists, category
    by category; the page goes where the caller says."""
    from mitsuba2_tpu.core.object import _REGISTRY, _ensure_loaded
    from mitsuba2_tpu_torch.tools import plugin_docs
    _ensure_loaded()
    want = {}
    for cat, name in sorted(_REGISTRY):
        want.setdefault(cat, []).append(name)
    got = {cat: [n for n, _ in v]
           for cat, v in plugin_docs.registry().items()}
    assert got == want
    out = tmp_path / "sub" / "plugins.md"
    plugin_docs.main([str(out)])
    text = out.read_text()
    assert "## bsdfs" in text and "### `roughconductor`" in text
