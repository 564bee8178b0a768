"""The matpreview slice's modules against their JAX counterparts on the
same seeded numpy inputs: the EXR codec, conductor Fresnel and its IOR
table, the GGX distribution, the checkerboard texture, the sphere shape's
parameters, the envmap plugin, and the scene gate's new cases.

Tolerances: the codec is bit-exact both ways. Float32 math on both sides
agrees to a few ulps (XLA and torch round rsqrt, sqrt and the
transcendentals on their own), so functions are held at 2e-6 relative;
the sampled normals, which chain a dozen such operations, at 5e-5
absolute."""

import os

import numpy as np
import pytest
import torch

import mitsuba2_tpu as mj
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import path_kernel as pk
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()

RNG = np.random.default_rng(20261016)


@pytest.mark.parametrize("half", [True, False])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_exr_round_trips_bit_exact_across_packages(tmp_path, half,
                                                   channels):
    from mitsuba2_tpu.utils.io_exr import read_exr as read_j, \
        write_exr as write_j
    from mitsuba2_tpu_torch.utils.io_exr import read_exr as read_t, \
        write_exr as write_t
    img = (RNG.standard_normal((37, 21, channels)) * 50).astype(np.float32)
    mine, theirs = str(tmp_path / "t.exr"), str(tmp_path / "j.exr")
    write_t(mine, img, half=half)
    write_j(theirs, img, half=half)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for path in (mine, theirs):
        got_t, names_t = read_t(path)
        got_j, names_j = read_j(path)
        assert names_t == names_j
        np.testing.assert_array_equal(got_t, got_j)
    want = img.astype(np.float16).astype(np.float32) if half else img
    np.testing.assert_array_equal(read_t(mine)[0], want)


def test_read_image_reads_exr_and_names_other_formats(tmp_path,
                                                     monkeypatch):
    """EXR reads as written; an 8-bit PNG reads through PIL, decoded from
    sRGB as the JAX package decodes it, and without PIL the error names
    the missing package."""
    import sys
    from PIL import Image
    from mitsuba2_tpu.utils.io_image import read_image as read_j
    from mitsuba2_tpu_torch.utils.io_exr import write_exr
    from mitsuba2_tpu_torch.utils.io_image import read_image
    img = RNG.random((4, 5, 3)).astype(np.float32)
    path = str(tmp_path / "a.exr")
    write_exr(path, img, half=False)
    np.testing.assert_array_equal(read_image(path), img)
    png = str(tmp_path / "a.png")
    Image.fromarray((img * 255).astype(np.uint8)).save(png)
    np.testing.assert_allclose(read_image(png), read_j(png), rtol=2e-6,
                               atol=1e-7)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        read_image(png)


def test_fresnel_conductor_and_ior_table():
    from mitsuba2_tpu.render import fresnel as fj
    from mitsuba2_tpu_torch.render import fresnel as ft
    cos = RNG.random(4096).astype(np.float32)
    eta = (RNG.random(4096) * 4).astype(np.float32)
    k = (RNG.random(4096) * 8).astype(np.float32)
    got = ft.fresnel_conductor(*(torch.from_numpy(x) for x in (cos, eta, k)))
    want = np.asarray(fj.fresnel_conductor(cos, eta, k))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-7)
    assert ft.CONDUCTOR_IOR_RGB == fj.CONDUCTOR_IOR_RGB
    assert ft.lookup_conductor_ior("Au") == fj.lookup_conductor_ior("Au")
    with pytest.raises(ValueError, match="unknown conductor"):
        ft.lookup_conductor_ior("unobtainium")


def _hemisphere(n):
    v = RNG.standard_normal((n, 3))
    v[:, 2] = np.abs(v[:, 2]) + 0.05
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("alphas", [(0.1, 0.1), (0.3, 0.3), (0.05, 0.4)])
def test_ggx_distribution(alphas):
    import jax.numpy as jnp
    from mitsuba2_tpu.render.microfacet import MicrofacetDistribution as DJ
    from mitsuba2_tpu_torch.render.microfacet import \
        MicrofacetDistribution as DT
    au, av = alphas
    dj = DJ("ggx", jnp.float32(au), jnp.float32(av), True)
    dt = DT(au, av)
    wi, mh = _hemisphere(2048), _hemisphere(2048)
    u = RNG.random((2048, 2)).astype(np.float32)
    twi, tmh = torch.from_numpy(wi), torch.from_numpy(mh)

    def close(a, b, rtol=2e-6):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=1e-6)

    close(dt.eval(tmh), dj.eval(mh))
    close(dt.smith_g1(twi, tmh), dj.smith_g1(wi, mh))
    close(dt.G(twi, twi * torch.tensor([-1.0, -1.0, 1.0]), tmh),
          dj.G(wi, wi * np.float32([-1, -1, 1]), mh))
    close(dt.pdf(twi, tmh), dj.pdf(wi, mh))
    m_t, pdf_t = dt.sample(twi, torch.from_numpy(u[:, 0]),
                           torch.from_numpy(u[:, 1]))
    m_j, pdf_j = dj.sample(wi, u)
    # unit vectors, held absolutely: near the rim sqrt(1 - p1^2) turns an
    # ulp of p1 into ~1e-5
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=0,
                               atol=5e-5)
    # the sample's pdf is the visible-normal density at the sampled normal
    assert torch.equal(pdf_t, dt.pdf(twi, m_t))
    close(dt.pdf(twi, torch.tensor(np.array(m_j))), pdf_j, rtol=2e-5)
    assert (torch.sum(m_t * twi, -1) > 0).all()     # visible normals


def test_checkerboard_eval():
    from types import SimpleNamespace
    import jax.numpy as jnp
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    d = {"type": "checkerboard",
         "color0": {"type": "rgb", "value": [0.1, 0.2, 0.3]},
         "color1": {"type": "rgb", "value": 0.7}}
    uv = (RNG.random((4096, 2)) * 6 - 3).astype(np.float32)
    for to_uv in (None, "scale", "rotate"):
        dj, dt = dict(d), dict(d)
        if to_uv == "scale":
            dj["to_uv"] = mj.Transform.scale([8, 8, 1])
            dt["to_uv"] = mt.Transform.scale([8, 8, 1])
        elif to_uv == "rotate":
            dj["to_uv"] = mj.Transform.translate([0.3, -0.2, 0]) \
                @ mj.Transform.rotate([0, 0, 1], 30)
            dt["to_uv"] = mt.Transform.translate([0.3, -0.2, 0]) \
                @ mt.Transform.rotate([0, 0, 1], 30)
        tj, tt = mj.load_dict(dj), mt.load_dict(dt)
        si = SimpleNamespace(uv=jnp.asarray(uv), t=jnp.zeros(len(uv)),
                             wavelengths=None)
        np.testing.assert_array_equal(tt.eval(torch.from_numpy(uv)).numpy(),
                                      np.asarray(tj.eval(si)))
    assert tt.mean() == pytest.approx(tj.mean())


@pytest.mark.parametrize("case", ["plain", "uniform", "nonuniform",
                                  "emitter", "flip"])
def test_sphere_parameters(case):
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")

    def make(pkg):
        d = {"type": "sphere", "center": [0.5, -1.0, 2.0], "radius": 0.7}
        T = pkg.Transform
        if case == "uniform":
            d["to_world"] = T.translate([1, 2, 3]) @ T.rotate([1, 1, 0], 40) \
                @ T.scale(1.5)
        elif case == "nonuniform":
            d["to_world"] = T.scale([1.0, 2.0, 0.5])
        elif case == "emitter":
            d["emitter"] = {"type": "area",
                            "radiance": {"type": "rgb", "value": 2.0}}
        elif case == "flip":
            d["flip_normals"] = True
        return pkg.load_dict(d)

    sj, st = make(mj), make(mt)
    np.testing.assert_allclose(st.center, sj.center, rtol=1e-6)
    assert st.radius == pytest.approx(sj.radius, rel=1e-6)
    assert st.flip_normals == sj.flip_normals
    [ej] = sj.expand()
    [et] = st.expand()
    if case in ("nonuniform", "emitter"):
        # tessellated into the reference's mesh, which rides the triangle
        # tables
        assert et.is_mesh() and ej.is_mesh()
        np.testing.assert_allclose(et.vertices, ej.vertices, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(et.faces, ej.faces)
        if case == "emitter":
            assert et.emitter is st.emitter and et.emitter.shape is et
    else:
        assert et is st and et.is_analytic()
        lo, hi = st.bbox()
        np.testing.assert_allclose(hi - lo, 2 * st.radius, rtol=1e-6)


def test_envmap_plugin_scale_and_rotation():
    from mitsuba2_tpu_torch.python.test.scenes import _sky_exr_path
    mt.set_variant("scalar_rgb")
    path = _sky_exr_path()
    assert os.path.basename(path) == "mitsuba2_tpu_torch_sky_v1.exr"
    T = mt.Transform.rotate([0, 1, 0], 90)
    e = mt.load_dict({"type": "envmap", "filename": path, "scale": 2.0,
                      "to_world": T})
    base = mt.load_dict({"type": "envmap", "filename": path})
    assert e.is_environment() and e.res == (128, 64)
    np.testing.assert_array_equal(e.data, base.data * np.float32(2.0))
    scene = mt.load_dict({
        "type": "scene", "env": {"type": "envmap", "filename": path,
                                 "to_world": T},
        "s": {"type": "sphere"}})
    t = scene.tables
    assert t.flags & pk.HAS_ENV_ROT and t.flags & pk.HAS_SPHERES
    np.testing.assert_allclose(t.env_rot[:9].reshape(3, 3).numpy(),
                               np.asarray(T.matrix)[:3, :3], atol=1e-7)


def test_env_sampling_tables_coarsen_a_smooth_sky():
    """A sky with no sharp sun pools into the 64 x 32 grid, as the
    reference's adaptive rule does (megakernel.py:2615-2642)."""
    from mitsuba2_tpu_torch.render.scene import env_sampling_tables
    data = (0.5 + RNG.random((64, 128, 3))).astype(np.float32)
    marg, cond, pmf = env_sampling_tables(data)
    assert pmf.shape == (32, 64) and cond.shape == (32, 64)
    assert pmf.dtype == np.float32
    np.testing.assert_allclose(pmf.sum(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(marg[-1], 1.0, rtol=1e-5)
    np.testing.assert_allclose(cond[:, -1], 1.0, rtol=1e-5)
    assert (np.diff(marg) >= 0).all() and (np.diff(cond, axis=1) >= 0).all()
