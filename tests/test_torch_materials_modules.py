"""The modules of the materials slice against their JAX counterparts on the
same seeded numpy inputs: the reconstruction filters and the image
block's splat, the diffuse Fresnel reflectance, the plastics' derived
parameters, the bitmap texture's payloads in every color mode, PFM and
RGBE reading, the disk and cylinder rows, and the path kernel's tables of
the materials scene against the JAX kernel's.

Tolerances: float32 math on both sides agrees to a few ulps (XLA and torch
round exp, sin and the polynomials on their own), so functions are held at
1e-6; the image codecs and the shape rows, which both packages compute in
the same numpy, exactly."""

import numpy as np
import pytest
import torch

import mitsuba2_tpu as mj
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu.core.transform import Transform as TJ
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.python.test.scenes import cornell_materials_dict
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_spectral import assert_coeff_close

_on_cpu = cpu_device_fixture()

RNG = np.random.default_rng(20261017)

FILTERS = {"box": {}, "tent": {"radius": 1.5}, "gaussian": {},
           "gaussian_wide": {"stddev": 0.8}, "mitchell": {},
           "catmullrom": {}, "lanczos": {}, "lanczos_2": {"lobes": 2}}


def _filter(pkg, name):
    props = dict(FILTERS[name])
    return pkg.load_dict({"type": name.split("_")[0], **props})


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_eval_matches_jax(name):
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    fj, ft = _filter(mj, name), _filter(mt, name)
    assert ft.radius == fj.radius
    x = np.concatenate([np.linspace(-4.0, 4.0, 4001),
                        RNG.uniform(-3.5, 3.5, 1000)]).astype(np.float32)
    got = ft.eval(torch.as_tensor(x)).numpy()
    want = np.asarray(fj.eval(x))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_image_block_put_matches_jax():
    """The per-sample splat through a gaussian's 5x5 stencil, samples on
    and beyond the block's edge included."""
    from mitsuba2_tpu.render.film import ImageBlock as BlockJ
    from mitsuba2_tpu_torch.render.film import ImageBlock as BlockT
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    fj, ft = _filter(mj, "gaussian"), _filter(mt, "gaussian")
    n = 4000
    pos = RNG.uniform(-1.5, [13.5, 9.5], (n, 2)).astype(np.float32)
    vals = RNG.random((n, 3)).astype(np.float32)
    active = RNG.random(n) > 0.1
    bj = BlockJ((12, 8), 3, fj)
    want = np.asarray(bj.put(bj.create(), pos, vals, active=active).data)
    bt = BlockT((12, 8), 3, ft, "cpu")
    got = bt.put(bt.create(), torch.as_tensor(pos), torch.as_tensor(vals),
                 active=torch.as_tensor(active)).numpy()
    assert got.shape == want.shape == (12, 16, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    img = bt.develop(torch.as_tensor(got)).numpy()
    np.testing.assert_allclose(img, np.asarray(bj.develop(
        bj.create()._replace(data=want))), rtol=1e-5, atol=1e-6)


def test_fresnel_diffuse_reflectance_matches_jax():
    from mitsuba2_tpu.render.fresnel import fresnel_diffuse_reflectance as fj
    from mitsuba2_tpu_torch.render.fresnel import \
        fresnel_diffuse_reflectance as ft
    eta = np.concatenate([np.linspace(0.3, 3.0, 500),
                          [1 / 1.49, 1.49, 1 / 1.5046, 1.0]]
                         ).astype(np.float32)
    np.testing.assert_allclose(ft(eta).numpy(), np.asarray(fj(eta)),
                               rtol=1e-6, atol=1e-7)


PLASTICS = {
    "plastic": {"type": "plastic",
                "diffuse_reflectance": {"type": "rgb",
                                        "value": [0.5, 0.2, 0.2]}},
    "plastic_nonlinear": {"type": "plastic", "nonlinear": True,
                          "int_ior": 1.7, "ext_ior": "water",
                          "specular_reflectance": {"type": "rgb",
                                                   "value": 0.6}},
    "roughplastic": {"type": "roughplastic", "distribution": "ggx",
                     "alpha": 0.2,
                     "diffuse_reflectance": {"type": "rgb",
                                             "value": [0.2, 0.4, 0.7]}},
    "roughplastic_beckmann": {"type": "roughplastic", "alpha": 0.3},
}


@pytest.mark.parametrize("name", sorted(PLASTICS))
def test_plastic_parameters_match_jax(name):
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    bj, bt = mj.load_dict(PLASTICS[name]), mt.load_dict(PLASTICS[name])
    for attr in ("eta", "specular_sampling_weight", "fdr_int", "inv_eta_2"):
        np.testing.assert_allclose(getattr(bt, attr), getattr(bj, attr),
                                   rtol=1e-6, err_msg=attr)
    assert bt.nonlinear == bj.nonlinear
    if name.startswith("rough"):
        assert (bt.dist_type, bt.alpha_u, bt.alpha_v, bt.sample_visible) \
            == (bj.dist_type, bj.alpha_u, bj.alpha_v, bj.sample_visible)


@pytest.mark.parametrize("variant", ["scalar_rgb", "scalar_spectral",
                                     "scalar_mono"])
def test_bitmap_payload_matches_jax(variant, tmp_path):
    """Per texel: rgb, the sigmoid coefficients (spectral) or the
    luminance (mono), the values the JAX texture evaluates, at 1e-6; the
    coefficients come from two float32 fits and are held by the
    reflectance they describe (tests/test_torch_spectral.py), at 1e-4. A
    one-channel image repeats to three."""
    from mitsuba2_tpu_torch.utils.io_exr import write_exr
    img = RNG.random((6, 9, 3)).astype(np.float32)
    path = str(tmp_path / "t.exr")
    write_exr(path, img, half=False)
    mj.set_variant(variant)
    mt.set_variant(variant)
    try:
        d = {"type": "bitmap", "filename": path, "raw": True}
        tj, tt = mj.load_dict(d), mt.load_dict(d)
        assert tt.resolution == tj.resolution == (9, 6) and tt.raw
        np.testing.assert_allclose(tt.mean(), tj.mean(), rtol=1e-6)
        data = tj.data
        got = tt.payload.reshape(-1, 3)
        if variant == "scalar_spectral":
            assert_coeff_close(got, np.asarray(data.coeff))
        else:
            want = (np.repeat(np.asarray(data.mono), 3, -1)
                    if variant == "scalar_mono" else np.asarray(data.rgb))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        from mitsuba2_tpu_torch.models.textures import BitmapTexture
        one = BitmapTexture(data=img[..., :1])
        np.testing.assert_array_equal(one.rgb, np.repeat(img[..., :1], 3,
                                                         -1))
    finally:
        mj.set_variant("scalar_rgb")
        mt.set_variant("scalar_rgb")


def test_pfm_round_trips_across_packages(tmp_path):
    from mitsuba2_tpu.utils.io_image import read_pfm as read_j, \
        write_pfm as write_j
    from mitsuba2_tpu_torch.utils.io_image import read_image, read_pfm, \
        write_pfm
    for shape in ((7, 5, 3), (4, 6)):
        img = RNG.standard_normal(shape).astype(np.float32)
        mine, theirs = str(tmp_path / "t.pfm"), str(tmp_path / "j.pfm")
        write_pfm(mine, img)
        write_j(theirs, img)
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
        want = img if img.ndim == 3 else img[..., None]
        np.testing.assert_array_equal(read_pfm(mine), want)
        np.testing.assert_array_equal(read_image(theirs), read_j(theirs))


def _write_rgbe(path, data, rle_rows):
    """A Radiance file of RGBE bytes ``data`` (h, w, 4): the rows in
    ``rle_rows`` run-length encoded (one run, then literals), the others
    flat."""
    h, w, _ = data.shape
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        for y in range(h):
            if y not in rle_rows:
                f.write(data[y].tobytes())
                continue
            f.write(bytes([2, 2, w >> 8, w & 255]))
            for c in range(4):
                row = data[y, :, c]
                f.write(bytes([128 + 3, row[0]]))       # a run of 3
                f.write(bytes([w - 3]) + row[3:].tobytes())


def test_rgbe_reads_like_jax(tmp_path):
    from mitsuba2_tpu.utils.io_image import read_image as read_j
    from mitsuba2_tpu_torch.utils.io_image import read_image
    h, w = 5, 12
    data = RNG.integers(0, 256, (h, w, 4)).astype(np.uint8)
    data[..., 3] = RNG.integers(120, 140, (h, w))
    data[1, :3] = data[1, 0]            # the rle row's run is uniform
    path = str(tmp_path / "t.hdr")
    _write_rgbe(path, data, rle_rows={1, 3})
    data[3, :3] = data[3, 0]
    got = read_image(path)
    np.testing.assert_array_equal(got, read_j(path))
    assert got.shape == (h, w, 3) and got.dtype == np.float32


QUADRICS = {
    "disk": {"type": "disk"},
    "disk_tilted": {"type": "disk", "flip_normals": True,
                    "to_world": TJ.translate([0.3, -0.2, 1.0])
                    @ TJ.rotate([1, 1, 0], 35) @ TJ.scale([0.5, 0.8, 1])},
    "cylinder": {"type": "cylinder"},
    "cylinder_rod": {"type": "cylinder", "radius": 0.1,
                     "p0": [0.05, -0.9, 0.7], "p1": [0.75, -0.9, 0.7],
                     "flip_normals": True},
    "cylinder_moved": {"type": "cylinder", "radius": 0.3,
                       "p0": [0, 0, -1], "p1": [0, 2, 1],
                       "to_world": TJ.rotate([0, 0, 1], 30)
                       @ TJ.translate([1, 0, 0])},
}


def _port_transform(d):
    from mitsuba2_tpu_torch.core.transform import Transform
    d = dict(d)
    if "to_world" in d:
        d["to_world"] = Transform.from_matrix(np.asarray(
            d["to_world"].matrix, np.float32))
    return d


@pytest.mark.parametrize("name", sorted(QUADRICS))
def test_quad_rows_match_jax_quad_table(name):
    """The scene's disk and cylinder row: to_object, to_world, kind,
    radius, length, shape index and flip, exactly the JAX scene's; the
    bounding boxes too."""
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    base = {"type": "scene", "box": {"type": "rectangle"}}
    sj = mj.load_dict({**base, "q": QUADRICS[name]})
    st = mt.load_dict({**base, "q": _port_transform(QUADRICS[name])})
    qj = np.asarray(sj.quad_table)
    assert st.quad_table.shape == (1, 26) and qj.shape[0] == 1
    np.testing.assert_array_equal(st.quad_table[:, :25], qj[:, :25])
    np.testing.assert_array_equal(st.quad_table[:, 25], qj[:, 29])
    for a, b in zip(st.shapes[1].bbox(), sj.shapes[1].bbox()):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    assert st.tables.n_quads == 1 and st.tables.flags & pk.HAS_SPHERES


@pytest.mark.parametrize("kind", ["disk", "cylinder"])
def test_emitting_quadric_is_tessellated_like_jax(kind):
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    d = {"type": "scene",
         "q": {**QUADRICS[f"{kind}_" + ("tilted" if kind == "disk"
                                        else "rod")],
               "emitter": {"type": "area",
                           "radiance": {"type": "rgb", "value": 2.0}}}}
    sj = mj.load_dict(d)
    st = mt.load_dict({"type": "scene", "q": _port_transform(d["q"])})
    assert not st.quad_table.shape[0] and st.tables.n_faces == 64 * (
        1 if kind == "disk" else 2)
    mesh_j = next(s for s in sj.shapes if s.is_mesh())
    np.testing.assert_allclose(st.shapes[0].vertices, mesh_j.vertices,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(st.shapes[0].faces, mesh_j.faces)
    assert st.emitters[0].shape is st.shapes[0]


@pytest.fixture(scope="module")
def reference_tables():
    """The JAX kernel's tables of the materials scene (no render)."""
    from mitsuba2_tpu.ops.megakernel import DiffusePathMegakernel
    from mitsuba2_tpu.python.test.scenes import cornell_box_dict as cj
    mj.set_variant("scalar_rgb")
    d = cornell_materials_dict(8, 8, 2, 3, base=cj(8, 8, 2, 3,
                                                   rfilter="gaussian"),
                               T=TJ)
    mk = DiffusePathMegakernel(mj.load_dict(d), interpret=True)
    tables, _ = pk.tables_from_reference(
        np.asarray(mk.woop), np.asarray(mk._fattr()), np.asarray(mk.lights),
        np.zeros(16, np.float32), sph=np.asarray(mk.sph),
        sattr=np.asarray(mk._sattr()), qd=np.asarray(mk.qd),
        qattr=np.asarray(mk._qattr()), atlas=np.asarray(mk.atlas))
    return tables


def test_materials_tables_match_jax_kernel(reference_tables):
    """Face, quad and light rows, every attribute column (the plastics'
    and dielectric's parameters, texture regions, flips) and the texels
    equal the JAX kernel's, in the same face order."""
    ref = reference_tables
    mt.set_variant("scalar_rgb")
    t = mt.load_dict(cornell_materials_dict(8, 8, 2, 3)).tables
    F = t.n_faces
    assert F == 36 and t.flags & pk.TEMPLATE_FLAGS == \
        pk.HAS_SPHERES | pk.HAS_LOBES
    np.testing.assert_allclose(t.woop.numpy(), ref.woop.numpy()[:F],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t.fattr.numpy(), ref.fattr.numpy()[:F],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(t.qd.numpy(), ref.qd.numpy())
    np.testing.assert_allclose(t.qattr.numpy(), ref.qattr.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(t.tex.numpy(), ref.tex.numpy())
    np.testing.assert_array_equal(t.lights.numpy(), ref.lights.numpy())
    kinds = sorted(set(t.fattr[:, pk.C_KIND].tolist())
                   | set(t.qattr[:, pk.C_KIND].tolist()))
    assert kinds == [pk.KIND_DIFFUSE, pk.KIND_DIELECTRIC, pk.KIND_PLASTIC,
                     pk.KIND_ROUGHPLASTIC, pk.KIND_BITMAP]
    assert t.tex.shape == (2 * 64 * 64, 4)
