"""The spectral path (K1e) on the Cornell box: the port's packed spectral
tables against the JAX package's DiffusePathMegakernel tables, its plain
PyTorch version against the JAX path kernel (Pallas interpret mode) per
pixel, on the reference's own tables and through ``load_dict`` +
``render``, the metameric check against the rgb render, and the CUDA
kernel of each new path against the plain version on the card.

Tolerances. Per pixel, the bar of test_torch_path_kernel.py: at least 99%
of pixels within 1e-4 relative, image means within 1e-5 (both sides draw
the same TEA streams and hero wavelengths). Measured at this size on the
reference's tables: every pixel within 7.7e-5, means 1.5e-6 apart. Table
columns that hold sigmoid coefficients come from two float32 fits
(test_torch_spectrum.py) and are compared by the reflectance they describe
at the 95 CIE wavelengths, within 1e-4; every other column within 1e-6.
The metameric check is the JAX test's own (tests/test_spectral.py): the
spectral image mean within 4% of the rgb one.
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.python.test.scenes import (
    cornell_box_dict as cornell_t, matpreview_dict as mp_t)
from mitsuba2_tpu_torch.render.srgb import srgb_model_eval
from tests.test_torch_matpreview import jax_tables
from tests.test_torch_path_kernel import (
    assert_images_agree, box_develop, cpu_device_fixture)

_on_cpu = cpu_device_fixture()

W, SPP, MAX_DEPTH, RR_DEPTH, SEED = 16, 16, 4, 2, 3
CIE_WL = torch.linspace(360.0, 830.0, 95)
FULL = pk.HAS_SPHERES | pk.HAS_ENV | pk.HAS_GGX | pk.HAS_CHECKER


def jax_reference(variant, scene, exact_math=False):
    """The JAX package's render of the Cornell box or matpreview under
    ``variant`` through its path kernel in interpret mode (the integrator's
    ``_force_megakernel`` test hook) -> (megakernel, (PathTables, camera
    row) of its own tables, image). With ``exact_math`` the kernel's
    polynomial atan2/acos are patched to exact math for the render."""
    import jax.numpy as jnp
    import mitsuba2_tpu as mj
    import mitsuba2_tpu.ops.megakernel as mk_mod
    from mitsuba2_tpu.python.test.scenes import (cornell_box_dict,
                                                 matpreview_dict)
    make = cornell_box_dict if scene == "cornell" else matpreview_dict
    mj.set_variant(variant)
    try:
        d = make(W, W, SPP, MAX_DEPTH)
        d["integrator"]["rr_depth"] = RR_DEPTH
        sj = mj.load_dict(d)
        sj.integrator._force_megakernel = True
        with pytest.MonkeyPatch.context() as mp:
            if exact_math:
                mp.setattr(mk_mod, "_atan2", jnp.arctan2)
                mp.setattr(mk_mod, "_acos",
                           lambda x: jnp.arccos(jnp.clip(x, -1.0, 1.0)))
            img = np.asarray(sj.integrator.render(sj, seed=SEED, spp=SPP))
        assert sj.integrator.last_engine == "megakernel"
        mk = sj.integrator._mk_cache[1]
        return mk, jax_tables(mk, sj.sensors[0]), img
    finally:
        mj.set_variant("scalar_rgb")


def port_scene(variant, scene, width=W, spp=SPP, max_depth=MAX_DEPTH):
    """The port's scene under ``variant``, loaded on the CPU."""
    mt.set_variant(variant)
    make = cornell_t if scene == "cornell" else mp_t
    d = make(width, width, spp, max_depth)
    d["integrator"]["rr_depth"] = RR_DEPTH
    return mt.load_dict(d)


def reflectance(coeff):
    """(..., 3) sigmoid coefficients -> (..., 95) reflectance at the CIE
    wavelengths."""
    return srgb_model_eval(torch.as_tensor(np.asarray(coeff, np.float32)),
                           CIE_WL).numpy()


def assert_coeff_close(a, b):
    err = np.abs(reflectance(a) - reflectance(b)).max()
    assert err <= 1e-4, err


def match_faces(port, ref):
    """Pair the port's faces with the reference's (which are in BVH leaf
    order, padded with never-hit rows) by their Woop rows -> (port index
    order, reference index order)."""
    wt, wj = port.woop.numpy(), ref.woop.numpy()
    real = ~(np.all(wj[:, 8:12] == [0, 0, 0, 1], axis=1)
             & np.all(wj[:, :8] == 0, axis=1))
    idx_j = np.flatnonzero(real)
    dist = np.abs(wt[:, None, :] - wj[None, idx_j, :]).max(-1)
    match = idx_j[dist.argmin(1)]
    assert sorted(match) == sorted(idx_j), "faces must pair one to one"
    assert dist.min(1).max() <= 1e-6
    return np.arange(len(wt)), match


COLOR_COLS = (pk.C_ALB, pk.C_LE, pk.C_C1)


def assert_attr_rows_agree(at, aj, coeff_cols=COLOR_COLS):
    """Attribute rows (N, FA): coefficient triples by reflectance, every
    other column within 1e-6."""
    at, aj = np.asarray(at), np.asarray(aj)
    other = np.ones(pk.FA, bool)
    for c in coeff_cols:
        other[c:c + 3] = False
        for i in range(len(at)):
            if np.any(at[i, c:c + 3]) or np.any(aj[i, c:c + 3]):
                assert_coeff_close(at[i, c:c + 3], aj[i, c:c + 3])
    np.testing.assert_allclose(at[:, other], aj[:, other], rtol=1e-6,
                               atol=1e-6)


@pytest.fixture(scope="module")
def reference():
    return jax_reference("scalar_spectral", "cornell")


def test_spectral_tables_match_jax(reference):
    mk, (ref, _), _ = reference
    st = port_scene("scalar_spectral", "cornell")
    t = st.tables
    assert t.nc == ref.nc == mk.nc == 4
    # the SPD table: D65 / 100 and the CMFs, padded by row 94
    np.testing.assert_array_equal(t.spd.numpy(), np.asarray(mk.d65)[:, :4])
    np.testing.assert_array_equal(t.spd.numpy(), pk.spd_table())
    # light rows in order: [coefficients, D65 scale] as the payload
    lt, lj = t.lights.numpy(), ref.lights.numpy()
    assert lt.shape == lj.shape == (8, 24)
    np.testing.assert_allclose(lt[:, :14], lj[:, :14], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lt[:, 17:], lj[:, 17:], rtol=1e-6, atol=1e-9)
    assert_coeff_close(lt[:2, 14:17], lj[:2, 14:17])
    assert lt[0, 17] > 0 and (lt[2:, 14:18] == 0).all()
    # face rows: albedo and emission as coefficients, le_scale on the
    # light's faces only
    it, ij = match_faces(t, ref)
    assert_attr_rows_agree(t.fattr.numpy()[it], ref.fattr.numpy()[ij])
    lescale = t.fattr.numpy()[:, pk.C_LESCALE]
    assert (lescale > 0).sum() == 2 and np.allclose(lescale[lescale > 0],
                                                    lt[0, 17])


def test_uniform_emitter_spectrum_is_d65_like_jax():
    """A uniform emitter spectrum becomes D65 of that scale in spectral
    mode (xml.cpp:1100-1104), in both packages."""
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.ops.megakernel import DiffusePathMegakernel
    from mitsuba2_tpu.python.test.scenes import cornell_box_dict
    dj, dt = cornell_box_dict(4, 4, 1), cornell_t(4, 4, 1)
    for d in (dj, dt):
        d["light"]["emitter"]["radiance"] = {"type": "spectrum", "value": 7.5}
    mj.set_variant("scalar_spectral")
    mt.set_variant("scalar_spectral")
    try:
        lj = np.asarray(DiffusePathMegakernel(mj.load_dict(dj)).lights).T
        st = mt.load_dict(dt)
        assert type(st.emitters[0].radiance).__name__ == "D65Spectrum"
        assert pk.path_kernel_ineligibility(st) is None
        lt = st.tables.lights.numpy()
        np.testing.assert_allclose(lt[:2, 14:18], lj[:2, 14:18], rtol=1e-6)
    finally:
        mj.set_variant("scalar_rgb")
        mt.set_variant("scalar_rgb")


def test_plain_version_matches_jax_kernel(reference):
    _, (tables, cam), ref = reference
    rad = pk.path_radiance_reference(tables, cam, SEED, 0, SPP, W, W,
                                     MAX_DEPTH, RR_DEPTH)
    assert rad.shape == (3, W * W * SPP) and rad.dtype == torch.float32
    assert torch.isfinite(rad).all()
    assert_images_agree(box_develop(rad, W, W, SPP).numpy(), ref)


def test_render_matches_jax_kernel(reference):
    """load_dict + render of the port (its own fit and packing) against
    the JAX kernel's render of the same dict and seed."""
    st = port_scene("scalar_spectral", "cornell")
    img = st.integrator.render(st, seed=SEED, spp=SPP)
    assert st.integrator.last_engine == "kernel"
    assert st.integrator.engine_reason is None
    assert img.shape == (W, W, 3) and torch.isfinite(img).all()
    assert_images_agree(img.numpy(), reference[2])


def test_spectral_render_is_metameric_to_rgb():
    """Upsampling, D65 and the CIE develop round-trip the rgb render."""
    means = {}
    for variant in ("scalar_rgb", "scalar_spectral"):
        st = port_scene(variant, "cornell", width=32, spp=32)
        means[variant] = float(st.integrator.render(st, seed=1,
                                                    spp=32).mean())
    mt.set_variant("scalar_rgb")
    assert abs(means["scalar_spectral"] - means["scalar_rgb"]) \
        <= 0.04 * means["scalar_rgb"], means


def test_spectral_and_mono_scenes_are_in_scope():
    for variant, scene, flags, nc in (
            ("scalar_spectral", "cornell", 0, 4),
            ("scalar_spectral", "matpreview", FULL, 4),
            ("scalar_mono", "cornell", 0, 1)):
        st = port_scene(variant, scene, width=4, spp=1)
        assert pk.path_kernel_ineligibility(st) is None
        assert (st.tables.flags & pk.TEMPLATE_FLAGS, st.tables.nc) \
            == (flags, nc)
        assert pk.kernel_name(flags, nc).endswith(
            variant.split("_")[1] + "]")
    mt.set_variant("scalar_rgb")


@pytest.mark.cuda
@pytest.mark.parametrize("variant,scene", [
    ("scalar_spectral", "cornell"), ("scalar_spectral", "matpreview"),
    ("scalar_mono", "cornell")])
def test_cuda_kernel_matches_plain_version(variant, scene):
    """The K1e instantiation of each new path against the plain version
    on the card (the main path's depth, RR exercised)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = mt.device()
    try:
        mt.set_device("cuda")
        st = port_scene(variant, scene, width=32, spp=16, max_depth=6)
    finally:
        mt.set_device(prev)
        mt.set_variant("scalar_rgb")
    key = (st.tables.flags & pk.TEMPLATE_FLAGS, st.tables.nc)
    cam = pk.camera_row(st.sensors[0], st.device)
    args = (st.tables, cam, SEED, 0, 16, 32, 32, 6, 3)
    before = pk.path_radiance.launches_by_kernel[key]
    got = pk.path_radiance(*args)
    torch.cuda.synchronize()
    assert pk.path_radiance.launches_by_kernel[key] == before + 1
    want = pk.path_radiance_reference(*args)
    assert_images_agree(box_develop(got, 32, 32, 16).cpu().numpy(),
                        box_develop(want, 32, 32, 16).cpu().numpy())
