"""The spectral modules of the port against the JAX package: the CIE and
D65 tables and their interpolation, the sRGB <-> XYZ matrices, hero
wavelength sampling (the module's and the path kernel's), the sigmoid
model's fit of sRGB colors, and the spectrum plugins' kernel payloads.

Tolerances. Tables and matrices are copies and must be equal. Lookups
and sampling run the same float32 operations on both sides, so they agree
within float32 rounding (1e-6 relative; hero wavelengths within a few
ulp, 2e-6 relative). The sigmoid fit is 25 damped Gauss-Newton steps in
float32 on both sides; the two sides round differently inside each step,
so the coefficients of a color can differ by ~1e-3 relative while the
reflectance they describe agrees: the bar is the reflectance at the 95
CIE wavelengths within 1e-4 absolute, for every color of the slice's
scenes and for seeded colors in [0.05, 0.95]^3 (measured: 3.9e-5 over
4,096 such colors). Near the gamut's edge (a channel near 0 or 1) the
float32 solve is ill-conditioned and the two sides can land on different
coefficients (in 4,096 seeded colors of [0, 1]^3, 4 differ by more than
1e-4, one of them a color the reference's own fit fails to reproduce);
there the bar is 99% of the colors within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba2_tpu as mj
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu.core import spectrum as spec_j
from mitsuba2_tpu.models import spectra as spectra_j
from mitsuba2_tpu.render import fresnel as fresnel_j, srgb as srgb_j
from mitsuba2_tpu_torch.core import spectrum as spec_t
from mitsuba2_tpu_torch.models import spectra as spectra_t
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.render import fresnel as fresnel_t, srgb as srgb_t
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()

CIE_WL = np.linspace(360.0, 830.0, 95).astype(np.float32)


def test_cie_tables_and_matrices_equal_jax():
    for name in ("CIE_XYZ_TABLE", "CIE_D65_TABLE", "XYZ_TO_SRGB",
                 "SRGB_TO_XYZ"):
        a, b = getattr(spec_t, name), np.asarray(getattr(spec_j, name))
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b, name)
    for name in ("MTS_CIE_MIN", "MTS_CIE_MAX", "MTS_CIE_SAMPLES",
                 "MTS_CIE_Y_NORMALIZATION"):
        assert getattr(spec_t, name) == getattr(spec_j, name), name
    np.testing.assert_array_equal(spec_t.LUMINANCE, spec_j.SRGB_TO_XYZ[1])


@pytest.mark.parametrize("fn", ["cie_d65", "cie1931_xyz", "cie1931_y"])
def test_cie_lookups_match_jax(fn):
    """1,000 seeded wavelengths, some outside [360, 830] nm (zero there)."""
    wl = np.random.default_rng(31).uniform(340.0, 850.0,
                                           1000).astype(np.float32)
    got = getattr(spec_t, fn)(torch.as_tensor(wl)).numpy()
    want = np.asarray(getattr(spec_j, fn)(jnp.asarray(wl)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    outside = (wl < 360.0) | (wl > 830.0)
    assert outside.any() and (got[outside] == 0).all()


def test_d65_normalization_and_color_transforms_match_jax():
    np.testing.assert_allclose(spec_t.d65_y_normalization(),
                               spec_j.d65_y_normalization(), rtol=1e-7)
    x = np.random.default_rng(32).random((500, 3)).astype(np.float32)
    for fn in ("srgb_to_xyz", "xyz_to_srgb", "luminance"):
        np.testing.assert_allclose(
            getattr(spec_t, fn)(torch.as_tensor(x)).numpy(),
            np.asarray(getattr(spec_j, fn)(jnp.asarray(x))), rtol=1e-6,
            atol=1e-7, err_msg=fn)
    assert spec_t.trapezoid([1.0, 3.0, 2.0], [0.0, 1.0, 3.0]) == 7.0


def test_wavelength_sampling_matches_jax():
    u = np.random.default_rng(33).random(2000).astype(np.float32)
    for n in (1, 4):
        np.testing.assert_allclose(
            spec_t.sample_shifted(torch.as_tensor(u), n).numpy(),
            np.asarray(spec_j.sample_shifted(jnp.asarray(u), n)), rtol=0,
            atol=1e-7)
    wl_t, wt_t = spec_t.sample_wavelength(torch.as_tensor(u))
    wl_j, wt_j = spec_j.sample_wavelength(jnp.asarray(u))
    np.testing.assert_allclose(wl_t.numpy(), np.asarray(wl_j), rtol=2e-6)
    np.testing.assert_allclose(wt_t.numpy(), np.asarray(wt_j), rtol=2e-5)
    assert wl_t.min() >= 360.0 and wl_t.max() <= 830.0
    np.testing.assert_allclose(
        spec_t.pdf_rgb_spectrum(wl_t).numpy(),
        np.asarray(spec_j.pdf_rgb_spectrum(jnp.asarray(wl_t.numpy()))),
        rtol=1e-5)
    # the weight is 1 / pdf
    np.testing.assert_allclose(
        (wt_t * spec_t.pdf_rgb_spectrum(wl_t)).numpy(), 1.0, rtol=1e-4)


def test_hero_wavelengths_match_jax_kernel():
    """The path kernel's per-lane hero wavelengths and sensor weights
    (atanh through log, cosh through exp) on the same TEA keys."""
    from mitsuba2_tpu.ops import megakernel as mk_j
    keys = np.random.default_rng(34).integers(0, 2**32, 4096,
                                              dtype=np.uint64)
    wl_t, wt_t = pk._hero_wavelengths(torch.as_tensor(keys.astype(np.int64)),
                                      4)
    wl_j, wt_j = mk_j._hero_wavelengths(jnp.asarray(keys.astype(np.uint32)),
                                        4)
    for c in range(4):
        np.testing.assert_allclose(wl_t[c].numpy(), np.asarray(wl_j[c]),
                                   rtol=2e-6)
        np.testing.assert_allclose(wt_t[c].numpy(), np.asarray(wt_j[c]),
                                   rtol=2e-5)
        assert wl_t[c].min() >= 360.0 and wl_t[c].max() <= 830.0


def _scene_colors():
    """Every color the three scenes of the slice fit: the Cornell walls
    and light, the matpreview checker and conductor reflectance, and the
    matpreview sky's unit texels."""
    from mitsuba2_tpu_torch.python.test.scenes import _sky_exr_path
    from mitsuba2_tpu_torch.utils import io_image
    sky = io_image.read_image(_sky_exr_path())[..., :3]
    unit = sky / np.maximum(2.0 * sky.max(-1), 1e-8)[..., None]
    fixed = np.asarray([[0.725, 0.71, 0.68], [0.570068, 0.0430135, 0.0443706],
                        [0.105421, 0.37798, 0.076425], [0, 0, 0],
                        [1, 1, 1], [0.4, 0.4, 0.4], [0.2, 0.2, 0.2],
                        [18.387, 13.9873, 6.75357]], np.float32)
    light = fixed[-1] / fixed[-1].max()
    return np.concatenate([fixed[:-1], light[None], unit.reshape(-1, 3)])


def _fit_colors(which):
    rng = np.random.default_rng(35)
    if which == "seeded":
        return rng.uniform(0.05, 0.95, (256, 3)).astype(np.float32)
    if which == "gamut edge":
        return rng.random((256, 3)).astype(np.float32)
    return _scene_colors().astype(np.float32)


@pytest.mark.parametrize("which", ["seeded", "scenes", "gamut edge"])
def test_srgb_fit_matches_jax(which):
    cols = _fit_colors(which)
    ct = srgb_t.srgb_model_fetch(cols)
    cj = np.asarray(srgb_j.srgb_model_fetch(cols))
    assert ct.shape == cj.shape == cols.shape and ct.dtype == np.float32
    rt = srgb_t.srgb_model_eval(torch.as_tensor(ct),
                                torch.as_tensor(CIE_WL)).numpy()
    rj = np.asarray(srgb_j.srgb_model_eval(jnp.asarray(cj),
                                           jnp.asarray(CIE_WL)))
    err = np.abs(rt - rj).max(1)
    if which == "gamut edge":
        assert (err <= 1e-4).mean() >= 0.99, np.sort(err)[-5:]
        return
    assert err.max() <= 1e-4, err.max()
    # the fit reproduces the (quantised) color it was given
    q = np.round(np.clip(cols, 0, 1) * 4095) / 4095
    back = srgb_t._coeff_to_rgb(torch.as_tensor(ct)).numpy()
    back_j = np.asarray(srgb_j._coeff_to_rgb(jnp.asarray(cj)))
    np.testing.assert_allclose(back, back_j, rtol=0, atol=1e-4)
    inside = (q > 0.02).all(1) & (q < 0.98).all(1)
    assert inside.sum() > 10
    np.testing.assert_allclose(back[inside], q[inside], rtol=0, atol=2e-2)


def test_srgb_model_mean_matches_jax():
    c = np.random.default_rng(36).normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        srgb_t.srgb_model_mean(torch.as_tensor(c)).numpy(),
        np.asarray(srgb_j.srgb_model_mean(jnp.asarray(c))), rtol=1e-6)


def test_emitter_spectra_payloads_match_jax():
    mj.set_variant("scalar_spectral")
    mt.set_variant("scalar_spectral")
    try:
        for color in ([18.387, 13.9873, 6.75357], [0.3, 0.6, 0.9], 1.0):
            t = spectra_t.SRGBD65Spectrum(color=color)
            j = spectra_j.SRGBD65Spectrum(color=color)
            np.testing.assert_allclose(t._d65_scale, j._d65_scale, rtol=1e-6)
            np.testing.assert_allclose(
                srgb_t.srgb_model_eval(torch.as_tensor(t._coeff),
                                       torch.as_tensor(CIE_WL)).numpy(),
                np.asarray(srgb_j.srgb_model_eval(jnp.asarray(j._coeff),
                                                  jnp.asarray(CIE_WL))),
                rtol=0, atol=1e-4)
        t, j = spectra_t.D65Spectrum(scale=2.5), spectra_j.D65Spectrum(scale=2.5)
        np.testing.assert_array_equal(t._coeff, j._coeff)
        np.testing.assert_allclose(t._d65_scale, j._d65_scale, rtol=1e-7)
    finally:
        mj.set_variant("scalar_rgb")
        mt.set_variant("scalar_rgb")


@pytest.mark.parametrize("material,curve", [("Au", True), ("Al", True),
                                            ("Cu", False)])
def test_conductor_ior_spectra_match_jax(material, curve):
    """The anchored quadratic (Cu without its curve) and the curve fits
    (Au, Al) and their clamp spans."""
    assert fresnel_t.CONDUCTOR_IOR_CURVES == fresnel_j.CONDUCTOR_IOR_CURVES
    assert fresnel_t.lookup_conductor_curves("W") is None
    eta_rgb, k_rgb = fresnel_t.lookup_conductor_ior(material)
    curves = fresnel_t.lookup_conductor_curves(material)
    for rgb, col in ((eta_rgb, 1), (k_rgb, 2)):
        cv = (curves[0], curves[col]) if curve else None
        t = spectra_t.ConductorIORSpectrum(rgb, curve=cv)
        j = spectra_j.ConductorIORSpectrum(rgb, curve=cv)
        np.testing.assert_allclose(t._coeff, j._coeff, rtol=1e-6, atol=1e-7)
        assert (t._x_lo, t._x_hi) == (j._x_lo, j._x_hi)
    assert spectra_t.IOR_ANCHORS_NM == spectra_j.IOR_ANCHORS_NM
    if not curve:
        # the quadratic runs through the rgb values at the anchors
        x = [spectra_t._norm_x(w) for w in spectra_t.IOR_ANCHORS_NM]
        np.testing.assert_allclose(np.polyval(t._coeff, x), k_rgb, rtol=1e-5)
