"""CIE 1931 color matching, the D65 illuminant, sRGB <-> XYZ and
hero-wavelength sampling (reference: include/mitsuba/core/spectrum.h,
src/libcore/spectrum.cpp; counterpart of ``mitsuba2_tpu.core.spectrum``).

The tables are standard public colorimetric data: the CIE 1931 2-degree
standard observer and the CIE D65 illuminant at 5 nm over [360, 830]
(95 samples). They live here as numpy arrays; the functions take and
return torch tensors, in float32 like the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..variants import MTS_WAVELENGTH_MAX, MTS_WAVELENGTH_MIN  # noqa: F401

MTS_CIE_MIN = 360.0
MTS_CIE_MAX = 830.0
MTS_CIE_SAMPLES = 95
# chosen so a unit-valued spectrum integrates to luminance 1 (spectrum.h:133)
MTS_CIE_Y_NORMALIZATION = 1.0 / 106.7502593994140625

# CIE 1931 2-deg color matching functions, 360..830nm in 5nm steps (95 rows).
_CIE1931_XYZ = np.array([
    # x, y, z
    [0.000129900000, 0.000003917000, 0.000606100000],
    [0.000232100000, 0.000006965000, 0.001086000000],
    [0.000414900000, 0.000012390000, 0.001946000000],
    [0.000741600000, 0.000022020000, 0.003486000000],
    [0.001368000000, 0.000039000000, 0.006450001000],
    [0.002236000000, 0.000064000000, 0.010549990000],
    [0.004243000000, 0.000120000000, 0.020050010000],
    [0.007650000000, 0.000217000000, 0.036210000000],
    [0.014310000000, 0.000396000000, 0.067850010000],
    [0.023190000000, 0.000640000000, 0.110200000000],
    [0.043510000000, 0.001210000000, 0.207400000000],
    [0.077630000000, 0.002180000000, 0.371300000000],
    [0.134380000000, 0.004000000000, 0.645600000000],
    [0.214770000000, 0.007300000000, 1.039050100000],
    [0.283900000000, 0.011600000000, 1.385600000000],
    [0.328500000000, 0.016840000000, 1.622960000000],
    [0.348280000000, 0.023000000000, 1.747060000000],
    [0.348060000000, 0.029800000000, 1.782600000000],
    [0.336200000000, 0.038000000000, 1.772110000000],
    [0.318700000000, 0.048000000000, 1.744100000000],
    [0.290800000000, 0.060000000000, 1.669200000000],
    [0.251100000000, 0.073900000000, 1.528100000000],
    [0.195360000000, 0.090980000000, 1.287640000000],
    [0.142100000000, 0.112600000000, 1.041900000000],
    [0.095640000000, 0.139020000000, 0.812950100000],
    [0.057950010000, 0.169300000000, 0.616200000000],
    [0.032010000000, 0.208020000000, 0.465180000000],
    [0.014700000000, 0.258600000000, 0.353300000000],
    [0.004900000000, 0.323000000000, 0.272000000000],
    [0.002400000000, 0.407300000000, 0.212300000000],
    [0.009300000000, 0.503000000000, 0.158200000000],
    [0.029100000000, 0.608200000000, 0.111700000000],
    [0.063270000000, 0.710000000000, 0.078249990000],
    [0.109600000000, 0.793200000000, 0.057250010000],
    [0.165500000000, 0.862000000000, 0.042160000000],
    [0.225749900000, 0.914850100000, 0.029840000000],
    [0.290400000000, 0.954000000000, 0.020300000000],
    [0.359700000000, 0.980300000000, 0.013400000000],
    [0.433449900000, 0.994950100000, 0.008749999000],
    [0.512050100000, 1.000000000000, 0.005749999000],
    [0.594500000000, 0.995000000000, 0.003900000000],
    [0.678400000000, 0.978600000000, 0.002749999000],
    [0.762100000000, 0.952000000000, 0.002100000000],
    [0.842500000000, 0.915400000000, 0.001800000000],
    [0.916300000000, 0.870000000000, 0.001650001000],
    [0.978600000000, 0.816300000000, 0.001400000000],
    [1.026300000000, 0.757000000000, 0.001100000000],
    [1.056700000000, 0.694900000000, 0.001000000000],
    [1.062200000000, 0.631000000000, 0.000800000000],
    [1.045600000000, 0.566800000000, 0.000600000000],
    [1.002600000000, 0.503000000000, 0.000340000000],
    [0.938400000000, 0.441200000000, 0.000240000000],
    [0.854449900000, 0.381000000000, 0.000190000000],
    [0.751400000000, 0.321000000000, 0.000100000000],
    [0.642400000000, 0.265000000000, 0.000049999990],
    [0.541900000000, 0.217000000000, 0.000030000000],
    [0.447900000000, 0.175000000000, 0.000020000000],
    [0.360800000000, 0.138200000000, 0.000010000000],
    [0.283500000000, 0.107000000000, 0.000000000000],
    [0.218700000000, 0.081600000000, 0.000000000000],
    [0.164900000000, 0.061000000000, 0.000000000000],
    [0.121200000000, 0.044580000000, 0.000000000000],
    [0.087400000000, 0.032000000000, 0.000000000000],
    [0.063600000000, 0.023200000000, 0.000000000000],
    [0.046770000000, 0.017000000000, 0.000000000000],
    [0.032900000000, 0.011920000000, 0.000000000000],
    [0.022700000000, 0.008210000000, 0.000000000000],
    [0.015840000000, 0.005723000000, 0.000000000000],
    [0.011359160000, 0.004102000000, 0.000000000000],
    [0.008110916000, 0.002929000000, 0.000000000000],
    [0.005790346000, 0.002091000000, 0.000000000000],
    [0.004109457000, 0.001484000000, 0.000000000000],
    [0.002899327000, 0.001047000000, 0.000000000000],
    [0.002049190000, 0.000740000000, 0.000000000000],
    [0.001439971000, 0.000520000000, 0.000000000000],
    [0.000999949300, 0.000361100000, 0.000000000000],
    [0.000690078600, 0.000249200000, 0.000000000000],
    [0.000476021300, 0.000171900000, 0.000000000000],
    [0.000332301100, 0.000120000000, 0.000000000000],
    [0.000234826100, 0.000084800000, 0.000000000000],
    [0.000166150500, 0.000060000000, 0.000000000000],
    [0.000117413000, 0.000042400000, 0.000000000000],
    [0.000083075270, 0.000030000000, 0.000000000000],
    [0.000058706520, 0.000021200000, 0.000000000000],
    [0.000041509940, 0.000014990000, 0.000000000000],
    [0.000029353260, 0.000010600000, 0.000000000000],
    [0.000020673830, 0.000007465700, 0.000000000000],
    [0.000014559770, 0.000005257800, 0.000000000000],
    [0.000010253980, 0.000003702900, 0.000000000000],
    [0.000007221456, 0.000002607800, 0.000000000000],
    [0.000005085868, 0.000001836600, 0.000000000000],
    [0.000003581652, 0.000001293400, 0.000000000000],
    [0.000002522525, 0.000000910930, 0.000000000000],
    [0.000001776509, 0.000000641530, 0.000000000000],
    [0.000001251141, 0.000000451810, 0.000000000000],
], dtype=np.float32)

assert _CIE1931_XYZ.shape == (MTS_CIE_SAMPLES, 3)

# CIE standard illuminant D65 relative SPD, 360..830nm in 5nm steps (95 rows),
# normalized to 100 at 560nm (standard published data).
_D65 = np.array([
    46.6383, 49.3637, 52.0891, 51.0323, 49.9755, 52.3118, 54.6482, 68.7015,
    82.7549, 87.1204, 91.486, 92.4589, 93.4318, 90.057, 86.6823, 95.7736,
    104.865, 110.936, 117.008, 117.41, 117.812, 116.336, 114.861, 115.392,
    115.923, 112.367, 108.811, 109.082, 109.354, 108.578, 107.802, 106.296,
    104.79, 106.239, 107.689, 106.047, 104.405, 104.225, 104.046, 102.023,
    100.0, 98.1671, 96.3342, 96.0611, 95.788, 92.2368, 88.6856, 89.3459,
    90.0062, 89.8026, 89.5991, 88.6489, 87.6987, 85.4936, 83.2886, 83.4939,
    83.6992, 81.863, 80.0268, 80.1207, 80.2146, 81.2462, 82.2778, 80.281,
    78.2842, 74.0027, 69.7213, 70.6652, 71.6091, 72.979, 74.349, 67.9765,
    61.604, 65.7448, 69.8856, 72.4863, 75.087, 69.3398, 63.5927, 55.0054,
    46.4182, 56.6118, 66.8054, 65.0941, 63.3828, 63.8434, 64.304, 61.8779,
    59.4519, 55.7054, 51.959, 54.6998, 57.4406, 58.8765, 60.3125,
], dtype=np.float32)

assert _D65.shape == (MTS_CIE_SAMPLES,)

CIE_XYZ_TABLE = _CIE1931_XYZ
_CIE_Y_TABLE = np.ascontiguousarray(CIE_XYZ_TABLE[:, 1])
CIE_D65_TABLE = (_D65 / 100.0).astype(np.float32)

# BT.709 / sRGB linear matrices (spectrum.h:220-236)
XYZ_TO_SRGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311]], dtype=np.float32)
SRGB_TO_XYZ = np.array([
    [0.412453, 0.357580, 0.180423],
    [0.212671, 0.715160, 0.072169],
    [0.019334, 0.119193, 0.950227]], dtype=np.float32)
# luminance weights: the Y row of SRGB_TO_XYZ
LUMINANCE = SRGB_TO_XYZ[1]


# the module's tables on each device, copied there once (a copy from the
# host at every call would wait for the device's stream)
_DEVICE_TABLES = {}


def _table(table, like):
    """One of this module's constant tables as float32 on ``like``'s
    device."""
    key = (id(table), str(like.device))
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = (table, torch.as_tensor(
            table, dtype=torch.float32, device=like.device))
    return _DEVICE_TABLES[key][1]


def _cie_interp(table, wavelength):
    """Linear interpolation of a per-5 nm CIE table at ``wavelength``,
    zero outside [360, 830] (spectrum.h:148-205)."""
    tab = _table(table, wavelength)
    t = (wavelength - MTS_CIE_MIN) * ((MTS_CIE_SAMPLES - 1)
                                      / (MTS_CIE_MAX - MTS_CIE_MIN))
    active = (wavelength >= MTS_CIE_MIN) & (wavelength <= MTS_CIE_MAX)
    i0 = t.to(torch.int32).clamp(0, MTS_CIE_SAMPLES - 2).long()
    w1 = t - i0.to(t.dtype)
    w0 = 1.0 - w1
    if tab.ndim == 2:
        v = w0[..., None] * tab[i0] + w1[..., None] * tab[i0 + 1]
        return torch.where(active[..., None], v, torch.zeros_like(v))
    v = w0 * tab[i0] + w1 * tab[i0 + 1]
    return torch.where(active, v, torch.zeros_like(v))


def cie1931_xyz(wavelength):
    """(..., 3) XYZ response at the wavelengths (...,) in nm."""
    return _cie_interp(CIE_XYZ_TABLE, wavelength)


def cie1931_y(wavelength):
    return _cie_interp(_CIE_Y_TABLE, wavelength)


def cie_d65(wavelength):
    """The D65 illuminant (relative SPD / 100) at the wavelengths."""
    return _cie_interp(CIE_D65_TABLE, wavelength)


def trapezoid(y, x) -> float:
    """Trapezoid-rule integral of samples ``y`` at ``x`` (numpy's
    ``trapezoid`` arithmetic, which exists only from numpy 2.0)."""
    y = np.asarray(y)
    x = np.asarray(x)
    return float((np.diff(x) * (y[1:] + y[:-1]) / 2.0).sum())


_D65_Y_NORM = None


def d65_y_normalization() -> float:
    """Integral of d65 * ybar over [360, 830] nm (256-sample trapezoid):
    the whitepoint normalization emitter spectra divide by, so that an rgb
    (1, 1, 1) light has unit luminance (d65.cpp)."""
    global _D65_Y_NORM
    if _D65_Y_NORM is None:
        wl = np.linspace(MTS_CIE_MIN, MTS_CIE_MAX, 256)
        wlt = torch.as_tensor(wl, dtype=torch.float32)
        _D65_Y_NORM = trapezoid(cie_d65(wlt).numpy() * cie1931_y(wlt).numpy(),
                                wl)
    return _D65_Y_NORM


def srgb_to_xyz(rgb):
    return rgb @ _table(SRGB_TO_XYZ, rgb).T


def xyz_to_srgb(xyz):
    return xyz @ _table(XYZ_TO_SRGB, xyz).T


def zeros(si):
    """A zero spectrum in the current variant's channels at each lane of
    ``si`` -> (n, C)."""
    from ..variants import current
    return torch.zeros((si.t.shape[0], current().n_channels),
                       device=si.t.device)


def luminance(value, wavelengths=None):
    """Luminance of linear rgb values (..., 3) -> (...); with
    ``wavelengths``, of hero-wavelength spectra (..., S): the mean of
    value x ybar."""
    if wavelengths is not None:
        return (cie1931_y(wavelengths) * value).mean(-1)
    return (value[..., 0] * 0.212671 + value[..., 1] * 0.715160
            + value[..., 2] * 0.072169)


def spectrum_to_xyz(value, wavelengths):
    """Hero-wavelength spectra (..., S) -> XYZ (..., 3) (spectrum.h:209)."""
    return (cie1931_xyz(wavelengths) * value[..., None]).mean(-2)


def cie1931_xyz_rows(wavelength):
    """The X, Y and Z responses at the wavelengths (n,), as three (n,)
    tensors (the channel-major form of ``cie1931_xyz``)."""
    xyz = cie1931_xyz(wavelength)
    return [xyz[..., k] for k in range(3)]


def spectrum_to_srgb_rows(vals_rows, wl_rows):
    """Hero-wavelength spectra (S, n) at wavelengths (S, n) -> linear sRGB
    rows (3, n): XYZ summed over the S wavelengths in order, over S, then
    the XYZ -> sRGB matrix (spectrum.h:209; mitsuba2_tpu.core.spectrum.
    spectrum_to_srgb_rows)."""
    nc = vals_rows.shape[0]
    xyz = [0.0, 0.0, 0.0]
    for c in range(nc):
        resp = cie1931_xyz_rows(wl_rows[c])
        for k in range(3):
            xyz[k] = xyz[k] + resp[k] * vals_rows[c]
    xyz_rows = torch.stack(xyz, 0) / nc
    return _table(XYZ_TO_SRGB, xyz_rows) @ xyz_rows


def spectrum_to_rgb(wavelengths, values, bounded: bool = True):
    """An (irregular) spectral curve integrated against the CIE matching
    functions on 1000 nodes and converted to linear sRGB (libcore/
    spectrum.cpp spectrum_to_rgb): host numpy, for scene loading."""
    wl = np.linspace(MTS_CIE_MIN, MTS_CIE_MAX, 1000)
    v = np.interp(wl, np.asarray(wavelengths), np.asarray(values),
                  left=0.0, right=0.0)
    cmf = cie1931_xyz(torch.as_tensor(wl, dtype=torch.float32)).numpy()
    y = cmf * v[:, None]
    xyz = (np.diff(wl)[:, None] * (y[1:] + y[:-1]) / 2.0).sum(0) \
        * MTS_CIE_Y_NORMALIZATION
    rgb = xyz @ XYZ_TO_SRGB.T
    return np.clip(rgb, 0.0, 1.0) if bounded else np.maximum(rgb, 0.0)


def sample_uniform_spectrum(sample):
    """Wavelengths uniform over [360, 830] nm and their weights 1/pdf."""
    return (sample * (MTS_CIE_MAX - MTS_CIE_MIN) + MTS_CIE_MIN,
            torch.full_like(sample, MTS_CIE_MAX - MTS_CIE_MIN))


def pdf_uniform_spectrum(wavelength):
    return torch.full_like(wavelength,
                           1.0 / (MTS_WAVELENGTH_MAX - MTS_WAVELENGTH_MIN))


def sample_shifted(sample, n: int = 4):
    """Hero-wavelength rotation (core/math.h sample_shifted): one u per
    lane -> n samples u + i/n mod 1, (..., n)."""
    shifts = torch.arange(n, dtype=sample.dtype, device=sample.device) / n
    v = sample[..., None] + shifts
    return v - torch.floor(v)


def sample_rgb_spectrum(sample):
    """Wavelengths importance-sampled for rgb rendering and their weights
    1/pdf (Radziszewski et al.'s analytic fit, spectrum.h:262-286)."""
    wavelengths = 538.0 - torch.atanh(0.8569106254698279
                                      - 1.8275019724092267 * sample) \
        * 138.88888888888889
    tmp = torch.cosh(0.0072 * (wavelengths - 538.0))
    return wavelengths, 253.82 * tmp * tmp


def pdf_rgb_spectrum(wavelengths):
    """Density of ``sample_rgb_spectrum`` (spectrum.h:293-302)."""
    tmp = 1.0 / torch.cosh(0.0072 * (wavelengths - 538.0))
    ok = (wavelengths >= MTS_WAVELENGTH_MIN) \
        & (wavelengths <= MTS_WAVELENGTH_MAX)
    return torch.where(ok, 0.003939804229326285 * tmp * tmp,
                       torch.zeros_like(tmp))


def sample_wavelength(sample, n: int = 4):
    """n hero wavelengths and their weights from one u per lane
    (spectrum.h:305)."""
    return sample_rgb_spectrum(sample_shifted(sample, n))
