"""Spectrum plugins (reference: src/spectra/{uniform,regular,irregular,
blackbody,d65,srgb_d65}.cpp, roughconductor.cpp:306-430; counterpart of
``mitsuba2_tpu.models.spectra``).

- ``_CurveSpectrum``: a tabulated curve, linear between its nodes, at the
  hero wavelengths in spectral variants; its CIE-integrated rgb
  (``spectrum_to_rgb``) in rgb variants and that rgb's luminance in mono
  variants. ``regular``, ``irregular``, ``blackbody``, ``d65`` and
  ``srgb_d65`` are curves; the dict's ``{"type": "spectrum", "value":
  [(wavelength, value), ...]}`` loads as an ``irregular`` one
  (models/textures.py ``as_texture``).
- ``uniform``: one value in every channel.
- ``D65Spectrum`` and ``SRGBD65Spectrum`` also hold the payload the path
  kernel evaluates: value(wl) = sigmoid(_coeff, wl) * d65(wl) *
  _d65_scale.
- ``ConductorIORSpectrum``, a conductor's eta or k: a quadratic in the
  normalized wavelength, clamped to its fit span.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import math as m
from ..core import spectrum as spec
from ..core.object import register_plugin
from ..render.texture import Texture
from .textures import on_device


class _CurveSpectrum(Texture):
    """A spectral curve (nodes ``_wl``, values ``_vals``, float32): its
    value at the hero wavelengths (linear between the nodes, zero outside
    them) in spectral variants, its CIE-integrated rgb ``_rgb`` in rgb
    variants and that rgb's luminance in mono variants; its wavelengths
    sampled in proportion to the curve
    (mitsuba2_tpu/models/spectra.py:22-84)."""

    def _setup(self, wl, vals, bounded=False):
        self._wl = np.asarray(wl, np.float32)
        self._vals = np.asarray(vals, np.float32)
        self._rgb = spec.spectrum_to_rgb(self._wl, self._vals,
                                         bounded=bounded)
        # float32 luminance of the rgb, the mono variants' value
        self._mono = float(spec.luminance(
            torch.as_tensor(self._rgb, dtype=torch.float32)))

    def _eval_curve(self, x):
        dev = x.device
        wl = on_device(self, "wl", self._wl, dev)
        vals = on_device(self, "vals", self._vals, dev)
        idx = (torch.searchsorted(wl, x.contiguous(), right=True)
               - 1).clamp(0, len(self._wl) - 2)
        x0, x1 = wl[idx], wl[idx + 1]
        w = (x - x0) / torch.clamp(x1 - x0, min=1e-8)
        v = vals[idx] * (1 - w) + vals[idx + 1] * w
        return torch.where((x >= wl[0]) & (x <= wl[-1]), v, 0.0)

    def _distr(self, device):
        from ..core.distr_1d import IrregularContinuousDistribution
        cache = self.__dict__.setdefault("_device_cache", {})
        key = ("distr", str(device))
        if key not in cache:
            cache[key] = IrregularContinuousDistribution.create(
                self._wl, self._vals).to(device)
        return cache[key]

    def eval(self, si, active=True):
        from ..variants import current
        var = current()
        if var.is_spectral:
            return self._eval_curve(si.wavelengths)
        n, dev = si.t.shape[0], si.t.device
        if var.is_monochromatic:
            return on_device(self, "mono", [self._mono], dev).expand(n, 1)
        return on_device(self, "rgb", self._rgb, dev).expand(n, 3)

    def eval_1(self, si, active=True):
        return torch.full_like(si.t, self._mono)

    def eval_3(self, si, active=True):
        return on_device(self, "rgb", self._rgb, si.t.device).expand(
            si.t.shape[0], 3)

    def sample_spectrum(self, si, sample, active=True):
        """Wavelengths drawn in proportion to the curve and its value over
        their pdf; outside spectral variants the lanes' own."""
        from ..variants import current
        if not current().is_spectral:
            return si.wavelengths, self.eval(si, active)
        distr = self._distr(sample.device)
        wl = distr.sample(sample)
        return wl, m.safe_div(self._eval_curve(wl),
                              distr.eval_pdf_normalized(wl), 0.0)

    def pdf_spectrum(self, si, active=True):
        from ..variants import current
        if not current().is_spectral:
            return torch.zeros_like(si.wavelengths)
        return self._distr(si.wavelengths.device).eval_pdf_normalized(
            si.wavelengths)

    def mean(self):
        return self._mono


@register_plugin("spectrum", "uniform")
class UniformSpectrum(Texture):
    """(uniform.cpp) the same ``value`` at every wavelength: in rgb and
    mono variants that value in every channel, not the E illuminant's
    color (mitsuba2_tpu/models/spectra.py:86-113)."""

    def __init__(self, props=None, value=None):
        super().__init__(props)
        self.value = float(props.float_("value", 1.0)) if props else \
            float(value if value is not None else 1.0)

    def eval(self, si, active=True):
        from ..variants import current
        # added to zeros, not filled: a bound value keeps its graph
        return torch.zeros((si.t.shape[0], current().n_channels),
                           device=si.t.device) + self.value

    def eval_1(self, si, active=True):
        return torch.zeros_like(si.t) + self.value

    def eval_3(self, si, active=True):
        return torch.zeros((si.t.shape[0], 3), device=si.t.device) \
            + self.value

    def mean(self):
        return float(self.value)

    def traverse(self, cb):
        cb.put_parameter("value", self.value)


def _numbers(v):
    """A list of floats from a list or a "1, 2 3" string."""
    if isinstance(v, str):
        return [float(x) for x in v.replace(",", " ").split()]
    return v


@register_plugin("spectrum", "regular")
class RegularSpectrum(_CurveSpectrum):
    """(regular.cpp) ``values`` on a uniform grid over [``lambda_min``,
    ``lambda_max``]."""

    def __init__(self, props=None, lambda_min=None, lambda_max=None,
                 values=None):
        super().__init__(props)
        if props is not None:
            lambda_min = props.float_("lambda_min", spec.MTS_WAVELENGTH_MIN)
            lambda_max = props.float_("lambda_max", spec.MTS_WAVELENGTH_MAX)
            values = _numbers(props.get("values"))
        values = np.asarray(values, np.float32)
        self._setup(np.linspace(lambda_min, lambda_max, len(values)),
                    values)


@register_plugin("spectrum", "irregular")
class IrregularSpectrum(_CurveSpectrum):
    """(irregular.cpp) explicit ``wavelengths`` and ``values``."""

    def __init__(self, props=None, wavelengths=None, values=None):
        super().__init__(props)
        if props is not None:
            wavelengths = _numbers(props.get("wavelengths"))
            values = _numbers(props.get("values"))
        self._setup(np.asarray(wavelengths, np.float32),
                    np.asarray(values, np.float32))


@register_plugin("spectrum", "blackbody")
class BlackbodySpectrum(_CurveSpectrum):
    """(blackbody.cpp) Planck's spectral radiance at ``temperature`` K in
    W / (m^2 sr nm), tabulated at 256 wavelengths over the CIE range."""

    def __init__(self, props=None, temperature=None):
        super().__init__(props)
        if props is not None:
            temperature = props.float_("temperature", 2856.0)
        T = float(temperature)
        wl = np.linspace(spec.MTS_CIE_MIN, spec.MTS_CIE_MAX, 256)
        lam = wl * 1e-9
        h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
        L = (2 * h * c * c) / (lam ** 5) \
            / (np.exp(h * c / (lam * kb * T)) - 1.0) * 1e-9
        self._setup(wl, L.astype(np.float32))


def _norm_x(wl_nm):
    """Wavelength in nm -> the sigmoid model's normalized x in [-1, 1]."""
    return (wl_nm - spec.MTS_CIE_MIN) / (spec.MTS_CIE_MAX
                                         - spec.MTS_CIE_MIN) * 2.0 - 1.0


@register_plugin("spectrum", "d65")
class D65Spectrum(_CurveSpectrum):
    """(d65.cpp) the CIE D65 illuminant normalized to luminance
    ``scale``."""

    def __init__(self, props=None, scale=None):
        super().__init__(props)
        if props is not None:
            scale = props.float_("scale", 1.0)
        scale = 1.0 if scale is None else float(scale)
        wl = np.linspace(spec.MTS_CIE_MIN, spec.MTS_CIE_MAX,
                         spec.MTS_CIE_SAMPLES)
        norm = spec.trapezoid(spec.CIE_D65_TABLE * spec.CIE_XYZ_TABLE[:, 1],
                              wl)
        # unit reflectance (the sigmoid saturates to 1) times d65
        self._coeff = np.asarray([0.0, 0.0, 1.0e5], np.float32)
        self._d65_scale = float(scale / norm)
        self._setup(wl, spec.CIE_D65_TABLE * (scale / norm))


@register_plugin("spectrum", "srgb_d65")
class SRGBD65Spectrum(_CurveSpectrum):
    """(srgb_d65.cpp) an sRGB color times the D65 illuminant: the emitter
    spectrum of rgb-specified lights. A color brighter than 1 is fitted
    at unit maximum and the excess goes into the scale."""

    def __init__(self, props=None, color=None):
        super().__init__(props)
        if props is not None:
            color = props.get("color", props.get("value", 1.0))
        color = np.asarray(color, np.float32)
        if color.ndim == 0:
            color = np.broadcast_to(color, (3,)).copy()
        from ..render.srgb import srgb_model_eval, srgb_model_fetch
        peak = max(color.max(), 1.0)
        self._coeff = np.asarray(
            srgb_model_fetch(np.clip(color / peak, 0, 1)),
            np.float32).reshape(3)
        self._d65_scale = float(float(peak) / spec.d65_y_normalization())
        # the curve at 256 nodes: reflectance x d65 / (d65 . ybar) x peak
        wl = np.linspace(spec.MTS_CIE_MIN, spec.MTS_CIE_MAX, 256)
        wlt = torch.as_tensor(wl, dtype=torch.float32)
        refl = srgb_model_eval(torch.as_tensor(self._coeff), wlt).numpy()
        d65 = spec.cie_d65(wlt).numpy()
        norm = spec.trapezoid(d65 * spec.cie1931_y(wlt).numpy(), wl)
        self._setup(wl, refl * d65 / norm * float(peak))


# anchor wavelengths of rgb-anchored conductor IOR curves (approximate
# centroids of the CIE-weighted sRGB primaries)
IOR_ANCHORS_NM = (600.0, 550.0, 450.0)     # (r, g, b)


def _anchored_quad_coeffs(rgb):
    """(a, b, c) of the quadratic in x through the three (anchor, value)
    points: exact and unbounded (eta and k exceed 1)."""
    xs = np.asarray([_norm_x(w) for w in IOR_ANCHORS_NM])
    return np.polyfit(xs, np.asarray(rgb, np.float64), 2)


class ConductorIORSpectrum(Texture):
    """A conductor's eta or k in spectral variants:
    value(x) = (a x + b) x + c at the clamped normalized wavelength x.

    ``rgb`` is the material's rgb triple. Without ``curve`` the quadratic
    runs through the rgb values at the anchor wavelengths and is clamped
    to the anchors' span; with ``curve`` = (wavelengths_nm, values) it is
    the least-squares fit to the curve over its whole span, and clamped to
    that span."""

    def __init__(self, rgb, curve=None):
        super().__init__(None)
        if curve is not None:
            wl_t = np.asarray(curve[0], np.float64)
            v_t = np.asarray(curve[1], np.float64)
            wl_d = np.linspace(wl_t[0], wl_t[-1], 128)
            self._coeff = np.asarray(
                np.polyfit(_norm_x(wl_d), np.interp(wl_d, wl_t, v_t), 2),
                np.float32)
            lo, hi = float(wl_t[0]), float(wl_t[-1])
        else:
            self._coeff = np.asarray(_anchored_quad_coeffs(
                np.asarray(rgb, np.float32).reshape(3)), np.float32)
            lo, hi = min(IOR_ANCHORS_NM), max(IOR_ANCHORS_NM)
        self._x_lo = float(_norm_x(lo))
        self._x_hi = float(_norm_x(hi))
        self._rgb_np = np.asarray(rgb, np.float32).reshape(3)

    def eval(self, si, active=True):
        """The quadratic at the lanes' hero wavelengths."""
        x = torch.clamp(_norm_x(si.wavelengths), self._x_lo, self._x_hi)
        a, b, c = (float(v) for v in self._coeff)
        return (a * x + b) * x + c

    def eval_3(self, si, active=True):
        return on_device(self, "rgb", self._rgb_np, si.t.device).expand(
            si.t.shape[0], 3)

    def eval_1(self, si, active=True):
        return torch.full_like(si.t, float(spec.luminance(
            np.asarray(self._rgb_np, np.float64))))

    def mean(self):
        return float(self._rgb_np.mean())
