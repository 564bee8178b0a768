"""Spectral upsampling of sRGB colors (reference srgb.h:9, srgb.cpp:14-37;
counterpart of ``mitsuba2_tpu.render.srgb``).

Model: Jakob & Hanika 2019 sigmoid-polynomial reflectance
    S(lambda) = sigmoid(c0 x^2 + c1 x + c2),  x = normalized wavelength,
    sigmoid(t) = 0.5 + t / (2 sqrt(1 + t^2)).

The coefficients of a color are fitted at scene-load time, on the host in
float32, by the reference's damped Gauss-Newton solve (25 steps) on the
color quantised to 4095 steps per channel; identical colors are fitted
once and fits are cached.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import spectrum as spec

_WL_MIN = spec.MTS_CIE_MIN
_WL_MAX = spec.MTS_CIE_MAX
_FIT_STEPS = 25
_QUANT = 4095


def _normalize_wl(wl):
    return (wl - _WL_MIN) / (_WL_MAX - _WL_MIN) * 2.0 - 1.0


def srgb_model_eval(coeff, wavelengths):
    """Reflectance of the model: coeff (..., 3), wavelengths (..., S) ->
    (..., S) (srgb.h srgb_model_eval)."""
    x = _normalize_wl(wavelengths)
    t = coeff[..., 0:1] * x * x + coeff[..., 1:2] * x + coeff[..., 2:3]
    return 0.5 + t / (2.0 * torch.sqrt(1.0 + t * t))


def srgb_model_mean(coeff):
    """Mean reflectance over the visible range (srgb.h srgb_model_mean)."""
    wl = torch.linspace(_WL_MIN, _WL_MAX, 64, device=coeff.device)
    return srgb_model_eval(coeff, wl).mean(dim=-1)


@functools.lru_cache(maxsize=1)
def _fit_tables():
    """The 95 fitting wavelengths and their CMF * D65 weights, scaled so
    that a unit reflectance maps to the D65 whitepoint with Y = 1."""
    wl = np.linspace(_WL_MIN, _WL_MAX, 95, dtype=np.float32)
    wlt = torch.as_tensor(wl)
    cmf = spec.cie1931_xyz(wlt).numpy()
    d65 = spec.cie_d65(wlt).numpy()
    w = cmf * d65[:, None]
    w = w / w[:, 1].sum()
    return wlt, torch.as_tensor(w)


def _coeff_to_rgb(coeff):
    """Linear sRGB (..., 3) of the reflectances of coefficients (..., 3)
    under D65."""
    wl, w = _fit_tables()
    xyz = srgb_model_eval(coeff, wl) @ w
    return spec.xyz_to_srgb(xyz)


def _fit_batch(rgb):
    """Damped Gauss-Newton fit of the coefficients of a batch (B, 3) of
    linear sRGB values in [0, 1] -> (B, 3) float32."""
    wl, w = _fit_tables()
    M = torch.as_tensor(spec.XYZ_TO_SRGB)
    x = _normalize_wl(wl)
    basis = torch.stack([x * x, x, torch.ones_like(x)], dim=-1)   # (95, 3)
    # start from the flat spectrum of the color's luminance
    y = spec.luminance(rgb).clamp(1e-4, 0.9999)
    t0 = (y - 0.5) / torch.sqrt(torch.clamp(y * (1.0 - y), min=1e-6))
    coeff = torch.stack([torch.zeros_like(t0), torch.zeros_like(t0), t0], -1)
    damp = 1e-4 * torch.eye(3)
    for _ in range(_FIT_STEPS):
        r = _coeff_to_rgb(coeff) - rgb
        # d rgb / d coeff: M W^T (sigmoid'(t) * basis)
        t = coeff[:, 0:1] * x * x + coeff[:, 1:2] * x + coeff[:, 2:3]
        q = 1.0 + t * t
        dref = 0.5 / (q * torch.sqrt(q))
        J = torch.einsum("ik,lk,bl,lj->bij", M, w, dref, basis)
        JtJ = torch.einsum("bij,bik->bjk", J, J) + damp
        Jtr = torch.einsum("bij,bi->bj", J, r)
        coeff = coeff - torch.linalg.solve(JtJ, Jtr[..., None])[..., 0]
    return coeff


_cache: dict[bytes, np.ndarray] = {}


def srgb_model_fetch(rgb) -> np.ndarray:
    """Model coefficients (..., 3) float32 of linear sRGB values (..., 3),
    clipped to [0, 1] (srgb.cpp:14-37, a table lookup there). Host side,
    at scene load."""
    flat = np.clip(np.asarray(rgb, np.float32).reshape(-1, 3), 0.0, 1.0)
    quant = np.round(flat * _QUANT).astype(np.uint16)
    key = quant.tobytes()
    hit = _cache.get(key)
    if hit is None:
        uniq, inv = np.unique(quant, axis=0, return_inverse=True)
        fitted = _fit_batch(torch.as_tensor(
            uniq.astype(np.float32) / _QUANT)).numpy()
        hit = fitted[inv.reshape(-1)]
        if len(key) < (1 << 20):
            _cache[key] = hit
    return hit.reshape(np.shape(rgb))
