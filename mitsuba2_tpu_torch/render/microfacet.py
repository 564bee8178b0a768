"""Microfacet distributions: Beckmann and GGX, isotropic or anisotropic,
with Smith shadowing and visible-normal sampling (reference: include/
mitsuba/render/microfacet.h; counterpart of ``mitsuba2_tpu.render.
microfacet.MicrofacetDistribution``). Vectors are (..., 3) tensors in the
local shading frame (+z = normal).

GGX samples visible normals by Heitz 2018's projection onto the stretched
hemisphere; Beckmann inverts the conditional slope cdf with the JAX
package's 12-step bracketed Newton solve. The error function and its
inverse are the JAX package's forms (Abramowitz-Stegun 7.1.26 and Giles
2010), not ``torch.erf``: another approximation would draw other slopes
from the same numbers and part the streams at the first rough bounce.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import frame as fr
from ..core import math as m

GGX = "ggx"
BECKMANN = "beckmann"


class MicrofacetDistribution(NamedTuple):
    """Roughness ``alpha_u`` along x and ``alpha_v`` along y (numbers or
    per-lane tensors)."""
    alpha_u: float
    alpha_v: float
    type: str = GGX
    sample_visible: bool = True

    def is_isotropic(self):
        return self.alpha_u is self.alpha_v

    def scale_alpha(self, s):
        return self._replace(alpha_u=self.alpha_u * s,
                             alpha_v=self.alpha_v * s)

    def eval(self, mh):
        """Normal density D(m) (microfacet.h eval)."""
        au, av = self.alpha_u, self.alpha_v
        ct = mh[..., 2]
        ct2 = ct * ct
        x2 = (mh[..., 0] / au) ** 2
        y2 = (mh[..., 1] / av) ** 2
        if self.type == BECKMANN:
            val = m.safe_div(torch.exp(-m.safe_div(x2 + y2, ct2, 0.0)),
                             m.Pi * au * av * ct2 * ct2, 0.0)
        else:
            t = x2 + y2 + ct2
            val = m.safe_div(torch.ones_like(t),
                             m.Pi * au * av * t * t, 0.0)
        return torch.where(ct > 0, val, torch.zeros_like(val))

    def smith_g1(self, v, mh):
        """Smith's monodirectional shadowing G1(v, m) (microfacet.h
        smith_g1; the exact Beckmann form, which the slope sampling
        matches)."""
        ct = v[..., 2]
        xy_alpha_2 = ((self.alpha_u * v[..., 0]) ** 2
                      + (self.alpha_v * v[..., 1]) ** 2)
        tan_theta_alpha_2 = m.safe_div(xy_alpha_2, ct * ct, 0.0)
        if self.type == BECKMANN:
            a = m.safe_rsqrt(tan_theta_alpha_2)
            lam = 0.5 * (_erf_approx(a) - 1.0) + m.safe_div(
                torch.exp(-a * a), 2.0 * a * m.SqrtPi, 0.0)
            result = 1.0 / (1.0 + lam)
        else:
            result = 2.0 / (1.0 + torch.sqrt(1.0 + tan_theta_alpha_2))
        one = torch.ones_like(result)
        result = torch.where(xy_alpha_2 == 0.0, one, result)
        return torch.where(m.dot(v, mh) * ct <= 0.0,
                           torch.zeros_like(result), result)

    def G(self, wi, wo, mh):
        return self.smith_g1(wi, mh) * self.smith_g1(wo, mh)

    def pdf(self, wi, mh):
        """Density of ``sample``: G1(wi, m) |wi . m| D(m) / |cos theta_i|
        with visible normals, else D(m) cos theta_m (microfacet.h pdf)."""
        d = self.eval(mh)
        if self.sample_visible:
            return (self.smith_g1(wi, mh) * m.dot(wi, mh).abs() * d
                    / torch.clamp(wi[..., 2].abs(), min=1e-8))
        return d * mh[..., 2]

    def sample(self, wi, u1, u2):
        """-> (micro-normal m, pdf) from the uniforms u1, u2
        (microfacet.h sample)."""
        if self.sample_visible:
            mh = self._sample_visible(wi, u1, u2)
            return mh, self.pdf(wi, mh)
        au, av = self.alpha_u, self.alpha_v
        phi = torch.atan2(av * torch.sin(2 * m.Pi * u2),
                          au * torch.cos(2 * m.Pi * u2))
        cp, sp = torch.cos(phi), torch.sin(phi)
        alpha2 = 1.0 / ((cp / au) ** 2 + (sp / av) ** 2)
        if self.type == BECKMANN:
            tan_theta2 = -alpha2 * torch.log(torch.clamp(1.0 - u1,
                                                         min=1e-38))
        else:
            tan_theta2 = alpha2 * u1 / torch.clamp(1.0 - u1, min=1e-8)
        ct = m.safe_rsqrt(1.0 + tan_theta2)
        st = m.safe_sqrt(1.0 - ct * ct)
        mh = torch.stack([st * cp, st * sp, ct], -1)
        return mh, self.pdf(wi, mh)

    def _sample_visible(self, wi, u1, u2):
        au, av = self.alpha_u, self.alpha_v
        wi_s = m.normalize(torch.stack(
            [au * wi[..., 0], av * wi[..., 1], wi[..., 2]], -1))
        if self.type == GGX:
            lensq = wi_s[..., 0] ** 2 + wi_s[..., 1] ** 2
            inv_len = m.safe_rsqrt(torch.clamp(lensq, min=1e-20))
            zero = torch.zeros_like(inv_len)
            t1 = torch.where(
                (lensq > 1e-14)[..., None],
                torch.stack([-wi_s[..., 1] * inv_len,
                             wi_s[..., 0] * inv_len, zero], -1),
                torch.stack([zero + 1.0, zero, zero], -1))
            t2 = m.cross(wi_s, t1)
            r = m.safe_sqrt(u1)
            phi = 2.0 * m.Pi * u2
            p1 = r * torch.cos(phi)
            p2 = r * torch.sin(phi)
            s = 0.5 * (1.0 + wi_s[..., 2])
            p2 = (1.0 - s) * m.safe_sqrt(1.0 - p1 * p1) + s * p2
            nh = (t1 * p1[..., None] + t2 * p2[..., None]
                  + wi_s * m.safe_sqrt(1.0 - p1 * p1 - p2 * p2)[..., None])
            return m.normalize(torch.stack(
                [au * nh[..., 0], av * nh[..., 1],
                 torch.clamp(nh[..., 2], min=1e-6)], -1))
        # Beckmann: slopes conditioned on the stretched wi, rotated by its
        # azimuth, unstretched
        sx, sy = self._sample_slopes(
            torch.clamp(wi_s[..., 2], -1.0, 1.0), u1, u2)
        cp = fr.cos_phi(wi_s)
        sp = fr.sin_phi(wi_s)
        sx_f = au * (cp * sx - sp * sy)
        sy_f = av * (sp * sx + cp * sy)
        return m.normalize(torch.stack([-sx_f, -sy_f,
                                        torch.ones_like(sx_f)], -1))

    def _sample_slopes(self, cos_theta_i, u1, u2):
        """Beckmann slopes of the visible normals at incidence cos_theta_i
        (microfacet.h sample_visible_11): the conditional cdf inverted in
        erf space by 12 Newton steps kept inside a shrinking bracket, and
        isotropic gaussian slopes near normal incidence."""
        u1 = torch.clamp(u1, 1e-6, 1 - 1e-6)
        u2 = torch.clamp(u2, 1e-6, 1 - 1e-6)
        ct = torch.clamp(cos_theta_i, min=1e-6)
        st = m.safe_sqrt(1.0 - ct * ct)
        tan_theta = st / ct
        cot_theta = 1.0 / torch.clamp(tan_theta, min=1e-12)
        c = _erf_approx(cot_theta)
        sample_x = torch.clamp(u1, min=1e-6)
        theta_big = tan_theta > 1e-4
        fit = 1.0 + cos_theta_i * (-0.876 + cos_theta_i
                                   * (0.4265 - 0.0594 * cos_theta_i))
        b = c - (1.0 + c) * torch.pow(1.0 - sample_x, fit)
        norm = m.safe_div(torch.ones_like(c), 1.0 + c + m.InvSqrtPi
                          * tan_theta * torch.exp(-cot_theta * cot_theta),
                          0.0)
        lo = torch.full_like(b, -1.0 + 1e-6)
        hi = c - 1e-6
        for _ in range(12):
            b = torch.minimum(torch.maximum(b, lo), hi)
            inv_erf = _erfinv(b)
            val = norm * (1.0 + b + m.InvSqrtPi * tan_theta
                          * torch.exp(-inv_erf * inv_erf)) - sample_x
            derivative = norm * (1.0 - inv_erf * tan_theta)
            go_lo = val > 0
            hi = torch.where(go_lo, b, hi)
            lo = torch.where(go_lo, lo, b)
            b_newton = b - m.safe_div(val, derivative, 0.0)
            inside = (b_newton > lo) & (b_newton < hi)
            b = torch.where(inside, b_newton, 0.5 * (lo + hi))
        slope_x = _erfinv(torch.clamp(b, -1 + 1e-6, 1 - 1e-6))
        slope_y = _erfinv(torch.clamp(2.0 * torch.clamp(u2, min=1e-6) - 1.0,
                                      -1 + 1e-6, 1 - 1e-6))
        ni = (cos_theta_i > 0.9999) | ~theta_big
        r = m.safe_sqrt(-torch.log(torch.clamp(1.0 - u1, min=1e-38)))
        phi_ni = 2 * m.Pi * u2
        slope_x = torch.where(ni, r * torch.cos(phi_ni), slope_x)
        slope_y = torch.where(ni, r * torch.sin(phi_ni), slope_y)
        return slope_x, slope_y


def _erf_approx(x):
    """Abramowitz-Stegun 7.1.26, |error| < 1.5e-7 (the JAX package's
    ``_erf_approx``)."""
    sign = torch.sign(x)
    x = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741)
                * t - 0.284496736) * t + 0.254829592) * t * torch.exp(-x * x)
    return sign * y


def _erfinv(x):
    """Giles 2010's single-precision rational approximation of erf^-1 (the
    JAX package's ``_erfinv``)."""
    w = -torch.log(torch.clamp((1.0 - x) * (1.0 + x), min=1e-38))
    w_small = w < 5.0
    ws = w - 2.5
    wb = torch.sqrt(torch.clamp(w, min=5.0)) - 3.0
    p_s = 2.81022636e-08
    p_s = 3.43273939e-07 + p_s * ws
    p_s = -3.5233877e-06 + p_s * ws
    p_s = -4.39150654e-06 + p_s * ws
    p_s = 0.00021858087 + p_s * ws
    p_s = -0.00125372503 + p_s * ws
    p_s = -0.00417768164 + p_s * ws
    p_s = 0.246640727 + p_s * ws
    p_s = 1.50140941 + p_s * ws
    p_b = -0.000200214257
    p_b = 0.000100950558 + p_b * wb
    p_b = 0.00134934322 + p_b * wb
    p_b = -0.00367342844 + p_b * wb
    p_b = 0.00573950773 + p_b * wb
    p_b = -0.0076224613 + p_b * wb
    p_b = 0.00943887047 + p_b * wb
    p_b = 1.00167406 + p_b * wb
    p_b = 2.83297682 + p_b * wb
    return torch.where(w_small, p_s, p_b) * x
