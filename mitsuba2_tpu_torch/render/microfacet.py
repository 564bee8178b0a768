"""GGX microfacet distribution with Smith shadowing and visible-normal
sampling (reference: include/mitsuba/render/microfacet.h; the GGX part of
``mitsuba2_tpu.render.microfacet.MicrofacetDistribution``). Vectors are
(..., 3) tensors in the local shading frame (+z = normal). Beckmann comes
with the BSDFs that need it."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as m


class MicrofacetDistribution(NamedTuple):
    """GGX with roughness ``alpha_u`` along x and ``alpha_v`` along y."""
    alpha_u: float
    alpha_v: float

    def eval(self, mh):
        """Normal density D(m) (microfacet.h eval)."""
        ct = mh[..., 2]
        ct2 = ct * ct
        x2 = (mh[..., 0] / self.alpha_u) ** 2
        y2 = (mh[..., 1] / self.alpha_v) ** 2
        t = x2 + y2 + ct2
        val = m.safe_div(torch.ones_like(t),
                         m.Pi * self.alpha_u * self.alpha_v * t * t, 0.0)
        return torch.where(ct > 0, val, torch.zeros_like(val))

    def smith_g1(self, v, mh):
        """Smith's monodirectional shadowing G1(v, m) (microfacet.h
        smith_g1)."""
        ct = v[..., 2]
        xy_alpha_2 = ((self.alpha_u * v[..., 0]) ** 2
                      + (self.alpha_v * v[..., 1]) ** 2)
        tan_theta_alpha_2 = m.safe_div(xy_alpha_2, ct * ct, 0.0)
        result = 2.0 / (1.0 + torch.sqrt(1.0 + tan_theta_alpha_2))
        one = torch.ones_like(result)
        result = torch.where(xy_alpha_2 == 0.0, one, result)
        return torch.where(m.dot(v, mh) * ct <= 0.0,
                           torch.zeros_like(result), result)

    def G(self, wi, wo, mh):
        return self.smith_g1(wi, mh) * self.smith_g1(wo, mh)

    def pdf(self, wi, mh):
        """Density of ``sample``: the visible-normal density
        G1(wi, m) |wi . m| D(m) / |cos theta_i| (microfacet.h pdf)."""
        return (self.smith_g1(wi, mh) * m.dot(wi, mh).abs() * self.eval(mh)
                / torch.clamp(wi[..., 2].abs(), min=1e-8))

    def sample(self, wi, u1, u2):
        """-> (micro-normal m, pdf): Heitz 2018's visible-normal sampling
        by projection onto the stretched hemisphere."""
        au, av = self.alpha_u, self.alpha_v
        wi_s = m.normalize(torch.stack(
            [au * wi[..., 0], av * wi[..., 1], wi[..., 2]], -1))
        lensq = wi_s[..., 0] ** 2 + wi_s[..., 1] ** 2
        inv_len = m.safe_rsqrt(torch.clamp(lensq, min=1e-20))
        zero = torch.zeros_like(inv_len)
        t1 = torch.where(
            (lensq > 1e-14)[..., None],
            torch.stack([-wi_s[..., 1] * inv_len, wi_s[..., 0] * inv_len,
                         zero], -1),
            torch.stack([zero + 1.0, zero, zero], -1))
        t2 = torch.cross(wi_s, t1, dim=-1)
        r = m.safe_sqrt(u1)
        phi = 2.0 * m.Pi * u2
        p1 = r * torch.cos(phi)
        p2 = r * torch.sin(phi)
        s = 0.5 * (1.0 + wi_s[..., 2])
        p2 = (1.0 - s) * m.safe_sqrt(1.0 - p1 * p1) + s * p2
        nh = (t1 * p1[..., None] + t2 * p2[..., None]
              + wi_s * m.safe_sqrt(1.0 - p1 * p1 - p2 * p2)[..., None])
        mh = m.normalize(torch.stack(
            [au * nh[..., 0], av * nh[..., 1],
             torch.clamp(nh[..., 2], min=1e-6)], -1))
        return mh, self.pdf(wi, mh)
