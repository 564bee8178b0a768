"""Square-to-distribution warps with their densities (reference:
include/mitsuba/core/warp.h; counterpart of ``mitsuba2_tpu.core.warp``,
every warp of it with its pdf, in its arithmetic order). Samples are
(..., 2) tensors in [0, 1)^2."""

from __future__ import annotations

import torch

from . import math as m
from .math import (InvFourPi, InvPi, InvTwoPi, Pi, TwoPi, safe_sqrt, sqr,
                   vec2, vec3)


def _like(value, ref):
    """``value`` (a number or tensor) as a tensor of ``ref``'s dtype and
    device."""
    return torch.as_tensor(value, dtype=ref.dtype, device=ref.device)


def interval_to_linear(v0, v1, sample):
    """Importance sample a linear interpolant on [0, 1] with end values v0,
    v1."""
    num = v0 - safe_sqrt(m.lerp(sqr(v0), sqr(v1), sample))
    den = v0 - v1
    return torch.where(den.abs() > 1e-9, m.safe_div(num, den, sample),
                       sample)


def interval_to_tent(sample):
    """[0, 1] -> [-1, 1] with density 1 - |x|."""
    return torch.where(sample < 0.5, safe_sqrt(2.0 * sample) - 1.0,
                       1.0 - safe_sqrt(torch.clamp(2.0 - 2.0 * sample,
                                                   min=0.0)))


def interval_to_nonuniform_tent(a, b, c, sample):
    """[0, 1] -> [a, c], a tent with its peak at b (warp.h
    interval_to_nonuniform_tent)."""
    a, b, c = (_like(x, sample) for x in (a, b, c))
    left = sample < m.safe_div(b - a, c - a, 0.0)
    x_l = a + safe_sqrt(sample * (b - a) * (c - a))
    x_r = c - safe_sqrt((1.0 - sample) * (c - b) * (c - a))
    return torch.where(left, x_l, x_r)


def square_to_uniform_disk(sample):
    r = safe_sqrt(sample[..., 1])
    phi = TwoPi * sample[..., 0]
    return vec2(r * torch.cos(phi), r * torch.sin(phi))


def square_to_uniform_disk_pdf(p):
    return torch.where(m.squared_norm(p) <= 1.0, InvPi, 0.0)


def square_to_uniform_disk_concentric(sample):
    """Shirley-Chiu low-distortion concentric disk mapping (warp.h:54)."""
    x = 2.0 * sample[..., 0] - 1.0
    y = 2.0 * sample[..., 1] - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quadrant_1_or_3 = x.abs() < y.abs()
    r = torch.where(quadrant_1_or_3, y, x)
    rp = torch.where(quadrant_1_or_3, x, y)
    phi = 0.25 * Pi * m.safe_div(rp, r, 0.0)
    phi = torch.where(quadrant_1_or_3, 0.5 * Pi - phi, phi)
    phi = torch.where(is_zero, 0.0, phi)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], -1)


def square_to_uniform_disk_concentric_pdf(p):
    return square_to_uniform_disk_pdf(p)


def uniform_disk_to_square_concentric(p):
    """The concentric mapping's inverse (warp.h:96)."""
    quadrant_0_or_2 = p[..., 0].abs() > p[..., 1].abs()
    r_sign = torch.where(quadrant_0_or_2, p[..., 0], p[..., 1])
    r = torch.copysign(m.norm(p), r_sign)
    phi = torch.atan2(m.mulsign(p[..., 1], r_sign),
                      m.mulsign(p[..., 0], r_sign))
    t = 4.0 / Pi * phi
    t = torch.where(quadrant_0_or_2, t, 2.0 - t) * r
    a = torch.where(quadrant_0_or_2, r, t)
    b = torch.where(quadrant_0_or_2, t, r)
    return vec2((a + 1.0) * 0.5, (b + 1.0) * 0.5)


def square_to_uniform_square_concentric(sample):
    """Square -> square through the concentric disk (warp.h)."""
    return uniform_disk_to_square_concentric(
        square_to_uniform_disk_concentric(sample))


def square_to_uniform_triangle(sample):
    """Uniform barycentrics on the triangle (0,0), (1,0), (0,1)."""
    t = safe_sqrt(1.0 - sample[..., 0])
    return torch.stack([1.0 - t, t * sample[..., 1]], -1)


def square_to_uniform_triangle_pdf(p):
    inside = (p[..., 0] >= 0) & (p[..., 1] >= 0) \
        & (p[..., 0] + p[..., 1] <= 1)
    return torch.where(inside, 2.0, 0.0)


def square_to_std_normal(sample):
    """The Box-Muller transform to a 2D standard normal."""
    r = safe_sqrt(-2.0 * torch.log(torch.clamp(1.0 - sample[..., 0],
                                               min=1e-38)))
    phi = TwoPi * sample[..., 1]
    return vec2(r * torch.cos(phi), r * torch.sin(phi))


def square_to_std_normal_pdf(p):
    return InvTwoPi * torch.exp(-0.5 * m.squared_norm(p))


def square_to_tent(sample):
    return vec2(interval_to_tent(sample[..., 0]),
                interval_to_tent(sample[..., 1]))


def square_to_tent_pdf(p):
    ax, ay = p[..., 0].abs(), p[..., 1].abs()
    return torch.where((ax <= 1.0) & (ay <= 1.0), (1.0 - ax) * (1.0 - ay),
                       0.0)


def square_to_uniform_sphere(sample):
    z = 1.0 - 2.0 * sample[..., 1]
    r = safe_sqrt(1.0 - sqr(z))
    phi = TwoPi * sample[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def square_to_uniform_sphere_pdf(v):
    return torch.full(v.shape[:-1], InvFourPi, dtype=v.dtype,
                      device=v.device)


def square_to_uniform_hemisphere(sample):
    z = sample[..., 1]
    r = safe_sqrt(1.0 - sqr(z))
    phi = TwoPi * sample[..., 0]
    return vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def square_to_uniform_hemisphere_pdf(v):
    return torch.where(v[..., 2] >= 0, InvTwoPi, 0.0)


def square_to_cosine_hemisphere(sample):
    p = square_to_uniform_disk_concentric(sample)
    z = safe_sqrt(1.0 - m.squared_norm(p))
    return torch.stack([p[..., 0], p[..., 1], z], -1)


def square_to_cosine_hemisphere_pdf(v):
    return torch.clamp(v[..., 2], min=0.0) * InvPi


def square_to_uniform_cone(sample, cos_cutoff):
    """Uniform direction in a cone around +z (warp.h:446)."""
    z = m.lerp(1.0, cos_cutoff, sample[..., 1])
    r = safe_sqrt(1.0 - sqr(z))
    phi = TwoPi * sample[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def square_to_uniform_cone_pdf(v, cos_cutoff):
    return torch.where(v[..., 2] >= cos_cutoff,
                       InvTwoPi / (1.0 - cos_cutoff), 0.0)


def square_to_beckmann(sample, alpha):
    """Sample the Beckmann normal distribution times cos (warp.h:496)."""
    phi = TwoPi * sample[..., 0]
    tan_theta_2 = -sqr(alpha) * torch.log(
        torch.clamp(1.0 - sample[..., 1], min=1e-38))
    cos_theta = m.safe_rsqrt(1.0 + tan_theta_2)
    r = safe_sqrt(torch.clamp(1.0 - sqr(cos_theta), min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), cos_theta],
                       -1)


def square_to_beckmann_pdf(v, alpha):
    ct = v[..., 2]
    ok = ct > 1e-9
    ct_safe = torch.where(ok, ct, 1.0)
    tan_theta_2 = (1.0 - sqr(ct_safe)) / sqr(ct_safe)
    pdf = torch.exp(-tan_theta_2 / sqr(alpha)) \
        / (Pi * sqr(alpha) * ct_safe ** 3)
    return torch.where(ok, pdf, 0.0)


def square_to_von_mises_fisher(sample, kappa):
    """The von Mises-Fisher distribution around +z (warp.h:551): z = 1 +
    log(y + (1 - y) e^{-2 kappa}) / kappa with y = 1 - sample.y held off
    zero, which stays finite in float32 at large kappa; uniform on the
    sphere at kappa <= 0."""
    kappa = _like(kappa, sample)
    sy = torch.clamp(1.0 - sample[..., 1], min=1e-38)
    z = 1.0 + torch.log(sy + (1.0 - sy) * torch.exp(-2.0 * kappa)) \
        / torch.clamp(kappa, min=1e-38)
    z = torch.where(kappa <= 0, 1.0 - 2.0 * sample[..., 1], z)
    r = safe_sqrt(1.0 - sqr(z))
    phi = TwoPi * sample[..., 0]
    return vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def square_to_von_mises_fisher_pdf(v, kappa):
    kappa = _like(kappa, v)
    pdf = torch.exp(kappa * (v[..., 2] - 1.0)) * kappa * InvTwoPi \
        / (1.0 - torch.exp(-2.0 * kappa))
    return torch.where(kappa <= 0, torch.full_like(pdf, InvFourPi), pdf)


def _fiber_frame(tangent, like):
    t = m.normalize(_like(tangent, like))
    s, b = m.coordinate_system(t)
    return s, b, t


def square_to_rough_fiber(sample, wi, tangent, kappa):
    """A rough fiber's scattering lobe (the role of warp.h:610), the JAX
    package's construction: a micro-normal from a vMF lobe of
    concentration ``kappa`` in a frame around ``tangent``, and ``wi``
    reflected about it."""
    s, b, t = _fiber_frame(tangent, sample)
    wi = _like(wi, sample)
    wi_l = vec3(m.dot(wi, s), m.dot(wi, b), m.dot(wi, t))
    n = square_to_von_mises_fisher(sample, kappa)
    wo_l = m.normalize(-wi_l + 2.0 * m.dot(wi_l, n)[..., None] * n)
    return s * wo_l[..., 0:1] + b * wo_l[..., 1:2] + t * wo_l[..., 2:3]


def square_to_rough_fiber_pdf(v, wi, tangent, kappa):
    """The density of ``square_to_rough_fiber`` through the half vector's
    Jacobian: p(wo) = p_n(h) / (4 |wo . h|), h = normalize(wo + wi), both
    n = h and n = -h reflecting wi onto wo."""
    s, b, t = _fiber_frame(tangent, v)
    wi = _like(wi, v)

    def local(x):
        return vec3(m.dot(x, s), m.dot(x, b), m.dot(x, t))

    wi_l, v_l = local(wi), local(v)
    h = m.normalize(v_l + wi_l)
    pn = (square_to_von_mises_fisher_pdf(h, kappa)
          + square_to_von_mises_fisher_pdf(-h, kappa))
    return m.safe_div(pn, 4.0 * m.dot(v_l, h).abs(), 0.0)


def square_to_bilinear(v00, v10, v01, v11, sample):
    """Sample a bilinear interpolant on [0, 1]^2 with corner values
    v<ix><iy> -> (point, pdf) (warp.h square_to_bilinear)."""
    x = interval_to_linear(v00 + v01, v10 + v11, sample[..., 0])
    c0 = m.lerp(v00, v10, x)
    c1 = m.lerp(v01, v11, x)
    y = interval_to_linear(c0, c1, sample[..., 1])
    p = torch.stack([x, y], -1)
    return p, square_to_bilinear_pdf(v00, v10, v01, v11, p)


def square_to_bilinear_pdf(v00, v10, v01, v11, p):
    x, y = p[..., 0], p[..., 1]
    f = (v00 * (1 - x) * (1 - y) + v10 * x * (1 - y)
         + v01 * (1 - x) * y + v11 * x * y)
    integral = 0.25 * (v00 + v10 + v01 + v11)
    inside = (x >= 0) & (x <= 1) & (y >= 0) & (y <= 1)
    return torch.where(inside, m.safe_div(f, integral, 0.0), 0.0)
