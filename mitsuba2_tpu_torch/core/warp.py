"""Square-to-distribution warps with their densities (reference:
include/mitsuba/core/warp.h; counterpart of ``mitsuba2_tpu.core.warp``):
the ones the path integrator's wavefront draws from. Samples are (..., 2)
tensors in [0, 1)^2."""

from __future__ import annotations

import torch

from . import math as m
from .math import InvFourPi, InvPi, InvTwoPi, Pi, TwoPi, safe_sqrt, sqr


def interval_to_linear(v0, v1, sample):
    """Importance sample a linear interpolant on [0, 1] with end values v0,
    v1."""
    num = v0 - safe_sqrt(m.lerp(sqr(v0), sqr(v1), sample))
    den = v0 - v1
    return torch.where(den.abs() > 1e-9, m.safe_div(num, den, sample),
                       sample)


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
    return torch.where(m.squared_norm(p) <= 1.0, InvPi, 0.0)


def square_to_uniform_triangle(sample):
    """Uniform barycentrics on the triangle (0,0), (1,0), (0,1)."""
    t = safe_sqrt(1.0 - sample[..., 0])
    return torch.stack([1.0 - t, t * sample[..., 1]], -1)


def square_to_uniform_triangle_pdf(p):
    inside = (p[..., 0] >= 0) & (p[..., 1] >= 0) \
        & (p[..., 0] + p[..., 1] <= 1)
    return torch.where(inside, 2.0, 0.0)


def square_to_uniform_sphere(sample):
    z = 1.0 - 2.0 * sample[..., 1]
    r = safe_sqrt(1.0 - sqr(z))
    phi = TwoPi * sample[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def square_to_uniform_sphere_pdf(v):
    return torch.full(v.shape[:-1], InvFourPi, dtype=v.dtype,
                      device=v.device)


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
