"""Scalar constants and tensor helpers (reference: include/mitsuba/core/
math.h, constants.h, vector.h; counterpart of ``mitsuba2_tpu.core.math``)."""

from __future__ import annotations

import torch

Pi = 3.141592653589793
TwoPi = 2.0 * Pi
FourPi = 4.0 * Pi
InvPi = 1.0 / Pi
InvTwoPi = 1.0 / TwoPi
InvFourPi = 1.0 / FourPi
SqrtPi = 1.7724538509055160
SqrtTwo = 1.4142135623730951
InvSqrtPi = 1.0 / SqrtPi
InvSqrtTwo = 1.0 / SqrtTwo
Infinity = float("inf")
# Ray-offset epsilons (include/mitsuba/render/fwd.h: float32 machine
# epsilon times 1500, and ten times that for shadow rays, as
# mitsuba2_tpu.core.math has them): a ray's default mint and the shadow
# ray's shortening (scene.cpp:204-206)
RayEpsilon = 1.1920929e-07 * 1500.0
ShadowEpsilon = RayEpsilon * 10.0
# the largest float32 below one is 1 - Epsilon
Epsilon = 1.1920929e-07 / 2


def safe_div(a, b, fallback=0.0):
    """a / b where b != 0, else ``fallback`` (no inf/NaN leaks); ``a`` and
    ``fallback`` may be numbers."""
    ok = b != 0
    return torch.where(ok, a / torch.where(ok, b, torch.ones_like(b)),
                       fallback)


# The safe functions below give the same values whether or not their
# argument is traced; a traced one (a differentiable render's) takes its
# derivative only where it is finite, zero at the domain's edge, where an
# unguarded sqrt or acos would turn a masked lane's zero gradient into NaN.

def safe_sqrt(x):
    if not x.requires_grad:
        return torch.sqrt(torch.clamp(x, min=0.0))
    ok = x > 0
    return torch.where(ok, torch.sqrt(torch.where(ok, x, 1.0)), 0.0)


def safe_rsqrt(x):
    return torch.rsqrt(torch.clamp(x, min=torch.finfo(x.dtype).tiny))


def _inside(f, x):
    """f(clamp(x, -1, 1)), its derivative zero where |x| >= 1."""
    c = torch.clamp(x, -1.0, 1.0)
    if not x.requires_grad:
        return f(c)
    ok = c.abs() < 1.0
    return torch.where(ok, f(torch.where(ok, c, 0.0)), f(c.detach()))


def safe_acos(x):
    return _inside(torch.acos, x)


def safe_asin(x):
    return _inside(torch.asin, x)


def sqr(x):
    return x * x


def rcp(x):
    return 1.0 / x


def clamp(x, lo, hi):
    return torch.clamp(x, lo, hi)


def fmadd(a, b, c):
    return a * b + c


def lerp(a, b, t):
    return a + (b - a) * t


def mulsign(x, s):
    """``x`` with the sign of ``s`` applied (Enoki ``mulsign``)."""
    return torch.where(s >= 0, x, -x)


def sign(x):
    """+1 where x >= 0, else -1."""
    return torch.where(x >= 0, 1.0, -1.0)


def dot(a, b):
    """Dot product over the last axis of (..., 3) tensors."""
    return (a * b).sum(-1)


def abs_dot(a, b, keepdims: bool = False):
    d = (a * b).sum(-1, keepdim=keepdims)
    return d.abs()


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def norm(v):
    return torch.sqrt((v * v).sum(-1))


def squared_norm(v):
    return (v * v).sum(-1)


def normalize(v):
    return v * safe_rsqrt((v * v).sum(-1, keepdim=True))


def vec3(x, y, z):
    """(..., 3) vector of three tensors (or numbers beside a tensor)."""
    like = next(c for c in (x, y, z) if isinstance(c, torch.Tensor))
    x, y, z = (c if isinstance(c, torch.Tensor) else torch.full_like(like, c)
               for c in (x, y, z))
    return torch.stack(torch.broadcast_tensors(x, y, z), -1)


def vec2(x, y):
    """(..., 2) vector of two tensors (or a number beside a tensor)."""
    like = x if isinstance(x, torch.Tensor) else y
    x, y = (c if isinstance(c, torch.Tensor) else torch.full_like(like, c)
            for c in (x, y))
    return torch.stack(torch.broadcast_tensors(x, y), -1)


def unstack(v):
    """The trailing axis's components as a tuple of tensors."""
    return tuple(v[..., i] for i in range(v.shape[-1]))


def coordinate_system(n):
    """Orthonormal tangents (s, t) of unit normals n (..., 3): Duff et
    al. 2017's branchless construction (vector.h coordinate_system)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = sign(nz)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    s_x = vec3(mulsign(nx * nx * a, nz) + 1.0, mulsign(b, nz),
               mulsign(-nx, nz))
    s_y = vec3(b, s + ny * ny * a, -ny)
    return s_x, s_y


def spherical_direction(theta, phi):
    """Unit directions from spherical angles (z up)."""
    st, ct = torch.sin(theta), torch.cos(theta)
    return vec3(st * torch.cos(phi), st * torch.sin(phi), ct)


def spherical_coordinates(d):
    """(theta, phi) of unit directions (..., 3)."""
    return safe_acos(d[..., 2]), torch.atan2(d[..., 1], d[..., 0])


def linear_to_srgb(x):
    """Linear RGB -> the sRGB transfer curve (math.h linear_to_srgb)."""
    x = torch.clamp(x, min=0.0)
    return torch.where(x <= 0.0031308, x * 12.92,
                       1.055 * torch.pow(torch.clamp(x, min=1e-12),
                                         1.0 / 2.4) - 0.055)


def srgb_to_linear(x):
    x = torch.clamp(x, min=0.0)
    return torch.where(x <= 0.04045, x / 12.92,
                       torch.pow((x + 0.055) / 1.055, 2.4))


def find_interval(size, pred):
    """Mitsuba's math::find_interval: the JAX package leaves it to
    ``searchsorted`` (mitsuba2_tpu/core/math.py find_interval), and so
    does the port."""
    raise NotImplementedError("use torch.searchsorted")


def legendre_p(order: int, x):
    """The Legendre polynomial P_n(x) by its recurrence (math.h
    legendre_p)."""
    if order == 0:
        return torch.ones_like(x)
    p_prev, p = torch.ones_like(x), x
    for n in range(1, order):
        p_prev, p = p, ((2 * n + 1) * x * p - n * p_prev) / (n + 1)
    return p


def legendre_pd(order: int, x):
    """(P_n(x), P_n'(x)), as Gauss-Legendre node finding uses them."""
    if order == 0:
        return torch.ones_like(x), torch.zeros_like(x)
    p_prev, p = torch.ones_like(x), x
    d_prev, d = torch.zeros_like(x), torch.ones_like(x)
    for n in range(1, order):
        p_next = ((2 * n + 1) * x * p - n * p_prev) / (n + 1)
        d_next = d_prev + (2 * n + 1) * p
        p_prev, p, d_prev, d = p, p_next, d, d_next
    return p, d
