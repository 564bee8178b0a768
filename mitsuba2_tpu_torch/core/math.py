"""Scalar constants and tensor helpers (reference: include/mitsuba/core/
math.h, constants.h, vector.h; counterpart of ``mitsuba2_tpu.core.math``).
Only what the ported slice calls."""

from __future__ import annotations

import torch

Pi = 3.141592653589793
TwoPi = 2.0 * Pi
InvPi = 1.0 / Pi
InvTwoPi = 1.0 / TwoPi
InvFourPi = 1.0 / (4.0 * Pi)
SqrtPi = 1.7724538509055160
InvSqrtPi = 1.0 / SqrtPi
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


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_rsqrt(x):
    return torch.rsqrt(torch.clamp(x, min=torch.finfo(x.dtype).tiny))


def safe_acos(x):
    return torch.acos(torch.clamp(x, -1.0, 1.0))


def safe_asin(x):
    return torch.asin(torch.clamp(x, -1.0, 1.0))


def sqr(x):
    return x * x


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
