"""Scalar constants and tensor helpers (reference: include/mitsuba/core/
math.h, constants.h). Only what the ported slice calls."""

from __future__ import annotations

import torch

Pi = 3.141592653589793
# Ray-offset epsilon (include/mitsuba/render/fwd.h: float32 machine epsilon
# times 1500, as mitsuba2_tpu.core.math has it): a ray's default mint
RayEpsilon = 1.1920929e-07 * 1500.0


def safe_div(a, b, fallback=0.0):
    """a / b where b != 0, else ``fallback`` (no inf/NaN leaks)."""
    ok = b != 0
    return torch.where(ok, a / torch.where(ok, b, torch.ones_like(b)),
                       torch.full_like(a, fallback))


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_rsqrt(x):
    return torch.rsqrt(torch.clamp(x, min=torch.finfo(x.dtype).tiny))


def dot(a, b):
    """Dot product over the last axis of (..., 3) tensors."""
    return (a * b).sum(-1)


def normalize(v):
    return v * safe_rsqrt((v * v).sum(-1, keepdim=True))
