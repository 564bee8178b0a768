"""Shading frame (reference: include/mitsuba/core/frame.h Frame3f;
counterpart of ``mitsuba2_tpu.core.frame``).

A Frame is three (..., 3) tensors forming an orthonormal basis with ``n``
the shading normal. The trigonometric helpers take directions in local
frame coordinates (z = n).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import math as m


class Frame(NamedTuple):
    s: torch.Tensor  # tangent
    t: torch.Tensor  # bitangent
    n: torch.Tensor  # normal

    @staticmethod
    def from_normal(n) -> "Frame":
        s, t = m.coordinate_system(n)
        return Frame(s, t, n)

    def to_local(self, v):
        return torch.stack([m.dot(v, self.s), m.dot(v, self.t),
                            m.dot(v, self.n)], -1)

    def to_world(self, v):
        return (self.s * v[..., 0:1] + self.t * v[..., 1:2]
                + self.n * v[..., 2:3])


# Local-frame trigonometry (frame.h:62-140)
def cos_theta(v):
    return v[..., 2]


def cos_theta_2(v):
    return m.sqr(v[..., 2])


def sin_theta_2(v):
    return torch.clamp(1.0 - cos_theta_2(v), min=0.0)


def sin_theta(v):
    return m.safe_sqrt(sin_theta_2(v))


def tan_theta(v):
    return m.safe_div(sin_theta(v), cos_theta(v), 0.0)


def tan_theta_2(v):
    return m.safe_div(sin_theta_2(v), cos_theta_2(v), 0.0)


def sin_phi(v):
    s = sin_theta(v)
    return torch.where(s == 0, 0.0,
                       torch.clamp(m.safe_div(v[..., 1], s), -1.0, 1.0))


def cos_phi(v):
    s = sin_theta(v)
    return torch.where(s == 0, 1.0,
                       torch.clamp(m.safe_div(v[..., 0], s), -1.0, 1.0))


def sincos_phi_2(v):
    s2 = sin_theta_2(v)
    inv = m.safe_div(torch.ones_like(s2), s2, 0.0)
    sin_phi2 = torch.where(s2 <= 0, 0.0,
                           torch.clamp(m.sqr(v[..., 1]) * inv, 0.0, 1.0))
    cos_phi2 = torch.where(s2 <= 0, 1.0,
                           torch.clamp(m.sqr(v[..., 0]) * inv, 0.0, 1.0))
    return sin_phi2, cos_phi2
