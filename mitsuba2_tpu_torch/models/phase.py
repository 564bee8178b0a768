"""Phase functions (reference: src/phase/{isotropic,hg}.cpp,
include/mitsuba/render/phase.h:85; counterpart of
``mitsuba2_tpu.models.phase``).

``eval`` and ``sample`` are plain torch functions of world directions:
``wi`` is the medium interaction's incident direction, -ray.d
(medium.cpp:46), and ``wo`` the scattered one. Each takes a medium record
(render/interaction.py ``MediumInteraction``, as the volpath wavefront
calls them: ``sample(mi, u2, active)``, ``eval(mi, wo, active)``) or its
``wi`` alone, and reads only ``wi`` of it; ``active`` masks nothing (the
caller selects its lanes), as in the reference. The volumetric kernel
evaluates and samples the same functions itself (ops/volpath_kernel.py).
"""

from __future__ import annotations

import torch

from ..core import math as m
from ..core.object import Object, register_plugin

INV_FOUR_PI = 1.0 / (4.0 * m.Pi)


def coordinate_system(n):
    """Duff et al.'s branchless orthonormal basis (s, t) around unit n
    (..., 3) (vector.h coordinate_system)."""
    nx, ny, nz = n.unbind(-1)
    pos = nz >= 0
    sgn = torch.where(pos, torch.ones_like(nz), -torch.ones_like(nz))
    a = -1.0 / (sgn + nz)
    b = nx * ny * a
    sx = torch.where(pos, nx * nx * a, -(nx * nx * a)) + 1.0
    s = torch.stack([sx, torch.where(pos, b, -b),
                     torch.where(pos, -nx, nx)], -1)
    t = torch.stack([b, sgn + ny * ny * a, -ny], -1)
    return s, t


def square_to_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 1]
    r = m.safe_sqrt(1.0 - z * z)
    phi = 2.0 * m.Pi * u[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def _wi(mi):
    """The incident direction of a medium record, or ``mi`` itself."""
    return getattr(mi, "wi", mi)


class PhaseFunction(Object):
    """Base (phase.h:85): sample(mi, sample2) -> (wo, pdf); eval(mi, wo)."""

    def sample(self, mi, sample2, active=True):
        raise NotImplementedError

    def eval(self, mi, wo, active=True):
        raise NotImplementedError


@register_plugin("phase", "isotropic")
class IsotropicPhase(PhaseFunction):
    """(isotropic.cpp) the uniform sphere."""

    def sample(self, mi, sample2, active=True):
        wo = square_to_uniform_sphere(sample2)
        return wo, torch.full(wo.shape[:-1], INV_FOUR_PI, dtype=wo.dtype,
                              device=wo.device)

    def eval(self, mi, wo, active=True):
        return torch.full(wo.shape[:-1], INV_FOUR_PI, dtype=wo.dtype,
                          device=wo.device)


@register_plugin("phase", "hg")
class HGPhase(PhaseFunction):
    """(hg.cpp) Henyey-Greenstein with anisotropy ``g`` in (-1, 1): density
    grows around the forward continuation -wi for g > 0."""

    def __init__(self, props=None):
        super().__init__(props)
        self.g = float(props.float_("g", 0.8)) if props else 0.8

    def sample(self, mi, sample2, active=True):
        g = self.g
        wi = _wi(mi)
        if abs(g) < 1e-3:
            wo = square_to_uniform_sphere(sample2)
            return wo, self.eval(wi, wo)
        sqr_term = (1 - g * g) / (1 - g + 2 * g * sample2[..., 0])
        cos_theta = (1 + g * g - sqr_term * sqr_term) / (2 * g)
        sin_theta = m.safe_sqrt(1.0 - cos_theta * cos_theta)
        phi = 2 * m.Pi * sample2[..., 1]
        # around the forward-scattering axis -wi
        s, t = coordinate_system(-wi)
        wo = (s * (sin_theta * torch.cos(phi))[..., None]
              + t * (sin_theta * torch.sin(phi))[..., None]
              + -wi * cos_theta[..., None])
        return wo, self.eval(wi, wo)

    def eval(self, mi, wo, active=True):
        g = self.g
        temp = 1.0 + g * g + 2.0 * g * m.dot(_wi(mi), wo)
        return INV_FOUR_PI * (1 - g * g) \
            / torch.clamp(temp * m.safe_sqrt(temp), min=1e-8)
