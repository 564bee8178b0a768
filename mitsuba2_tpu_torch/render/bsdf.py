"""BSDF abstraction.

Parity: include/mitsuba/render/bsdf.h — ``BSDFFlags`` lobe bitfield
(bsdf.h:38-100), ``BSDFContext`` (bsdf.h:217-244) and the BSDF base. The
kernels shade the ported BSDFs themselves from the scene's face tables;
the wavefront calls each plugin's per-lane ``sample``/``eval``/``pdf``
(bsdf.h:328-391: directions in the local shading frame, ``si.wi`` away
from the surface; ``sample`` returns the value over its pdf with the
cosine folded in, ``eval`` the value times cos theta_o).
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from ..core.object import Object
from .records import BSDFSample3


class BSDFFlags(enum.IntFlag):
    # (bsdf.h:38-100)
    Empty = 0x00000
    Null = 0x00001
    DiffuseReflection = 0x00002
    DiffuseTransmission = 0x00004
    GlossyReflection = 0x00008
    GlossyTransmission = 0x00010
    DeltaReflection = 0x00020
    DeltaTransmission = 0x00040
    Anisotropic = 0x01000
    SpatiallyVarying = 0x02000
    NonSymmetric = 0x04000
    FrontSide = 0x08000
    BackSide = 0x10000
    NeedsDifferentials = 0x20000
    # composites
    Reflection = (DiffuseReflection | GlossyReflection | DeltaReflection)
    Transmission = (DiffuseTransmission | GlossyTransmission
                    | DeltaTransmission | Null)
    Diffuse = DiffuseReflection | DiffuseTransmission
    Glossy = GlossyReflection | GlossyTransmission
    Smooth = Diffuse | Glossy
    Delta = DeltaReflection | DeltaTransmission
    All = Reflection | Transmission


class BSDF(Object):
    """Base BSDF (bsdf.h:328)."""

    def __init__(self, props=None):
        super().__init__(props)
        self.m_flags = BSDFFlags.Empty
        self.m_components: list[BSDFFlags] = []

    def flags(self, component: int | None = None) -> BSDFFlags:
        if component is None:
            return self.m_flags
        return self.m_components[component]

    def eval_null_transmission(self, si, active):
        """The spectrum a null lobe passes straight through (bsdf.h:408):
        none, unless the BSDF has one -> (n, C)."""
        from ..core import spectrum as spec
        return spec.zeros(si)

    def eval_pol(self, ctx, si, wo, active):
        """``eval`` as Mueller matrices (n, C, 4, 4) in the local frame's
        Stokes bases: a depolarizer (the reference's
        ``unpolarized<Spectrum>()`` wrapper) unless the BSDF polarizes."""
        return depolarize_value(self.eval(ctx, si, wo, active))

    def sample_pol(self, ctx, si, sample1, sample2, active):
        """``sample`` with its weight as Mueller matrices (n, C, 4, 4)."""
        bs, value = self.sample(ctx, si, sample1, sample2, active)
        return bs, depolarize_value(value)


class TransportMode(enum.IntEnum):
    Radiance = 0
    Importance = 1


class BSDFContext(NamedTuple):
    """Query context (bsdf.h:217): the transport mode, the enabled lobe
    types and the selected component (-1 all)."""
    mode: int = TransportMode.Radiance
    type_mask: int = int(BSDFFlags.All)
    component: int = -1

    def is_enabled(self, flags: BSDFFlags, component: int = 0) -> bool:
        return ((self.type_mask & int(flags)) == int(flags)
                and (self.component == -1 or self.component == component))


def depolarize_value(value):
    """(n, C) spectra -> (n, C, 4, 4) depolarizers (the value in the
    matrix's (0, 0) entry)."""
    out = torch.zeros(value.shape + (4, 4), dtype=value.dtype,
                      device=value.device)
    out[..., 0, 0] = value
    return out


def zero_bsdf_sample(n, device) -> BSDFSample3:
    """The sample of a lane no BSDF sampled: wo = +z, pdf 0, eta 1."""
    wo = torch.zeros((n, 3), device=device)
    wo[:, 2] = 1.0
    return BSDFSample3(wo, torch.zeros((n,), device=device),
                       torch.ones((n,), device=device),
                       torch.zeros((n,), dtype=torch.int32, device=device),
                       torch.full((n,), -1, dtype=torch.int32,
                                  device=device))
