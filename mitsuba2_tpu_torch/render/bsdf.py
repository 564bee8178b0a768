"""BSDF abstraction.

Parity: include/mitsuba/render/bsdf.h — ``BSDFFlags`` lobe bitfield
(bsdf.h:38-100) and the BSDF base. In this slice the path kernel shades
constant-albedo diffuse surfaces itself from the scene's face tables, so
the base carries flags and components only; the per-lane
sample/eval/pdf interface comes with the torch wavefront.
"""

from __future__ import annotations

import enum

from ..core.object import Object


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
