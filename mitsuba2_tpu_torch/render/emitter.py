"""Emitters.

Parity: include/mitsuba/render/emitter.h:61 (EmitterFlags) and the endpoint
base. Emitters pack their sampling tables on the host at scene compile;
the path kernel samples them from the scene's light table.
"""

from __future__ import annotations

import enum

from ..core.object import Object


class EmitterFlags(enum.IntFlag):
    # (emitter.h:14-44)
    Empty = 0x00000
    DeltaPosition = 0x00001
    DeltaDirection = 0x00002
    Infinite = 0x00004
    Surface = 0x00008
    SpatiallyVarying = 0x00010
    Delta = DeltaPosition | DeltaDirection


class Emitter(Object):
    def __init__(self, props=None):
        super().__init__(props)
        self.m_flags = EmitterFlags.Empty
        self.shape = None          # set when attached to a shape
        self._scene_bsphere = None  # set by set_scene

    def set_shape(self, shape):
        self.shape = shape

    def set_scene(self, scene):
        """Keeps the scene's bounding sphere (envmap.cpp set_scene); the
        port's environment emitters read it from the wavefront's tables
        (render/scene.py WavefrontTables.bsphere)."""
        self._scene_bsphere = scene.bounding_sphere()

    def is_environment(self) -> bool:
        return bool(self.m_flags & EmitterFlags.Infinite) and \
            not bool(self.m_flags & EmitterFlags.Delta)

    def flags(self):
        return self.m_flags

    # the endpoint interface (endpoint.h:86-163)
    def sample_ray(self, time, sample1, sample2, sample3, active):
        """An emitted ray (position, direction and wavelengths)."""
        raise NotImplementedError

    def sample_direction(self, it, sample, active):
        """-> (DirectionSample, spectrum / pdf)."""
        raise NotImplementedError

    def pdf_direction(self, it, ds, active):
        raise NotImplementedError

    def eval(self, si, active):
        """The radiance emitted at ``si`` toward ``si.wi``."""
        raise NotImplementedError
