"""Emitter plugins (reference: src/emitters/). This slice ports ``area``
and ``envmap``.

An area emitter packs its shape's triangles and per-face areas on the host
at scene compile (``prepare``); the scene turns them into the light table
the path kernel samples from (area-weighted face pick, then a uniform
point on the triangle — mesh.cpp:300-307). An envmap holds its lat-long
rgb radiance; the scene packs it, and its importance-sampling tables, for
the path kernel.
"""

from __future__ import annotations

import numpy as np

from ..core.object import register_plugin
from ..core.transform import Transform
from ..render.emitter import Emitter, EmitterFlags


@register_plugin("emitter", "area")
class AreaEmitter(Emitter):
    """(area.cpp) one-sided surface emitter with uniform radiance: a
    constant color, or in spectral variants a D65-weighted spectrum
    (``SRGBD65Spectrum`` or ``D65Spectrum``)."""

    def __init__(self, props=None):
        super().__init__(props)
        if props is not None:
            self.radiance = props.texture_d65("radiance", 1.0)
        else:
            from .textures import as_texture
            self.radiance = as_texture(1.0, within_emitter=True)
        self.m_flags = EmitterFlags.Surface
        if self.radiance.is_spatially_varying():
            self.m_flags |= EmitterFlags.SpatiallyVarying
        self._packed = False

    def prepare(self, scene):
        """Per-face sampling tables of the attached mesh: origin ``tv0``,
        edges ``te1``/``te2``, unit normal ``tn`` and ``face_areas``."""
        del scene
        mesh = self.shape
        if mesh is None or not mesh.is_mesh():
            raise RuntimeError("area emitter requires a mesh shape")
        p = mesh.vertices[mesh.faces]
        self.tv0 = p[:, 0]
        self.te1 = p[:, 1] - p[:, 0]
        self.te2 = p[:, 2] - p[:, 0]
        fn = np.cross(self.te1, self.te2)
        self.face_areas = (0.5 * np.linalg.norm(fn, axis=-1)).astype(
            np.float32)
        self.total_area = float(self.face_areas.sum())
        self.tn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True),
                                  1e-20)
        self._packed = True


@register_plugin("emitter", "envmap")
class EnvironmentMap(Emitter):
    """(envmap.cpp) lat-long environment map: ``filename`` (an EXR read
    through utils/io_image.py), ``scale`` and ``to_world``. rgb only. The
    radiance ``data`` is (h, w, 3) float32 with the scale applied; u runs
    along the width, v along the height (u = atan2(x, -z) / 2 pi + 1/2,
    v = acos(y) / pi in the emitter's frame)."""

    def __init__(self, props=None, data=None, scale=1.0):
        super().__init__(props)
        self.to_world = Transform.identity()
        if props is not None:
            from ..utils import io_image
            data = io_image.read_image(props.string("filename"))
            scale = props.float_("scale", 1.0)
            self.to_world = props.transform("to_world", self.to_world)
        data = np.asarray(data, np.float32)
        if data.ndim == 2:
            data = data[..., None]
        if data.shape[-1] == 1:
            data = np.repeat(data, 3, -1)
        self.data = data[..., :3] * scale
        self.res = (self.data.shape[1], self.data.shape[0])
        self.m_flags = EmitterFlags.Infinite | EmitterFlags.SpatiallyVarying
