"""Texture plugins: the constant color the scene loaders create for rgb
values (xml.cpp:774-850, src/spectra/srgb.cpp)."""

from __future__ import annotations

import numpy as np

from ..core.object import register_plugin
from ..render.texture import Texture

_LUMINANCE = np.asarray([0.212671, 0.715160, 0.072169], np.float64)


@register_plugin("texture", "srgb")
class ConstantTexture(Texture):
    """Uniform linear-rgb color, held on the host as float32."""

    def __init__(self, props=None, color=None):
        super().__init__(props)
        if color is None:
            color = props.get("color", props.get("value", 0.5))
        color = np.asarray(color, np.float32)
        if color.ndim == 0:
            color = np.broadcast_to(color, (3,)).copy()
        self.rgb = color

    def mean(self):
        return float(np.asarray(self.rgb, np.float64) @ _LUMINANCE)


def as_texture(v) -> Texture:
    """Auto-wrap scalars / colors into textures (properties.h:281-343)."""
    from ..core.dictio import ColorValue
    if isinstance(v, Texture):
        return v
    if isinstance(v, ColorValue):
        v = v.payload
    if isinstance(v, (int, float, list, tuple, np.ndarray)):
        return ConstantTexture(color=v)
    raise TypeError(f"cannot interpret {type(v)} as a texture")
