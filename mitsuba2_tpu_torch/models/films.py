"""Film plugins (reference: src/films/hdrfilm.cpp — the only film)."""

from __future__ import annotations

from ..core.object import register_plugin
from ..render.film import Film


@register_plugin("film", "hdrfilm")
class HDRFilm(Film):
    """(hdrfilm.cpp:1-393) high-dynamic-range film; accumulation is
    RGB + weight in the variant's working space."""

    def __init__(self, props=None):
        super().__init__(props)
        p = props
        self.pixel_format = p.string("pixel_format", "rgba") if p else "rgba"
        self.component_format = p.string("component_format", "float16") \
            if p else "float16"
        self.high_quality_edges = p.bool_("high_quality_edges", False) \
            if p else False
