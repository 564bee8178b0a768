"""Reconstruction filters (reference: src/rfilters/{box,gaussian}.cpp).

The box filter is the one the path kernel develops (a per-pixel sum over
samples). The gaussian is hdrfilm's default, so it loads; the path
integrator refuses it until the shift-splat develop is ported.
"""

from __future__ import annotations

from ..core.object import Object, register_plugin


class ReconstructionFilter(Object):
    radius: float = 1.0


@register_plugin("rfilter", "box")
class BoxFilter(ReconstructionFilter):
    """(box.cpp) radius 0.5."""

    def __init__(self, props=None):
        super().__init__(props)
        self.radius = 0.5


@register_plugin("rfilter", "gaussian")
class GaussianFilter(ReconstructionFilter):
    """(gaussian.cpp) truncated gaussian, stddev 0.5, radius 2."""

    def __init__(self, props=None):
        super().__init__(props)
        self.stddev = float(props.float_("stddev", 0.5)) if props else 0.5
        self.radius = 4.0 * self.stddev
