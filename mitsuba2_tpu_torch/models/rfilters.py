"""Reconstruction filters (reference: src/rfilters/{box,tent,gaussian,
mitchell,catmullrom,lanczos}.cpp; counterpart of
``mitsuba2_tpu.models.rfilters``).

``eval`` computes each filter directly in float32, as the reference does;
the path kernel's splat (ops/splat.py) evaluates the same functions on the
card from ``kernel_params``: a filter id and its float32 constants.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.object import Object, register_plugin
from ..core import math as m

# filter ids of csrc/splat_kernel.cu's filter_eval
BOX, TENT, GAUSSIAN, MITCHELL, LANCZOS = 0, 1, 2, 3, 4


def _f32(x) -> float:
    """``x`` rounded to float32, as the reference's weakly typed Python
    constants are where they meet a float32 array."""
    return float(np.float32(x))


class ReconstructionFilter(Object):
    radius: float = 1.0

    def eval(self, x):
        raise NotImplementedError

    def kernel_params(self):
        """-> (filter id, float32 constants) for csrc/splat_kernel.cu."""
        raise NotImplementedError


@register_plugin("rfilter", "box")
class BoxFilter(ReconstructionFilter):
    """(box.cpp) radius 0.5."""

    def __init__(self, props=None):
        super().__init__(props)
        self.radius = 0.5

    def eval(self, x):
        return torch.where(x.abs() <= 0.5, 1.0, 0.0)

    def kernel_params(self):
        return BOX, ()


@register_plugin("rfilter", "tent")
class TentFilter(ReconstructionFilter):
    """(tent.cpp) 1 - |x| / radius, radius 1 by default."""

    def __init__(self, props=None):
        super().__init__(props)
        self.radius = float(props.float_("radius", 1.0)) if props else 1.0

    def eval(self, x):
        return torch.clamp(1.0 - (x / self.radius).abs(), min=0.0)

    def kernel_params(self):
        return TENT, (_f32(self.radius),)


@register_plugin("rfilter", "gaussian")
class GaussianFilter(ReconstructionFilter):
    """(gaussian.cpp) gaussian of ``stddev`` (0.5) truncated at radius
    4 stddev and shifted down by its value there (``bias``)."""

    def __init__(self, props=None):
        super().__init__(props)
        self.stddev = float(props.float_("stddev", 0.5)) if props else 0.5
        self.radius = 4.0 * self.stddev
        self.alpha = -1.0 / (2.0 * self.stddev ** 2)
        self.bias = float(torch.exp(torch.tensor(self.alpha
                                                 * self.radius ** 2,
                                                 dtype=torch.float32)))

    def eval(self, x):
        return torch.clamp(torch.exp(self.alpha * x * x) - self.bias,
                           min=0.0)

    def kernel_params(self):
        return GAUSSIAN, (_f32(self.alpha), _f32(self.bias))


class _Mitchell(ReconstructionFilter):
    """Mitchell-Netravali cubic of parameters B, C, radius 2."""
    B: float = 1.0 / 3.0
    C: float = 1.0 / 3.0

    def __init__(self, props=None):
        super().__init__(props)
        if props is not None:
            self.B = float(props.float_("B", type(self).B))
            self.C = float(props.float_("C", type(self).C))
        self.radius = 2.0

    def _coefficients(self):
        """[x^3, x^2, 1] inside |x| < 1, [x^3, x^2, x, 1] in 1 <= |x| < 2,
        and the common factor 1/6."""
        B, C = self.B, self.C
        return ((12 - 9 * B - 6 * C, -18 + 12 * B + 6 * C, 6 - 2 * B),
                (-B - 6 * C, 6 * B + 30 * C, -12 * B - 48 * C,
                 8 * B + 24 * C), 1.0 / 6.0)

    def eval(self, x):
        x = x.abs()
        x2 = x * x
        x3 = x2 * x
        (a3, a2, a0), (b3, b2, b1, b0), sixth = self._coefficients()
        inner = (a3 * x3 + a2 * x2 + a0) * sixth
        outer = (b3 * x3 + b2 * x2 + b1 * x + b0) * sixth
        return torch.where(x < 1.0, inner,
                           torch.where(x < 2.0, outer, 0.0))

    def kernel_params(self):
        inner, outer, sixth = self._coefficients()
        return MITCHELL, tuple(_f32(c) for c in (*inner, *outer, sixth))


@register_plugin("rfilter", "mitchell")
class MitchellFilter(_Mitchell):
    """(mitchell.cpp) B = C = 1/3."""


@register_plugin("rfilter", "catmullrom")
class CatmullRomFilter(_Mitchell):
    """(catmullrom.cpp) Mitchell with B = 0, C = 0.5."""
    B = 0.0
    C = 0.5


@register_plugin("rfilter", "lanczos")
class LanczosFilter(ReconstructionFilter):
    """(lanczos.cpp) windowed sinc of ``lobes`` (3) lobes, radius
    ``lobes``."""

    def __init__(self, props=None):
        super().__init__(props)
        self.lobes = int(props.int_("lobes", 3)) if props else 3
        self.radius = float(self.lobes)

    def eval(self, x):
        def sinc(v):
            v = v.abs() * m.Pi
            return torch.where(v < 1e-5, 1.0, torch.sin(v) / torch.where(
                v == 0, 1.0, v))
        return torch.where(x.abs() < self.radius,
                           sinc(x) * sinc(x / self.lobes), 0.0)

    def kernel_params(self):
        return LANCZOS, (_f32(self.lobes), _f32(self.radius), _f32(m.Pi))

