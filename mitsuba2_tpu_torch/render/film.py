"""Film + ImageBlock.

Parity: include/mitsuba/render/film.h:21 (crop window, develop) and
imageblock.h:20 (accumulation with a filter-weight channel). The block is a
``(h + 2b, w + 2b, ch + 1)`` tensor of weighted sums; ``develop``
normalizes by the weight channel. The box filter (border 0) is the only
splat in this slice: its passes arrive already reduced per pixel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.object import Object


class ImageBlock:
    def __init__(self, size, n_channels, rfilter, device):
        self.size = tuple(int(s) for s in size)  # (w, h)
        self.n_channels = int(n_channels)
        self.rfilter = rfilter
        self.border = int(np.ceil(rfilter.radius - 0.5))
        self.device = device

    def create(self) -> torch.Tensor:
        w, h = self.size
        b = self.border
        return torch.zeros((h + 2 * b, w + 2 * b, self.n_channels + 1),
                           dtype=torch.float32, device=self.device)

    def develop(self, data: torch.Tensor) -> torch.Tensor:
        """-> (h, w, ch) image normalized by accumulated filter weight."""
        b = self.border
        w, h = self.size
        core = data[b:b + h, b:b + w]
        weight = core[..., -1:]
        return core[..., :-1] / torch.clamp(weight, min=1e-20)


class Film(Object):
    """Film base (film.h:21)."""

    def __init__(self, props=None):
        super().__init__(props)
        p = props
        self.size = (int(p.int_("width", 768)), int(p.int_("height", 576))) \
            if p else (768, 576)
        cw = p.int_("crop_width", self.size[0]) if p else self.size[0]
        ch = p.int_("crop_height", self.size[1]) if p else self.size[1]
        cx = p.int_("crop_offset_x", 0) if p else 0
        cy = p.int_("crop_offset_y", 0) if p else 0
        self.crop_size = (int(cw), int(ch))
        self.crop_offset = (int(cx), int(cy))
        self.rfilter = None
        if p is not None:
            for _, obj in p.objects():
                if getattr(obj, "plugin_category", "") == "rfilter":
                    self.rfilter = obj
        if self.rfilter is None:
            from ..models.rfilters import GaussianFilter
            self.rfilter = GaussianFilter()
