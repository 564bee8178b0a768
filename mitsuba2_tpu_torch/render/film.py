"""Film + ImageBlock.

Parity: include/mitsuba/render/film.h:21 (crop window, develop) and
imageblock.h:20 (accumulation with a filter-weight channel). The block is a
``(h + 2b, w + 2b, ch + 1)`` tensor of weighted sums with a border of b =
ceil(radius - 1/2) pixels; ``put`` splats samples at continuous film
positions through the filter's (2b + 1)^2 taps, ``develop`` crops the
border and normalizes by the weight channel. The path kernel's passes
arrive already splatted (ops/splat.py).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..core.object import Object, bump_param_epoch


def border(rfilter) -> int:
    """Pixels of an image block's border for ``rfilter``: ceil(radius -
    1/2) (imageblock.cpp)."""
    return int(np.ceil(rfilter.radius - 0.5))


class ImageBlock:
    def __init__(self, size, n_channels, rfilter, device):
        self.size = tuple(int(s) for s in size)  # (w, h)
        self.n_channels = int(n_channels)
        self.rfilter = rfilter
        self.border = border(rfilter)
        self.device = device

    def create(self) -> torch.Tensor:
        w, h = self.size
        b = self.border
        return torch.zeros((h + 2 * b, w + 2 * b, self.n_channels + 1),
                           dtype=torch.float32, device=self.device)

    def put(self, data: torch.Tensor, pos, values, active=None,
            weight=None) -> torch.Tensor:
        """``data`` with samples ``values`` (n, ch) splatted at continuous
        film positions ``pos`` (n, 2): each tap of the (2b + 1)^2 stencil
        around the pixel a sample falls into gets the filter's weight at
        tap center - sample position, per axis (imageblock.cpp:62;
        mitsuba2_tpu/render/film.py ImageBlock.put). Taps outside the
        bordered block are dropped. Returns a new tensor."""
        b = self.border
        w, h = self.size
        px = torch.floor(pos[..., 0])
        py = torch.floor(pos[..., 1])
        if weight is None:
            weight = torch.ones(pos.shape[:-1], dtype=data.dtype,
                                device=data.device)
        if active is not None:
            weight = torch.where(active, weight, 0.0)
            values = torch.where(active[..., None], values, 0.0)
        vals_w = torch.cat([values, weight[..., None]], -1)
        data = data.clone()
        for ty in range(2 * b + 1):
            for tx in range(2 * b + 1):
                cx = px + (tx - b)
                cy = py + (ty - b)
                fw = (self.rfilter.eval(cx + 0.5 - pos[..., 0])
                      * self.rfilter.eval(cy + 0.5 - pos[..., 1]))
                ix = torch.clamp(cx.long() + b, 0, w + 2 * b - 1)
                iy = torch.clamp(cy.long() + b, 0, h + 2 * b - 1)
                inside = ((cx >= -b) & (cx < w + b)
                          & (cy >= -b) & (cy < h + b))
                data.index_put_((iy, ix), vals_w * torch.where(
                    inside, fw, 0.0)[..., None], accumulate=True)
        return data

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
        # the sensors that expose this film (render/sensor.py)
        self._sensors = weakref.WeakSet()
        self.rfilter = None
        if p is not None:
            for _, obj in p.objects():
                if getattr(obj, "plugin_category", "") == "rfilter":
                    self.rfilter = obj
        if self.rfilter is None:
            from ..models.rfilters import GaussianFilter
            self.rfilter = GaussianFilter()

    def set_crop_window(self, offset, size):
        """Renders from now on cover the window of ``size`` pixels at
        ``offset``; each camera of this film rebuilds its sample-to-camera
        transform for it, and the parameter epoch moves, so that the
        integrators re-gate their kernels (a render is a fresh load's with
        these crop properties; the JAX package's camera keeps the old
        window, mitsuba2_tpu/render/film.py:111)."""
        self.crop_offset = tuple(int(x) for x in offset)
        self.crop_size = tuple(int(x) for x in size)
        self.__dict__.pop("_device_cache", None)
        bump_param_epoch()
        for sensor in list(self._sensors):
            sensor.film_changed()
