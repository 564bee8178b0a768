"""Rays as tuples of tensors (reference: include/mitsuba/core/ray.h and
``mitsuba2_tpu.core.ray``): origin and direction (n, 3) and the [mint,
maxt] segment (n,), on one device, float32; a ray differential adds the
origins and directions of the rays one pixel over in x and in y."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..variants import device as load_device
from . import math as m


class Ray(NamedTuple):
    o: torch.Tensor           # (n, 3)
    d: torch.Tensor           # (n, 3)
    mint: torch.Tensor        # (n,)
    maxt: torch.Tensor        # (n,)

    @staticmethod
    def make(o, d, mint=None, maxt=None) -> "Ray":
        """A batch of rays from array-likes; ``mint`` defaults to
        ``RayEpsilon``, ``maxt`` to infinity, scalars broadcast. On the
        device of ``o`` if it is a tensor, else on the device scenes load
        onto (``set_device``; ``cuda`` unless the caller asked for
        another)."""
        device = o.device if isinstance(o, torch.Tensor) else load_device()

        def as_t(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        o, d = torch.broadcast_tensors(as_t(o), as_t(d))
        n = o.shape[:-1]
        mint = as_t(m.RayEpsilon if mint is None else mint)
        maxt = as_t(float("inf") if maxt is None else maxt)
        return Ray(o.contiguous(), d.contiguous(),
                   torch.broadcast_to(mint, n).contiguous(),
                   torch.broadcast_to(maxt, n).contiguous())

    def __call__(self, t):
        """Points along the rays: o + t d."""
        return self.o + self.d * t[..., None]

    def replace(self, **kw) -> "Ray":
        return self._replace(**kw)


class RayDifferential(NamedTuple):
    """A ray and its neighbours one pixel over (ray.h RayDifferential):
    their origins ``o_x``, ``o_y`` and directions ``d_x``, ``d_y`` (n,
    3); ``has_differentials`` is a host flag."""
    ray: Ray
    o_x: torch.Tensor
    o_y: torch.Tensor
    d_x: torch.Tensor
    d_y: torch.Tensor
    has_differentials: bool

    @staticmethod
    def from_ray(ray: Ray) -> "RayDifferential":
        z = torch.zeros_like(ray.o)
        return RayDifferential(ray, z, z, z, z, False)

    def scale_differential(self, amount) -> "RayDifferential":
        """The neighbours moved toward the ray by ``amount`` (ray.h
        scale_differential: 1 / sqrt(spp) where a pixel takes spp
        samples)."""
        r = self.ray
        return RayDifferential(
            r, (self.o_x - r.o) * amount + r.o,
            (self.o_y - r.o) * amount + r.o,
            (self.d_x - r.d) * amount + r.d,
            (self.d_y - r.d) * amount + r.d, self.has_differentials)
