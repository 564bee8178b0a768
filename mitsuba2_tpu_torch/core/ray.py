"""Rays as tuples of tensors (reference: include/mitsuba/core/ray.h and
``mitsuba2_tpu.core.ray``), as far as the scene's ray queries need them:
origin and direction (n, 3) and the [mint, maxt] segment (n,), on one
device, float32."""

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
