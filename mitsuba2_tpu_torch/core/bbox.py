"""Axis-aligned bounding boxes (reference: include/mitsuba/core/bbox.h;
counterpart of ``mitsuba2_tpu.core.bbox``), as far as the heterogeneous
medium's bounds need them: the ray slab test."""

from __future__ import annotations

from typing import NamedTuple

import torch


class BoundingBox(NamedTuple):
    min: torch.Tensor  # (..., 3)
    max: torch.Tensor  # (..., 3)

    def ray_intersect(self, o, d, mint=0.0, maxt=float("inf")):
        """The slab test of rays (o, d) (n, 3) -> (hit (n,) bool, t_near,
        t_far): a zero direction component divides to +inf, as the
        reference's (bbox.h ray_intersect), so a ray in a slab's plane
        gives NaN there and misses."""
        inv_d = torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d),
                            torch.where(d >= 0, float("inf"),
                                        float("-inf")))
        t1 = (self.min - o) * inv_d
        t2 = (self.max - o) * inv_d
        t_near = torch.minimum(t1, t2).amax(-1)
        t_far = torch.maximum(t1, t2).amin(-1)
        hit = (t_near <= t_far) & (t_far >= mint) & (t_near <= maxt)
        return hit, t_near, t_far
