"""Axis-aligned bounding boxes (reference: include/mitsuba/core/bbox.h;
counterpart of ``mitsuba2_tpu.core.bbox``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import math as m


class BoundingBox(NamedTuple):
    min: torch.Tensor  # (..., 3)
    max: torch.Tensor  # (..., 3)

    @staticmethod
    def invalid(batch=(), dtype=torch.float32, device=None) -> "BoundingBox":
        """The empty box: min +inf, max -inf."""
        shape = tuple(batch) + (3,)
        return BoundingBox(
            torch.full(shape, float("inf"), dtype=dtype, device=device),
            torch.full(shape, float("-inf"), dtype=dtype, device=device))

    @staticmethod
    def from_points(p) -> "BoundingBox":
        return BoundingBox(p.amin(-2), p.amax(-2))

    def expand(self, other: "BoundingBox") -> "BoundingBox":
        return BoundingBox(torch.minimum(self.min, other.min),
                           torch.maximum(self.max, other.max))

    def valid(self):
        return (self.max >= self.min).all(-1)

    @property
    def center(self):
        return 0.5 * (self.min + self.max)

    @property
    def extents(self):
        return self.max - self.min

    def surface_area(self):
        e = self.extents
        return 2.0 * (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2]
                      + e[..., 0] * e[..., 2])

    def contains(self, p, strict: bool = False):
        if strict:
            return ((p > self.min) & (p < self.max)).all(-1)
        return ((p >= self.min) & (p <= self.max)).all(-1)

    def distance_squared(self, p):
        d = torch.clamp(torch.maximum(self.min - p, p - self.max), min=0.0)
        return (d * d).sum(-1)

    def bounding_sphere(self):
        c = self.center
        return c, m.norm(self.max - c)

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
