"""Intersection records (reference: include/mitsuba/render/interaction.h:
511-569 and ``mitsuba2_tpu.render.interaction.PreliminaryIntersection``),
as far as the scene's ray queries need them. Object pointers become
integer ids into the scene's tables; a miss is t == inf."""

from __future__ import annotations

from typing import NamedTuple

import torch


class PreliminaryIntersection(NamedTuple):
    """The cheap hit record of ``Scene.ray_intersect_preliminary``."""
    t: torch.Tensor           # (n,) hit distance, inf on a miss
    prim_uv: torch.Tensor     # (n, 2) barycentrics of a face hit, else 0
    shape_idx: torch.Tensor   # (n,) int32 index into scene.shapes, -1
    prim_idx: torch.Tensor    # (n,) int32 face id (F + sphere index for
                              # a sphere), -1 on a miss

    def is_valid(self):
        return torch.isfinite(self.t)
