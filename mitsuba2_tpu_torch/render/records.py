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


class PositionSample(NamedTuple):
    """A sampled position on a surface, area measure (records.h:20)."""
    p: torch.Tensor           # (n, 3)
    n: torch.Tensor           # (n, 3)
    uv: torch.Tensor          # (n, 2)
    pdf: torch.Tensor         # (n,)
    delta: torch.Tensor       # (n,) bool


class DirectionSample(NamedTuple):
    """A direction toward an endpoint, solid-angle measure (records.h:121);
    the emitter is an index into the scene's emitters, -1 for none."""
    p: torch.Tensor           # (n, 3)
    n: torch.Tensor           # (n, 3)
    uv: torch.Tensor          # (n, 2)
    pdf: torch.Tensor         # (n,)
    delta: torch.Tensor       # (n,) bool
    d: torch.Tensor           # (n, 3) from the reference point
    dist: torch.Tensor        # (n,)
    emitter_idx: torch.Tensor  # (n,) int32


class BSDFSample3(NamedTuple):
    """The result of BSDF::sample (bsdf.h BSDFSample3f)."""
    wo: torch.Tensor              # (n, 3) local frame
    pdf: torch.Tensor             # (n,)
    eta: torch.Tensor             # (n,) relative IOR across the event
    sampled_type: torch.Tensor    # (n,) int32 BSDFFlags of the lobe
    sampled_component: torch.Tensor  # (n,) int32


# the JAX package's name of the record (mitsuba2_tpu/render/records.py)
BSDFSample = BSDFSample3


def zero_direction_sample(n, device):
    z3 = torch.zeros((n, 3), device=device)
    z = torch.zeros((n,), device=device)
    return DirectionSample(z3, z3, torch.zeros((n, 2), device=device), z,
                           torch.zeros((n,), dtype=torch.bool, device=device),
                           z3, z, torch.full((n,), -1, dtype=torch.int32,
                                             device=device))


def select(mask, a, b):
    """Field by field, ``a`` where ``mask`` (n,) holds, else ``b``: records
    of one type; a nested record (a frame) is selected field by field, a
    field that is None in both stays None."""
    out = []
    for x, y in zip(a, b):
        if x is None and y is None:
            out.append(None)
        elif isinstance(x, tuple):
            out.append(select(mask, x, y))
        else:
            mk = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
            out.append(torch.where(mk, x, y))
    return type(a)(*out)
