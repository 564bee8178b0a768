"""Surface interaction records (reference: include/mitsuba/render/
interaction.h:83-131; counterpart of ``mitsuba2_tpu.render.interaction.
SurfaceInteraction``). Object pointers become integer ids into the scene's
tables; a miss is t == inf."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import math as m
from ..core.frame import Frame
from ..core.ray import Ray


class SurfaceInteraction(NamedTuple):
    t: torch.Tensor              # (n,) hit distance, inf on a miss
    p: torch.Tensor              # (n, 3) position
    n: torch.Tensor              # (n, 3) geometric normal
    sh_frame: Frame              # shading frame (n = shading normal)
    uv: torch.Tensor             # (n, 2)
    wi: torch.Tensor             # (n, 3) incident direction, local frame
    dp_du: torch.Tensor          # (n, 3)
    dp_dv: torch.Tensor          # (n, 3)
    shape_idx: torch.Tensor      # (n,) int32 into scene.shapes, -1
    prim_idx: torch.Tensor       # (n,) int32 face id (F + sphere index ...)
    wavelengths: Optional[torch.Tensor]  # (n, 4) in spectral variants
    bsdf_idx: torch.Tensor       # (n,) int32, -1 where none
    emitter_idx: torch.Tensor    # (n,) int32, -1 where none
    prim_uv: torch.Tensor        # (n, 2) barycentrics of a face hit

    def is_valid(self):
        return torch.isfinite(self.t)

    def to_local(self, v):
        return self.sh_frame.to_local(v)

    def to_world(self, v):
        return self.sh_frame.to_world(v)

    def take(self, idx):
        """The lanes ``idx`` (int64) of every field, in that order."""
        def g(x):
            if x is None:
                return None
            if isinstance(x, Frame):
                return Frame(*(y[idx] for y in x))
            return x[idx]
        return SurfaceInteraction(*(g(x) for x in self))

    def offset_p(self, d):
        """The position offset along the geometric normal by RayEpsilon,
        scaled by the position's magnitude, to the side of ``d``
        (interaction.h spawn_ray)."""
        mag = (1.0 + self.p.abs().amax(-1)) * m.RayEpsilon
        sgn = m.sign(m.dot(self.n, d))
        return self.p + (mag * sgn)[..., None] * self.n

    def spawn_ray(self, d) -> Ray:
        """A ray from the offset position along ``d``: [0, inf), its four
        tensors contiguous (K2 reads them as they are)."""
        o = self.offset_p(d)
        return Ray(o.contiguous(), d.contiguous(),
                   torch.zeros_like(self.t), torch.full_like(self.t,
                                                             float("inf")))

    def spawn_ray_to(self, p):
        """A shadow ray toward the points ``p``, stopping short of them by
        ShadowEpsilon -> (ray, distance)."""
        o = self.offset_p(p - self.p)
        d = p - o
        dist = m.norm(d)
        d = d / torch.clamp(dist, min=1e-20)[..., None]
        return Ray(o.contiguous(), d.contiguous(), torch.zeros_like(dist),
                   (dist * (1.0 - m.ShadowEpsilon)).contiguous()), dist
