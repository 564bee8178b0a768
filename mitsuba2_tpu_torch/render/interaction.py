"""Surface and medium interaction records (reference: include/mitsuba/
render/interaction.h:83-131, :368; counterpart of
``mitsuba2_tpu.render.interaction``). Object pointers become integer ids
into the scene's tables; a miss, or no collision, is t == inf. Records
of one type merge lane by lane with ``render/records.py select``.
``PreliminaryIntersection`` is render/records.py's."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import math as m
from ..core.frame import Frame
from ..core.ray import Ray
from .records import PreliminaryIntersection  # noqa: F401


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
    # (n, 2) uv footprint of a pixel, set by compute_uv_partials
    duv_dx: Optional[torch.Tensor] = None
    duv_dy: Optional[torch.Tensor] = None

    def is_valid(self):
        return torch.isfinite(self.t)

    def compute_uv_partials(self, rd) -> "SurfaceInteraction":
        """The uv footprint of a RayDifferential's pixel (interaction.h:
        217-249): the neighbour rays met with the tangent plane, their
        offsets projected onto (dp_du, dp_dv) by least squares, a 2 x 2
        solve a lane. A neighbour parallel to the plane, a degenerate
        parameterization or a value that overflows gives a zero footprint
        (the JAX package's guards), and no division by zero is taken, so
        no NaN reaches a gradient."""
        if not rd.has_differentials:
            return self
        n = self.n
        dist = m.dot(n, self.p)
        den_x, den_y = m.dot(n, rd.d_x), m.dot(n, rd.d_y)
        t_x = m.safe_div(dist - m.dot(n, rd.o_x), den_x, 0.0)
        t_y = m.safe_div(dist - m.dot(n, rd.o_y), den_y, 0.0)
        dp_dx = rd.o_x + rd.d_x * t_x[..., None] - self.p
        dp_dy = rd.o_y + rd.d_y * t_y[..., None] - self.p
        a00 = m.dot(self.dp_du, self.dp_du)
        a01 = m.dot(self.dp_du, self.dp_dv)
        a11 = m.dot(self.dp_dv, self.dp_dv)
        det = a00 * a11 - a01 * a01
        ok = det.abs() > 1e-20
        inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        inv_det = torch.where(torch.isfinite(inv_det), inv_det, 0.0)

        def solve(dp, den):
            b0, b1 = m.dot(self.dp_du, dp), m.dot(self.dp_dv, dp)
            duv = torch.stack([(a11 * b0 - a01 * b1) * inv_det,
                               (a00 * b1 - a01 * b0) * inv_det], -1)
            keep = (den != 0)[..., None] & torch.isfinite(duv)
            return torch.where(keep, duv, 0.0)

        return self._replace(duv_dx=solve(dp_dx, den_x),
                             duv_dy=solve(dp_dy, den_y))

    def has_uv_partials(self):
        return self.duv_dx is not None

    @staticmethod
    def invalid(n_lanes: int, n_channels: int = 0, dtype=torch.float32,
                device=None) -> "SurfaceInteraction":
        """The record of ``n_lanes`` misses: t inf, the identity frame,
        every id -1; hero wavelengths (n, n_channels) where n_channels is
        not 0."""
        z3 = torch.zeros((n_lanes, 3), dtype=dtype, device=device)
        ex, ey, ez = (z3.clone() for _ in range(3))
        ex[:, 0] = 1.0
        ey[:, 1] = 1.0
        ez[:, 2] = 1.0
        none = torch.full((n_lanes,), -1, dtype=torch.int32, device=device)
        z2 = torch.zeros((n_lanes, 2), dtype=dtype, device=device)
        return SurfaceInteraction(
            t=torch.full((n_lanes,), float("inf"), dtype=dtype,
                         device=device),
            p=z3, n=ez, sh_frame=Frame(ex, ey, ez), uv=z2, wi=ez,
            dp_du=z3, dp_dv=z3, shape_idx=none,
            prim_idx=torch.zeros((n_lanes,), dtype=torch.int32,
                                 device=device),
            wavelengths=torch.zeros((n_lanes, n_channels), dtype=dtype,
                                    device=device) if n_channels else None,
            bsdf_idx=none, emitter_idx=none, prim_uv=z2)

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


class MediumInteraction(NamedTuple):
    """A sampled collision inside a medium (interaction.h:368): its
    distance along the ray from the ray's origin (inf where none), point,
    a frame around the ray's direction, ``wi`` = -ray.d in world
    coordinates (the phase functions dot it with world directions, as the
    reference's medium.cpp:46 keeps it), the medium's index, the
    collision coefficients per channel (n, C), the majorant per channel,
    the start of the medium's segment along the ray, and the hero
    wavelengths (n, 4) in spectral variants (None otherwise)."""
    t: torch.Tensor
    p: torch.Tensor
    sh_frame: Frame
    wi: torch.Tensor
    medium_idx: torch.Tensor
    sigma_s: torch.Tensor
    sigma_n: torch.Tensor
    sigma_t: torch.Tensor
    combined_extinction: torch.Tensor
    mint: torch.Tensor
    wavelengths: Optional[torch.Tensor]

    def is_valid(self):
        return torch.isfinite(self.t)

    def to_local(self, v):
        return self.sh_frame.to_local(v)

    def to_world(self, v):
        return self.sh_frame.to_world(v)


def zero_mi(n, nch, device, wavelengths=None):
    """The record of lanes no medium sampled (the reference's ``_zero_mi``,
    mitsuba2_tpu/models/media_impl.py:130-141): no collision, the
    identity frame, medium -1, zero coefficients, majorant 1."""
    z3 = torch.zeros((n, 3), device=device)
    ex, ey, ez = (z3.clone() for _ in range(3))
    ex[:, 0] = 1.0
    ey[:, 1] = 1.0
    ez[:, 2] = 1.0
    zc = torch.zeros((n, nch), device=device)
    return MediumInteraction(
        t=torch.full((n,), float("inf"), device=device), p=z3,
        sh_frame=Frame(ex, ey, ez), wi=ez,
        medium_idx=torch.full((n,), -1, dtype=torch.int32, device=device),
        sigma_s=zc, sigma_n=zc, sigma_t=zc,
        combined_extinction=torch.ones((n, nch), device=device),
        mint=torch.zeros((n,), device=device), wavelengths=wavelengths)
