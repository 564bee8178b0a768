"""Participating media and the grid volume (reference: src/media/
{homogeneous,heterogeneous}.cpp, src/textures/grid3d.cpp; counterpart of
``mitsuba2_tpu.models.media_impl``).

This slice holds the media's parameters; the volumetric kernel
(ops/volpath_kernel.py) samples free flights and transmittance itself.
The homogeneous medium's sampling comes with the torch wavefront.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.object import register_plugin
from ..core.transform import Transform
from .media import Medium, Volume, as_volume


def trilinear(data, lx, ly, lz):
    """Clamped trilinear lookup of a (D, H, W) float32 grid at points of
    its [0,1]^3 frame, 0 outside it (grid3d.cpp; the lerp of
    ``Grid3DVolume._interp``, mitsuba2_tpu/models/media_impl.py:65-121).
    Voxel centres sit at (i + 0.5) / n; indices clamp to the grid. The
    lerps run along z, then y, then x, in the order of the reference
    kernel's factorized fetch (``_trilinear_sigma``)."""
    D, H, W = data.shape

    def axis(l, n):
        f = l * n - 0.5
        i = torch.clamp(torch.floor(f), 0.0, n - 1.0)
        t = torch.clamp(f - i, 0.0, 1.0)
        i = i.to(torch.int64)
        return i, torch.clamp(i + 1, max=n - 1), t

    ix, ix1, tx = axis(lx, W)
    iy, iy1, ty = axis(ly, H)
    iz, iz1, tz = axis(lz, D)
    flat = data.reshape(-1)

    def zlerp(y, x):
        return (flat[(iz * H + y) * W + x] * (1.0 - tz)
                + flat[(iz1 * H + y) * W + x] * tz)

    def zylerp(x):
        return zlerp(iy, x) * (1.0 - ty) + zlerp(iy1, x) * ty

    val = zylerp(ix) * (1.0 - tx) + zylerp(ix1) * tx
    inside = ((lx >= 0.0) & (lx <= 1.0) & (ly >= 0.0) & (ly <= 1.0)
              & (lz >= 0.0) & (lz <= 1.0))
    return torch.where(inside, val, torch.zeros_like(val))


@register_plugin("volume", "grid3d")
class Grid3DVolume(Volume):
    """(grid3d.cpp) a trilinearly interpolated grid over [0,1]^3 in its
    local frame, from inline ``data`` (D, H, W) or (D, H, W, C). Loading
    a ``filename`` (utils/vol.py) is not ported."""

    def __init__(self, props=None, data=None, to_world=None):
        super().__init__(props)
        if props is not None:
            if props.has_property("filename"):
                raise NotImplementedError(
                    "grid3d: loading a .vol file is not ported; pass data")
            data = props.get("data")
        data = np.asarray(data, np.float32)
        if data.ndim == 3:
            data = data[..., None]
        self.data = data                      # (D, H, W, C) float32
        self._max = float(data.max())
        if to_world is not None:
            self.to_local = to_world.inverse()
            self.identity_transform = False

    def eval_1(self, p):
        """Channel 0 at world points p (..., 3), a torch tensor."""
        M = torch.as_tensor(self.to_local.matrix, dtype=p.dtype,
                            device=p.device)
        q = p @ M[:3, :3].T + M[:3, 3]
        q = q / (p @ M[3, :3] + M[3, 3])[..., None]
        grid = torch.as_tensor(self.data[..., 0], device=p.device)
        return trilinear(grid, q[..., 0], q[..., 1], q[..., 2])

    def max(self) -> float:
        return self._max


@register_plugin("medium", "homogeneous")
class HomogeneousMedium(Medium):
    """(homogeneous.cpp) an unbounded uniform medium: ``sigma_t``,
    ``albedo`` (textures) and ``scale``. Parameters only in this slice:
    the volumetric kernel refuses it."""

    def __init__(self, props=None, sigma_t=1.0, albedo=0.75, scale=1.0):
        super().__init__(props)
        if props is not None:
            sigma_t = props.get("sigma_t", 1.0)
            albedo = props.get("albedo", 0.75)
            scale = props.float_("scale", 1.0)
        from .textures import as_texture
        self.sigma_t_tex = as_texture(sigma_t)
        self.albedo_tex = as_texture(albedo)
        self.scale = float(scale)


@register_plugin("medium", "heterogeneous")
class HeterogeneousMedium(Medium):
    """(heterogeneous.cpp) extinction from a volume (``sigma_t``, a grid or
    a constant) times ``scale``, single-scattering ``albedo``, over the
    unit cube mapped by ``to_world``, with the global majorant
    ``max(sigma_t) * scale``."""

    def __init__(self, props=None, sigma_t=None, albedo=0.75, scale=1.0,
                 to_world=None):
        super().__init__(props)
        if props is not None:
            sigma_t = props.volume("sigma_t", 1.0)
            albedo = props.get("albedo", 0.75)
            scale = props.float_("scale", 1.0)
            to_world = props.transform("to_world", Transform.identity())
        else:
            to_world = to_world or Transform.identity()
        self.sigma_t_vol = as_volume(1.0 if sigma_t is None else sigma_t)
        self.albedo_vol = as_volume(albedo)
        self.scale = float(scale)
        self.to_world = to_world
        self.to_local = to_world.inverse()
        # volumes without their own to_world live in the medium's frame
        for vol in (self.sigma_t_vol, self.albedo_vol):
            if vol.identity_transform:
                vol.to_local = self.to_local
        self.majorant = self.sigma_t_vol.max() * self.scale
