"""Participating media and the grid volume (reference: src/media/
{homogeneous,heterogeneous}.cpp, src/textures/grid3d.cpp; counterpart of
``mitsuba2_tpu.models.media_impl``).

The volumetric kernel (ops/volpath_kernel.py) packs the heterogeneous
medium's grid into its tables and samples free flights itself, through
``trilinear``; the volpath wavefront samples through each medium's own
``intersect_aabb``, ``get_combined_extinction`` and
``get_scattering_coefficients`` (models/media.py ``Medium``), and reads
grids through ``Grid3DVolume.eval``.
"""

from __future__ import annotations

from types import SimpleNamespace

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
    kernel's factorized fetch (``_trilinear_sigma``); the volpath
    wavefront's lookup, ``Grid3DVolume._interp``, keeps the reference
    wavefront's order."""
    D, H, W = data.shape
    ix, ix1, tx = _axis(lx, W)
    iy, iy1, ty = _axis(ly, H)
    iz, iz1, tz = _axis(lz, D)
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
    local frame, from inline ``data`` (D, H, W) or (D, H, W, C) or a
    binary ``filename`` (utils/vol.py)."""

    def __init__(self, props=None, data=None, to_world=None):
        super().__init__(props)
        if props is not None:
            if props.has_property("filename"):
                from ..utils.vol import read_vol
                data, _bbox = read_vol(props.string("filename"))
            else:
                data = props.get("data")
        data = np.asarray(data, np.float32)
        if data.ndim == 3:
            data = data[..., None]
        self.data = data                      # (D, H, W, C) float32
        self._max = float(data.max())
        if to_world is not None:
            self.to_local = to_world.inverse()
            self.identity_transform = False

    def traverse(self, cb):
        cb.put_parameter("data", self.data)

    def set_parameter(self, name, value):
        super().set_parameter(name, value)
        if name == "data":
            from .textures import host_value
            self._max = float(host_value(self.data).max())

    def _interp(self, p):
        """Every channel (..., C) at world points p (..., 3), 0 outside
        the grid: the reference's gather lerp, along x, then y, then z
        (mitsuba2_tpu/models/media_impl.py:108-119). The reference
        interpolates small grids through a one-hot matmul instead, a TPU
        form whose sums round apart from these lerps."""
        from .textures import on_device
        q = self.to_local.transform_point(p)
        g = on_device(self, "data", self.data, p.device)
        D, H, W, C = g.shape
        ix, ix1, tx = _axis(q[..., 0], W)
        iy, iy1, ty = _axis(q[..., 1], H)
        iz, iz1, tz = _axis(q[..., 2], D)
        flat = g.reshape(-1, C)
        tx, ty, tz = tx[..., None], ty[..., None], tz[..., None]

        def xlerp(z, y):
            row = (z * H + y) * W
            return flat[row + ix] * (1 - tx) + flat[row + ix1] * tx

        c0 = xlerp(iz, iy) * (1 - ty) + xlerp(iz, iy1) * ty
        c1 = xlerp(iz1, iy) * (1 - ty) + xlerp(iz1, iy1) * ty
        out = c0 * (1 - tz) + c1 * tz
        inside = ((q >= 0.0) & (q <= 1.0)).all(-1)
        return torch.where(inside[..., None], out, 0.0)

    def eval_1(self, p):
        """Channel 0 at world points p (..., 3)."""
        return self._interp(p)[..., 0]

    def eval(self, p, wavelengths=None):
        """The variant's channels at world points p: a one-channel grid
        repeated, else its first C channels, or its first repeated when it
        has fewer (the reference's ``Grid3DVolume.eval``)."""
        from ..variants import current
        v = self._interp(p)
        nch = current().n_channels
        if v.shape[-1] >= nch and v.shape[-1] > 1:
            return v[..., :nch]
        return v[..., :1].expand(v.shape[:-1] + (nch,))

    def max(self) -> float:
        return self._max


def _axis(l, n):
    """A grid axis of n voxels at local coordinates l: the clamped lower
    and upper voxel and the lerp weight (voxel centres at (i + 0.5) /
    n)."""
    f = l * n - 0.5
    i = torch.clamp(torch.floor(f), 0.0, n - 1.0)
    t = torch.clamp(f - i, 0.0, 1.0)
    i = i.to(torch.int64)
    return i, torch.clamp(i + 1, max=n - 1), t


def _texture_lanes(mi):
    """The record a texture reads at each collision: the reference's
    ``dummy_si`` (mitsuba2_tpu/render/testutil.py:15-31) with the
    collision's point and wavelengths, uv (0.5, 0.5)."""
    n = mi.t.shape[0]
    return SimpleNamespace(
        t=torch.ones_like(mi.t), p=mi.p, wavelengths=mi.wavelengths,
        uv=torch.full((n, 2), 0.5, device=mi.t.device))


@register_plugin("medium", "homogeneous")
class HomogeneousMedium(Medium):
    """(homogeneous.cpp) an unbounded uniform medium: ``sigma_t`` and
    ``albedo`` (textures, read at uv (0.5, 0.5), per channel, at the
    lanes' wavelengths in spectral variants) and ``scale``; the majorant
    is sigma_t itself, so no collision is null."""

    is_homogeneous = True

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

    def traverse(self, cb):
        cb.put_object("sigma_t", self.sigma_t_tex)
        cb.put_object("albedo", self.albedo_tex)

    def intersect_aabb(self, ray):
        n, dev = ray.o.shape[0], ray.o.device
        return (torch.ones((n,), dtype=torch.bool, device=dev),
                torch.zeros((n,), device=dev),
                torch.full((n,), float("inf"), device=dev))

    def _sigma_t(self, mi, active):
        return self.sigma_t_tex.eval(_texture_lanes(mi), active) * self.scale

    def get_combined_extinction(self, mi, active):
        return self._sigma_t(mi, active)

    def get_scattering_coefficients(self, mi, active):
        sigma_t = self._sigma_t(mi, active)
        albedo = self.albedo_tex.eval(_texture_lanes(mi), active)
        return sigma_t * albedo, torch.zeros_like(sigma_t), sigma_t


@register_plugin("medium", "heterogeneous")
class HeterogeneousMedium(Medium):
    """(heterogeneous.cpp) extinction from a volume (``sigma_t``, a grid or
    a constant) times ``scale``, single-scattering ``albedo`` (a volume),
    over the unit cube mapped by ``to_world``, with the global majorant
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

    def has_spectral_extinction(self):
        return False

    @property
    def majorant(self):
        """max(sigma_t) * scale, from the volume's current values."""
        return self.sigma_t_vol.max() * self.scale

    def traverse(self, cb):
        cb.put_object("sigma_t", self.sigma_t_vol)
        cb.put_object("albedo", self.albedo_vol)

    def intersect_aabb(self, ray):
        """The ray against the unit cube in the medium's frame; the near
        distance clamped to 0."""
        from ..core.bbox import BoundingBox
        o = self.to_local.transform_point(ray.o)
        d = self.to_local.transform_vector(ray.d)
        box = BoundingBox(torch.zeros(3, device=o.device),
                          torch.ones(3, device=o.device))
        hit, t0, t1 = box.ray_intersect(o, d)
        return hit, torch.clamp(t0, min=0.0), t1

    def get_combined_extinction(self, mi, active):
        return torch.full_like(mi.sigma_t, self.majorant)

    def get_scattering_coefficients(self, mi, active):
        """sigma_t from the volume's first channel, the same in every
        channel; the albedo volume's channels (at 550 nm in spectral
        variants: the reference passes it no wavelengths); sigma_n the
        rest of the majorant."""
        nch = mi.sigma_t.shape[1]
        sigma_t = (self.sigma_t_vol.eval_1(mi.p)[:, None] * self.scale) \
            .expand(-1, nch)
        albedo = self.albedo_vol.eval(mi.p)
        return (sigma_t * albedo, torch.clamp(self.majorant - sigma_t,
                                              min=0.0), sigma_t)
