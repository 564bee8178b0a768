"""Emitter plugins (reference: src/emitters/): ``area``, ``envmap``,
``point``, ``constant``, ``directional``, ``spot`` and ``projector``.

An area emitter packs its shape's triangles and per-face areas on the host
at scene compile (``prepare``); the scene turns them into the light table
the path kernel samples from (area-weighted face pick, then a uniform
point on the triangle — mesh.cpp:300-307). An envmap holds its lat-long
rgb radiance; the scene packs it, and its importance-sampling tables, for
the path kernel. The kernels' gates refuse the other five, which the
wavefronts render.

For the wavefront each emitter evaluates and samples itself per lane,
as the JAX wavefront's (mitsuba2_tpu/models/emitters.py:33-750):
``eval``, ``sample_direction`` (-> DirectionSample and the radiance over
its pdf; a delta emitter's sample has pdf 1 and ``delta`` set) and
``pdf_direction``; the environment emitters (envmap, constant) and the
directional one read the scene's bounding sphere, which the scene passes
in. The envmap samples its texels' luminance x sin(theta) through
``Hierarchical2D``. ``sample_ray`` (endpoint.h:86-135) gives each
emitter's emitted rays and their flux weights; nothing in the renderer
calls it, the tests hold it against the JAX emitters'.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..core import math as m
from ..core import spectrum as spec
from ..core import warp
from ..core.frame import Frame
from ..core.object import register_plugin
from ..core.transform import Transform
from ..render.emitter import Emitter, EmitterFlags
from ..render.records import DirectionSample
from .textures import bilinear_taps, on_device


def _lookup(it, uv):
    """The fields a texture reads (t, uv, wavelengths) at the lanes of the
    reference interaction ``it``, with their own ``uv``."""
    return SimpleNamespace(t=it.t, uv=uv, wavelengths=it.wavelengths)


def _emitted_wavelengths(sample1):
    """The hero wavelengths of an emitted ray and their weight: sampled
    from ``sample1`` in spectral variants, none (and weight 1) else."""
    from ..variants import current
    if current().is_spectral:
        return spec.sample_wavelength(sample1)
    return None, 1.0


def _ray_lookup(uv, wavelengths):
    """The texture lookup of an emitted ray's lanes."""
    return SimpleNamespace(t=uv[..., 0], uv=uv, wavelengths=wavelengths)


def _delta_sample(it, p, n, uv, d, dist):
    """The direction sample of a delta emitter seen from ``it``: pdf 1,
    ``delta`` set (``emitter_idx`` -1, the scene sets it)."""
    return DirectionSample(p, n, uv, torch.ones_like(it.t),
                           torch.ones_like(it.t, dtype=torch.bool), d, dist,
                           torch.full_like(it.t, -1, dtype=torch.int32))


def _towards(position, it):
    """(unit direction, distance, squared distance) from each lane of
    ``it`` to ``position`` (3,)."""
    d = position - it.p
    dist2 = m.squared_norm(d)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-30))
    return d / dist[..., None], dist, dist2


@register_plugin("emitter", "area")
class AreaEmitter(Emitter):
    """(area.cpp) one-sided surface emitter with uniform radiance: a
    constant color, or in spectral variants a D65-weighted spectrum
    (``SRGBD65Spectrum`` or ``D65Spectrum``)."""

    def __init__(self, props=None):
        super().__init__(props)
        if props is not None:
            self.radiance = props.texture_d65("radiance", 1.0)
        else:
            from .textures import as_texture
            self.radiance = as_texture(1.0, within_emitter=True)
        self.m_flags = EmitterFlags.Surface
        if self.radiance.is_spatially_varying():
            self.m_flags |= EmitterFlags.SpatiallyVarying
        self._packed = False

    def prepare(self, scene):
        """Per-face sampling tables of the attached mesh: origin ``tv0``,
        edges ``te1``/``te2``, unit normal ``tn`` and ``face_areas``."""
        del scene
        mesh = self.shape
        if mesh is None or not mesh.is_mesh():
            raise RuntimeError("area emitter requires a mesh shape")
        p = mesh.vertices[mesh.faces]
        self.tv0 = p[:, 0]
        self.te1 = p[:, 1] - p[:, 0]
        self.te2 = p[:, 2] - p[:, 0]
        fn = np.cross(self.te1, self.te2)
        self.face_areas = (0.5 * np.linalg.norm(fn, axis=-1)).astype(
            np.float32)
        self.total_area = float(self.face_areas.sum())
        self.tn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True),
                                  1e-20)
        # the wavefront's face table: v0, e1, e2, n and the corner uvs
        cols = [self.tv0, self.te1, self.te2, self.tn]
        if mesh.uvs is not None:
            uv = mesh.uvs[mesh.faces]
            cols += [uv[:, 0], uv[:, 1], uv[:, 2]]
        self._face_table = np.concatenate(cols, 1).astype(np.float32)
        self._packed = True

    def _face_distr(self, device):
        from ..core.distr_1d import DiscreteDistribution
        cache = self.__dict__.setdefault("_device_cache", {})
        key = ("face_distr", str(device))
        if key not in cache:
            cache[key] = DiscreteDistribution.create(
                self.face_areas).to(device)
        return cache[key]

    def eval(self, si, active):
        """Radiance leaving the front side toward ``si.wi``."""
        ok = active & (si.wi[..., 2] > 0)
        return torch.where(ok[..., None], self.radiance.eval(si, active),
                           0.0)

    def sample_direction(self, it, sample, active, bsphere):
        """A point on the emitter, area-weighted face then uniform
        barycentrics (mesh.cpp:300-307), seen from ``it.p``: the direction
        sample (solid-angle pdf; ``emitter_idx`` -1, the scene sets it)
        and radiance / pdf. ``bsphere``, the scene's bounding sphere, is
        the environment's argument."""
        del bsphere
        dev = it.p.device
        face, u_re = self._face_distr(dev).sample_reuse(sample[..., 0])
        from ..core.warp import square_to_uniform_triangle
        bary = square_to_uniform_triangle(
            torch.stack([u_re, sample[..., 1]], -1))
        bu, bv = bary[..., 0:1], bary[..., 1:2]
        A = on_device(self, "faces", self._face_table, dev)[face]
        p = A[:, 0:3] + A[:, 3:6] * bu + A[:, 6:9] * bv
        nrm = A[:, 9:12]
        uv = (A[:, 12:14] * (1 - bu - bv) + A[:, 14:16] * bu
              + A[:, 16:18] * bv) if A.shape[1] > 12 else bary
        d = p - it.p
        dist2 = m.squared_norm(d)
        dist = torch.sqrt(torch.clamp(dist2, min=1e-30))
        d = d / dist[..., None]
        # area density -> solid angle (shape.cpp sample_direction)
        cos_em = m.dot(-d, nrm)
        pdf = m.safe_div(dist2, cos_em * self.total_area, 0.0)
        active = active & (cos_em > 0) & (pdf > 0)
        pdf = torch.where(active, pdf, 0.0)
        ds = DirectionSample(
            p, nrm, uv, pdf, torch.zeros_like(active), d, dist,
            torch.full_like(face, -1, dtype=torch.int32))
        spec = self.radiance.eval(_lookup(it, uv), active)
        spec = torch.where(active[..., None], spec * m.safe_div(
            torch.ones_like(pdf), pdf, 0.0)[..., None], 0.0)
        return ds, spec

    def pdf_direction(self, it, ds, active):
        cos_em = m.dot(-ds.d, ds.n)
        pdf = m.safe_div(ds.dist * ds.dist, cos_em * self.total_area, 0.0)
        return torch.where(active & (cos_em > 0), pdf, 0.0)

    def sample_ray(self, sample1, sample2, sample3, active, bsphere):
        """An emitted ray (area.cpp:75-120): an area-uniform point, a
        cosine-weighted direction about its normal -> (ray, flux weight
        radiance x pi x area, hero wavelengths or None). The uv the
        radiance reads is the barycentric pair, as the JAX emitter's."""
        from ..core.ray import Ray
        del bsphere
        dev = sample2.device
        face, u_re = self._face_distr(dev).sample_reuse(sample2[..., 0])
        bary = warp.square_to_uniform_triangle(
            torch.stack([u_re, sample2[..., 1]], -1))
        A = on_device(self, "faces", self._face_table, dev)[face]
        p = A[:, 0:3] + A[:, 3:6] * bary[..., 0:1] \
            + A[:, 6:9] * bary[..., 1:2]
        d = Frame.from_normal(A[:, 9:12]).to_world(
            warp.square_to_cosine_hemisphere(sample3))
        wav, wav_weight = _emitted_wavelengths(sample1)
        spec = self.radiance.eval(_ray_lookup(bary, wav), active) \
            * wav_weight
        return Ray.make(p, d), spec * (m.Pi * self.total_area), wav


@register_plugin("emitter", "envmap")
class EnvironmentMap(Emitter):
    """(envmap.cpp) lat-long environment map: ``filename`` (an EXR read
    through utils/io_image.py), ``scale`` and ``to_world``. rgb only. The
    radiance ``data`` is (h, w, 3) float32 with the scale applied; u runs
    along the width, v along the height (u = atan2(x, -z) / 2 pi + 1/2,
    v = acos(y) / pi in the emitter's frame)."""

    def __init__(self, props=None, data=None, scale=1.0):
        super().__init__(props)
        self.to_world = Transform.identity()
        if props is not None:
            from ..utils import io_image
            data = io_image.read_image(props.string("filename"))
            scale = props.float_("scale", 1.0)
            self.to_world = props.transform("to_world", self.to_world)
        data = np.asarray(data, np.float32)
        if data.ndim == 2:
            data = data[..., None]
        if data.shape[-1] == 1:
            data = np.repeat(data, 3, -1)
        self.data = data[..., :3] * scale
        self.res = (self.data.shape[1], self.data.shape[0])
        self.m_flags = EmitterFlags.Infinite | EmitterFlags.SpatiallyVarying
        self._bitmap = None

    def _warp(self, device):
        """Hierarchical2D over the texels' luminance x sin(theta) at row
        centers (envmap.cpp:67; the JAX envmap's weights)."""
        from ..core.distr_2d import Hierarchical2D
        cache = self.__dict__.setdefault("_device_cache", {})
        key = ("warp", str(device))
        if key not in cache:
            data = self.data
            h = data.shape[0]
            lum = (0.212671 * data[..., 0] + 0.715160 * data[..., 1]
                   + 0.072169 * data[..., 2])
            theta = (np.arange(h) + 0.5) / h * np.pi
            weight = (lum * np.sin(theta)[:, None]).astype(np.float32)
            cache[key] = Hierarchical2D.create(weight).to(device)
        return cache[key]

    def _frame(self, device):
        """(to_world 3x3, its inverse's 3x3) on ``device``."""
        inv = self.to_world.inverse()
        return (on_device(self, "to_world", self.to_world.matrix[:3, :3],
                          device),
                on_device(self, "to_local", inv.matrix[:3, :3], device))

    def _dir_to_uv(self, d_world):
        d = m.normalize(d_world @ self._frame(d_world.device)[1].T)
        u = torch.atan2(d[..., 0], -d[..., 2]) * m.InvTwoPi + 0.5
        v = m.safe_acos(torch.clamp(d[..., 1], -1.0, 1.0)) * m.InvPi
        return torch.stack([u, v], -1)

    def _uv_to_dir(self, uv):
        phi = (uv[..., 0] - 0.5) * m.TwoPi
        theta = uv[..., 1] * m.Pi
        st = torch.sin(theta)
        d = torch.stack([st * torch.sin(phi), torch.cos(theta),
                         -st * torch.cos(phi)], -1)
        return m.normalize(d @ self._frame(uv.device)[0].T), st

    def _radiance_at_uv(self, uv, it):
        from ..variants import current
        if current().is_spectral:
            return self._radiance_spectral(uv, it.wavelengths)
        if self._bitmap is None:
            from .textures import BitmapTexture
            self._bitmap = BitmapTexture(data=self.data)
        return self._bitmap.eval(_lookup(it, uv))

    def _radiance_spectral(self, uv, wavelengths):
        """Radiance at the hero wavelengths: the four texels' sigmoid
        spectra blended bilinearly, their scales blended likewise, times
        D65 (envmap.cpp:269-307 eval_spectrum)."""
        from ..core import spectrum as spec
        from ..render.scene import env_texels
        from ..render.srgb import srgb_model_eval
        w, h = self.res
        cache = self.__dict__.setdefault("_device_cache", {})
        key = ("texels", str(uv.device))
        if key not in cache:
            cache[key] = torch.as_tensor(env_texels(
                self.data, "spectral").reshape(h * w, 4), device=uv.device)
        texels = cache[key]
        out, scl = 0.0, 0.0
        for wgt, idx in bilinear_taps(uv, w, h):
            row = texels[idx]
            out = out + wgt[..., None] * srgb_model_eval(row[:, :3],
                                                         wavelengths)
            scl = scl + wgt * row[:, 3]
        return out * scl[..., None] * spec.cie_d65(wavelengths)

    def eval(self, si, active):
        """Radiance arriving along -si.to_world(si.wi)."""
        uv = self._dir_to_uv(-si.to_world(si.wi))
        return torch.where(active[..., None], self._radiance_at_uv(uv, si),
                           0.0)

    def sample_direction(self, it, sample, active, bsphere):
        """A direction from the luminance-weighted texel grid: the
        direction sample (its point 2 r + |p - c| away, outside the
        scene's bounding sphere ``bsphere`` = (center (3,) on the device,
        radius); ``emitter_idx`` -1, the scene sets it) and radiance /
        pdf."""
        uv, pdf_uv = self._warp(it.p.device).sample(sample)
        d, st = self._uv_to_dir(uv)
        # uv area to solid angle: dA_uv / dOmega = 1 / (2 pi^2 sin theta)
        pdf = m.safe_div(pdf_uv, 2.0 * m.Pi * m.Pi * st, 0.0)
        center, radius = bsphere
        dist = 2.0 * radius + m.norm(it.p - center)
        ds = DirectionSample(
            it.p + d * dist[..., None], -d, uv, pdf,
            torch.zeros_like(active), d, dist,
            torch.full_like(it.t, -1, dtype=torch.int32))
        spec = self._radiance_at_uv(uv, it) * m.safe_div(
            torch.ones_like(pdf), pdf, 0.0)[..., None]
        return ds, torch.where((active & (pdf > 0))[..., None], spec, 0.0)

    def pdf_direction(self, it, ds, active):
        uv = self._dir_to_uv(ds.d)
        pdf_uv = self._warp(uv.device).eval(uv)
        st = torch.sin(uv[..., 1] * m.Pi)
        return m.safe_div(pdf_uv, 2.0 * m.Pi * m.Pi * st, 0.0)

    def sample_ray(self, sample1, sample2, sample3, active, bsphere):
        """An emitted ray: an importance-sampled direction into the scene
        from a uniform point of the bounding sphere's cross-section
        behind it, the spatial construction of directional.cpp:80-105
        (the reference leaves this unimplemented, envmap.cpp:149-154; the
        JAX emitter's construction) -> (ray, flux weight, hero wavelengths
        or None). The weight reads the texels as a bitmap, as the JAX
        emitter's does."""
        from ..core.ray import Ray
        from .textures import BitmapTexture
        center, radius = bsphere
        uv, pdf_uv = self._warp(sample2.device).sample(sample2)
        d_to_env, st = self._uv_to_dir(uv)
        d = -d_to_env
        pdf_dir = m.safe_div(pdf_uv, 2.0 * m.Pi * m.Pi * st, 0.0)
        offset = warp.square_to_uniform_disk_concentric(sample3)
        frame = Frame.from_normal(d)
        perp = frame.s * offset[..., 0:1] + frame.t * offset[..., 1:2]
        p = center + (perp - d) * radius
        wav, wav_weight = _emitted_wavelengths(sample1)
        if self._bitmap is None:
            self._bitmap = BitmapTexture(data=self.data)
        weight = self._bitmap.eval(_ray_lookup(uv, wav), active) \
            * wav_weight * m.safe_div(m.Pi * radius * radius, pdf_dir,
                                      0.0)[..., None]
        ok = active & (pdf_dir > 0)
        return Ray.make(p, d), torch.where(ok[..., None], weight, 0.0), wav


def env_lookup_si(ray_d, it):
    """The interaction an environment emitter reads for escaping rays
    ``ray_d``: a frame around -ray_d, wi = -ray_d in it and the lat-long
    uv of ray_d, as the JAX scene's eval_emitter builds it
    (mitsuba2_tpu/render/scene.py:1006-1025, :1477-1481)."""
    frame = Frame.from_normal(-ray_d)
    uv = torch.stack([
        torch.atan2(ray_d[..., 0], -ray_d[..., 2]) * m.InvTwoPi + 0.5,
        m.safe_acos(ray_d[..., 1]) * m.InvPi], -1)
    return it._replace(wi=frame.to_local(-ray_d), sh_frame=frame, uv=uv)


@register_plugin("emitter", "point")
class PointEmitter(Emitter):
    """(point.cpp) a delta position emitter of uniform ``intensity`` at
    ``position`` (or ``to_world``'s translation)
    (mitsuba2_tpu/models/emitters.py:187-250)."""

    def __init__(self, props=None):
        super().__init__(props)
        p = props
        if p is not None:
            self.intensity = p.texture_d65("intensity", 1.0)
        else:
            from .textures import ConstantTexture
            self.intensity = ConstantTexture(color=1.0)
        pos = p.vector3("position", [0, 0, 0]) if p else np.zeros(3)
        if p is not None and p.has_property("to_world"):
            pos = np.asarray(p.transform("to_world").matrix)[:3, 3]
        self.position = np.asarray(pos, np.float32)
        self.m_flags = EmitterFlags.DeltaPosition

    def eval(self, si, active):
        return spec.zeros(si)

    def sample_direction(self, it, sample, active, bsphere):
        del sample, bsphere
        pos = on_device(self, "position", self.position, it.p.device)
        d, dist, dist2 = _towards(pos, it)
        uv = torch.zeros_like(it.p[..., :2])
        ds = _delta_sample(it, pos.expand_as(it.p), torch.zeros_like(it.p),
                           uv, d, dist)
        spec = self.intensity.eval(_lookup(it, uv), active) \
            / dist2[..., None]
        return ds, torch.where(active[..., None], spec, 0.0)

    def pdf_direction(self, it, ds, active):
        return torch.zeros_like(ds.pdf)

    def sample_ray(self, sample1, sample2, sample3, active, bsphere):
        """An emitted ray in a uniform direction -> (ray, intensity x 4 pi,
        hero wavelengths or None)."""
        from ..core.ray import Ray
        del sample3, bsphere
        d = warp.square_to_uniform_sphere(sample2)
        wav, wav_weight = _emitted_wavelengths(sample1)
        spec = self.intensity.eval(_ray_lookup(torch.zeros_like(d[..., :2]),
                                               wav), active) \
            * wav_weight * (4.0 * m.Pi)
        pos = on_device(self, "position", self.position, d.device)
        return Ray.make(pos.expand_as(d), d), spec, wav


@register_plugin("emitter", "constant")
class ConstantEmitter(Emitter):
    """(constant.cpp) a uniform environment ``radiance`` over the scene's
    bounding sphere, sampled uniformly over the sphere of directions
    (mitsuba2_tpu/models/emitters.py:252-312)."""

    def __init__(self, props=None):
        super().__init__(props)
        if props is not None:
            self.radiance = props.texture_d65("radiance", 1.0)
        else:
            from .textures import ConstantTexture
            self.radiance = ConstantTexture(color=1.0)
        self.m_flags = EmitterFlags.Infinite

    def eval(self, si, active):
        return torch.where(active[..., None], self.radiance.eval(si, active),
                           0.0)

    def sample_direction(self, it, sample, active, bsphere):
        d = warp.square_to_uniform_sphere(sample)
        center, radius = bsphere
        dist = 2.0 * radius + m.norm(it.p - center)
        uv = torch.zeros_like(it.p[..., :2])
        ds = DirectionSample(
            it.p + d * dist[..., None], -d, uv,
            torch.full_like(it.t, m.InvFourPi),
            torch.zeros_like(it.t, dtype=torch.bool), d, dist,
            torch.full_like(it.t, -1, dtype=torch.int32))
        spec = self.radiance.eval(_lookup(it, uv), active) * (4.0 * m.Pi)
        return ds, torch.where(active[..., None], spec, 0.0)

    def pdf_direction(self, it, ds, active):
        return torch.full_like(ds.pdf, m.InvFourPi)

    def sample_ray(self, sample1, sample2, sample3, active, bsphere):
        """An emitted ray (constant.cpp:59-78): a uniform point of the
        bounding sphere and a cosine-weighted direction inward -> (ray,
        radiance x 4 (pi r)^2, hero wavelengths or None)."""
        from ..core.ray import Ray
        center, radius = bsphere
        v0 = warp.square_to_uniform_sphere(sample2)
        d = Frame.from_normal(-v0).to_world(
            warp.square_to_cosine_hemisphere(sample3))
        wav, wav_weight = _emitted_wavelengths(sample1)
        weight = self.radiance.eval(_ray_lookup(
            torch.zeros_like(d[..., :2]), wav), active) * wav_weight \
            * (4.0 * (m.Pi * radius) ** 2)
        return Ray.make(center + v0 * radius, d), weight, wav


@register_plugin("emitter", "directional")
class DirectionalEmitter(Emitter):
    """(directional.cpp) a distant delta-direction emitter of
    ``irradiance`` travelling along ``direction`` (or ``to_world``'s z
    axis) (mitsuba2_tpu/models/emitters.py:492-562)."""

    def __init__(self, props=None, direction=None, irradiance=1.0):
        super().__init__(props)
        if props is not None:
            d = props.vector3("direction", [0, 0, 1])
            if props.has_property("to_world"):
                d = np.asarray(props.transform("to_world").matrix)[:3, 2]
            self.irradiance = props.texture_d65("irradiance", 1.0)
        else:
            from .textures import ConstantTexture
            d = np.asarray(direction if direction is not None
                           else [0, 0, 1], np.float32)
            self.irradiance = ConstantTexture(color=irradiance)
        self.direction = np.asarray(d / np.linalg.norm(d), np.float32)
        self.m_flags = EmitterFlags.Infinite | EmitterFlags.DeltaDirection

    def eval(self, si, active):
        return spec.zeros(si)

    def sample_direction(self, it, sample, active, bsphere):
        del sample
        w = on_device(self, "direction", self.direction, it.p.device)
        d = (-w).expand_as(it.p)
        center, radius = bsphere
        dist = 2.0 * radius + m.norm(it.p - center)
        uv = torch.zeros_like(it.p[..., :2])
        ds = _delta_sample(it, it.p + d * dist[..., None], w.expand_as(d),
                           uv, d, dist)
        spec = self.irradiance.eval(_lookup(it, uv), active)
        return ds, torch.where(active[..., None], spec, 0.0)

    def pdf_direction(self, it, ds, active):
        return torch.zeros_like(ds.pdf)

    def sample_ray(self, sample1, sample2, sample3, active, bsphere):
        """An emitted ray (directional.cpp:80-105): from a uniform point of
        the bounding sphere's cross-section behind the scene -> (ray,
        irradiance x pi r^2, hero wavelengths or None)."""
        from ..core.ray import Ray
        del sample3
        center, radius = bsphere
        w = on_device(self, "direction", self.direction, sample2.device)
        d = w.expand(sample2.shape[0], 3)
        offset = warp.square_to_uniform_disk_concentric(sample2)
        frame = Frame.from_normal(d)
        perp = frame.s * offset[..., 0:1] + frame.t * offset[..., 1:2]
        wav, wav_weight = _emitted_wavelengths(sample1)
        weight = self.irradiance.eval(_ray_lookup(
            torch.zeros_like(d[..., :2]), wav), active) * wav_weight \
            * (m.Pi * radius * radius)
        return Ray.make(center + (perp - d) * radius, d), weight, wav


@register_plugin("emitter", "spot")
class SpotEmitter(Emitter):
    """(spot.cpp) a delta position emitter of ``intensity`` at
    ``to_world``'s origin, shining down its +z axis: full within
    ``beam_width`` (3/4 of the cutoff by default), falling off linearly
    in angle to zero at ``cutoff_angle`` (20 degrees), times an optional
    ``texture`` projected over the cone
    (mitsuba2_tpu/models/emitters.py:564-668)."""

    def __init__(self, props=None):
        super().__init__(props)
        p = props
        if p is not None:
            self.intensity = p.texture_d65("intensity", 1.0)
        else:
            from .textures import ConstantTexture
            self.intensity = ConstantTexture(color=1.0)
        cutoff = p.float_("cutoff_angle", 20.0) if p else 20.0
        beam = p.float_("beam_width", cutoff * 0.75) if p else cutoff * 0.75
        self.cutoff_angle = float(np.deg2rad(cutoff))
        self.beam_width = float(np.deg2rad(beam))
        self.cos_cutoff = float(np.cos(self.cutoff_angle))
        self.cos_beam = float(np.cos(self.beam_width))
        self.inv_transition_width = 1.0 / max(
            self.cutoff_angle - self.beam_width, 1e-6)
        self.texture = p.texture("texture", 1.0) if (
            p is not None and p.has_property("texture")) else None
        self.to_world = p.transform("to_world", Transform.identity()) \
            if p else Transform.identity()
        self.to_local = self.to_world.inverse()
        self.position = np.asarray(self.to_world.matrix[:3, 3], np.float32)
        self.m_flags = EmitterFlags.DeltaPosition

    def _falloff(self, d_world, wavelengths, active):
        """The cone's falloff (spot.cpp falloff_curve) toward the world
        directions ``d_world``, times the texture there -> (n, 1) or (n,
        C). The texture reads the lanes' hero wavelengths."""
        local = m.normalize(self.to_local.transform_vector(d_world))
        ct = local[..., 2]
        falloff = torch.clamp((self.cutoff_angle - m.safe_acos(ct))
                              * self.inv_transition_width, 0.0, 1.0)
        falloff = torch.where(ct >= self.cos_beam, 1.0, falloff)
        falloff = torch.where(ct <= self.cos_cutoff, 0.0, falloff)
        if self.texture is None:
            return falloff[..., None]
        uv = torch.stack([
            0.5 + 0.5 * m.safe_div(local[..., 0], local[..., 2], 0.0),
            0.5 + 0.5 * m.safe_div(local[..., 1], local[..., 2], 0.0)], -1)
        return falloff[..., None] * self.texture.eval(
            _ray_lookup(uv, wavelengths), active)

    def eval(self, si, active):
        return spec.zeros(si)

    def sample_direction(self, it, sample, active, bsphere):
        del sample, bsphere
        pos = on_device(self, "position", self.position, it.p.device)
        d, dist, dist2 = _towards(pos, it)
        uv = torch.zeros_like(it.p[..., :2])
        ds = _delta_sample(it, pos.expand_as(it.p), torch.zeros_like(it.p),
                           uv, d, dist)
        spec = self.intensity.eval(_lookup(it, uv), active) \
            * self._falloff(-d, it.wavelengths, active) / dist2[..., None]
        return ds, torch.where(active[..., None], spec, 0.0)

    def pdf_direction(self, it, ds, active):
        return torch.zeros_like(ds.pdf)

    def sample_ray(self, sample1, sample2, sample3, active, bsphere):
        """An emitted ray uniform in the cutoff cone -> (ray, intensity x
        falloff / cone pdf, hero wavelengths or None)."""
        from ..core.ray import Ray
        del sample3, bsphere
        local = warp.square_to_uniform_cone(sample2, self.cos_cutoff)
        d = self.to_world.transform_vector(local)
        pdf_dir = warp.square_to_uniform_cone_pdf(local, self.cos_cutoff)
        wav, wav_weight = _emitted_wavelengths(sample1)
        spec = self.intensity.eval(_ray_lookup(torch.zeros_like(d[..., :2]),
                                               wav), active) \
            * self._falloff(d, wav, active) * wav_weight \
            * m.safe_div(1.0, pdf_dir, 0.0)[..., None]
        pos = on_device(self, "position", self.position, d.device)
        return Ray.make(pos.expand_as(d), d), spec, wav


@register_plugin("emitter", "projector")
class ProjectorEmitter(Emitter):
    """(projector.cpp) a delta position emitter at ``to_world``'s origin
    that projects its ``irradiance`` texture (a bitmap) through a pinhole
    of field of view ``fov`` (45 degrees) down its +z axis, times
    ``scale`` (mitsuba2_tpu/models/emitters.py:670-750). The texture is
    a reflectance-style texture, not an emitter spectrum, as the JAX
    emitter reads it."""

    def __init__(self, props=None):
        super().__init__(props)
        p = props
        if p is not None:
            self.irradiance = p.texture("irradiance", 1.0)
        else:
            from .textures import ConstantTexture
            self.irradiance = ConstantTexture(color=1.0)
        self.scale = p.float_("scale", 1.0) if p else 1.0
        fov = p.float_("fov", 45.0) if p else 45.0
        self.to_world = p.transform("to_world", Transform.identity()) \
            if p else Transform.identity()
        self.to_local = self.to_world.inverse()
        self.position = np.asarray(self.to_world.matrix[:3, 3], np.float32)
        # the camera's sample mapping (projector.cpp)
        self.camera_to_sample = (Transform.scale([-0.5, -0.5, 1.0])
                                 @ Transform.translate([-1.0, -1.0, 0.0])
                                 @ Transform.perspective(fov, 1e-4, 1e4))
        self.sample_to_camera = self.camera_to_sample.inverse()
        self.m_flags = EmitterFlags.DeltaPosition \
            | EmitterFlags.SpatiallyVarying

    def eval(self, si, active):
        return spec.zeros(si)

    def sample_direction(self, it, sample, active, bsphere):
        del sample, bsphere
        pos = on_device(self, "position", self.position, it.p.device)
        d, dist, dist2 = _towards(pos, it)
        # the lane's point projected into the projector's image plane
        local = self.to_local.transform_vector(-d)
        uv = self.camera_to_sample.transform_point(local)[..., :2]
        in_frustum = ((uv[..., 0] >= 0) & (uv[..., 0] <= 1)
                      & (uv[..., 1] >= 0) & (uv[..., 1] <= 1)
                      & (local[..., 2] > 0))
        ds = _delta_sample(it, pos.expand_as(it.p), torch.zeros_like(it.p),
                           uv, d, dist)
        spec = self.irradiance.eval(_lookup(it, uv), active) * self.scale \
            / dist2[..., None]
        return ds, torch.where((active & in_frustum)[..., None], spec, 0.0)

    def pdf_direction(self, it, ds, active):
        return torch.zeros_like(ds.pdf)

    def sample_ray(self, sample1, sample2, sample3, active, bsphere):
        """An emitted ray through the film point ``sample3``
        (projector.cpp:118-152; a uniform film point, the reference's
        default position sampling of an untextured irradiance) -> (ray,
        irradiance x scale, hero wavelengths or None)."""
        from ..core.ray import Ray
        del sample2, bsphere
        uv = sample3
        wav, wav_weight = _emitted_wavelengths(sample1)
        near = self.sample_to_camera.transform_point(
            torch.cat([uv, torch.zeros_like(uv[..., :1])], -1))
        d = self.to_world.transform_vector(m.normalize(near))
        weight = self.irradiance.eval(_ray_lookup(uv, wav), active) \
            * self.scale * wav_weight
        pos = on_device(self, "position", self.position, d.device)
        return Ray.make(pos.expand_as(d), d), weight, wav
