"""Emitter plugins (reference: src/emitters/). This slice ports ``area``
and ``envmap``.

An area emitter packs its shape's triangles and per-face areas on the host
at scene compile (``prepare``); the scene turns them into the light table
the path kernel samples from (area-weighted face pick, then a uniform
point on the triangle — mesh.cpp:300-307). An envmap holds its lat-long
rgb radiance; the scene packs it, and its importance-sampling tables, for
the path kernel.

For the wavefront each emitter evaluates and samples itself per lane,
as the JAX wavefront's (mitsuba2_tpu/models/emitters.py:33-135,
:324-455): ``eval``, ``sample_direction`` (-> DirectionSample and the
radiance over its pdf) and ``pdf_direction``. The envmap samples its
texels' luminance x sin(theta) through ``Hierarchical2D``.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..core import math as m
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


def env_lookup_si(ray_d, it):
    """The interaction an environment emitter reads for escaping rays
    ``ray_d``: a frame around -ray_d and wi = -ray_d in it, as the JAX
    scene's eval_emitter builds it (mitsuba2_tpu/render/scene.py:
    1006-1025)."""
    frame = Frame.from_normal(-ray_d)
    return it._replace(wi=frame.to_local(-ray_d), sh_frame=frame)
