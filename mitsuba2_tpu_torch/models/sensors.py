"""Sensor plugins (reference: src/sensors/{perspective,thinlens,
radiancemeter,irradiancemeter}.cpp; mitsuba2_tpu/models/sensors.py)."""

from __future__ import annotations

import numpy as np
import torch

from ..core import math as m
from ..core import warp
from ..core.frame import Frame
from ..core.object import register_plugin
from ..core.ray import Ray
from ..core.transform import Transform
from ..render.sensor import ProjectiveCamera, Sensor
from .textures import on_device


def _parse_fov(props, aspect: float) -> float:
    """fov + fov_axis handling (perspective.cpp parse_fov semantics)."""
    if props is None:
        return 34.0
    if props.has_property("focal_length") and props.has_property("fov"):
        raise RuntimeError("specify either focal_length or fov, not both")
    axis = props.string("fov_axis", "x")
    if props.has_property("fov"):
        fov = props.float_("fov")
    else:
        # 35mm-equivalent focal length (36x24mm frame, diagonal 43.27mm)
        focal = props.get("focal_length", "50mm")
        if isinstance(focal, str):
            focal = float(focal.replace("mm", ""))
        fov = float(np.rad2deg(2.0 * np.arctan(
            43.266615300557 / 2.0 / focal)))
        axis = "diagonal"

    def conv(v, factor):
        return float(np.rad2deg(
            2.0 * np.arctan(np.tan(np.deg2rad(v) * 0.5) * factor)))

    if axis == "x":
        return fov
    if axis == "y":
        return conv(fov, aspect)
    if axis == "diagonal":
        diag = np.hypot(1.0, 1.0 / aspect)
        return conv(fov, 1.0 / diag)
    if axis == "smaller":
        return fov if aspect < 1 else conv(fov, aspect)
    if axis == "larger":
        return conv(fov, aspect) if aspect < 1 else fov
    raise RuntimeError(f"bad fov_axis {axis!r}")


@register_plugin("sensor", "perspective")
class PerspectiveCamera(ProjectiveCamera):
    """(perspective.cpp:1-325) pinhole camera. The path kernel generates
    its rays from the camera row (ops/path_kernel.py camera_row): the
    to_world basis, the origin and tan(x_fov / 2); the wavefront through
    ``sample_ray`` and the sample-to-camera transform, as the JAX
    camera's (mitsuba2_tpu/models/sensors.py:69-120). The aspect, of the
    field of view and of the image plane, is the film's, as
    perspective.cpp's; the JAX camera takes the crop window's."""

    def __init__(self, props=None):
        super().__init__(props)
        fw, fh = self.film.size
        self.x_fov = _parse_fov(props, fw / fh)
        self.film_changed()

    def film_changed(self):
        """(perspective.cpp update_camera_transforms): the image plane at
        z = 1 maps to [0, 1]^2 over the whole film, then the crop window
        to [0, 1]^2."""
        fw, fh = self.film.size
        w, h = self.film.crop_size
        cx, cy = self.film.crop_offset
        aspect = fw / fh
        camera_to_sample = (
            Transform.scale([-0.5, -0.5 * aspect, 1.0])
            @ Transform.translate([-1.0, -1.0 / aspect, 0.0])
            @ Transform.perspective(self.x_fov, self.near_clip,
                                    self.far_clip))
        camera_to_sample = (Transform.scale([fw / w, fh / h, 1.0])
                            @ Transform.translate([-cx / fw, -cy / fh, 0.0])
                            @ camera_to_sample)
        self.sample_to_camera = camera_to_sample.inverse()

    def traverse(self, cb):
        super().traverse(cb)
        cb.put_parameter("x_fov", self.x_fov)

    def sample_ray(self, time, wavelength_sample, position_sample,
                   aperture_sample=None, active=True):
        """Rays through film positions (n, 2) in [0, 1]^2 -> (Ray, its
        spectral weight (n, C), wavelengths (n, 4) or None): from the near
        plane to the far plane, contiguous. Spectral variants draw four
        hero wavelengths from ``wavelength_sample`` (n,). A pinhole reads
        neither the time nor the aperture sample."""
        n = position_sample.shape[0]
        dev = position_sample.device
        wav, weight = _sample_wavelengths(wavelength_sample, n, dev)
        d = m.normalize(self.sample_to_camera.transform_point(
            _on_plane(position_sample)))
        inv_z = 1.0 / d[..., 2]
        o = self.world_transform.transform_point(torch.zeros((n, 3),
                                                             device=dev))
        return _clipped_ray(self, o, self.world_transform.transform_vector(d),
                            inv_z), weight, wav


def _sample_wavelengths(wavelength_sample, n, device):
    """Four hero wavelengths (n, 4) from ``wavelength_sample`` and their
    weight in spectral variants; none and ones (n, C) otherwise."""
    from ..core import spectrum as spec
    from ..variants import current
    var = current()
    if var.is_spectral:
        return spec.sample_wavelength(wavelength_sample)
    return None, torch.ones((n, var.n_channels), device=device)


def _on_plane(position_sample):
    """Film positions (n, 2) as points (n, 3) on the plane z = 0."""
    return torch.cat([position_sample,
                      torch.zeros_like(position_sample[:, :1])], -1)


def _clipped_ray(cam, o, d_world, inv_z):
    """The ray from ``o`` along ``d_world`` between the camera's near and
    far planes, ``inv_z`` the reciprocal of the camera-space direction's
    z."""
    n = o.shape[0]
    return Ray((o + d_world * (cam.near_clip * inv_z)[..., None])
               .contiguous(), d_world.contiguous(),
               torch.zeros((n,), device=o.device),
               (torch.full((n,), cam.far_clip - cam.near_clip,
                           device=o.device) * inv_z).contiguous())


@register_plugin("sensor", "thinlens")
class ThinLensCamera(PerspectiveCamera):
    """(thinlens.cpp:1-285) a perspective camera with a finite aperture:
    each ray leaves a point of the lens disk of ``aperture_radius`` and
    passes through the pinhole ray's point on the focal plane at
    ``focus_distance`` (mitsuba2_tpu/models/sensors.py:121-165). The
    kernels' gates refuse it (a pinhole only); the wavefronts render
    it."""

    def __init__(self, props=None):
        self.aperture_radius = props.float_("aperture_radius", 0.1) \
            if props else 0.1
        super().__init__(props)

    def needs_aperture_sample(self):
        return True

    def sample_ray(self, time, wavelength_sample, position_sample,
                   aperture_sample, active=True):
        n = position_sample.shape[0]
        dev = position_sample.device
        wav, weight = _sample_wavelengths(wavelength_sample, n, dev)
        near_p = self.sample_to_camera.transform_point(
            _on_plane(position_sample))
        ap = warp.square_to_uniform_disk_concentric(aperture_sample) \
            * self.aperture_radius
        ap3 = _on_plane(ap)
        # the pinhole ray's point on the focal plane
        d = m.normalize(near_p)
        focus_t = self.focus_distance / torch.clamp(d[..., 2], min=1e-8)
        d_new = m.normalize(d * focus_t[..., None] - ap3)
        o = self.world_transform.transform_point(ap3)
        inv_z = 1.0 / torch.clamp(d_new[..., 2], min=1e-8)
        return _clipped_ray(self, o,
                            self.world_transform.transform_vector(d_new),
                            inv_z), weight, wav


@register_plugin("sensor", "radiancemeter")
class RadianceMeter(Sensor):
    """(radiancemeter.cpp) the radiance along one ray: ``origin`` and
    ``direction``, or ``to_world``'s translation and z axis."""

    def __init__(self, props=None):
        super().__init__(props)
        p = props
        origin = p.vector3("origin", [0, 0, 0]) if p else np.zeros(3)
        direction = p.vector3("direction", [0, 0, 1]) if p else \
            np.array([0, 0, 1.0])
        if p is not None and p.has_property("to_world"):
            mtx = np.asarray(p.transform("to_world").matrix)
            origin = mtx[:3, 3]
            direction = mtx[:3, 2]
        self.origin = np.asarray(origin, np.float32)
        self.direction = np.asarray(direction / np.linalg.norm(direction),
                                    np.float32)

    def sample_ray(self, time, wavelength_sample, position_sample,
                   aperture_sample, active=True):
        n = position_sample.shape[0]
        dev = position_sample.device
        wav, weight = _sample_wavelengths(wavelength_sample, n, dev)
        o = on_device(self, "origin", self.origin, dev).expand(n, 3)
        d = on_device(self, "direction", self.direction, dev).expand(n, 3)
        return Ray.make(o, d), weight, wav


@register_plugin("sensor", "irradiancemeter")
class IrradianceMeter(Sensor):
    """(irradiancemeter.cpp) the irradiance on the shape it is nested in:
    rays leave an area-uniform point of the shape (the ``area`` emitter's
    face tables and sampling, as the JAX sensor reuses them,
    mitsuba2_tpu/models/sensors.py:187-239) in a cosine-weighted
    direction about its normal, weighted by pi. The scene re-points it at
    the shape's triangle mesh (``set_shape``)."""

    def __init__(self, props=None):
        super().__init__(props)
        self.shape = None
        self._pack = None

    def set_shape(self, shape):
        """Attach to ``shape``; its area-sampling tables are packed once it
        is a mesh (an analytic shape tessellates, then calls again)."""
        from .emitters import AreaEmitter
        self.shape = shape
        if not shape.is_mesh():
            return
        helper = AreaEmitter()
        helper.shape = shape
        helper.prepare(None)
        self._pack = helper

    def sample_ray(self, time, wavelength_sample, position_sample,
                   aperture_sample, active=True):
        if self._pack is None:
            raise RuntimeError("irradiancemeter requires a shape")
        hp = self._pack
        n = position_sample.shape[0]
        dev = position_sample.device
        wav, weight = _sample_wavelengths(wavelength_sample, n, dev)
        face, u_re = hp._face_distr(dev).sample_reuse(position_sample[..., 0])
        bary = warp.square_to_uniform_triangle(
            torch.stack([u_re, position_sample[..., 1]], -1))
        A = on_device(hp, "faces", hp._face_table, dev)[face]
        p = A[:, 0:3] + A[:, 3:6] * bary[..., 0:1] \
            + A[:, 6:9] * bary[..., 1:2]
        nrm = A[:, 9:12]
        d = Frame.from_normal(nrm).to_world(
            warp.square_to_cosine_hemisphere(aperture_sample))
        return Ray.make(p + nrm * 1e-4, d), weight * m.Pi, wav
