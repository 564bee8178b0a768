"""Sensor plugins (reference: src/sensors/perspective.cpp)."""

from __future__ import annotations

import numpy as np
import torch

from ..core import math as m
from ..core.object import register_plugin
from ..core.ray import Ray
from ..core.transform import Transform
from ..render.sensor import ProjectiveCamera


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
    camera's (mitsuba2_tpu/models/sensors.py:69-120)."""

    def __init__(self, props=None):
        super().__init__(props)
        w, h = self.film.crop_size
        self.x_fov = _parse_fov(props, w / h)
        # (perspective.cpp update_camera_transforms): the image plane at
        # z = 1 maps to [0, 1]^2, then the crop window to [0, 1]^2
        aspect = w / h
        fw, fh = self.film.size
        cx, cy = self.film.crop_offset
        camera_to_sample = (
            Transform.scale([-0.5, -0.5 * aspect, 1.0])
            @ Transform.translate([-1.0, -1.0 / aspect, 0.0])
            @ Transform.perspective(self.x_fov, self.near_clip,
                                    self.far_clip))
        camera_to_sample = (Transform.scale([fw / w, fh / h, 1.0])
                            @ Transform.translate([-cx / fw, -cy / fh, 0.0])
                            @ camera_to_sample)
        self.sample_to_camera = camera_to_sample.inverse()

    def sample_ray(self, wavelength_sample, position_sample):
        """Rays through film positions (n, 2) in [0, 1]^2 -> (Ray, its
        spectral weight (n, C), wavelengths (n, 4) or None): from the near
        plane to the far plane, contiguous. Spectral variants draw four
        hero wavelengths from ``wavelength_sample`` (n,)."""
        from ..core import spectrum as spec
        from ..variants import current
        var = current()
        n = position_sample.shape[0]
        dev = position_sample.device
        if var.is_spectral:
            wav, weight = spec.sample_wavelength(wavelength_sample)
        else:
            wav = None
            weight = torch.ones((n, var.n_channels), device=dev)
        p3 = torch.cat([position_sample, torch.zeros((n, 1), device=dev)],
                       -1)
        d = m.normalize(self.sample_to_camera.transform_point(p3))
        inv_z = 1.0 / d[..., 2]
        o = self.world_transform.transform_point(torch.zeros((n, 3),
                                                             device=dev))
        d_world = self.world_transform.transform_vector(d)
        ray = Ray((o + d_world * (self.near_clip * inv_z)[..., None])
                  .contiguous(), d_world.contiguous(),
                  torch.zeros((n,), device=dev),
                  (torch.full((n,), self.far_clip - self.near_clip,
                              device=dev) * inv_z).contiguous())
        return ray, weight, wav
