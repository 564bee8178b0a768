"""Sensor plugins (reference: src/sensors/perspective.cpp)."""

from __future__ import annotations

import numpy as np

from ..core.object import register_plugin
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
    to_world basis, the origin and tan(x_fov / 2)."""

    def __init__(self, props=None):
        super().__init__(props)
        w, h = self.film.crop_size
        self.x_fov = _parse_fov(props, w / h)
