"""Participating-media bases and the constant volume (reference: include/
mitsuba/render/medium.h:11, texture.h:210 Volume, src/textures/
constant3d.cpp; counterpart of ``mitsuba2_tpu.models.media``).

Volumes take world points as torch tensors (..., 3) and return values of
the same leading shape. A medium holds its parameters; the volumetric
kernel (ops/volpath_kernel.py) packs them into its tables and does the
transport itself.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.object import Object, register_plugin


class Volume(Object):
    """3D texture base (texture.h:210-225): ``to_local`` maps world points
    into the volume's [0,1]^3 frame; a volume without its own
    ``to_world`` takes its medium's."""

    def __init__(self, props=None):
        super().__init__(props)
        from ..core.transform import Transform
        has_tw = props is not None and props.has_property("to_world")
        self.to_local = (props.transform("to_world").inverse() if has_tw
                         else Transform.identity())
        self.identity_transform = not has_tw

    def eval_1(self, p):
        raise NotImplementedError

    def max(self) -> float:
        raise NotImplementedError


@register_plugin("volume", "constant3d")
class ConstantVolume(Volume):
    """(constant3d.cpp) one rgb value everywhere."""

    def __init__(self, props=None, value=None):
        super().__init__(props)
        if props is not None:
            value = props.get("value", 1.0)
        v = np.asarray(value, np.float32)
        if v.ndim == 0:
            v = np.broadcast_to(v, (3,)).copy()
        self.rgb = v

    def eval_1(self, p):
        """The value's luminance at every point of p (..., 3)."""
        from ..core import spectrum as spec
        lum = float(spec.luminance(torch.as_tensor(self.rgb)))
        return torch.full(p.shape[:-1], lum, dtype=p.dtype, device=p.device)

    def max(self) -> float:
        return float(self.rgb.max())


class Medium(Object):
    """Medium base (medium.h:11): the phase function is the nested
    ``phase`` object, isotropic by default; ``sample_emitters`` (default
    true) is kept as ``use_emitter_sampling``, as the reference's medium
    base keeps it (mitsuba2_tpu/models/media_impl.py:155), where nothing
    reads it either: the volumetric kernel samples the emitters."""

    def __init__(self, props=None):
        super().__init__(props)
        self.phase_function = None
        if props is not None:
            for _, obj in props.objects():
                if getattr(obj, "plugin_category", "") == "phase":
                    self.phase_function = obj
        if self.phase_function is None:
            from .phase import IsotropicPhase
            self.phase_function = IsotropicPhase()
        self.use_emitter_sampling = props.bool_("sample_emitters", True) \
            if props is not None else True


def as_volume(v) -> Volume:
    """A volume, or a constant volume of a number or color."""
    if isinstance(v, Volume):
        return v
    from ..core.dictio import ColorValue
    if isinstance(v, ColorValue):
        return ConstantVolume(value=v.payload)
    if isinstance(v, (int, float, list, tuple, np.ndarray)):
        return ConstantVolume(value=v)
    raise TypeError(f"cannot interpret {type(v)} as a volume")
