"""Participating-media bases and the constant volume (reference: include/
mitsuba/render/medium.h:11, texture.h:210 Volume, src/textures/
constant3d.cpp; counterpart of ``mitsuba2_tpu.models.media``).

Volumes take world points as torch tensors (..., 3) and return values of
the same leading shape: ``eval_1`` one value, ``eval`` the variant's
channels. The volumetric kernel (ops/volpath_kernel.py) packs a medium's
parameters into its tables and does the transport itself; the volpath
wavefront samples through the media's own methods (models/media_impl.py).
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

    def eval(self, p, wavelengths=None):
        raise NotImplementedError

    def max(self) -> float:
        raise NotImplementedError


@register_plugin("volume", "constant3d")
class ConstantVolume(Volume):
    """(constant3d.cpp) one rgb value everywhere, with its payload in the
    variant it was loaded under, as a constant texture holds it
    (models/textures.py): the sigmoid model's coefficients in spectral
    variants, the luminance in mono variants."""

    def __init__(self, props=None, value=None):
        super().__init__(props)
        if props is not None:
            value = props.get("value", 1.0)
        v = np.asarray(value, np.float32)
        if v.ndim == 0:
            v = np.broadcast_to(v, (3,)).copy()
        self.rgb = v
        from .textures import ConstantTexture
        self._color = ConstantTexture(color=v)

    def eval(self, p, wavelengths=None):
        """The value in the variant's channels at every point of p (...,
        3); in spectral variants at ``wavelengths`` (..., 4), or at 550 nm
        without them, as the reference evaluates a volume it is given no
        wavelengths for (mitsuba2_tpu/models/media.py:55-65)."""
        from ..variants import current
        var = current()
        lead = p.shape[:-1]
        n = p[..., 0].numel()
        if var.is_spectral:
            wavelengths = (torch.full((n, var.n_channels), 550.0,
                                      dtype=p.dtype, device=p.device)
                           if wavelengths is None
                           else wavelengths.reshape(n, -1))
        out = self._color.eval(_Lanes(p.new_empty((n,)), wavelengths))
        return out.reshape(lead + out.shape[-1:])

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
    reads it either. Free-flight sampling and transmittance are shared
    (medium.cpp:36-90; the reference's ``_MediumImpl``,
    mitsuba2_tpu/models/media_impl.py:144-214): single-step delta
    tracking against the per-channel majorant, whose null collisions the
    volpath wavefront chains. A medium gives ``intersect_aabb``,
    ``get_combined_extinction`` and ``get_scattering_coefficients``."""

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

    is_homogeneous = False

    def has_spectral_extinction(self) -> bool:
        return True

    def intersect_aabb(self, ray):
        """-> (hit, mint, maxt) (n,) of the medium's bounds along ray."""
        raise NotImplementedError

    def get_combined_extinction(self, mi, active):
        """The majorant (n, C)."""
        raise NotImplementedError

    def get_scattering_coefficients(self, mi, active):
        """(sigma_s, sigma_n, sigma_t) (n, C) at ``mi.p``."""
        raise NotImplementedError

    def sample_interaction(self, ray, sample, channel, active, index,
                           wavelengths=None):
        """A collision distance drawn from ``sample`` (n,) against the
        majorant of each lane's hero ``channel`` (n,) along ``ray`` (its
        [mint, maxt] clipped to the medium's bounds) -> the medium record
        (render/interaction.py), t = inf where the draw passes maxt or the
        lane is not ``active``; ``index`` is the medium's index in its
        scene, ``wavelengths`` the lanes' hero wavelengths (n, 4) in
        spectral variants."""
        from ..core.frame import Frame
        from ..render.interaction import zero_mi
        from ..variants import current
        n, dev = ray.o.shape[0], ray.o.device
        mi = zero_mi(n, current().n_channels, dev, wavelengths)
        mi = mi._replace(sh_frame=Frame.from_normal(ray.d), wi=-ray.d)
        hit, mint, maxt = self.intersect_aabb(ray)
        active = active & hit
        mint = torch.where(active, torch.maximum(ray.mint, mint), 0.0)
        maxt = torch.where(active, torch.minimum(ray.maxt, maxt),
                           float("inf"))
        combined = self.get_combined_extinction(mi, active)
        maj_c = combined.gather(1, channel.long()[:, None])[:, 0]
        sampled_t = mint - torch.log(torch.clamp(1.0 - sample, min=1e-38)) \
            / torch.clamp(maj_c, min=1e-20)
        valid = active & (sampled_t <= maxt)
        mi = mi._replace(
            t=torch.where(valid, sampled_t, float("inf")),
            p=ray.o + ray.d * sampled_t[:, None],
            medium_idx=torch.full((n,), index, dtype=torch.int32,
                                  device=dev),
            mint=mint, combined_extinction=combined)
        sigma_s, sigma_n, sigma_t = self.get_scattering_coefficients(mi,
                                                                     valid)
        return mi._replace(sigma_s=sigma_s, sigma_n=sigma_n,
                           sigma_t=sigma_t)

    @staticmethod
    def eval_tr_and_pdf(mi, si_t):
        """(transmittance, free-flight pdf) (n, C) over the medium's
        segment up to the collision or the surface at ``si_t``, whichever
        comes first (medium.cpp:80-90): the pdf is the transmittance where
        the surface comes first, else its product with the majorant."""
        t = torch.clamp(torch.minimum(mi.t, si_t) - mi.mint, min=0.0)
        tr = torch.exp(-t[:, None] * mi.combined_extinction)
        pdf = torch.where((si_t < mi.t)[:, None], tr,
                          tr * mi.combined_extinction)
        return tr, pdf


class _Lanes:
    """The fields a constant texture reads of a record: its lane count
    (``t``) and wavelengths."""

    def __init__(self, t, wavelengths):
        self.t, self.wavelengths = t, wavelengths


def as_volume(v) -> Volume:
    """A volume, or a constant volume of a number or color."""
    if isinstance(v, Volume):
        return v
    from ..core.dictio import ColorValue
    if isinstance(v, ColorValue) and v.kind != "spectrum-curve":
        return ConstantVolume(value=v.payload)
    if isinstance(v, (int, float, list, tuple, np.ndarray)):
        return ConstantVolume(value=v)
    raise TypeError(f"cannot interpret {type(v)} as a volume")
