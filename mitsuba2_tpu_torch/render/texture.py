"""Texture base (reference: include/mitsuba/render/texture.h:23-189;
counterpart of ``mitsuba2_tpu.render.texture``).

Interface: ``eval`` (the variant's channels, at ``si.wavelengths`` in
spectral variants), ``eval_1`` (a scalar a lane), ``eval_3`` (raw linear
rgb), ``sample_spectrum``/``pdf_spectrum`` (rgb-importance sampling of
the hero wavelengths by default, texture.cpp), ``mean``.
"""

from __future__ import annotations

import torch

from ..core.object import Object


def rgb_to_variant_spectrum(rgb, wavelengths):
    """Linear sRGB (n, 3) in the active variant's channels: as it is in
    rgb, its luminance (n, 1) in mono, the rgb2spec model's reflectance
    at the hero wavelengths (n, 4) in spectral variants (srgb.cpp:14-37;
    the model's fit runs on the host)."""
    from ..core import spectrum as spec
    from ..variants import current
    from .srgb import srgb_model_eval, srgb_model_fetch
    var = current()
    if var.is_rgb:
        return rgb
    if var.is_monochromatic:
        return spec.luminance(rgb)[..., None]
    coeff = srgb_model_fetch(rgb.detach().cpu().numpy())
    return srgb_model_eval(torch.as_tensor(coeff, device=rgb.device)
                           .reshape(rgb.shape), wavelengths)


class Texture(Object):
    def eval(self, si, active=True):
        """The value at each lane of ``si`` in the variant's channels."""
        raise NotImplementedError

    def eval_1(self, si, active=True):
        """A scalar a lane (n,)."""
        raise NotImplementedError

    def eval_3(self, si, active=True):
        """Raw linear rgb a lane (n, 3)."""
        raise NotImplementedError

    def sample_spectrum(self, si, sample, active=True):
        """Hero wavelengths for the lanes' ``sample`` (n, 4) and the value
        over their pdf; outside spectral variants the lanes' own
        wavelengths and value."""
        from ..core import spectrum as spec
        from ..variants import current
        if not current().is_spectral:
            return si.wavelengths, self.eval(si, active)
        wav, weight = spec.sample_rgb_spectrum(sample)
        return wav, self.eval(si._replace(wavelengths=wav), active) * weight

    def pdf_spectrum(self, si, active=True):
        """The density of ``sample_spectrum`` at the lanes' wavelengths
        (zeros outside spectral variants)."""
        from ..core import spectrum as spec
        from ..variants import current
        if not current().is_spectral:
            return torch.zeros_like(si.wavelengths)
        return spec.pdf_rgb_spectrum(si.wavelengths)

    def mean(self) -> float:
        raise NotImplementedError

    def is_spatially_varying(self) -> bool:
        return False
