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
