"""Sampler plugins (reference: src/samplers/independent.cpp)."""

from __future__ import annotations

from ..core.object import register_plugin
from ..render.sampler import Sampler


@register_plugin("sampler", "independent")
class IndependentSampler(Sampler):
    """(independent.cpp) pure white noise from the TEA counter streams."""
