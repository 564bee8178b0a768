"""Samplers.

The reference threads a stateful per-lane PCG32 (sampler.h:49,127); this
package is stateless and counter-based instead: every draw hashes
(seed, pixel, sample index, dimension) through TEA (core/rng.py). The path
kernel derives its own lane keys and dimensions from that contract; the
wavefront draws through ``seed``, ``next_1d`` and ``next_2d``, the JAX
wavefront's sampler (mitsuba2_tpu/render/sampler.py:22-73) with the same
lane key, dimension counter, sample index and per-pixel scramble key, so
that both draw the same numbers. A structured sampler (models/samplers.py)
replaces ``_draw``, the one hook both draws go through, and may replace
``next_2d``.
"""

from __future__ import annotations

import copy

from typing import NamedTuple

import torch

from ..core import rng
from ..core.object import Object


class SamplerState(NamedTuple):
    key: torch.Tensor           # (n,) int64 holding the uint32 lane key
    dim: int                    # the next dimension, the same for every lane
    sample_index: torch.Tensor  # (n,) the sample's index in its pixel
    lane_id: torch.Tensor       # (n,) the pixel's scramble key


class Sampler(Object):
    """Base sampler: sample count and base seed; independent draws."""

    plugin_name = "independent"

    def __init__(self, props=None):
        super().__init__(props)
        self.sample_count = int(props.int_("sample_count", 4)) \
            if props is not None else 4
        self.base_seed = int(props.int_("seed", 0)) \
            if props is not None else 0

    def seed(self, seed, pixel_id, sample_index) -> SamplerState:
        """The lanes' state: (pixel, sample index) mixed through TEA, keyed
        by the seed xor the base seed; pixel_id and sample_index are (n,)
        integer tensors of uint32 values. ``lane_id``, the structured
        samplers' scramble key, is the same for a pixel's samples and
        mixes in the seed (ldsampler.cpp:90-118 seeds its sequences
        from it)."""
        sample_index = rng._u32(sample_index)
        mixed, _ = rng.sample_tea_32(pixel_id, sample_index)
        full_seed = (int(self.base_seed) ^ int(seed)) & rng.MASK32
        return SamplerState(rng.lane_key(full_seed, mixed), 0, sample_index,
                            rng.lane_key(full_seed, pixel_id))

    def next_1d(self, state: SamplerState):
        return self._draw(state, 0), state._replace(dim=state.dim + 1)

    def next_2d(self, state: SamplerState):
        return (torch.stack([self._draw(state, 0), self._draw(state, 1)],
                            -1),
                state._replace(dim=state.dim + 2))

    def clone(self):
        """An independent sampler of the same kind, sample count and seed
        (sampler.h clone)."""
        other = copy.copy(self)
        other.__dict__.pop("_device_cache", None)
        return other

    def _draw(self, state: SamplerState, offset: int):
        """Each lane's number in [0, 1) of dimension ``state.dim +
        offset``."""
        return rng.uniform_float(state.key, state.dim + offset)
