"""Samplers.

The reference threads a stateful per-lane PCG32 (sampler.h:49,127); this
package is stateless and counter-based instead: every draw hashes
(seed, pixel, sample index, dimension) through TEA (core/rng.py). The path
kernel derives its own lane keys and dimensions from that contract; the
wavefront draws through ``seed``, ``next_1d`` and ``next_2d``, the JAX
wavefront's sampler (mitsuba2_tpu/render/sampler.py:44-73) with the same
lane key and dimension counter, so that both draw the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import rng
from ..core.object import Object


class SamplerState(NamedTuple):
    key: torch.Tensor    # (n,) int64 holding the uint32 lane key
    dim: int             # the next dimension, the same for every lane


class Sampler(Object):
    """Base sampler: sample count and base seed."""

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
        integer tensors of uint32 values."""
        mixed, _ = rng.sample_tea_32(pixel_id, sample_index)
        full_seed = (int(self.base_seed) ^ int(seed)) & rng.MASK32
        return SamplerState(rng.lane_key(full_seed, mixed), 0)

    def next_1d(self, state: SamplerState):
        return (rng.uniform_float(state.key, state.dim),
                SamplerState(state.key, state.dim + 1))

    def next_2d(self, state: SamplerState):
        return (torch.stack([rng.uniform_float(state.key, state.dim),
                             rng.uniform_float(state.key, state.dim + 1)],
                            -1),
                SamplerState(state.key, state.dim + 2))
