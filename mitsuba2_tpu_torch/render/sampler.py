"""Samplers.

The reference threads a stateful per-lane PCG32 (sampler.h:49,127); this
package is stateless and counter-based instead: every draw hashes
(seed, pixel, sample index, dimension) through TEA (core/rng.py). The path
kernel derives its own lane keys and dimensions from that contract, so the
sampler object carries only its configuration in this slice.
"""

from __future__ import annotations

from ..core.object import Object


class Sampler(Object):
    """Base sampler: sample count and base seed."""

    plugin_name = "independent"

    def __init__(self, props=None):
        super().__init__(props)
        self.sample_count = int(props.int_("sample_count", 4)) \
            if props is not None else 4
        self.base_seed = int(props.int_("seed", 0)) \
            if props is not None else 0
