"""Sampler plugins (reference: src/samplers/{independent,stratified,
multijitter,orthogonal,ldsampler}.cpp; mitsuba2_tpu/models/samplers.py).

Every draw is a pure function of (seed, pixel, sample index, dimension)
(render/sampler.py): integer hashes of the pixel's scramble key
``lane_id`` and the dimension (core/rng.py ``hash_combine``,
``pcg_hash``), turned into floats as the JAX samplers do, bit for bit.
The path kernel keys its lanes by TEA whatever the sampler, as the JAX
kernel does; only the wavefronts draw through these.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import qmc, rng
from ..core.object import register_plugin
from ..render.sampler import Sampler, SamplerState


@register_plugin("sampler", "independent")
class IndependentSampler(Sampler):
    """(independent.cpp) pure white noise from the TEA counter streams."""


class _StratifiedBase(Sampler):
    """Jittered strata over ``sample_count`` rounded up to a square: a
    per-(pixel, dimension) rotation of the sample indices picks each
    sample's stratum."""

    def __init__(self, props=None):
        super().__init__(props)
        self.jitter = props.bool_("jitter", True) if props is not None \
            else True
        self.res = int(np.ceil(np.sqrt(self.sample_count)))
        self.sample_count = self.res * self.res

    def _perm(self, state: SamplerState, offset: int, n: int):
        """Each lane's stratum in [0, n) for dimension ``state.dim +
        offset`` and that dimension's key (mitsuba2_tpu/models/samplers.py:
        35-44)."""
        dim_key = rng.hash_combine(state.lane_id, state.dim + offset)
        s = ((state.sample_index + rng.pcg_hash(dim_key)) & rng.MASK32) \
            % max(n, 1)
        return s, dim_key

    def _jitter(self, state: SamplerState, offset: int):
        if not self.jitter:
            return 0.5
        return rng.uniform_float(state.key, state.dim + offset)

    def _draw(self, state, offset):
        n = self.sample_count
        s, _ = self._perm(state, offset, n)
        return (s.to(torch.float32) + self._jitter(state, offset)) / n


@register_plugin("sampler", "stratified")
class StratifiedSampler(_StratifiedBase):
    """(stratified.cpp) jittered strata: 1D draws over ``sample_count``
    strata, 2D draws over the (res x res) grid."""

    def next_2d(self, state):
        r = self.res
        s, _ = self._perm(state, 0, self.sample_count)
        sx = (s % r).to(torch.float32)
        sy = (s // r).to(torch.float32)
        v = torch.stack([(sx + self._jitter(state, 0)) / r,
                         (sy + self._jitter(state, 1)) / r], -1)
        return v, state._replace(dim=state.dim + 2)


@register_plugin("sampler", "multijitter")
class MultijitterSampler(_StratifiedBase):
    """(multijitter.cpp) correlated multi-jittered sampling (Kensler
    2013): 2D draws stratified in the coarse (res x res) grid and in the
    fine one, each row's and column's sub-strata shuffled by a hash."""

    def next_2d(self, state):
        r = self.res
        s, dim_key = self._perm(state, 0, self.sample_count)
        x = s % r
        y = s // r
        # the sub-stratum shuffles keyed per column and row
        # (mitsuba2_tpu/models/samplers.py:109-114; the pair computed
        # before them at :105-108 is never read)
        kx = rng.pcg_hash(dim_key ^ rng._mul32(x, 2654435761))
        ky = rng.pcg_hash(dim_key ^ rng._mul32(y, 40503))
        sx = x.to(torch.float32) \
            + (((y + kx) & rng.MASK32) % r).to(torch.float32) / r
        sy = y.to(torch.float32) \
            + (((x + ky) & rng.MASK32) % r).to(torch.float32) / r
        v = torch.stack([(sx + self._jitter(state, 0) / r) / r,
                         (sy + self._jitter(state, 1) / r) / r], -1)
        return v, state._replace(dim=state.dim + 2)


@register_plugin("sampler", "ldsampler")
class LowDiscrepancySampler(Sampler):
    """(ldsampler.cpp:90-118) the scrambled (0,2)-sequence: a
    per-(pixel, dimension) scramble key and sample order, the base-2
    radical inverse and Sobol's second dimension."""

    def _keys(self, state, offset):
        seq_key = rng.hash_combine(state.lane_id, state.dim + offset)
        # the sample order within the sequence (compute_per_sequence_seed)
        return seq_key, state.sample_index ^ (seq_key >> 16)

    def _draw(self, state, offset):
        seq_key, index = self._keys(state, offset)
        return qmc.radical_inverse_2(index, seq_key)

    def next_2d(self, state):
        seq_key, index = self._keys(state, 0)
        v = torch.stack([qmc.radical_inverse_2(index, seq_key),
                         qmc.sobol_2(index, rng.pcg_hash(seq_key))], -1)
        return v, state._replace(dim=state.dim + 2)


@register_plugin("sampler", "orthogonal")
class OrthogonalSampler(Sampler):
    """(orthogonal.cpp) orthogonal-array sampling (Jarosz et al. 2019): a
    Bush-construction array of strength 2 over p^2 samples, p the
    smallest prime with p^2 >= ``sample_count``; dimension d of sample i
    takes stratum (i % p) * k_d + i / p (mod p), k_d a per-pixel rotation
    of d onto [1, p - 1], and a jitter within it."""

    def __init__(self, props=None):
        super().__init__(props)
        p = 2
        while p * p < self.sample_count or not _is_prime(p):
            p += 1
        self.p = p
        self.sample_count = p * p

    def _draw(self, state, offset):
        p = self.p
        i = state.sample_index
        rot = rng.hash_combine(state.lane_id, 0x9E3779B9)
        k = ((state.dim + offset + rot) & rng.MASK32) % (p - 1) + 1
        s = ((i % p) * k + i // p) % p
        j = rng.uniform_float(state.key, state.dim + offset)
        return (s.to(torch.float32) + j) / p


def _is_prime(n):
    if n < 2:
        return False
    k = 2
    while k * k <= n:
        if n % k == 0:
            return False
        k += 1
    return True
