"""Quasi Monte Carlo: radical inverses and (0,2)-sequences (reference:
include/mitsuba/core/qmc.h RadicalInverse; src/samplers/ldsampler.cpp uses
the base-2 fast paths), bit for bit ``mitsuba2_tpu.core.qmc``.

The base-2 paths are uint32 bit operations on int64 tensors holding
uint32 values (core/rng.py); the generic bases run a fixed number of
digit steps, float32 sums in the reference's order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .rng import MASK32, _u32, u32_to_float01

_PRIME_COUNT = 1024
# the largest float32 below one, the generic inverses' upper clamp
_ONE_MINUS = float(np.float32(1.0 - 1e-7))


@functools.lru_cache(maxsize=1)
def primes() -> np.ndarray:
    """The first 1024 primes (qmc.h prime table)."""
    out = []
    n = 2
    while len(out) < _PRIME_COUNT:
        if all(n % p for p in out if p * p <= n):
            out.append(n)
        n += 1
    return np.asarray(out, np.int64)


def prime_base(index: int) -> int:
    return int(primes()[index])


def reverse_bits_u32(x):
    """The 32 bits of each uint32 value in reverse order."""
    x = _u32(x)
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & MASK32


def radical_inverse_2(index, scramble=0):
    """Base-2 radical inverse with XOR scrambling -> float32 in [0, 1)."""
    bits = reverse_bits_u32(index)
    return u32_to_float01(bits ^ _u32(scramble, bits))


def sobol_2(index, scramble=0):
    """The second dimension of the (0,2)-sequence (Sobol' direction
    numbers), XOR-scrambled -> float32 in [0, 1)."""
    index = _u32(index)
    result = torch.broadcast_to(_u32(scramble, index), index.shape).clone()
    v = 1 << 31
    for i in range(32):
        result = torch.where(((index >> i) & 1) != 0, result ^ v, result)
        v = v ^ (v >> 1)
    return u32_to_float01(result)


def sample_02(index, scramble_x=0, scramble_y=0):
    """A point of the scrambled (0,2)-sequence (ldsampler's building
    block)."""
    return radical_inverse_2(index, scramble_x), sobol_2(index, scramble_y)


def _digits(base: int) -> int:
    """Digit steps of a generic inverse: the digits of 2^32 in ``base``,
    plus one."""
    return int(np.ceil(32 / np.log2(base))) + 1


def radical_inverse(base_index: int, index):
    """Radical inverse of uint32 ``index`` in the ``base_index``-th prime
    (qmc.h eval) -> float32 below one."""
    base = prime_base(base_index)
    if base == 2:
        return radical_inverse_2(index)
    idx = _u32(index)
    inv_base = np.float32(1.0 / base)
    value = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    factor = torch.full(idx.shape, float(inv_base), device=idx.device)
    for _ in range(_digits(base)):
        value = value + (idx % base).to(torch.float32) * factor
        factor = factor * float(inv_base)
        idx = idx // base
    return torch.clamp(value, max=_ONE_MINUS)


def scrambled_radical_inverse(base_index: int, index, permutation):
    """Radical inverse with a per-digit ``permutation`` (qmc.h scrambled
    variant; ``faure_permutation`` makes them), the permuted zeros past
    the last digit summed in closed form."""
    base = prime_base(base_index)
    idx = _u32(index)
    perm = torch.as_tensor(np.asarray(permutation, np.int64),
                           device=idx.device)
    inv_base = np.float32(1.0 / base)
    value = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    factor = torch.full(idx.shape, float(inv_base), device=idx.device)
    for _ in range(_digits(base)):
        value = value + perm[idx % base].to(torch.float32) * factor
        factor = factor * float(inv_base)
        idx = idx // base
    tail = float(np.float32(base / (base - 1.0)))
    value = value + perm[0].to(torch.float32) * factor * tail
    return torch.clamp(value, max=_ONE_MINUS)


@functools.lru_cache(maxsize=None)
def faure_permutation(base: int) -> np.ndarray:
    """Faure's deterministic digit permutation of ``base`` (qmc.h
    compute_faure_permutations)."""
    if base == 2:
        return np.array([0, 1], np.uint32)
    if base % 2 == 0:
        # even: twice the half base's, then twice plus one
        prev = faure_permutation(base // 2)
        return np.concatenate([2 * prev, 2 * prev + 1]).astype(np.uint32)
    # odd: (base - 1) / 2 in the middle, the entries at or above it raised
    prev = faure_permutation(base - 1)
    k = (base - 1) // 2
    out = np.where(prev >= k, prev + 1, prev)
    return np.concatenate([out[:k], [k], out[k:]]).astype(np.uint32)


class RadicalInverse:
    """The qmc.h RadicalInverse class's interface."""

    def __init__(self, max_base: int = 1024, scramble: int = -1):
        self.scramble = scramble

    def base(self, index: int) -> int:
        return prime_base(index)

    def bases(self) -> int:
        return _PRIME_COUNT

    def eval(self, base_index: int, index):
        return radical_inverse(base_index, index)

    def eval_scrambled(self, base_index: int, index):
        perm = faure_permutation(prime_base(base_index))
        return scrambled_radical_inverse(base_index, index, perm)
