"""Counter-based random number generation on torch tensors.

Every random value is ``hash(seed, lane_key, dimension)`` through TEA
(reference: include/mitsuba/core/random.h:75-169, ``sample_tea_32``), bit
for bit the same streams as ``mitsuba2_tpu.core.rng``; the volumetric
kernel's tracking streams use the cheaper ``mix32`` hash. Torch has no
general uint32 arithmetic, so the words ride int64 tensors that hold
values in [0, 2**32): sums and xors only ever need their low 32 bits, and
the mask after each update keeps the right shifts exact.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
# the dtype that carries uint32 words (``jnp.uint32`` in the JAX package)
U32 = torch.int64


def _u32(x, like=None):
    """int64 tensor of uint32 values from a tensor, int or array."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    dev = like.device if like is not None else None
    if isinstance(x, int):
        # a fill on the device: no copy from the host to wait for
        return torch.full((), x & MASK32, dtype=torch.int64, device=dev)
    return torch.as_tensor(x, dtype=torch.int64, device=dev) & MASK32


def sample_tea_32(v0, v1, rounds: int = 4):
    """TEA block cipher as a hash: two well-mixed uint32 words (as int64)."""
    v0 = _u32(v0, v1 if isinstance(v1, torch.Tensor) else None)
    v1 = _u32(v1, v0)
    v0, v1 = torch.broadcast_tensors(v0, v1)
    s = 0
    for _ in range(rounds):
        s = (s + 0x9E3779B9) & MASK32
        v0 = (v0 + (((v1 << 4) + 0xA341316C) ^ (v1 + s)
                    ^ ((v1 >> 5) + 0xC8013EA4))) & MASK32
        v1 = (v1 + (((v0 << 4) + 0xAD90777D) ^ (v0 + s)
                    ^ ((v0 >> 5) + 0x7E95761E))) & MASK32
    return v0, v1


def sample_tea_64(v0, v1, rounds: int = 4):
    """64 mixed bits as a (hi, lo) pair of uint32 words."""
    a, b = sample_tea_32(v0, v1, rounds)
    return b, a


def _mul32(a, c: int):
    """Low 32 bits of uint32 a (int64) times the constant uint32 c, in two
    16-bit halves so that no int64 product overflows."""
    lo = (a & 0xFFFF) * c
    hi = ((((a >> 16) * c) & 0xFFFF) << 16)
    return (lo + hi) & MASK32


def mix32(key, dim):
    """Weyl-offset murmur3 finalizer of (key, dim): the cheap counter RNG of
    the volumetric tracking streams (``_mix32`` of
    mitsuba2_tpu/ops/megakernel.py:208-224), bit for bit. ``dim`` is an
    int or an int64 tensor of uint32 values."""
    key = _u32(key)
    d = _u32(dim, key)
    h = (key + _mul32(d, 0x9E3779B9)) & MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def u32_to_float01(bits):
    """uint32 -> float32 in [0, 1) via the mantissa trick (random.h):
    ``((bits >> 9) | 0x3F800000)`` viewed as float32, minus one."""
    f = ((_u32(bits) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def sample_tea_float32(v0, v1, rounds: int = 4):
    """A uniform float in [0, 1) from two seeds (random.h
    sample_tea_float32)."""
    return u32_to_float01(sample_tea_32(v0, v1, rounds)[0])


sample_tea_float = sample_tea_float32


def lane_key(seed, index):
    """Per-lane decorrelated key from a global seed and lane index."""
    return sample_tea_32(seed, index)[0]


# 5 TEA rounds per sample dimension, as the reference sampler substrate.
_SAMPLE_ROUNDS = 5


def uniform_float(key, dim):
    """The core primitive: U[0,1) for (lane key, dimension counter)."""
    v0, _ = sample_tea_32(key, dim, _SAMPLE_ROUNDS)
    return u32_to_float01(v0)


def uniform_float2(key, dim):
    v0, v1 = sample_tea_32(key, dim, _SAMPLE_ROUNDS)
    return u32_to_float01(v0), u32_to_float01(v1)


def uniform_uint32(key, dim):
    return sample_tea_32(key, dim, _SAMPLE_ROUNDS)[0]


def pcg_hash(x):
    """PCG's output permutation of one LCG step: a fast one-word hash
    (``pcg_hash`` of mitsuba2_tpu/core/rng.py:58-63), bit for bit."""
    state = (_mul32(_u32(x), 747796405) + 2891336453) & MASK32
    word = _mul32(((state >> ((state >> 28) + 4)) ^ state), 277803737)
    return (word >> 22) ^ word


def hash_combine(a, b):
    """Two uint32 words mixed boost-style, then through ``pcg_hash``
    (mitsuba2_tpu/core/rng.py:66-69)."""
    a = _u32(a)
    b = _u32(b, a)
    return pcg_hash(a ^ (((b + 0x9E3779B9) & MASK32) + ((a << 6) & MASK32)
                         + (a >> 2)) & MASK32)


# ----------------------------------------------------------------------------
# PCG32 (host-side scalar Python, the reference's exact stream)
# ----------------------------------------------------------------------------

PCG32_DEFAULT_STATE = 0x853C49E6748FEA9B
PCG32_DEFAULT_STREAM = 0xDA3E39CB94B95BDB
PCG32_MULT = 0x5851F42D4C957F2D
_MASK64 = (1 << 64) - 1


class PCG32:
    """Melissa O'Neill's PCG32 in scalar Python (random.h:75), for host
    tooling and tests; the device draws from the TEA streams above."""

    def __init__(self, initstate=PCG32_DEFAULT_STATE,
                 initseq=PCG32_DEFAULT_STREAM):
        self.state = 0
        self.inc = ((initseq << 1) | 1) & _MASK64
        self.next_uint32()
        self.state = (self.state + initstate) & _MASK64
        self.next_uint32()

    def next_uint32(self) -> int:
        old = self.state
        self.state = (old * PCG32_MULT + self.inc) & _MASK64
        xorshifted = (((old >> 18) ^ old) >> 27) & MASK32
        rot = old >> 59
        return ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) \
            & MASK32

    def next_float32(self) -> float:
        return (self.next_uint32() >> 9) * (1.0 / (1 << 23))
