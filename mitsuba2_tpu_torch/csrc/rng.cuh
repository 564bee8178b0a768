// Device-side RNG and sampling helpers shared by the path kernels.
//
// Replaces mitsuba2_tpu/ops/megakernel.py:194-252 (_tea, _mix32, _u01, _rng2,
// _concentric, _mis). TEA and the float conversion are bit-exact with
// mitsuba2_tpu/core/rng.py and with the plain versions in
// ops/path_kernel.py; _concentric and _mis agree to float rounding.
#pragma once

#include <stdint.h>

// TEA block cipher used as a hash of (v0, v1), in place.
__device__ __forceinline__ void tea(uint32_t& v0, uint32_t& v1, int rounds) {
    uint32_t s = 0u;
    for (int i = 0; i < rounds; ++i) {
        s += 0x9E3779B9u;
        v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s) ^ ((v1 >> 5) + 0xC8013EA4u);
        v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s) ^ ((v0 >> 5) + 0x7E95761Eu);
    }
}

// uint32 -> float in [0, 1): 23 mantissa bits under exponent 0, minus one.
__device__ __forceinline__ float u01(uint32_t bits) {
    return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// Two uniforms of sampler dimension `dim` of the path with key `key`.
__device__ __forceinline__ void rng2(uint32_t key, uint32_t dim,
                                     float& a, float& b) {
    uint32_t v0 = key, v1 = dim;
    tea(v0, v1, 5);
    a = u01(v0);
    b = u01(v1);
}

// Shirley-Chiu concentric square -> disk map.
__device__ __forceinline__ void concentric(float u1, float u2,
                                           float& dx, float& dy) {
    const float x = 2.0f * u1 - 1.0f;
    const float y = 2.0f * u2 - 1.0f;
    const bool zero = (x == 0.0f) && (y == 0.0f);
    const bool q13 = fabsf(x) < fabsf(y);
    const float r = q13 ? y : x;
    const float rp = q13 ? x : y;
    // 0.25 * pi and 0.5 * pi rounded to float, as the reference's
    // weakly-typed Python constants are
    float phi = 0.785398163397448f * rp / (r == 0.0f ? 1.0f : r);
    if (q13) phi = 1.57079632679490f - phi;
    if (zero) phi = 0.0f;
    dx = r * cosf(phi);
    dy = r * sinf(phi);
}

// Power-2 MIS weight of strategy a against b.
__device__ __forceinline__ float mis(float a, float b) {
    const float a2 = a * a;
    const float b2 = b * b;
    return a2 > 0.0f ? a2 / fmaxf(a2 + b2, 1e-30f) : 0.0f;
}

// Weyl-offset murmur3 finalizer of (key, dim): the counter RNG of the
// volumetric tracking streams (mitsuba2_tpu/ops/megakernel.py:208-224
// _mix32), bit-exact with mix32 in core/rng.py.
__device__ __forceinline__ uint32_t mix32(uint32_t key, uint32_t dim) {
    uint32_t h = key + dim * 0x9E3779B9u;
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}
