// Device-side shading helpers shared by the path kernels.
//
// Replaces mitsuba2_tpu/ops/megakernel.py:255-284 and :347
// (_fresnel_cond, _ggx_d, _ggx_g1, _fresnel_diel): the conductor and
// dielectric Fresnel terms and the isotropic GGX distribution and Smith
// G1, in float32 as the plain versions compute them (render/fresnel.py
// fresnel_conductor, ops/path_kernel.py).
#pragma once

#define PI_F 3.14159265358979f

// Exact unpolarized conductor Fresnel (megakernel.py:255).
__device__ __forceinline__ float fresnel_cond(float c, float eta, float k) {
    const float c2 = c * c;
    const float s2 = 1.0f - c2;
    const float eta2 = eta * eta - k * k;
    const float etak2 = 2.0f * eta * k;
    const float t0 = eta2 - s2;
    const float a2b2 = sqrtf(fmaxf(t0 * t0 + etak2 * etak2, 0.0f));
    const float t1 = a2b2 + c2;
    const float a = sqrtf(fmaxf(0.5f * (a2b2 + t0), 0.0f));
    const float t2 = 2.0f * a * c;
    const float rs = (t1 - t2) / fmaxf(t1 + t2, 1e-20f);
    const float t3 = c2 * a2b2 + s2 * s2;
    const float t4 = t2 * s2;
    const float rp = rs * (t3 - t4) / fmaxf(t3 + t4, 1e-20f);
    return 0.5f * (rp + rs);
}

__device__ __forceinline__ float ggx_d(float hz, float a) {
    const float a2 = a * a;
    const float d = hz * hz * (a2 - 1.0f) + 1.0f;
    return a2 / fmaxf(PI_F * d * d, 1e-20f);
}

// Smith G1 of isotropic GGX from the cosine alone.
__device__ __forceinline__ float ggx_g1(float cz, float a) {
    cz = fmaxf(cz, 1e-6f);
    const float a2 = a * a;
    const float t2 = (1.0f - cz * cz) / (cz * cz);
    return 2.0f / (1.0f + sqrtf(1.0f + a2 * t2));
}

// Unpolarized dielectric Fresnel reflectance at signed incident cosine
// cos_i and relative IOR eta seen from the normal's side
// (megakernel.py:347); also the signed transmitted cosine and the
// relative IORs eta_it (incident over transmitted side) and eta_ti.
__device__ __forceinline__ float fresnel_diel(float cos_i, float eta,
                                              float& cos_t, float& eta_it,
                                              float& eta_ti) {
    const bool outside = cos_i >= 0.0f;
    const float rcp = 1.0f / eta;
    eta_it = outside ? eta : rcp;
    eta_ti = outside ? rcp : eta;
    const float c2t = 1.0f - eta_ti * eta_ti * (1.0f - cos_i * cos_i);
    const float aci = fabsf(cos_i);
    const float act = sqrtf(fmaxf(c2t, 0.0f));
    const float a_s = (aci - eta_it * act) / fmaxf(aci + eta_it * act, 1e-20f);
    const float a_p = (eta_it * aci - act) / fmaxf(eta_it * aci + act, 1e-20f);
    const float F = 0.5f * (a_s * a_s + a_p * a_p);
    cos_t = outside ? -act : act;
    return eta == 1.0f ? 0.0f : (c2t <= 0.0f ? 1.0f : F);
}

__device__ __forceinline__ float fresnel_diel(float cos_i, float eta) {
    float cos_t, eta_it, eta_ti;
    return fresnel_diel(cos_i, eta, cos_t, eta_it, eta_ti);
}
