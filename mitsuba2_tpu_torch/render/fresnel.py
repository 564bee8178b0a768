"""Dielectric and conductor Fresnel terms, the named dielectric IORs and
the rgb conductor IOR table (reference: include/mitsuba/render/fresnel.h,
ior.h; counterpart of ``mitsuba2_tpu.render.fresnel``), and the
full-range eta/k curves of the headline metals that spectral variants fit
their IOR spectra to."""

from __future__ import annotations

import torch

from ..core import math as m


def fresnel(cos_theta_i, eta):
    """Unpolarized Fresnel reflectance of a dielectric interface with
    relative IOR ``eta`` (fresnel.h fresnel) -> (F, cos_theta_t, eta_it,
    eta_ti): the reflectance, the transmitted cosine (signed, on the
    other side), the relative IOR seen by the incident ray and its
    inverse. ``eta`` is a number or a tensor."""
    eta = eta.to(cos_theta_i.dtype) if isinstance(eta, torch.Tensor) \
        else torch.full((), eta, dtype=cos_theta_i.dtype,
                        device=cos_theta_i.device)
    outside = cos_theta_i >= 0
    rcp_eta = 1.0 / eta
    eta_it = torch.where(outside, eta, rcp_eta)
    eta_ti = torch.where(outside, rcp_eta, eta)
    cos_theta_t_sqr = 1.0 - eta_ti * eta_ti * (1.0 - cos_theta_i
                                               * cos_theta_i)
    cos_i = cos_theta_i.abs()
    cos_t = m.safe_sqrt(cos_theta_t_sqr)
    a_s = m.safe_div(cos_i - eta_it * cos_t, cos_i + eta_it * cos_t, 0.0)
    a_p = m.safe_div(eta_it * cos_i - cos_t, eta_it * cos_i + cos_t, 0.0)
    F = 0.5 * (a_s * a_s + a_p * a_p)
    F = torch.where(cos_theta_t_sqr <= 0.0, torch.ones_like(F), F)
    F = torch.where(eta == 1.0, torch.zeros_like(F), F)
    return F, torch.where(cos_theta_i <= 0, cos_t, -cos_t), eta_it, eta_ti


def fresnel_diffuse_reflectance(eta) -> torch.Tensor:
    """Average Fresnel reflectance of diffuse internal scattering at
    relative IOR ``eta`` (fresnel.h fresnel_diffuse_reflectance: the Egan
    and Hilgeman / d'Eon polynomial fits), in float32."""
    eta = torch.as_tensor(eta, dtype=torch.float32)

    def powers(ie):
        ie2 = ie * ie
        ie3 = ie2 * ie
        ie4 = ie3 * ie
        return ie, ie2, ie3, ie4, ie4 * ie

    ie, ie2, ie3, ie4, ie5 = powers(eta)
    below = (0.919317 - 3.4793 * ie + 6.75335 * ie2 - 7.80989 * ie3
             + 4.98554 * ie4 - 1.36881 * ie5)
    ie, ie2, ie3, ie4, ie5 = powers(1.0 / eta)
    above = (-9.23372 + 22.2272 * ie - 20.9292 * ie2 + 10.2291 * ie3
             - 2.54396 * ie4 + 0.254913 * ie5)
    return torch.where(eta < 1.0, below, above)


# Named dielectric IORs (ior.h), the values of mitsuba2_tpu.render.fresnel.
IOR_DATABASE = {
    "vacuum": 1.0, "helium": 1.000036, "hydrogen": 1.000132,
    "air": 1.000277, "carbon dioxide": 1.00045,
    "water": 1.3330, "acetone": 1.36, "ethanol": 1.361,
    "carbon tetrachloride": 1.461, "glycerol": 1.4729, "benzene": 1.501,
    "silicone oil": 1.52045, "bromine": 1.661,
    "water ice": 1.31, "fused quartz": 1.458, "pyrex": 1.470,
    "acrylic glass": 1.49, "polypropylene": 1.49, "bk7": 1.5046,
    "sodium chloride": 1.544, "amber": 1.55, "pet": 1.5750,
    "diamond": 2.419,
}


def lookup_ior(name_or_value, default=None):
    """An IOR given as a number or a name of ``IOR_DATABASE`` (ior.h
    lookup_ior)."""
    if name_or_value is None:
        name_or_value = default
    if isinstance(name_or_value, (int, float)):
        return float(name_or_value)
    key = str(name_or_value).lower()
    if key not in IOR_DATABASE:
        raise ValueError(f"unknown IOR name {name_or_value!r}; known: "
                         f"{sorted(IOR_DATABASE)}")
    return IOR_DATABASE[key]


def fresnel_conductor(cos_theta_i, eta_re, eta_im):
    """Unpolarized Fresnel reflectance of a conductor with complex IOR
    ``eta_re + i * eta_im`` at incident cosine ``cos_theta_i``
    (fresnel.h fresnel_conductor); tensors broadcast."""
    c2 = cos_theta_i * cos_theta_i
    s2 = 1.0 - c2
    eta2 = eta_re * eta_re - eta_im * eta_im
    etak2 = 2.0 * eta_re * eta_im

    t0 = eta2 - s2
    a2b2 = m.safe_sqrt(t0 * t0 + etak2 * etak2)
    t1 = a2b2 + c2
    a = m.safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * cos_theta_i
    rs = m.safe_div(t1 - t2, t1 + t2, 1.0)

    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * m.safe_div(t3 - t4, t3 + t4, 1.0)
    return 0.5 * (rp + rs)


# Conductor eta/k as linear sRGB triples (role of the data/ior/*.spd files
# conductor.cpp loads), the same values as mitsuba2_tpu.render.fresnel.
CONDUCTOR_IOR_RGB = {
    # name: (eta_rgb, k_rgb)
    "a-C": ((2.93, 2.20, 1.98), (0.88, 0.74, 0.82)),
    "Ag": ((0.155, 0.116, 0.138), (4.82, 3.12, 2.14)),
    "Al": ((1.345, 0.965, 0.617), (7.47, 6.40, 5.30)),
    "Au": ((0.143, 0.375, 1.442), (3.98, 2.39, 1.60)),
    "Cu": ((0.200, 0.924, 1.102), (3.91, 2.45, 2.14)),
    "Cr": ((4.36, 2.91, 1.65), (5.19, 4.22, 3.75)),
    "Ni": ((2.36, 1.66, 1.47), (4.50, 3.04, 2.34)),
    "TiO2": ((2.21, 2.31, 2.42), (0.0001, 0.0001, 0.001)),
    "W": ((4.37, 3.30, 2.99), (3.50, 2.73, 2.36)),
    "none": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),  # 100% mirror
}


def lookup_conductor_ior(material: str):
    """-> (eta_rgb, k_rgb) of a named conductor (ior.h)."""
    if material not in CONDUCTOR_IOR_RGB:
        raise ValueError(f"unknown conductor {material!r}; known: "
                         f"{sorted(CONDUCTOR_IOR_RGB)}")
    return CONDUCTOR_IOR_RGB[material]


# Full-visible-range eta/k curves of the headline metals (role of the
# reference's data/ior/<m>.eta.spd and .k.spd tables, ior.h:137-141):
# interpolated published optical constants (Johnson & Christy 1972 for
# Au, Ag and Cu; Rakic 1998 Lorentz-Drude for Al), the same values as
# mitsuba2_tpu.render.fresnel. Layout: (wavelengths_nm, eta, k), strictly
# increasing wavelengths.
CONDUCTOR_IOR_CURVES = {
    "Au": ((360, 400, 450, 500, 550, 600, 650, 700, 750, 830),
           (1.72, 1.66, 1.50, 0.85, 0.43, 0.25, 0.17, 0.13, 0.14, 0.17),
           (1.85, 1.96, 1.88, 1.90, 2.46, 2.99, 3.30, 3.84, 4.27, 4.90)),
    "Ag": ((360, 400, 450, 500, 550, 600, 650, 700, 750, 830),
           (0.09, 0.05, 0.04, 0.05, 0.06, 0.06, 0.07, 0.08, 0.09, 0.10),
           (1.61, 2.07, 2.45, 2.87, 3.32, 3.75, 4.15, 4.52, 4.90, 5.50)),
    "Cu": ((360, 400, 450, 500, 550, 600, 650, 700, 750, 830),
           (1.27, 1.18, 1.17, 1.13, 1.04, 0.47, 0.22, 0.21, 0.22, 0.26),
           (1.95, 2.21, 2.36, 2.56, 2.59, 2.81, 3.29, 3.67, 4.05, 4.50)),
    "Al": ((360, 400, 450, 500, 550, 600, 650, 700, 750, 800, 830),
           (0.41, 0.49, 0.61, 0.77, 0.96, 1.20, 1.47, 1.83, 2.40,
            2.80, 2.75),
           (4.43, 4.86, 5.47, 6.08, 6.69, 7.26, 7.79, 8.31, 8.62,
            8.45, 8.31)),
}


def lookup_conductor_curves(material: str):
    """-> (wavelengths, eta, k) full-range curves of a named conductor, or
    None where only its rgb triples exist."""
    return CONDUCTOR_IOR_CURVES.get(material)


def reflect(wi, n=None):
    """Mirror reflection about ``n``, or about the local +z axis
    (fresnel.h reflect)."""
    if n is None:
        return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], -1)
    return 2.0 * m.dot(wi, n)[..., None] * n - wi


def refract(wi, cos_theta_t, eta_ti):
    """Refraction through the local +z interface with the transmitted
    cosine and relative IOR from ``fresnel`` (fresnel.h refract)."""
    return torch.stack([-wi[..., 0] * eta_ti, -wi[..., 1] * eta_ti,
                        cos_theta_t], -1)
