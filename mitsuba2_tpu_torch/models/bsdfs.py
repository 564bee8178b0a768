"""BSDF plugins (reference: src/bsdfs/). This slice ports ``diffuse``,
``roughconductor``, ``dielectric``, ``plastic``, ``roughplastic`` and
``null``. The kernels shade them themselves from the scene's per-face
columns (ops/path_kernel.py, ops/volpath_kernel.py), so the plugins hold
parameters."""

from __future__ import annotations

from ..core.object import register_plugin
from ..render.bsdf import BSDF, BSDFFlags
from ..render.fresnel import (fresnel_diffuse_reflectance,
                              lookup_conductor_curves, lookup_conductor_ior,
                              lookup_ior)


def _spectral_ior(tex, curve=None):
    """In spectral variants a conductor's constant eta or k becomes a
    ``ConductorIORSpectrum`` (the sigmoid upsampling is bounded to [0, 1]
    and would clip k > 1): the curve fit of a named material with
    tabulated curves, else the quadratic through its rgb anchors. Other
    textures pass through (mitsuba2_tpu.models.bsdfs._spectral_ior)."""
    from ..variants import current
    from .textures import ConstantTexture
    if not current().is_spectral or type(tex) is not ConstantTexture:
        return tex
    from .spectra import ConductorIORSpectrum
    return ConductorIORSpectrum(tex.rgb, curve=curve)


def _microfacet_from_props(p):
    """-> (distribution, alpha_u, alpha_v, sample_visible) of a rough
    BSDF's properties: ``distribution`` (beckmann by default), ``alpha``
    or ``alpha_u``/``alpha_v`` (0.1), ``sample_visible`` (true)
    (mitsuba2_tpu.models.bsdfs._microfacet_from_props)."""
    dist = p.string("distribution", "beckmann") if p else "beckmann"
    if dist not in ("ggx", "beckmann"):
        raise ValueError(f"unknown microfacet distribution {dist!r}")
    if p is not None and (p.has_property("alpha_u")
                          or p.has_property("alpha_v")):
        au, av = p.float_("alpha_u"), p.float_("alpha_v")
    else:
        au = av = p.float_("alpha", 0.1) if p else 0.1
    sv = p.bool_("sample_visible", True) if p else True
    return dist, float(au), float(av), sv


@register_plugin("bsdf", "diffuse")
class SmoothDiffuse(BSDF):
    """Lambertian reflection (diffuse.cpp:1-156): cosine-hemisphere
    sampling, eval = albedo * cos(theta_o) / pi. The path kernel evaluates
    it from the per-face albedo the scene packs from ``reflectance``."""

    def __init__(self, props=None):
        super().__init__(props)
        self.reflectance = props.texture("reflectance", 0.5) if props \
            else None
        if self.reflectance is None:
            from .textures import ConstantTexture
            self.reflectance = ConstantTexture(color=0.5)
        self.m_components = [BSDFFlags.DiffuseReflection
                             | BSDFFlags.FrontSide]
        self.m_flags = self.m_components[0]


@register_plugin("bsdf", "roughconductor")
class RoughConductor(BSDF):
    """(roughconductor.cpp) microfacet conductor: complex IOR ``eta`` +
    i ``k`` (or a named ``material``), ``specular_reflectance``, roughness
    ``alpha`` or ``alpha_u``/``alpha_v``, ``distribution`` and
    ``sample_visible`` (mitsuba2_tpu.models.bsdfs.RoughConductor). The
    path kernel takes isotropic GGX with alpha >= 0.01 and samples visible
    normals. In spectral variants eta and k are ``ConductorIORSpectrum``
    curves."""

    def __init__(self, props=None):
        super().__init__(props)
        from .textures import ConstantTexture, as_texture
        p = props
        material = p.string("material", "none") if p else "none"
        if p is not None and (p.has_property("eta") or p.has_property("k")):
            self.eta_tex = _spectral_ior(p.texture("eta", 0.0))
            self.k_tex = _spectral_ior(p.texture("k", 1.0))
        else:
            eta_rgb, k_rgb = lookup_conductor_ior(material)
            curves = lookup_conductor_curves(material)
            self.eta_tex = _spectral_ior(
                as_texture(list(eta_rgb)),
                (curves[0], curves[1]) if curves else None)
            self.k_tex = _spectral_ior(
                as_texture(list(k_rgb)),
                (curves[0], curves[2]) if curves else None)
        self.specular_reflectance = p.texture("specular_reflectance", 1.0) \
            if p else ConstantTexture(color=1.0)
        (self.dist_type, self.alpha_u, self.alpha_v,
         self.sample_visible) = _microfacet_from_props(p)
        flags = BSDFFlags.GlossyReflection | BSDFFlags.FrontSide
        if self.alpha_u != self.alpha_v:
            flags |= BSDFFlags.Anisotropic
        self.m_components = [flags]
        self.m_flags = flags


@register_plugin("bsdf", "null")
class NullBSDF(BSDF):
    """(null.cpp) the pass-through material of a medium's boundary."""

    def __init__(self, props=None):
        super().__init__(props)
        self.m_components = [BSDFFlags.Null | BSDFFlags.FrontSide
                             | BSDFFlags.BackSide]
        self.m_flags = self.m_components[0]


@register_plugin("bsdf", "dielectric")
class SmoothDielectric(BSDF):
    """(dielectric.cpp) a perfectly smooth dielectric interface: relative
    IOR ``eta = int_ior / ext_ior`` (names or numbers, bk7 in air by
    default), ``specular_reflectance`` and ``specular_transmittance``. Two
    delta lobes, picked by the Fresnel term; two-sided."""

    def __init__(self, props=None):
        super().__init__(props)
        from .textures import ConstantTexture
        p = props
        int_ior = lookup_ior(p.get("int_ior", "bk7")) if p else 1.5046
        ext_ior = lookup_ior(p.get("ext_ior", "air")) if p else 1.000277
        self.eta = int_ior / ext_ior
        if p is not None:
            self.specular_reflectance = p.texture("specular_reflectance",
                                                  1.0)
            self.specular_transmittance = p.texture(
                "specular_transmittance", 1.0)
        else:
            self.specular_reflectance = ConstantTexture(color=1.0)
            self.specular_transmittance = ConstantTexture(color=1.0)
        self.m_components = [
            BSDFFlags.DeltaReflection | BSDFFlags.FrontSide
            | BSDFFlags.BackSide,
            BSDFFlags.DeltaTransmission | BSDFFlags.FrontSide
            | BSDFFlags.BackSide | BSDFFlags.NonSymmetric]
        self.m_flags = self.m_components[0] | self.m_components[1]


class _Plastic(BSDF):
    """A dielectric coating of relative IOR ``eta = int_ior / ext_ior``
    (polypropylene in air by default) over a diffuse base
    ``diffuse_reflectance`` (0.5), with ``specular_reflectance`` (1) and
    the ``nonlinear`` internal-scattering compensation (plastic.cpp,
    roughplastic.cpp). The constructor derives what the path kernel reads:
    the coat's sampling weight s / (d + s) of the two textures' mean
    luminances, the internal diffuse Fresnel reflectance ``fdr_int`` and
    1 / eta^2 (mitsuba2_tpu.models.bsdfs.SmoothPlastic.__init__)."""

    def __init__(self, props=None):
        super().__init__(props)
        from .textures import ConstantTexture
        p = props
        int_ior = lookup_ior(p.get("int_ior", "polypropylene")) if p \
            else 1.49
        ext_ior = lookup_ior(p.get("ext_ior", "air")) if p else 1.000277
        self.eta = int_ior / ext_ior
        if p is not None:
            self.diffuse_reflectance = p.texture("diffuse_reflectance", 0.5)
            self.specular_reflectance = p.texture("specular_reflectance",
                                                  1.0)
        else:
            self.diffuse_reflectance = ConstantTexture(color=0.5)
            self.specular_reflectance = ConstantTexture(color=1.0)
        self.nonlinear = p.bool_("nonlinear", False) if p else False
        d_mean = self.diffuse_reflectance.mean()
        s_mean = self.specular_reflectance.mean()
        self.specular_sampling_weight = s_mean / (d_mean + s_mean)
        self.fdr_int = float(fresnel_diffuse_reflectance(1.0 / self.eta))
        self.inv_eta_2 = 1.0 / (self.eta * self.eta)


@register_plugin("bsdf", "plastic")
class SmoothPlastic(_Plastic):
    """(plastic.cpp) a smooth coat: a delta reflection lobe picked by the
    Fresnel-weighted sampling weight, else the cosine-sampled base."""

    def __init__(self, props=None):
        super().__init__(props)
        self.m_components = [
            BSDFFlags.DeltaReflection | BSDFFlags.FrontSide,
            BSDFFlags.DiffuseReflection | BSDFFlags.FrontSide]
        self.m_flags = self.m_components[0] | self.m_components[1]


@register_plugin("bsdf", "roughplastic")
class RoughPlastic(_Plastic):
    """(roughplastic.cpp) a microfacet coat (``distribution``, ``alpha``,
    ``sample_visible`` as roughconductor) over the diffuse base. The path
    kernel takes isotropic GGX with alpha >= 0.01 and visible-normal
    sampling."""

    def __init__(self, props=None):
        super().__init__(props)
        (self.dist_type, self.alpha_u, self.alpha_v,
         self.sample_visible) = _microfacet_from_props(props)
        self.m_components = [
            BSDFFlags.GlossyReflection | BSDFFlags.FrontSide,
            BSDFFlags.DiffuseReflection | BSDFFlags.FrontSide]
        self.m_flags = self.m_components[0] | self.m_components[1]
