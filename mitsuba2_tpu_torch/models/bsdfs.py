"""BSDF plugins (reference: src/bsdfs/). This slice ports ``diffuse``,
``roughconductor``, ``dielectric``, ``plastic``, ``roughplastic`` and
``null``. The kernels shade them themselves from the scene's per-face
columns (ops/path_kernel.py, ops/volpath_kernel.py); the wavefront calls
each plugin's ``sample``, ``eval`` and ``pdf`` on the lanes whose surface
carries it (mitsuba2_tpu/models/bsdfs.py:21-110, :151-236, :395-503,
:680-958, in rgb, spectral and mono)."""

from __future__ import annotations

import torch

from ..core import math as m
from ..core import warp
from ..core.object import register_plugin
from ..render.bsdf import BSDF, BSDFFlags, zero_bsdf_sample
from ..render.fresnel import (fresnel, fresnel_conductor,
                              fresnel_diffuse_reflectance,
                              lookup_conductor_curves, lookup_conductor_ior,
                              lookup_ior, reflect, refract)
from ..render.microfacet import MicrofacetDistribution
from ..render.records import BSDFSample3


def _sample(wo, pdf, eta, sampled_type, component):
    """A BSDFSample3 of per-lane tensors; ``sampled_type`` and
    ``component`` are int32 tensors or numbers."""
    def i32(x):
        return (x.to(torch.int32) if isinstance(x, torch.Tensor)
                else torch.full_like(pdf, x).to(torch.int32))
    return BSDFSample3(wo, pdf, eta, i32(sampled_type), i32(component))


def _lobe(select, a, b):
    return torch.where(select, int(a), int(b)).to(torch.int32)


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

    def sample(self, ctx, si, sample1, sample2, active):
        active = active & (si.wi[..., 2] > 0)
        wo = warp.square_to_cosine_hemisphere(sample2)
        pdf = warp.square_to_cosine_hemisphere_pdf(wo)
        # value / pdf * cos = albedo (perfect importance sampling)
        value = self.reflectance.eval(si, active)
        ok = active & (pdf > 0) \
            & ctx.is_enabled(BSDFFlags.DiffuseReflection)
        bs = _sample(wo, torch.where(ok, pdf, 0.0), torch.ones_like(pdf),
                     int(BSDFFlags.DiffuseReflection), 0)
        return bs, torch.where(ok[..., None], value, 0.0)

    def eval(self, ctx, si, wo, active):
        cos_o = wo[..., 2]
        ok = active & (si.wi[..., 2] > 0) & (cos_o > 0) \
            & ctx.is_enabled(BSDFFlags.DiffuseReflection)
        value = self.reflectance.eval(si, active) \
            * (m.InvPi * cos_o)[..., None]
        return torch.where(ok[..., None], value, 0.0)

    def pdf(self, ctx, si, wo, active):
        cos_o = wo[..., 2]
        ok = active & (si.wi[..., 2] > 0) & (cos_o > 0) \
            & ctx.is_enabled(BSDFFlags.DiffuseReflection)
        return torch.where(ok, cos_o * m.InvPi, 0.0)


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

    def _distr(self):
        return MicrofacetDistribution(self.alpha_u, self.alpha_v,
                                      self.dist_type, self.sample_visible)

    def _fresnel(self, si, cos_mh, active):
        return fresnel_conductor(cos_mh[..., None],
                                 self.eta_tex.eval(si, active),
                                 self.k_tex.eval(si, active))

    def sample(self, ctx, si, sample1, sample2, active):
        cos_i = si.wi[..., 2]
        ok = active & (cos_i > 0) \
            & ctx.is_enabled(BSDFFlags.GlossyReflection)
        d = self._distr()
        mh, pdf_m = d.sample(si.wi, sample2[..., 0], sample2[..., 1])
        wo = reflect(si.wi, mh)
        pdf = m.safe_div(pdf_m, 4.0 * m.dot(wo, mh), 0.0)
        ok = ok & (wo[..., 2] > 0) & (pdf > 0)
        # the weight value / pdf
        if self.sample_visible:
            weight = d.smith_g1(wo, mh)
        else:
            weight = m.safe_div(d.eval(mh) * d.G(si.wi, wo, mh),
                                4.0 * pdf * cos_i, 0.0)
        F = self._fresnel(si, m.dot(si.wi, mh), active)
        value = self.specular_reflectance.eval(si, active) * F \
            * weight[..., None]
        bs = _sample(wo, torch.where(ok, pdf, 0.0), torch.ones_like(pdf),
                     int(BSDFFlags.GlossyReflection), 0)
        return bs, torch.where(ok[..., None], value, 0.0)

    def eval(self, ctx, si, wo, active):
        cos_i = si.wi[..., 2]
        ok = active & (cos_i > 0) & (wo[..., 2] > 0) \
            & ctx.is_enabled(BSDFFlags.GlossyReflection)
        d = self._distr()
        mh = m.normalize(si.wi + wo)
        F = self._fresnel(si, m.dot(si.wi, mh), active)
        value = self.specular_reflectance.eval(si, active) * F * m.safe_div(
            d.eval(mh) * d.G(si.wi, wo, mh), 4.0 * cos_i, 0.0)[..., None]
        return torch.where(ok[..., None], value, 0.0)

    def pdf(self, ctx, si, wo, active):
        ok = active & (si.wi[..., 2] > 0) & (wo[..., 2] > 0) \
            & ctx.is_enabled(BSDFFlags.GlossyReflection)
        d = self._distr()
        mh = m.normalize(si.wi + wo)
        pdf = m.safe_div(d.pdf(si.wi, mh), 4.0 * m.dot(wo, mh), 0.0)
        return torch.where(ok, pdf, 0.0)


@register_plugin("bsdf", "null")
class NullBSDF(BSDF):
    """(null.cpp) the pass-through material of a medium's boundary."""

    def __init__(self, props=None):
        super().__init__(props)
        self.m_components = [BSDFFlags.Null | BSDFFlags.FrontSide
                             | BSDFFlags.BackSide]
        self.m_flags = self.m_components[0]

    def sample(self, ctx, si, sample1, sample2, active):
        from ..variants import current
        n = si.t.shape[0]
        bs = zero_bsdf_sample(n, si.t.device)
        ok = active & ctx.is_enabled(BSDFFlags.Null)
        bs = bs._replace(
            wo=-si.wi, pdf=torch.where(ok, 1.0, 0.0),
            sampled_type=torch.full_like(bs.sampled_type,
                                         int(BSDFFlags.Null)))
        value = torch.where(ok[..., None], 1.0, torch.zeros(
            (n, current().n_channels), device=si.t.device))
        return bs, value

    def eval(self, ctx, si, wo, active):
        from ..variants import current
        return torch.zeros((si.t.shape[0], current().n_channels),
                           device=si.t.device)

    def pdf(self, ctx, si, wo, active):
        return torch.zeros_like(si.t)

    def eval_null_transmission(self, si, active):
        """Everything passes (null.cpp)."""
        from ..variants import current
        return torch.where(active[:, None], 1.0, torch.zeros(
            (si.t.shape[0], current().n_channels), device=si.t.device))


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

    def sample(self, ctx, si, sample1, sample2, active):
        from ..variants import current
        n = si.t.shape[0]
        F, cos_t, eta_it, eta_ti = fresnel(si.wi[..., 2], self.eta)
        has_r = ctx.is_enabled(BSDFFlags.DeltaReflection, 0)
        has_t = ctx.is_enabled(BSDFFlags.DeltaTransmission, 1)
        if has_r and has_t:
            select_r = sample1 <= F
            pdf = torch.where(select_r, F, 1.0 - F)
            weight = torch.ones_like(F)
        elif has_r or has_t:
            select_r = torch.full_like(F, has_r, dtype=torch.bool)
            pdf = torch.ones_like(F)
            weight = F if has_r else 1.0 - F
        else:
            return zero_bsdf_sample(n, si.t.device), torch.zeros(
                (n, current().n_channels), device=si.t.device)
        wo = torch.where(select_r[..., None], reflect(si.wi),
                         refract(si.wi, cos_t, eta_ti))
        # radiance transport compresses the solid angle (dielectric.cpp)
        factor = torch.where(select_r, 1.0, eta_ti) if ctx.mode == 0 \
            else torch.ones_like(F)
        value = torch.where(select_r[..., None],
                            self.specular_reflectance.eval(si, active),
                            self.specular_transmittance.eval(si, active)) \
            * (weight * factor * factor)[..., None]
        ok = active & (pdf > 0)
        bs = _sample(wo, torch.where(ok, pdf, 0.0),
                     torch.where(select_r, 1.0, eta_it),
                     _lobe(select_r, BSDFFlags.DeltaReflection,
                           BSDFFlags.DeltaTransmission),
                     _lobe(select_r, 0, 1))
        return bs, torch.where(ok[..., None], value, 0.0)

    def eval(self, ctx, si, wo, active):
        from ..variants import current
        return torch.zeros((si.t.shape[0], current().n_channels),
                           device=si.t.device)

    def pdf(self, ctx, si, wo, active):
        return torch.zeros_like(si.t)


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

    def _probs(self, F_i, has_spec, has_diff):
        """The coat's share of the samples at incident Fresnel F_i."""
        w = self.specular_sampling_weight
        prob_spec = F_i * w
        prob_diff = (1.0 - F_i) * (1.0 - w)
        if has_spec and has_diff:
            return m.safe_div(prob_spec, prob_spec + prob_diff, 1.0)
        return torch.full_like(F_i, 1.0 if has_spec else 0.0)

    def _diffuse(self, si, lead, F_i, F_o, active):
        """The base's color diffuse / (1 - [diffuse] fdr_int) and its
        scale lead (1 - F_i) (1 - F_o), ``lead`` a tensor or number,
        factors in the JAX package's order."""
        diff = self.diffuse_reflectance.eval(si, active)
        denom = 1.0 - diff * self.fdr_int if self.nonlinear \
            else 1.0 - torch.full_like(diff[..., :1], self.fdr_int)
        return m.safe_div(diff, denom, 0.0), (
            lead * (1.0 - F_i) * (1.0 - F_o))


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

    def sample(self, ctx, si, sample1, sample2, active):
        cos_i = si.wi[..., 2]
        ok = active & (cos_i > 0)
        F_i = fresnel(cos_i, self.eta)[0]
        has_spec = ctx.is_enabled(BSDFFlags.DeltaReflection, 0)
        has_diff = ctx.is_enabled(BSDFFlags.DiffuseReflection, 1)
        prob_spec = self._probs(F_i, has_spec, has_diff)
        sel_spec = (sample1 < prob_spec) & has_spec
        wo = torch.where(sel_spec[..., None], reflect(si.wi),
                         warp.square_to_cosine_hemisphere(sample2))
        cos_o = wo[..., 2]
        F_o = fresnel(cos_o, self.eta)[0]
        pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo) \
            * (1.0 - prob_spec)
        pdf = torch.where(sel_spec, prob_spec, pdf_diff)
        spec_w = self.specular_reflectance.eval(si, active) \
            * m.safe_div(F_i, prob_spec, 0.0)[..., None]
        base, scale = self._diffuse(si, self.inv_eta_2, F_i, F_o, active)
        diff_w = base * (scale / torch.clamp(1.0 - prob_spec,
                                             min=1e-8))[..., None]
        value = torch.where(sel_spec[..., None], spec_w, diff_w)
        ok = ok & (pdf > 0)
        bs = _sample(wo, torch.where(ok, pdf, 0.0), torch.ones_like(pdf),
                     _lobe(sel_spec, BSDFFlags.DeltaReflection,
                           BSDFFlags.DiffuseReflection),
                     _lobe(sel_spec, 0, 1))
        return bs, torch.where(ok[..., None], value, 0.0)

    def eval(self, ctx, si, wo, active):
        cos_i, cos_o = si.wi[..., 2], wo[..., 2]
        ok = active & (cos_i > 0) & (cos_o > 0) \
            & ctx.is_enabled(BSDFFlags.DiffuseReflection, 1)
        F_i = fresnel(cos_i, self.eta)[0]
        F_o = fresnel(cos_o, self.eta)[0]
        base, scale = self._diffuse(si, m.InvPi * self.inv_eta_2 * cos_o,
                                    F_i, F_o, active)
        return torch.where(ok[..., None], base * scale[..., None], 0.0)

    def pdf(self, ctx, si, wo, active):
        cos_i, cos_o = si.wi[..., 2], wo[..., 2]
        ok = active & (cos_i > 0) & (cos_o > 0) \
            & ctx.is_enabled(BSDFFlags.DiffuseReflection, 1)
        prob_spec = self._probs(fresnel(cos_i, self.eta)[0],
                                ctx.is_enabled(BSDFFlags.DeltaReflection,
                                               0), True)
        pdf = warp.square_to_cosine_hemisphere_pdf(wo) * (1.0 - prob_spec)
        return torch.where(ok, pdf, 0.0)


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

    def _distr(self):
        return MicrofacetDistribution(self.alpha_u, self.alpha_v,
                                      self.dist_type, self.sample_visible)

    def sample(self, ctx, si, sample1, sample2, active):
        cos_i = si.wi[..., 2]
        ok = active & (cos_i > 0)
        has_spec = ctx.is_enabled(BSDFFlags.GlossyReflection, 0)
        has_diff = ctx.is_enabled(BSDFFlags.DiffuseReflection, 1)
        prob_spec = self._probs(fresnel(cos_i, self.eta)[0], has_spec,
                                has_diff)
        sel_spec = (sample1 < prob_spec) & has_spec
        mh, _ = self._distr().sample(si.wi, sample2[..., 0],
                                     sample2[..., 1])
        wo = torch.where(sel_spec[..., None], reflect(si.wi, mh),
                         warp.square_to_cosine_hemisphere(sample2))
        ok = ok & (wo[..., 2] > 0)
        pdf = self.pdf(ctx, si, wo, ok)
        value = self.eval(ctx, si, wo, ok)
        value = torch.where((ok & (pdf > 0))[..., None], value * m.safe_div(
            torch.ones_like(pdf), pdf, 0.0)[..., None], 0.0)
        bs = _sample(wo, torch.where(ok, pdf, 0.0), torch.ones_like(pdf),
                     _lobe(sel_spec, BSDFFlags.GlossyReflection,
                           BSDFFlags.DiffuseReflection),
                     _lobe(sel_spec, 0, 1))
        return bs, value

    def eval(self, ctx, si, wo, active):
        from ..variants import current
        cos_i, cos_o = si.wi[..., 2], wo[..., 2]
        ok = active & (cos_i > 0) & (cos_o > 0)
        value = torch.zeros((si.t.shape[0], current().n_channels),
                            device=si.t.device)
        if ctx.is_enabled(BSDFFlags.GlossyReflection, 0):
            d = self._distr()
            mh = m.normalize(si.wi + wo)
            F = fresnel(m.dot(si.wi, mh), self.eta)[0]
            spec = m.safe_div(F * d.eval(mh) * d.G(si.wi, wo, mh),
                              4.0 * cos_i, 0.0)
            value = value + self.specular_reflectance.eval(si, active) \
                * spec[..., None]
        if ctx.is_enabled(BSDFFlags.DiffuseReflection, 1):
            F_i = fresnel(cos_i, self.eta)[0]
            F_o = fresnel(cos_o, self.eta)[0]
            base, scale = self._diffuse(
                si, m.InvPi * self.inv_eta_2 * cos_o, F_i, F_o, active)
            value = value + base * scale[..., None]
        return torch.where(ok[..., None], value, 0.0)

    def pdf(self, ctx, si, wo, active):
        cos_i, cos_o = si.wi[..., 2], wo[..., 2]
        ok = active & (cos_i > 0) & (cos_o > 0)
        prob_spec = self._probs(
            fresnel(cos_i, self.eta)[0],
            ctx.is_enabled(BSDFFlags.GlossyReflection, 0),
            ctx.is_enabled(BSDFFlags.DiffuseReflection, 1))
        mh = m.normalize(si.wi + wo)
        pdf_spec = m.safe_div(self._distr().pdf(si.wi, mh),
                              4.0 * m.dot(wo, mh), 0.0) * prob_spec
        pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo) \
            * (1.0 - prob_spec)
        return torch.where(ok, pdf_spec + pdf_diff, 0.0)
