"""BSDF plugins (reference: src/bsdfs/): ``diffuse``, ``roughconductor``,
``dielectric``, ``plastic``, ``roughplastic`` and ``null``, which the
kernels also shade themselves from the scene's per-face columns
(ops/path_kernel.py, ops/volpath_kernel.py); and ``conductor``,
``thindielectric``, ``roughdielectric`` and the wrappers ``twosided``,
``mask``, ``blendbsdf``, ``normalmap`` and ``bumpmap``, which the kernels'
gates refuse. The wavefront calls each plugin's ``sample``, ``eval`` and
``pdf`` on the lanes whose surface carries it, a wrapper its children on
those same lanes under masks (mitsuba2_tpu/models/bsdfs.py:21-1271, in
rgb, spectral and mono). The polarizing elements ``polarizer``,
``retarder`` and ``circular`` and the polarized plastic ``pplastic``
(:1275-1435) give the ``stokes`` integrator their Mueller matrices
(``sample_pol``) and every other integrator their (0, 0) entry."""

from __future__ import annotations

import torch

from ..core import math as m
from ..core import spectrum as spec
from ..core import warp
from ..core.object import register_plugin
from ..render.bsdf import (BSDF, BSDFFlags, depolarize_value,
                           zero_bsdf_sample)
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


def _lobe_select(ctx, F, sample1, flag_r, flag_t):
    """The reflection/transmission pick of a two-lobe BSDF at Fresnel F
    (dielectric.cpp's pattern) -> (select_r, lobe pdf, weight), or None
    when neither lobe is enabled."""
    has_r = ctx.is_enabled(flag_r, 0)
    has_t = ctx.is_enabled(flag_t, 1)
    if has_r and has_t:
        select_r = sample1 <= F
        return select_r, torch.where(select_r, F, 1.0 - F), \
            torch.ones_like(F)
    if has_r or has_t:
        return (torch.full_like(F, has_r, dtype=torch.bool),
                torch.ones_like(F), F if has_r else 1.0 - F)
    return None


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


def _conductor_ior(p):
    """(eta, k) textures of a conductor's properties: ``eta`` and ``k``,
    or the named ``material`` (none: a perfect mirror), as
    ``ConductorIORSpectrum`` curves in spectral variants."""
    from .textures import as_texture
    if p is not None and (p.has_property("eta") or p.has_property("k")):
        return (_spectral_ior(p.texture("eta", 0.0)),
                _spectral_ior(p.texture("k", 1.0)))
    material = p.string("material", "none") if p else "none"
    eta_rgb, k_rgb = lookup_conductor_ior(material)
    curves = lookup_conductor_curves(material)
    return (_spectral_ior(as_texture(list(eta_rgb)),
                          (curves[0], curves[1]) if curves else None),
            _spectral_ior(as_texture(list(k_rgb)),
                          (curves[0], curves[2]) if curves else None))


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
        from .textures import ConstantTexture
        p = props
        self.eta_tex, self.k_tex = _conductor_ior(p)
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
        n = si.t.shape[0]
        bs = zero_bsdf_sample(n, si.t.device)
        ok = active & ctx.is_enabled(BSDFFlags.Null)
        bs = bs._replace(
            wo=-si.wi, pdf=torch.where(ok, 1.0, 0.0),
            sampled_type=torch.full_like(bs.sampled_type,
                                         int(BSDFFlags.Null)))
        value = torch.where(ok[..., None], 1.0, spec.zeros(si))
        return bs, value

    def eval(self, ctx, si, wo, active):
        return spec.zeros(si)

    def pdf(self, ctx, si, wo, active):
        return torch.zeros_like(si.t)

    def eval_null_transmission(self, si, active):
        """Everything passes (null.cpp)."""
        return torch.where(active[:, None], 1.0, spec.zeros(si))


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
        n = si.t.shape[0]
        F, cos_t, eta_it, eta_ti = fresnel(si.wi[..., 2], self.eta)
        pick = _lobe_select(ctx, F, sample1, BSDFFlags.DeltaReflection,
                            BSDFFlags.DeltaTransmission)
        if pick is None:
            return zero_bsdf_sample(n, si.t.device), spec.zeros(si)
        select_r, pdf, weight = pick
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
        return spec.zeros(si)

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
        cos_i, cos_o = si.wi[..., 2], wo[..., 2]
        ok = active & (cos_i > 0) & (cos_o > 0)
        value = spec.zeros(si)
        if ctx.is_enabled(BSDFFlags.GlossyReflection, 0):
            d = self._distr()
            mh = m.normalize(si.wi + wo)
            F = fresnel(m.dot(si.wi, mh), self.eta)[0]
            glossy = m.safe_div(F * d.eval(mh) * d.G(si.wi, wo, mh),
                                4.0 * cos_i, 0.0)
            value = value + self.specular_reflectance.eval(si, active) \
                * glossy[..., None]
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


@register_plugin("bsdf", "thindielectric")
class ThinDielectric(BSDF):
    """(thindielectric.cpp) a thin dielectric slab of relative IOR ``eta
    = int_ior / ext_ior``: transmission leaves the direction unchanged (a
    Null lobe), and the reflectance counts the internal bounces, R' =
    2 F / (1 + F) (mitsuba2_tpu/models/bsdfs.py:238-310)."""

    def __init__(self, props=None):
        super().__init__(props)
        from .textures import ConstantTexture
        p = props
        int_ior = lookup_ior(p.get("int_ior", "bk7")) if p else 1.5046
        ext_ior = lookup_ior(p.get("ext_ior", "air")) if p else 1.000277
        self.eta = int_ior / ext_ior
        self.specular_reflectance = p.texture("specular_reflectance", 1.0) \
            if p else ConstantTexture(color=1.0)
        self.specular_transmittance = p.texture(
            "specular_transmittance", 1.0) if p else \
            ConstantTexture(color=1.0)
        self.m_components = [
            BSDFFlags.DeltaReflection | BSDFFlags.FrontSide
            | BSDFFlags.BackSide,
            BSDFFlags.Null | BSDFFlags.FrontSide | BSDFFlags.BackSide]
        self.m_flags = self.m_components[0] | self.m_components[1]

    def _reflectance(self, si):
        F = fresnel(si.wi[..., 2].abs(), self.eta)[0]
        return torch.where(F < 1.0, 2.0 * F / (1.0 + F), 1.0)

    def sample(self, ctx, si, sample1, sample2, active):
        n = si.t.shape[0]
        F = self._reflectance(si)
        pick = _lobe_select(ctx, F, sample1, BSDFFlags.DeltaReflection,
                            BSDFFlags.Null)
        if pick is None:
            return zero_bsdf_sample(n, si.t.device), spec.zeros(si)
        select_r, pdf, weight = pick
        wo = torch.where(select_r[..., None], reflect(si.wi), -si.wi)
        value = torch.where(select_r[..., None],
                            self.specular_reflectance.eval(si, active),
                            self.specular_transmittance.eval(si, active)) \
            * weight[..., None]
        ok = active & (pdf > 0)
        bs = _sample(wo, torch.where(ok, pdf, 0.0), torch.ones_like(pdf),
                     _lobe(select_r, BSDFFlags.DeltaReflection,
                           BSDFFlags.Null), _lobe(select_r, 0, 1))
        return bs, torch.where(ok[..., None], value, 0.0)

    def eval(self, ctx, si, wo, active):
        return spec.zeros(si)

    def pdf(self, ctx, si, wo, active):
        return torch.zeros_like(si.t)

    def eval_null_transmission(self, si, active):
        return self.specular_transmittance.eval(si, active) \
            * (1.0 - self._reflectance(si))[..., None]


@register_plugin("bsdf", "conductor")
class SmoothConductor(BSDF):
    """(conductor.cpp) a smooth conductor: one delta reflection lobe
    weighted by the complex-IOR Fresnel term, ``eta`` + i ``k`` or a named
    ``material``, times ``specular_reflectance``
    (mitsuba2_tpu/models/bsdfs.py:317-378)."""

    def __init__(self, props=None):
        super().__init__(props)
        from .textures import ConstantTexture
        self.eta_tex, self.k_tex = _conductor_ior(props)
        self.specular_reflectance = props.texture(
            "specular_reflectance", 1.0) if props else \
            ConstantTexture(color=1.0)
        self.m_components = [BSDFFlags.DeltaReflection | BSDFFlags.FrontSide]
        self.m_flags = self.m_components[0]

    def sample(self, ctx, si, sample1, sample2, active):
        n = si.t.shape[0]
        cos_i = si.wi[..., 2]
        ok = active & (cos_i > 0) \
            & ctx.is_enabled(BSDFFlags.DeltaReflection)
        F = fresnel_conductor(cos_i[..., None], self.eta_tex.eval(si, active),
                              self.k_tex.eval(si, active))
        value = self.specular_reflectance.eval(si, active) * F
        bs = _sample(reflect(si.wi), torch.where(ok, 1.0, 0.0),
                     torch.ones((n,), device=si.t.device),
                     int(BSDFFlags.DeltaReflection), 0)
        return bs, torch.where(ok[..., None], value, 0.0)

    def eval(self, ctx, si, wo, active):
        return spec.zeros(si)

    def pdf(self, ctx, si, wo, active):
        return torch.zeros_like(si.t)


@register_plugin("bsdf", "roughdielectric")
class RoughDielectric(BSDF):
    """(roughdielectric.cpp, Walter et al. 2007) a rough dielectric
    interface: glossy reflection and refraction through a microfacet
    distribution (``distribution``, ``alpha`` or ``alpha_u``/``alpha_v``,
    ``sample_visible`` as roughconductor), relative IOR ``eta = int_ior /
    ext_ior``; the Fresnel term picks the lobe, ``wi`` below the surface
    sees 1 / eta (mitsuba2_tpu/models/bsdfs.py:504-673)."""

    def __init__(self, props=None):
        super().__init__(props)
        from .textures import ConstantTexture
        p = props
        int_ior = lookup_ior(p.get("int_ior", "bk7")) if p else 1.5046
        ext_ior = lookup_ior(p.get("ext_ior", "air")) if p else 1.000277
        self.eta = int_ior / ext_ior
        self.inv_eta = 1.0 / self.eta
        self.specular_reflectance = p.texture("specular_reflectance", 1.0) \
            if p else ConstantTexture(color=1.0)
        self.specular_transmittance = p.texture(
            "specular_transmittance", 1.0) if p else \
            ConstantTexture(color=1.0)
        (self.dist_type, self.alpha_u, self.alpha_v,
         self.sample_visible) = _microfacet_from_props(p)
        f = (BSDFFlags.GlossyReflection | BSDFFlags.FrontSide
             | BSDFFlags.BackSide)
        ft = (BSDFFlags.GlossyTransmission | BSDFFlags.FrontSide
              | BSDFFlags.BackSide | BSDFFlags.NonSymmetric)
        if self.alpha_u != self.alpha_v:
            f |= BSDFFlags.Anisotropic
            ft |= BSDFFlags.Anisotropic
        self.m_components = [f, ft]
        self.m_flags = f | ft

    def _distr(self):
        return MicrofacetDistribution(self.alpha_u, self.alpha_v,
                                      self.dist_type, self.sample_visible)

    def sample(self, ctx, si, sample1, sample2, active):
        n = si.t.shape[0]
        cos_i = si.wi[..., 2]
        d = self._distr()
        # wi flipped to the +z hemisphere for sampling
        wi_p = m.mulsign(si.wi, cos_i[..., None])
        mh, pdf_m = d.sample(wi_p, sample2[..., 0], sample2[..., 1])
        F, cos_t, eta_it, eta_ti = fresnel(m.dot(si.wi, mh), self.eta)
        pick = _lobe_select(ctx, F, sample1, BSDFFlags.GlossyReflection,
                            BSDFFlags.GlossyTransmission)
        if pick is None:
            return zero_bsdf_sample(n, si.t.device), spec.zeros(si)
        select_r, lobe_pdf, weight = pick
        wo = torch.where(select_r[..., None], reflect(si.wi, mh),
                         refract(si.wi, cos_t, eta_ti, mh))
        cos_o = wo[..., 2]
        # reflection stays on its side, transmission crosses
        side_ok = torch.where(select_r, cos_i * cos_o > 0,
                              cos_i * cos_o < 0)
        dwh_dwo_r = m.safe_div(1.0, 4.0 * m.dot(wo, mh).abs(), 0.0)
        sqrt_denom = m.dot(si.wi, mh) + eta_it * m.dot(wo, mh)
        dwh_dwo_t = m.safe_div(m.sqr(eta_it) * m.dot(wo, mh).abs(),
                               m.sqr(sqrt_denom), 0.0)
        pdf = pdf_m * lobe_pdf * torch.where(select_r, dwh_dwo_r, dwh_dwo_t)
        ok = active & side_ok & (pdf > 0) & (pdf_m > 0)
        wo_p = m.mulsign(wo, cos_o[..., None])
        if self.sample_visible:
            weight = weight * d.smith_g1(wo_p, mh)
        else:
            weight = weight * m.safe_div(
                d.eval(mh) * d.G(wi_p, wo_p, mh) * m.dot(si.wi, mh).abs(),
                pdf_m * cos_i.abs(), 0.0)
        # radiance transport compresses the refracted solid angle
        factor = torch.where(select_r, 1.0, eta_ti) if ctx.mode == 0 \
            else torch.ones_like(F)
        value = torch.where(select_r[..., None],
                            self.specular_reflectance.eval(si, active),
                            self.specular_transmittance.eval(si, active)) \
            * (weight * factor * factor)[..., None]
        bs = _sample(wo, torch.where(ok, pdf, 0.0),
                     torch.where(select_r, 1.0, eta_it),
                     _lobe(select_r, BSDFFlags.GlossyReflection,
                           BSDFFlags.GlossyTransmission),
                     _lobe(select_r, 0, 1))
        return bs, torch.where(ok[..., None], value, 0.0)

    def _half_vector(self, si, wo):
        """(cos_i, cos_o, reflecting, the micro-normal on the +z side)."""
        cos_i, cos_o = si.wi[..., 2], wo[..., 2]
        reflecting = cos_i * cos_o > 0
        eta_l = torch.where(cos_i > 0, self.eta, self.inv_eta)
        mh = torch.where(reflecting[..., None], m.normalize(si.wi + wo),
                         m.normalize(si.wi + wo * eta_l[..., None]))
        return cos_i, cos_o, reflecting, m.mulsign(mh, mh[..., 2:3])

    def eval(self, ctx, si, wo, active):
        cos_i, cos_o, reflecting, mh = self._half_vector(si, wo)
        d = self._distr()
        wi_p = m.mulsign(si.wi, cos_i[..., None])
        wo_p = m.mulsign(wo, cos_o[..., None])
        D = d.eval(mh)
        G = d.smith_g1(wi_p, mh) * d.smith_g1(wo_p, mh)
        F, _, eta_it, eta_ti = fresnel(m.dot(si.wi, mh), self.eta)
        val_r = m.safe_div(F * D * G, 4.0 * cos_i.abs(), 0.0)
        # transmission (Walter 2007 eq. 21, radiance compression)
        sqrt_denom = m.dot(si.wi, mh) + eta_it * m.dot(wo, mh)
        scale = m.sqr(eta_ti) if ctx.mode == 0 else 1.0
        val_t = m.safe_div(
            scale * (1.0 - F) * D * G * m.sqr(eta_it)
            * m.dot(si.wi, mh) * m.dot(wo, mh),
            cos_i * m.sqr(sqrt_denom), 0.0).abs()
        has_r = ctx.is_enabled(BSDFFlags.GlossyReflection, 0)
        has_t = ctx.is_enabled(BSDFFlags.GlossyTransmission, 1)
        val = torch.where(reflecting, val_r if has_r else 0.0,
                          val_t if has_t else 0.0)
        tint = torch.where(reflecting[..., None],
                           self.specular_reflectance.eval(si, active),
                           self.specular_transmittance.eval(si, active))
        ok = active & (cos_i.abs() > 1e-6) & (cos_o.abs() > 1e-6)
        return torch.where(ok[..., None], tint * val[..., None], 0.0)

    def pdf(self, ctx, si, wo, active):
        cos_i, cos_o, reflecting, mh = self._half_vector(si, wo)
        d = self._distr()
        wi_p = m.mulsign(si.wi, cos_i[..., None])
        F, _, eta_it, _ = fresnel(m.dot(si.wi, mh), self.eta)
        dwh_dwo_r = m.safe_div(1.0, 4.0 * m.dot(wo, mh).abs(), 0.0)
        sqrt_denom = m.dot(si.wi, mh) + eta_it * m.dot(wo, mh)
        dwh_dwo_t = m.safe_div(m.sqr(eta_it) * m.dot(wo, mh).abs(),
                               m.sqr(sqrt_denom), 0.0)
        has_r = ctx.is_enabled(BSDFFlags.GlossyReflection, 0)
        has_t = ctx.is_enabled(BSDFFlags.GlossyTransmission, 1)
        lobe = torch.where(reflecting, F, 1.0 - F) if has_r and has_t \
            else torch.ones_like(F)
        pdf = d.pdf(wi_p, mh) * lobe \
            * torch.where(reflecting, dwh_dwo_r, dwh_dwo_t)
        none = torch.zeros_like(reflecting)
        lobe_on = (reflecting if has_r else none) \
            | (~reflecting if has_t else none)
        # the micro-normal on the side of both directions (the masking
        # that eval's and sample's smith_g1 carry)
        ok = active & lobe_on & (m.dot(si.wi, mh) * cos_i > 0) \
            & (m.dot(wo, mh) * cos_o > 0)
        return torch.where(ok, pdf, 0.0)


# ---------------------------------------------------------------------------
# Wrappers (twosided.cpp, mask.cpp, blendbsdf.cpp, normalmap.cpp,
# bumpmap.cpp). A wrapper is one BSDF of the scene's dispatch: its
# children run on the wrapper's partition lanes under masks, as the JAX
# wrappers call them (mitsuba2_tpu/models/bsdfs.py:945-1271), and are
# never partitioned again.
# ---------------------------------------------------------------------------

def _nested_bsdfs(props, max_count=2):
    out = []
    if props is not None:
        for _, obj in props.objects():
            if getattr(obj, "plugin_category", "") == "bsdf":
                out.append(obj)
    return out[:max_count]


def _flip(v):
    """``v`` mirrored through the local xy plane."""
    return torch.cat([v[..., :2], -v[..., 2:3]], -1)


def _merge(mask, a, b):
    """BSDF samples ``a`` where ``mask``, else ``b``, field by field."""
    from ..render.records import select
    return select(mask, a, b)


@register_plugin("bsdf", "twosided")
class TwoSided(BSDF):
    """(twosided.cpp) one or two nested one-sided BSDFs seen from both
    sides: a lane below the surface evaluates the back BSDF (the front one
    if only one is given) with its directions mirrored through the
    surface."""

    def __init__(self, props=None, nested=None):
        super().__init__(props)
        bsdfs = _nested_bsdfs(props) if props is not None else \
            ([nested] if nested is not None else [])
        if not bsdfs:
            raise RuntimeError("twosided requires a nested BSDF")
        self.brdf_front = bsdfs[0]
        self.brdf_back = bsdfs[1] if len(bsdfs) > 1 else bsdfs[0]
        f = (self.brdf_front.flags() | self.brdf_back.flags()
             | BSDFFlags.FrontSide | BSDFFlags.BackSide)
        self.m_components = [f]
        self.m_flags = f

    def sample(self, ctx, si, sample1, sample2, active):
        front = si.wi[..., 2] > 0
        bs_f, val_f = self.brdf_front.sample(ctx, si, sample1, sample2,
                                             active & front)
        bs_b, val_b = self.brdf_back.sample(ctx, si._replace(
            wi=_flip(si.wi)), sample1, sample2, active & ~front)
        bs = _merge(front, bs_f, bs_b._replace(wo=_flip(bs_b.wo)))
        return bs, torch.where(front[..., None], val_f, val_b)

    def eval(self, ctx, si, wo, active):
        front = si.wi[..., 2] > 0
        val_f = self.brdf_front.eval(ctx, si, wo, active & front)
        val_b = self.brdf_back.eval(ctx, si._replace(wi=_flip(si.wi)),
                                    _flip(wo), active & ~front)
        return torch.where(front[..., None], val_f, val_b)

    def pdf(self, ctx, si, wo, active):
        front = si.wi[..., 2] > 0
        p_f = self.brdf_front.pdf(ctx, si, wo, active & front)
        p_b = self.brdf_back.pdf(ctx, si._replace(wi=_flip(si.wi)),
                                 _flip(wo), active & ~front)
        return torch.where(front, p_f, p_b)


@register_plugin("bsdf", "mask")
class MaskBSDF(BSDF):
    """(mask.cpp) an ``opacity`` mask (0.5) over a nested BSDF: a sample
    passes straight through with probability 1 - opacity (a Null lobe,
    ``wo = -wi``, the pass probability as its pdf and unit weight), else
    the nested BSDF samples with ``sample1`` rescaled by the opacity."""

    def __init__(self, props=None, nested=None, opacity=0.5):
        super().__init__(props)
        bsdfs = _nested_bsdfs(props) if props is not None else \
            ([nested] if nested is not None else [])
        if not bsdfs:
            raise RuntimeError("mask requires a nested BSDF")
        self.nested = bsdfs[0]
        if props is not None:
            self.opacity = props.texture("opacity", 0.5)
        else:
            from .textures import ConstantTexture
            self.opacity = ConstantTexture(color=opacity)
        null = BSDFFlags.Null | BSDFFlags.FrontSide | BSDFFlags.BackSide
        self.m_components = list(self.nested.m_components) + [null]
        self.m_flags = self.nested.flags() | null

    def _opacity(self, si, active):
        return torch.clamp(self.opacity.eval_1(si, active), 0.0, 1.0)

    def sample(self, ctx, si, sample1, sample2, active):
        n = si.t.shape[0]
        op = self._opacity(si, active)
        sel_nested = sample1 < op
        bs_n, val_n = self.nested.sample(ctx, si, m.safe_div(sample1, op,
                                                             0.0),
                                         sample2, active & sel_nested)
        pass_pdf = 1.0 - op
        bs_null = zero_bsdf_sample(n, si.t.device)._replace(
            wo=-si.wi, pdf=pass_pdf,
            sampled_type=torch.full((n,), int(BSDFFlags.Null),
                                    dtype=torch.int32, device=si.t.device),
            sampled_component=torch.full(
                (n,), len(self.m_components) - 1, dtype=torch.int32,
                device=si.t.device))
        bs = _merge(sel_nested, bs_n, bs_null)
        bs = bs._replace(pdf=torch.where(sel_nested, bs_n.pdf * op,
                                         pass_pdf))
        value = torch.where(sel_nested[..., None], val_n, 1.0)
        return bs, torch.where(active[..., None], value, 0.0)

    def eval(self, ctx, si, wo, active):
        return self.nested.eval(ctx, si, wo, active) \
            * self._opacity(si, active)[..., None]

    def pdf(self, ctx, si, wo, active):
        return self.nested.pdf(ctx, si, wo, active) \
            * self._opacity(si, active)

    def eval_null_transmission(self, si, active):
        op = self._opacity(si, active)
        return torch.where(active[..., None], (1.0 - op)[..., None]
                           * (spec.zeros(si) + 1.0), 0.0)


@register_plugin("bsdf", "blendbsdf")
class BlendBSDF(BSDF):
    """(blendbsdf.cpp) the mix (1 - w) f0 + w f1 of two nested BSDFs by
    the ``weight`` texture w (0.5): a sample picks f1 where sample1 < w
    and rescales sample1 into its lobe's share."""

    def __init__(self, props=None, bsdf0=None, bsdf1=None, weight=0.5):
        super().__init__(props)
        bsdfs = _nested_bsdfs(props) if props is not None else \
            [b for b in (bsdf0, bsdf1) if b is not None]
        if len(bsdfs) != 2:
            raise RuntimeError("blendbsdf requires exactly two nested BSDFs")
        self.bsdf0, self.bsdf1 = bsdfs
        if props is not None:
            self.weight = props.texture("weight", 0.5)
        else:
            from .textures import ConstantTexture
            self.weight = ConstantTexture(color=weight)
        self.m_components = (list(self.bsdf0.m_components)
                             + list(self.bsdf1.m_components))
        self.m_flags = self.bsdf0.flags() | self.bsdf1.flags()

    def _w(self, si, active):
        return torch.clamp(self.weight.eval_1(si, active), 0.0, 1.0)

    def sample(self, ctx, si, sample1, sample2, active):
        w = self._w(si, active)
        sel1 = sample1 < w
        s1 = torch.where(sel1, m.safe_div(sample1, w, 0.0),
                         m.safe_div(sample1 - w, 1.0 - w, 0.0))
        bs0, v0 = self.bsdf0.sample(ctx, si, s1, sample2, active & ~sel1)
        bs1, v1 = self.bsdf1.sample(ctx, si, s1, sample2, active & sel1)
        return _merge(sel1, bs1, bs0), torch.where(sel1[..., None], v1, v0)

    def eval(self, ctx, si, wo, active):
        w = self._w(si, active)
        return (self.bsdf0.eval(ctx, si, wo, active) * (1 - w)[..., None]
                + self.bsdf1.eval(ctx, si, wo, active) * w[..., None])

    def pdf(self, ctx, si, wo, active):
        w = self._w(si, active)
        return (self.bsdf0.pdf(ctx, si, wo, active) * (1 - w)
                + self.bsdf1.pdf(ctx, si, wo, active) * w)


def _tangent_frame(n_world, dp_du):
    """The frame of normal ``n_world`` with its tangent dp_du made
    orthogonal to it, a constructed one where that degenerates."""
    from ..core.frame import Frame
    s = m.normalize(dp_du - n_world * m.dot(n_world, dp_du)[..., None])
    fs, _ = m.coordinate_system(n_world)
    s = torch.where((m.squared_norm(s) < 0.5)[..., None], fs, s)
    return Frame(s, m.normalize(m.cross(n_world, s)), n_world)


class _FrameMapBSDF(BSDF):
    """A nested BSDF evaluated in a perturbed shading frame
    (``_perturbed_frame``): ``wi`` and ``wo`` move into it, and a sample
    the perturbation pushes below the geometric surface is void."""

    def __init__(self, props=None, nested=None):
        super().__init__(props)
        bsdfs = _nested_bsdfs(props) if props is not None else \
            ([nested] if nested is not None else [])
        if not bsdfs:
            raise RuntimeError(f"{type(self).__name__} requires a nested "
                               f"BSDF")
        self.nested = bsdfs[0]
        self.m_components = list(self.nested.m_components)
        self.m_flags = self.nested.flags() | BSDFFlags.SpatiallyVarying

    def _perturbed_frame(self, si, active):
        raise NotImplementedError

    def _to_perturbed(self, si, active):
        frame = self._perturbed_frame(si, active)
        return si._replace(wi=frame.to_local(si.to_world(si.wi))), frame

    def sample(self, ctx, si, sample1, sample2, active):
        si_p, frame = self._to_perturbed(si, active)
        bs, value = self.nested.sample(ctx, si_p, sample1, sample2, active)
        wo = si.to_local(frame.to_world(bs.wo))
        ok = active & (wo[..., 2] * bs.wo[..., 2] > 0)
        bs = bs._replace(wo=wo, pdf=torch.where(ok, bs.pdf, 0.0))
        return bs, torch.where(ok[..., None], value, 0.0)

    def eval(self, ctx, si, wo, active):
        si_p, frame = self._to_perturbed(si, active)
        wo_p = frame.to_local(si.to_world(wo))
        ok = active & (wo[..., 2] * wo_p[..., 2] > 0)
        return torch.where(ok[..., None],
                           self.nested.eval(ctx, si_p, wo_p, ok), 0.0)

    def pdf(self, ctx, si, wo, active):
        si_p, frame = self._to_perturbed(si, active)
        wo_p = frame.to_local(si.to_world(wo))
        ok = active & (wo[..., 2] * wo_p[..., 2] > 0)
        return torch.where(ok, self.nested.pdf(ctx, si_p, wo_p, ok), 0.0)


def _texture_prop(props):
    """The last texture among ``props``' objects, or None."""
    from ..render.texture import Texture
    out = None
    if props is not None:
        for _, obj in props.objects():
            if isinstance(obj, Texture):
                out = obj
    return out


@register_plugin("bsdf", "normalmap")
class NormalMap(_FrameMapBSDF):
    """(normalmap.cpp) a tangent-space normal map: the texture's raw rgb
    (``eval_3``), mapped from [0, 1] to [-1, 1], is the shading normal in
    the shading frame."""

    def __init__(self, props=None, nested=None):
        self.normalmap = _texture_prop(props)
        if self.normalmap is None and props is not None \
                and props.has_property("normalmap"):
            self.normalmap = props.texture("normalmap")
        super().__init__(props, nested)
        if self.normalmap is None:
            raise RuntimeError("normalmap requires a normal texture")

    def _perturbed_frame(self, si, active):
        n_local = m.normalize(2.0 * self.normalmap.eval_3(si, active) - 1.0)
        return _tangent_frame(m.normalize(si.sh_frame.to_world(n_local)),
                              si.dp_du)


@register_plugin("bsdf", "bumpmap")
class BumpMap(_FrameMapBSDF):
    """(bumpmap.cpp) a height field (a texture's ``eval_1``) times
    ``scale`` displaces the surface along its normal: its uv gradient, a
    forward difference over 1e-3 in u and in v, tilts the tangents, and
    their cross product is the shading normal."""

    EPS = 1e-3

    def __init__(self, props=None, nested=None):
        self.bumpmap = _texture_prop(props)
        self.scale = props.float_("scale", 1.0) if props is not None \
            else 1.0
        super().__init__(props, nested)
        if self.bumpmap is None:
            raise RuntimeError("bumpmap requires a height texture")

    def _perturbed_frame(self, si, active):
        eps = self.EPS
        h = self.bumpmap.eval_1(si, active)
        u, v = si.uv[..., 0:1], si.uv[..., 1:2]
        # over a tensor of eps, so that every device divides: a division
        # by a number may run as a product with its reciprocal, which
        # rounds apart from the reference's division
        eps_t = torch.full_like(h, eps)
        h_u = self.bumpmap.eval_1(si._replace(
            uv=torch.cat([u + eps, v], -1)), active)
        h_v = self.bumpmap.eval_1(si._replace(
            uv=torch.cat([u, v + eps], -1)), active)
        dh_du = (h_u - h) / eps_t * self.scale
        dh_dv = (h_v - h) / eps_t * self.scale
        n = si.sh_frame.n
        tu = si.dp_du + n * dh_du[..., None]
        tv = si.dp_dv + n * dh_dv[..., None]
        n_world = m.normalize(m.cross(tu, tv))
        n_world = m.mulsign(n_world, m.dot(n_world, n)[..., None])
        return _tangent_frame(n_world, si.dp_du)


# =============================================================================
# Polarized optical elements (polarizer.cpp, retarder.cpp, circular.cpp)
# and polarized plastic (pplastic.cpp); mitsuba2_tpu/models/bsdfs.py:
# 1275-1435
# =============================================================================

class _PolarizedElement(BSDF):
    """A null-direction filter with a Mueller matrix: ``sample`` passes
    the ray straight through (a Null lobe, pdf 1) with the matrix's (0, 0)
    component as its weight, as the reference's elements do in
    unpolarized variants; ``sample_pol`` with the whole matrix, rotated
    into the transport bases. ``theta`` (degrees) turns the element."""

    def __init__(self, props=None):
        super().__init__(props)
        from .textures import ConstantTexture
        self.theta_tex = props.texture("theta", 0.0) if props \
            else ConstantTexture(color=0.0)
        self.m_components = [BSDFFlags.Null | BSDFFlags.FrontSide
                             | BSDFFlags.BackSide]
        self.m_flags = self.m_components[0]

    def _mueller(self, si, active, forward):
        """The element's (n, 4, 4) matrix; ``forward`` the local
        propagation direction."""
        raise NotImplementedError

    def _scalar(self, si, active, forward):
        return self._mueller(si, active, forward)[..., 0, 0]

    def _null_sample(self, ctx, si, active):
        ok = active & ctx.is_enabled(BSDFFlags.Null)
        return ok, _sample(-si.wi, torch.where(ok, 1.0, 0.0),
                           torch.ones_like(si.t), int(BSDFFlags.Null), 0)

    def sample(self, ctx, si, sample1, sample2, active):
        ok, bs = self._null_sample(ctx, si, active)
        value = self._scalar(si, active, -si.wi)[..., None] \
            * torch.ones_like(spec.zeros(si))
        return bs, torch.where(ok[..., None], value, 0.0)

    def sample_pol(self, ctx, si, sample1, sample2, active):
        from ..render import mueller as mu
        ok, bs = self._null_sample(ctx, si, active)
        wo = -si.wi
        M = mu.to_world_mueller(si, self._mueller(si, active, wo), -wo,
                                si.wi)
        value = M[:, None].expand(-1, spec.zeros(si).shape[1], 4, 4)
        return bs, torch.where(ok[..., None, None, None], value, 0.0)

    def eval(self, ctx, si, wo, active):
        return spec.zeros(si)

    def pdf(self, ctx, si, wo, active):
        return torch.zeros_like(si.t)

    def eval_null_transmission(self, si, active):
        v = self._scalar(si, active, -si.wi)
        return torch.where(active[..., None], v[..., None]
                           * torch.ones_like(spec.zeros(si)), 0.0)


@register_plugin("bsdf", "polarizer")
class PolarizerBSDF(_PolarizedElement):
    """(polarizer.cpp) an ideal linear polarizer of ``transmittance``,
    its axis turned by ``theta`` degrees."""

    def __init__(self, props=None):
        super().__init__(props)
        from .textures import ConstantTexture
        self.transmittance = props.texture("transmittance", 1.0) if props \
            else ConstantTexture(color=1.0)

    def _mueller(self, si, active, forward):
        from ..render import mueller as mu
        theta = torch.deg2rad(self.theta_tex.eval_1(si, active))
        t = self.transmittance.eval_1(si, active)
        return mu.rotated_element(theta, mu.linear_polarizer(t))


@register_plugin("bsdf", "retarder")
class RetarderBSDF(_PolarizedElement):
    """(retarder.cpp) a linear retarder of phase ``delta`` degrees (90: a
    quarter-wave plate, the default; 180: a half-wave plate), its fast
    axis turned by ``theta``."""

    def __init__(self, props=None):
        super().__init__(props)
        from .textures import ConstantTexture
        self.delta_tex = props.texture("delta", 90.0) if props \
            else ConstantTexture(color=90.0)

    def _mueller(self, si, active, forward):
        from ..render import mueller as mu
        theta = torch.deg2rad(self.theta_tex.eval_1(si, active))
        delta = torch.deg2rad(self.delta_tex.eval_1(si, active))
        return mu.rotated_element(theta, mu.linear_retarder(delta))


@register_plugin("bsdf", "circular")
class CircularPolarizerBSDF(_PolarizedElement):
    """(circular.cpp) a right circular polarizer, or a left one with
    ``left_handed``."""

    def __init__(self, props=None):
        super().__init__(props)
        from ..render import mueller as mu
        self.left_handed = props.bool_("left_handed", False) if props \
            else False
        self.matrix = (mu.left_circular_polarizer() if self.left_handed
                       else mu.right_circular_polarizer()).numpy()

    def _mueller(self, si, active, forward):
        from .textures import on_device
        return on_device(self, "matrix", self.matrix, si.t.device) \
            .expand(si.t.shape[0], 4, 4)


@register_plugin("bsdf", "pplastic")
class PolarizedPlastic(SmoothPlastic):
    """(pplastic.cpp) the smooth plastic whose specular lobe carries the
    polarized Fresnel matrix, rescaled so that its (0, 0) entry is the
    scalar lobe's value and rotated into the transport bases; the diffuse
    base depolarizes."""

    def sample_pol(self, ctx, si, sample1, sample2, active):
        from ..render import mueller as mu
        bs, value = self.sample(ctx, si, sample1, sample2, active)
        sel_spec = (bs.sampled_type & int(BSDFFlags.DeltaReflection)) != 0
        Msp = mu.specular_reflection(torch.clamp(si.wi[..., 2], min=1e-6),
                                     self.eta)
        # sample() divided by the lobe's probability: the (0, 0) entry
        # takes the scalar value of its first channel
        scale = m.safe_div(value[..., 0],
                           torch.clamp(Msp[..., 0, 0], min=1e-12), 0.0)
        Mspec = mu.to_world_mueller(
            si, Msp[:, None] * scale[..., None, None, None], -bs.wo, si.wi)
        return bs, torch.where(sel_spec[..., None, None, None], Mspec,
                               depolarize_value(value))
