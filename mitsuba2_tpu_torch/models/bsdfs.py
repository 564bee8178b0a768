"""BSDF plugins (reference: src/bsdfs/). This slice ports ``diffuse`` and
``roughconductor``. The path kernel shades both itself from the scene's
per-face columns (ops/path_kernel.py), so the plugins hold parameters."""

from __future__ import annotations

from ..core.object import register_plugin
from ..render.bsdf import BSDF, BSDFFlags
from ..render.fresnel import lookup_conductor_ior


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
    normals."""

    def __init__(self, props=None):
        super().__init__(props)
        from .textures import ConstantTexture, as_texture
        p = props
        material = p.string("material", "none") if p else "none"
        if p is not None and (p.has_property("eta") or p.has_property("k")):
            self.eta_tex = p.texture("eta", 0.0)
            self.k_tex = p.texture("k", 1.0)
        else:
            eta_rgb, k_rgb = lookup_conductor_ior(material)
            self.eta_tex = as_texture(list(eta_rgb))
            self.k_tex = as_texture(list(k_rgb))
        self.specular_reflectance = p.texture("specular_reflectance", 1.0) \
            if p else ConstantTexture(color=1.0)
        dist = p.string("distribution", "beckmann") if p else "beckmann"
        if dist not in ("ggx", "beckmann"):
            raise ValueError(f"unknown microfacet distribution {dist!r}")
        if p is not None and (p.has_property("alpha_u")
                              or p.has_property("alpha_v")):
            au, av = p.float_("alpha_u"), p.float_("alpha_v")
        else:
            au = av = p.float_("alpha", 0.1) if p else 0.1
        self.dist_type = dist
        self.alpha_u, self.alpha_v = float(au), float(av)
        self.sample_visible = p.bool_("sample_visible", True) if p else True
        flags = BSDFFlags.GlossyReflection | BSDFFlags.FrontSide
        if self.alpha_u != self.alpha_v:
            flags |= BSDFFlags.Anisotropic
        self.m_components = [flags]
        self.m_flags = flags
