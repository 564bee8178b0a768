"""The surface plugins the wavefronts render and the kernels' gates
refuse, against their JAX counterparts on the same numpy inputs made
from a seed: the BSDFs ``conductor``, ``thindielectric``,
``roughdielectric`` and the wrappers ``twosided`` (front and back lanes),
``mask``, ``blendbsdf``, ``normalmap`` and ``bumpmap`` (``sample``,
``eval``, ``pdf``, ``eval_null_transmission``); the emitters ``point``,
``spot``, ``directional``, ``constant`` and ``projector``
(``sample_direction``, ``pdf_direction``, ``eval``) and every emitter's
``sample_ray``, ``area`` and ``envmap`` included; the spectra
``uniform``, ``regular``, ``irregular`` and ``blackbody`` and the dict's
curve form (``eval``, ``eval_1``, ``eval_3``, ``sample_spectrum``,
``pdf_spectrum``, ``mean``); the textures' ``eval_1`` and ``eval_3``;
and the kernels' gates, whose reasons are the JAX gates' word for word.
Each in rgb, spectral and mono. Tolerance: 1e-5 relative (3e-5 for
values that are products of several such, 1e-4 on 99.9% of the lanes
for directions and weights of sampled microfacets, whose reflection
about a sampled normal moves by ~1e-4 when an input moves by an ulp),
absolute near zero."""

from collections import namedtuple
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_wavefront_modules import (T, close, close_lanes,
                                                hemisphere, rng)

_on_cpu = cpu_device_fixture()

VARIANTS = ["scalar_rgb", "scalar_spectral", "scalar_mono"]
N = 2048
# what a texture or spectrum reads of a lane (``sample_spectrum``
# replaces its wavelengths)
Lookup = namedtuple("Lookup", "t uv wavelengths")


@pytest.fixture
def variant(request):
    import mitsuba2_tpu as mj
    mj.set_variant(request.param)
    mt.set_variant(request.param)
    yield request.param
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")


def _maps():
    from mitsuba2_tpu_torch.python.test.scenes import _surface_maps_path
    return (_surface_maps_path("height"), _surface_maps_path("normal"))


def wavelengths(r, n, variant):
    if variant == "scalar_spectral":
        return (360 + 470 * r.random((n, 4))).astype(np.float32)
    return np.zeros((n, 0), np.float32)


def surface_records(seed, variant, n=N):
    """The same surface records in both packages: random shading frames,
    wi in them (a quarter below the surface), uvs, uv tangents and hero
    wavelengths -> (JAX record, port record)."""
    import jax.numpy as jnp
    from mitsuba2_tpu.core.frame import Frame as FJ
    from mitsuba2_tpu.render.interaction import SurfaceInteraction as SJ
    from mitsuba2_tpu_torch.core.frame import Frame as FT
    from mitsuba2_tpu_torch.render.interaction import SurfaceInteraction as ST
    r = rng(seed)
    nrm = hemisphere(r, n)
    wi = hemisphere(r, n, lower=True)
    uv = r.random((n, 2)).astype(np.float32)
    dp_du = r.standard_normal((n, 3)).astype(np.float32)
    dp_dv = r.standard_normal((n, 3)).astype(np.float32)
    p = r.standard_normal((n, 3)).astype(np.float32)
    wl = wavelengths(r, n, variant)
    fj = FJ.from_normal(jnp.asarray(nrm))
    ft = FT.from_normal(T(nrm))
    ij = jnp.zeros(n, jnp.int32)
    it = torch.zeros(n, dtype=torch.int32)
    sj = SJ(t=jnp.ones(n), p=jnp.asarray(p), n=jnp.asarray(nrm),
            sh_frame=fj, uv=jnp.asarray(uv), wi=jnp.asarray(wi),
            dp_du=jnp.asarray(dp_du), dp_dv=jnp.asarray(dp_dv),
            shape_idx=ij, prim_idx=ij, wavelengths=jnp.asarray(wl),
            time=jnp.zeros(n), bsdf_idx=ij, emitter_idx=ij - 1)
    st = ST(t=torch.ones(n), p=T(p), n=T(nrm), sh_frame=ft, uv=T(uv),
            wi=T(wi), dp_du=T(dp_du), dp_dv=T(dp_dv), shape_idx=it,
            prim_idx=it, wavelengths=T(wl) if wl.shape[1] else None,
            bsdf_idx=it, emitter_idx=it - 1,
            prim_uv=torch.zeros(n, 2))
    return sj, st


def rgb(v):
    return {"type": "rgb", "value": v}


def checker(c0, c1, k=4.0):
    return {"type": "checkerboard", "color0": rgb(c0), "color1": rgb(c1),
            "to_uv": None if k is None else ("scale", k)}


def _with_to_uv(d, pkg):
    """``d`` with each checkerboard's ("scale", k) made ``pkg``'s
    Transform."""
    if isinstance(d, dict):
        out = {}
        for k, v in d.items():
            if k == "to_uv":
                if v is not None:
                    out[k] = pkg.Transform.scale([v[1], v[1], 1])
            else:
                out[k] = _with_to_uv(v, pkg)
        return out
    return d


def _bsdf_dicts():
    height, normals = _maps()
    diffuse = {"type": "diffuse", "reflectance": rgb([0.3, 0.5, 0.7])}
    ggx = {"type": "roughconductor", "distribution": "ggx", "alpha": 0.2,
           "material": "Au"}
    return {
        "conductor Au": {"type": "conductor", "material": "Au"},
        "conductor eta k": {"type": "conductor", "eta": rgb([0.2, 0.9, 1.1]),
                            "k": rgb([3.9, 2.4, 2.1]),
                            "specular_reflectance": rgb(0.8)},
        "conductor mirror": {"type": "conductor"},
        "thindielectric": {"type": "thindielectric"},
        "thindielectric water": {"type": "thindielectric",
                                 "int_ior": "water",
                                 "specular_transmittance": rgb(
                                     [0.9, 0.8, 0.6])},
        "roughdielectric ggx": {"type": "roughdielectric",
                                "distribution": "ggx", "alpha": 0.1},
        "roughdielectric ggx anisotropic projected": {
            "type": "roughdielectric", "distribution": "ggx",
            "alpha_u": 0.1, "alpha_v": 0.3, "sample_visible": False},
        "roughdielectric beckmann projected": {
            "type": "roughdielectric", "alpha": 0.2, "int_ior": 1.33,
            "sample_visible": False},
        "twosided diffuse": {"type": "twosided", "material": diffuse},
        "twosided front and back": {"type": "twosided", "front": diffuse,
                                    "back": ggx},
        "mask checker": {"type": "mask", "opacity": checker(1.0, 0.2),
                         "material": ggx},
        "mask constant": {"type": "mask", "opacity": 0.3,
                          "material": diffuse},
        "blendbsdf checker": {"type": "blendbsdf",
                              "weight": checker(0.85, 0.15),
                              "a": {"type": "conductor", "material": "Au"},
                              "b": diffuse},
        "blendbsdf constant": {"type": "blendbsdf", "weight": 0.3,
                               "a": ggx, "b": {"type": "plastic"}},
        "normalmap": {"type": "normalmap",
                      "normals": {"type": "bitmap", "raw": True,
                                  "filename": normals},
                      "material": diffuse},
        "normalmap roughconductor": {"type": "normalmap",
                                     "normals": {"type": "bitmap",
                                                 "raw": True,
                                                 "filename": normals},
                                     "material": ggx},
        "bumpmap": {"type": "bumpmap", "scale": 0.02,
                    "height": {"type": "bitmap", "raw": True,
                               "filename": height},
                    "material": diffuse},
        "bumpmap plastic": {"type": "bumpmap", "scale": 0.05,
                            "height": {"type": "bitmap", "raw": True,
                                       "filename": height},
                            "material": {"type": "plastic"}},
    }


def load_both(d):
    import mitsuba2_tpu as mj
    return (mj.load_dict(_with_to_uv(d, mj)),
            mt.load_dict(_with_to_uv(d, mt)))


@pytest.mark.parametrize("variant", VARIANTS, indirect=True)
@pytest.mark.parametrize("case", sorted(_bsdf_dicts()))
def test_bsdf_sample_eval_pdf(case, variant):
    import jax.numpy as jnp
    from mitsuba2_tpu.render.bsdf import BSDFContext as CJ
    from mitsuba2_tpu_torch.render.bsdf import BSDFContext as CT
    bj, bt = load_both(_bsdf_dicts()[case])
    assert type(bt).__name__ == type(bj).__name__
    assert int(bt.flags()) == int(bj.flags())
    sj, st = surface_records(8, variant)
    r = rng(9)
    wo = hemisphere(r, N, lower=True)
    s1 = r.random(N).astype(np.float32)
    s2 = r.random((N, 2)).astype(np.float32)
    act_j, act_t = jnp.ones(N, bool), torch.ones(N, dtype=torch.bool)
    close_lanes(bt.eval(CT(), st, T(wo), act_t),
                bj.eval(CJ(), sj, jnp.asarray(wo), act_j), rtol=3e-5)
    close_lanes(bt.pdf(CT(), st, T(wo), act_t),
                bj.pdf(CJ(), sj, jnp.asarray(wo), act_j), rtol=3e-5)
    bs_t, w_t = bt.sample(CT(), st, T(s1), T(s2), act_t)
    bs_j, w_j = bj.sample(CJ(), sj, jnp.asarray(s1), jnp.asarray(s2), act_j)
    close_lanes(bs_t.wo, bs_j.wo, rtol=0, atol=5e-5)
    close_lanes(bs_t.pdf, bs_j.pdf, rtol=1e-4)
    close(bs_t.eta, bs_j.eta)
    np.testing.assert_array_equal(bs_t.sampled_type.numpy(),
                                  np.asarray(bs_j.sampled_type))
    np.testing.assert_array_equal(bs_t.sampled_component.numpy(),
                                  np.asarray(bs_j.sampled_component))
    close_lanes(w_t, w_j, rtol=1e-4, atol=1e-5)
    # what a null lobe passes straight through (the volpath walk's read)
    nt = bt.eval_null_transmission(st, act_t)
    nj = np.broadcast_to(np.asarray(bj.eval_null_transmission(sj, act_j)),
                         nt.shape)
    close(nt, nj)


def test_twosided_back_lanes_mirror_the_front():
    """A lane below the surface sees the back BSDF with its directions
    mirrored: twosided(diffuse) gives the same value for wi, wo and
    their mirror images."""
    from mitsuba2_tpu_torch.render.bsdf import BSDFContext
    mt.set_variant("scalar_rgb")
    b = mt.load_dict({"type": "twosided", "material": {"type": "diffuse"}})
    _, st = surface_records(3, "scalar_rgb")
    wo = T(hemisphere(rng(4), N))
    flip = torch.tensor([1.0, 1.0, -1.0])
    act = torch.ones(N, dtype=torch.bool)
    up = b.eval(BSDFContext(), st._replace(wi=st.wi.abs()), wo, act)
    down = b.eval(BSDFContext(), st._replace(wi=st.wi.abs() * flip),
                  wo * flip, act)
    assert torch.equal(up, down) and bool((up > 0).any())


# ---- emitters ----

def _emitter_dicts(pkg):
    from mitsuba2_tpu_torch.python.test.scenes import \
        _materials_texture_path
    Tr = pkg.Transform
    spot_to_world = Tr.look_at([0.1, 0.9, 0.2], [0.0, -1.0, 0.0], [0, 0, 1])
    bitmap = {"type": "bitmap", "filename": _materials_texture_path()}
    return {
        "point": {"type": "point", "position": [0.2, 0.6, -0.1],
                  "intensity": rgb([2.0, 1.5, 1.0])},
        "point curve": {"type": "point", "to_world": Tr.translate(
            [0.3, 0.5, 0.2]), "intensity": {"type": "spectrum", "value": [
                (400.0, 0.4), (520.0, 2.0), (700.0, 1.0)]}},
        "spot blackbody": {"type": "spot", "to_world": spot_to_world,
                           "cutoff_angle": 40.0, "beam_width": 25.0,
                           "intensity": {"type": "blackbody",
                                         "temperature": 2000.0}},
        "spot textured": {"type": "spot", "to_world": spot_to_world,
                          "cutoff_angle": 50.0, "texture": bitmap},
        "directional": {"type": "directional",
                        "direction": [-0.3, -0.4, -1.0],
                        "irradiance": rgb([1.2, 1.0, 0.8])},
        "directional to_world": {"type": "directional",
                                 "to_world": Tr.rotate([1, 0, 0], 120)},
        "constant": {"type": "constant",
                     "radiance": {"type": "spectrum", "value": 0.35}},
        "constant rgb": {"type": "constant", "radiance": rgb([0.2, 0.3,
                                                              0.5])},
        "projector": {"type": "projector", "fov": 45.0, "scale": 2.5,
                      "to_world": Tr.look_at([0.0, 0.1, 0.95],
                                             [0.0, 0.1, -1.0], [0, 1, 0]),
                      "irradiance": bitmap},
    }


def _share(case):
    """The share of lanes held to the bar: a spot's falloff ramps linearly
    in angle to zero at its cutoff, so an ulp of the angle's acos moves a
    lane near the cutoff by far more than 1e-4 relative."""
    return 0.995 if case.startswith("spot") else 0.999


def _emitter_case(case, variant):
    """(JAX emitter, port emitter, bounding sphere as the port passes
    it), the JAX emitter's sphere set as its scene sets it."""
    import mitsuba2_tpu as mj
    import jax.numpy as jnp
    ej = mj.load_dict(_emitter_dicts(mj)[case])
    et = mt.load_dict(_emitter_dicts(mt)[case])
    assert type(et).__name__ == type(ej).__name__
    assert int(et.flags()) == int(ej.flags())
    center, radius = np.float32([0.1, -0.2, 0.3]), 2.5
    ej._scene_bsphere = (jnp.asarray(center), radius)
    return ej, et, (T(center), radius)


def interaction(r, n, variant):
    import jax.numpy as jnp
    p = (r.random((n, 3)) * 1.6 - 0.8).astype(np.float32)
    wl = wavelengths(r, n, variant)
    it_j = SimpleNamespace(p=jnp.asarray(p), t=jnp.zeros(n),
                           time=jnp.zeros(n), wavelengths=jnp.asarray(wl))
    it_t = SimpleNamespace(p=T(p), t=torch.zeros(n),
                           wavelengths=T(wl) if wl.shape[1] else None)
    return it_j, it_t


def _emitter_params(extra=()):
    """(case, variant) pairs: every emitter in every variant, but the
    textured spot in spectral variants, where the JAX spot looks its
    texture up at no wavelengths (its lookup's are (n, 0)) and cannot
    broadcast them (ROADMAP queue 3)."""
    return [(c, v) for c in sorted(_emitter_dicts(mt)) + list(extra)
            for v in VARIANTS
            if (c, v) != ("spot textured", "scalar_spectral")]


@pytest.mark.parametrize("case,variant", _emitter_params(),
                         indirect=["variant"])
def test_emitter_direction_sampling(case, variant):
    import jax.numpy as jnp
    ej, et, bsphere = _emitter_case(case, variant)
    r = rng(12)
    it_j, it_t = interaction(r, N, variant)
    u = r.random((N, 2)).astype(np.float32)
    act_j, act_t = jnp.ones(N, bool), torch.ones(N, dtype=torch.bool)
    ds_j, sp_j = ej.sample_direction(it_j, jnp.asarray(u), act_j)
    ds_t, sp_t = et.sample_direction(it_t, T(u), act_t, bsphere)
    for a, b in ((ds_t.p, ds_j.p), (ds_t.n, ds_j.n), (ds_t.d, ds_j.d)):
        close(a, b, rtol=0, atol=2e-5)
    close(ds_t.uv, ds_j.uv, rtol=0, atol=2e-5)
    close(ds_t.pdf, ds_j.pdf)
    close(ds_t.dist, ds_j.dist)
    np.testing.assert_array_equal(ds_t.delta.numpy(), np.asarray(ds_j.delta))
    close_lanes(sp_t, sp_j, rtol=1e-4, atol=1e-6, share=_share(case))
    close(et.pdf_direction(it_t, ds_t, act_t),
          ej.pdf_direction(it_j, ds_j, act_j))
    # radiance toward the lanes (zero but for the environment)
    sj, st = surface_records(13, variant)
    close(et.eval(st, act_t), ej.eval(sj, act_j), rtol=1e-5)


def _ray_emitters(pkg, variant):
    """The area light of the Cornell box, the envmap of matpreview and the
    emitters above, with the bounding sphere the port passes each."""
    import mitsuba2_tpu as mj
    if pkg is mj:
        from mitsuba2_tpu.python.test import scenes
    else:
        from mitsuba2_tpu_torch.python.test import scenes
    out = {}
    for name, d in (("area", scenes.cornell_box_dict(8, 8, 1)),
                    ("envmap", scenes.matpreview_dict(8, 8, 1, 4))):
        sc = pkg.load_dict(d)
        e = next(e for e in sc.emitters
                 if type(e).__name__ in ("AreaEmitter", "EnvironmentMap"))
        out[name] = (e, None if pkg is mj else sc.wavefront_tables().bsphere)
    return out


@pytest.mark.parametrize("case,variant", _emitter_params(["area", "envmap"]),
                         indirect=["variant"])
def test_emitter_sample_ray(case, variant):
    """Emitted rays and their flux weights (endpoint.h:86-135), against
    the JAX emitters' (tests/test_emitters.py:150-240 holds those to
    their fluxes)."""
    import mitsuba2_tpu as mj
    import jax.numpy as jnp
    if case in ("area", "envmap"):
        ej, _ = _ray_emitters(mj, variant)[case]
        et, bsphere = _ray_emitters(mt, variant)[case]
    else:
        ej, et, bsphere = _emitter_case(case, variant)
    r = rng(14)
    s1 = r.random(N).astype(np.float32)
    s2 = r.random((N, 2)).astype(np.float32)
    s3 = (r.random((N, 2)) * 0.9 + 0.05).astype(np.float32)
    ray_j, w_j = ej.sample_ray(jnp.zeros(N), jnp.asarray(s1),
                               jnp.asarray(s2), jnp.asarray(s3),
                               jnp.ones(N, bool))
    ray_t, w_t, wav = et.sample_ray(T(s1), T(s2), T(s3),
                                    torch.ones(N, dtype=torch.bool), bsphere)
    close(ray_t.o, ray_j.o, rtol=0, atol=3e-5)
    close(ray_t.d, ray_j.d, rtol=0, atol=3e-5)
    close_lanes(w_t, w_j, rtol=1e-4, atol=1e-5, share=_share(case))
    if variant == "scalar_spectral":
        close(wav, ray_j.wavelengths)
    else:
        assert wav is None


# ---- spectra ----

def _spectrum_dicts():
    return {
        "uniform": {"type": "uniform", "value": 0.6},
        "regular": {"type": "regular", "lambda_min": 400.0,
                    "lambda_max": 700.0, "values": "0.05, 0.08, 0.3, 0.7"},
        "irregular": {"type": "irregular",
                      "wavelengths": "380, 450, 520, 600, 780",
                      "values": [0.2, 0.9, 0.4, 0.6, 0.1]},
        "blackbody": {"type": "blackbody", "temperature": 2400.0},
        "d65": {"type": "d65", "scale": 2.0},
        "curve (dict list)": {"type": "spectrum", "value": [
            (400.0, 0.4), (480.0, 1.2), (560.0, 2.0), (640.0, 2.6),
            (720.0, 1.0)]},
        "curve (dict string)": {"type": "spectrum",
                                "value": "400:0.1, 550:0.8, 700:0.3"},
        "uniform (dict)": {"type": "spectrum", "value": 0.45},
    }


def _as_spectrum(pkg, d, within_emitter):
    from importlib import import_module
    tex = import_module(f"{pkg.__name__}.models.textures")
    return tex.as_texture(pkg.load_dict(d), within_emitter)


@pytest.mark.parametrize("variant", VARIANTS, indirect=True)
@pytest.mark.parametrize("within_emitter", [False, True])
@pytest.mark.parametrize("case", sorted(_spectrum_dicts()))
def test_spectrum(case, within_emitter, variant):
    import mitsuba2_tpu as mj
    import jax.numpy as jnp
    d = _spectrum_dicts()[case]
    sj = _as_spectrum(mj, d, within_emitter)
    st = _as_spectrum(mt, d, within_emitter)
    assert type(st).__name__ == type(sj).__name__
    assert st.mean() == pytest.approx(sj.mean(), rel=1e-6)
    r = rng(15)
    wl = wavelengths(r, N, variant)
    uv = r.random((N, 2)).astype(np.float32)
    rj = Lookup(jnp.zeros(N), jnp.asarray(uv), jnp.asarray(wl))
    rt = Lookup(torch.zeros(N), T(uv), T(wl) if wl.shape[1] else None)
    close(st.eval(rt), np.broadcast_to(np.asarray(sj.eval(rj)),
                                       tuple(st.eval(rt).shape)))
    close(st.eval_1(rt), sj.eval_1(rj))
    close(st.eval_3(rt), sj.eval_3(rj))
    if variant == "scalar_spectral":
        u = r.random((N, 4)).astype(np.float32)
        wl_t, v_t = st.sample_spectrum(rt, T(u))
        wl_j, v_j = sj.sample_spectrum(rj, jnp.asarray(u))
        close(wl_t, wl_j, rtol=2e-6)
        close_lanes(v_t, v_j, rtol=1e-4, atol=1e-6)
        close(st.pdf_spectrum(rt), sj.pdf_spectrum(rj), rtol=2e-5)


def test_dict_curve_form_loads_as_irregular():
    """``{"type": "spectrum", "value": [(wavelength, value), ...]}`` (or
    "400:0.1, ..." as a string) is a curve: an ``irregular`` spectrum as a
    reflectance, scaled to unit luminance in a spectral emitter
    (xml.cpp:1113-1125)."""
    from mitsuba2_tpu_torch.core.dictio import ColorValue
    from mitsuba2_tpu_torch.core.spectrum import MTS_CIE_Y_NORMALIZATION
    mt.set_variant("scalar_spectral")
    try:
        cv = mt.load_dict({"type": "spectrum", "value": "400:0.5, 600:1.0"})
        assert isinstance(cv, ColorValue) and cv.kind == "spectrum-curve"
        assert cv.payload == [(400.0, 0.5), (600.0, 1.0)]
        b = mt.load_dict({"type": "diffuse", "reflectance": {
            "type": "spectrum", "value": [(400, 0.5), (600, 1.0)]}})
        assert type(b.reflectance).__name__ == "IrregularSpectrum"
        np.testing.assert_array_equal(b.reflectance._vals, [0.5, 1.0])
        e = mt.load_dict({"type": "point", "intensity": {
            "type": "spectrum", "value": [(400, 0.5), (600, 1.0)]}})
        np.testing.assert_allclose(e.intensity._vals, np.float32(
            [0.5 * MTS_CIE_Y_NORMALIZATION, MTS_CIE_Y_NORMALIZATION]))
    finally:
        mt.set_variant("scalar_rgb")


# ---- textures ----

def _texture_dicts():
    from mitsuba2_tpu_torch.python.test.scenes import \
        _materials_texture_path
    height, normals = _maps()
    return {
        "srgb": rgb([0.2, 0.5, 0.9]),
        "checkerboard": checker([0.9, 0.2, 0.1], 0.3, k=3.0),
        "bitmap": {"type": "bitmap", "filename": _materials_texture_path()},
        "bitmap raw": {"type": "bitmap", "raw": True, "filename": normals},
        "bitmap height": {"type": "bitmap", "raw": True, "filename": height},
    }


@pytest.mark.parametrize("variant", VARIANTS, indirect=True)
@pytest.mark.parametrize("case", sorted(_texture_dicts()))
def test_texture_eval_1_eval_3(case, variant):
    import mitsuba2_tpu as mj
    import jax.numpy as jnp
    d = _texture_dicts()[case]
    tj = _as_spectrum(mj, _with_to_uv(d, mj), False)
    tt = _as_spectrum(mt, _with_to_uv(d, mt), False)
    r = rng(16)
    uv = (r.random((N, 2)) * 3 - 1).astype(np.float32)
    wl = wavelengths(r, N, variant)
    rj = Lookup(jnp.zeros(N), jnp.asarray(uv), jnp.asarray(wl))
    rt = Lookup(torch.zeros(N), T(uv), T(wl) if wl.shape[1] else None)
    close(tt.eval_1(rt), tj.eval_1(rj))
    close(tt.eval_3(rt), np.broadcast_to(np.asarray(tj.eval_3(rj)),
                                         (N, 3)))
    # the sigmoid model at the hero wavelengths, blended (spectral)
    close(tt.eval(rt), np.broadcast_to(np.asarray(tj.eval(rj)),
                                       tuple(tt.eval(rt).shape)), rtol=3e-5)


# ---- the kernels' gates ----

def _gate_cases():
    """(edit of the Cornell dict, variant): each new plugin in turn."""
    def bsdf(d_bsdf):
        def edit(d, pkg):
            d["tallbox"]["bsdf"] = _with_to_uv(d_bsdf, pkg)
        return edit

    def emitter(name):
        def edit(d, pkg):
            d["extra"] = _emitter_dicts(pkg)[name]
        return edit

    def reflectance(spec):
        def edit(d, pkg):
            d["back"]["bsdf"]["reflectance"] = spec
        return edit

    def radiance(spec):
        def edit(d, pkg):
            d["light"]["emitter"]["radiance"] = spec
        return edit

    cases = {f"bsdf {k}": (bsdf(v), "scalar_rgb")
             for k, v in _bsdf_dicts().items()}
    cases.update({f"emitter {k}": (emitter(k), "scalar_rgb")
                  for k in ("point", "spot blackbody", "directional",
                            "constant", "projector")})
    for k in ("uniform", "regular", "irregular", "blackbody"):
        cases[f"reflectance {k}"] = (reflectance(_spectrum_dicts()[k]),
                                     "scalar_rgb")
        cases[f"radiance {k} spectral"] = (radiance(_spectrum_dicts()[k]),
                                           "scalar_spectral")
    cases["radiance curve spectral"] = (radiance(
        _spectrum_dicts()["curve (dict list)"]), "scalar_spectral")
    return cases


@pytest.mark.parametrize("case", sorted(_gate_cases()))
def test_kernel_gates_give_the_jax_reasons(case):
    """The path kernel's gate (and the integrator's ``engine_reason``)
    and the volumetric kernel's gate against the JAX gates, word for
    word, on the Cornell box with each new plugin in turn."""
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.ops.megakernel import megakernel_ineligibility
    from mitsuba2_tpu.ops.volmegakernel import vol_megakernel_ineligibility
    from mitsuba2_tpu.python.test.scenes import cornell_box_dict as cj
    from mitsuba2_tpu_torch.ops.path_kernel import path_kernel_ineligibility
    from mitsuba2_tpu_torch.ops.volpath_kernel import \
        vol_kernel_ineligibility
    from mitsuba2_tpu_torch.python.test.scenes import \
        cornell_box_dict as ct
    edit, variant = _gate_cases()[case]
    mj.set_variant(variant)
    mt.set_variant(variant)
    try:
        dj, dt = cj(4, 4, 1), ct(4, 4, 1)
        edit(dj, mj)
        edit(dt, mt)
        sj, st = mj.load_dict(dj), mt.load_dict(dt)
        want = megakernel_ineligibility(sj)
        assert want is not None
        assert path_kernel_ineligibility(st) == want
        assert st.integrator._kernel(st, st.sensors[0]) is None
        assert st.integrator.engine_reason == want
        assert vol_kernel_ineligibility(st) \
            == vol_megakernel_ineligibility(sj)
    finally:
        mj.set_variant("scalar_rgb")
        mt.set_variant("scalar_rgb")


@pytest.mark.parametrize("variant", ["scalar_rgb", "scalar_mono"])
@pytest.mark.parametrize("case", ["uniform", "uniform (dict)", "regular",
                                  "irregular", "blackbody",
                                  "curve (dict list)"])
def test_spectrum_area_light_stays_on_the_kernel(case, variant):
    """Outside spectral variants an area light whose radiance is a
    spectrum is uniform: both packages' gates keep the Cornell box on the
    kernel, and the port's light table packs the value the JAX emitter
    evaluates (its three channels in rgb, its one channel repeated in
    mono), which the wavefront would emit."""
    import jax.numpy as jnp
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.ops.megakernel import megakernel_ineligibility
    from mitsuba2_tpu.python.test.scenes import cornell_box_dict as cj
    from mitsuba2_tpu_torch.ops.path_kernel import path_kernel_ineligibility
    from mitsuba2_tpu_torch.python.test.scenes import \
        cornell_box_dict as ct
    mj.set_variant(variant)
    mt.set_variant(variant)
    try:
        dj, dt = cj(4, 4, 1), ct(4, 4, 1)
        for d in (dj, dt):
            d["light"]["emitter"]["radiance"] = _spectrum_dicts()[case]
        sj, st = mj.load_dict(dj), mt.load_dict(dt)
        assert megakernel_ineligibility(sj) is None
        assert path_kernel_ineligibility(st) is None
        want = np.asarray(sj.emitters[0].radiance.eval(
            Lookup(jnp.zeros(1), jnp.zeros((1, 2)), None)))[0]
        table = torch.as_tensor(st.light_rows).cpu().numpy()
        # the light's two faces (the padding rows have the cdf 2)
        rows = table[table[:, 12] <= 1.0, 14:17]
        assert len(rows) == 2 and np.abs(want).max() > 0
        np.testing.assert_allclose(
            rows, np.broadcast_to(want, rows.shape), rtol=1e-6)
    finally:
        mj.set_variant("scalar_rgb")
        mt.set_variant("scalar_rgb")


def test_tie_parting_needs_coplanar_faces_hit_at_one_point():
    """``wavefront_spread.tie_parting`` (which sets apart the lanes where
    two runs break the tie of cornell_surfaces' glass base with its floor)
    names a parting only where the two prims are faces of one plane hit
    at one point: the floor and the glass base, not the floor and a wall,
    nor two points 1e-2 apart, nor a lane whose prims never differ."""
    from mitsuba2_tpu_torch.python.test.scenes import cornell_surfaces_dict
    from mitsuba2_tpu_torch.tools import wavefront_spread as ws
    mt.set_variant("scalar_rgb")
    st = mt.load_dict(cornell_surfaces_dict(4, 4, 1, 2))
    kinds = [type(s.bsdf).__name__ for s in st.shapes]
    floor, wall = (int(np.flatnonzero(st.face_shape == kinds.index(k))[0])
                   for k in ("BumpMap", "TwoSided"))
    # the glass box's base: two of its twelve faces
    base = [int(k) for k in np.flatnonzero(
        st.face_shape == kinds.index("RoughDielectric"))
        if ws.coplanar(st, floor, int(k))]
    assert len(base) == 2
    glass = base[0]
    assert not ws.coplanar(st, floor, wall)
    o, d = np.array([0.1, 0.3, 0.1]), np.array([0.0, -1.0, 0.0])
    first = (o, d, 0.5, glass)

    def trace(t, prim):
        return [first, (o, d, t, prim)]
    t = float(st.v0[floor] @ st.ng[floor] - o @ st.ng[floor]) \
        / float(d @ st.ng[floor])
    tie = ws.tie_parting(st, trace(t, floor), trace(t + 1e-6, glass))
    assert tie is not None and tie.startswith("call 1")
    assert ws.tie_parting(st, trace(t, floor), trace(t, wall)) is None
    assert ws.tie_parting(st, trace(t, floor),
                          trace(t + 1e-2, glass)) is None
    assert ws.tie_parting(st, trace(t, floor), trace(t, floor)) is None


def test_one_environment_emitter():
    """``constant`` is an environment emitter: beside an envmap the scene
    refuses it, as the JAX scene does."""
    from mitsuba2_tpu_torch.python.test.scenes import matpreview_dict
    mt.set_variant("scalar_rgb")
    d = matpreview_dict(4, 4, 1, 2)
    d["sky"] = {"type": "constant"}
    with pytest.raises(RuntimeError, match="only one environment emitter"):
        mt.load_dict(d)
    assert mt.load_dict({"type": "constant"}).is_environment()
    assert not mt.load_dict({"type": "directional"}).is_environment()
