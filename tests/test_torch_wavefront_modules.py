"""The wavefront's modules against their JAX counterparts on the same
numpy inputs, made from a seed: the frame, the warps and their pdfs,
``distr_1d`` and ``distr_2d``, the microfacet distributions, each BSDF's
``sample``/``eval``/``pdf`` in rgb and spectral, the area and envmap
emitters' sampling, ``compute_surface_interaction`` on each shape kind and
the spectral helpers. Tolerance: 1e-5 relative (2e-5 where a quantity is
a ratio of two such), absolute near zero."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()

RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def close_lanes(got, want, rtol=RTOL, atol=ATOL, share=0.999):
    """``close`` on at least ``share`` of the lanes: a direction reflected
    about a sampled normal near grazing, or a weight of such a direction,
    moves by ~1e-4 when an input moves by an ulp."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    ok = np.abs(got - want) <= atol + rtol * np.abs(want)
    ok = ok.reshape(len(ok), -1).all(-1)
    assert ok.mean() >= share, (ok.mean(), np.abs(got - want).max())


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def rng(seed=0):
    return np.random.default_rng(seed)


def hemisphere(r, n, lower=False):
    v = r.standard_normal((n, 3))
    v[:, 2] = np.abs(v[:, 2]) + 0.05
    if lower:
        v[: n // 4, 2] *= -1
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_frame_and_trigonometry():
    import jax.numpy as jnp
    from mitsuba2_tpu.core import frame as fj
    from mitsuba2_tpu_torch.core import frame as ft
    r = rng(1)
    n = hemisphere(r, 512, lower=True)
    v = r.standard_normal((512, 3)).astype(np.float32)
    Fj, Ft = fj.Frame.from_normal(jnp.asarray(n)), ft.Frame.from_normal(T(n))
    for a, b in zip(Ft, Fj):
        close(a, b)
    close(Ft.to_local(T(v)), Fj.to_local(jnp.asarray(v)))
    close(Ft.to_world(T(v)), Fj.to_world(jnp.asarray(v)))
    for name in ("cos_theta", "cos_theta_2", "sin_theta", "sin_theta_2",
                 "tan_theta", "tan_theta_2", "sin_phi", "cos_phi"):
        close(getattr(ft, name)(T(n)), getattr(fj, name)(jnp.asarray(n)),
              rtol=2e-5)
    for a, b in zip(ft.sincos_phi_2(T(n)), fj.sincos_phi_2(jnp.asarray(n))):
        close(a, b, rtol=2e-5)


@pytest.mark.parametrize("name", [
    "square_to_uniform_disk_concentric", "square_to_uniform_triangle",
    "square_to_uniform_sphere", "square_to_cosine_hemisphere",
    "square_to_uniform_cone", "square_to_beckmann"])
def test_warps_and_pdfs(name):
    import jax.numpy as jnp
    from mitsuba2_tpu.core import warp as wj
    from mitsuba2_tpu_torch.core import warp as wt
    u = rng(2).random((4096, 2)).astype(np.float32)
    extra = {"square_to_uniform_cone": (0.7,),
             "square_to_beckmann": (0.3,)}.get(name, ())
    pj = getattr(wj, name)(jnp.asarray(u), *extra)
    pt = getattr(wt, name)(T(u), *extra)
    # unit vectors, held absolutely: near the pole sqrt(1 - cos^2) turns
    # an ulp of cos into ~1e-5
    close(pt, pj, atol=5e-5 if pt.shape[-1] == 3 else 2e-6)
    pdf = name + "_pdf"
    if hasattr(wt, pdf):
        close(getattr(wt, pdf)(pt, *extra),
              getattr(wj, pdf)(jnp.asarray(pt.numpy()), *extra), rtol=2e-5)


def test_bilinear_warp():
    import jax.numpy as jnp
    from mitsuba2_tpu.core import warp as wj
    from mitsuba2_tpu_torch.core import warp as wt
    r = rng(3)
    c = r.random((4, 2048)).astype(np.float32) + 0.1
    u = r.random((2048, 2)).astype(np.float32)
    pj, qj = wj.square_to_bilinear(*map(jnp.asarray, c), jnp.asarray(u))
    pt, qt = wt.square_to_bilinear(*map(T, c), T(u))
    close(pt, pj)
    close(qt, qj)


def test_discrete_distribution():
    import jax.numpy as jnp
    from mitsuba2_tpu.core.distr_1d import DiscreteDistribution as DJ
    from mitsuba2_tpu_torch.core.distr_1d import DiscreteDistribution as DT
    r = rng(4)
    for n in (5, 40, 300):
        pmf = (r.random(n) ** 4).astype(np.float32)
        dj, dt = DJ.create(jnp.asarray(pmf)), DT.create(T(pmf))
        np.testing.assert_array_equal(dt.cdf.numpy(), np.asarray(dj.cdf))
        u = r.random(4096).astype(np.float32)
        ij, uj = dj.sample_reuse(jnp.asarray(u))
        it, ut = dt.sample_reuse(T(u))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        close(ut, uj)
        close(dt.eval_pmf_normalized(it), dj.eval_pmf_normalized(ij))


def test_hierarchical2d_and_marginal2d():
    import jax.numpy as jnp
    from mitsuba2_tpu.core import distr_2d as dj
    from mitsuba2_tpu_torch.core import distr_2d as dt
    r = rng(5)
    data = (r.random((17, 45)) ** 3).astype(np.float32)
    u = r.random((4096, 2)).astype(np.float32)
    for cls in ("Hierarchical2D", "Marginal2D"):
        wj = getattr(dj, cls).create(jnp.asarray(data))
        wt = getattr(dt, cls).create(T(data))
        pj, qj = wj.sample(jnp.asarray(u))
        pt, qt = wt.sample(T(u))
        close(pt, pj, atol=2e-6)
        # the density at the same positions (its gradient turns the
        # positions' ~1e-6 into ~1e-4 of the sampled pdf)
        close(wt.eval(T(np.asarray(pj))), qj, rtol=2e-5)
        close(wt.eval(T(u)), wj.eval(jnp.asarray(u)))


def test_erf_forms():
    import jax
    import jax.numpy as jnp
    from mitsuba2_tpu.render import microfacet as mj
    from mitsuba2_tpu_torch.render import microfacet as mt_
    x = (rng(6).random(8192) * 2 - 1).astype(np.float32)
    close(mt_._erfinv(T(x * 0.999)), jax.jit(mj._erfinv)(
        jnp.asarray(x * 0.999)), rtol=2e-6)
    close(mt_._erf_approx(T(x * 4)), jax.jit(mj._erf_approx)(
        jnp.asarray(x * 4)), rtol=2e-6)


@pytest.mark.parametrize("dist,alphas,visible", [
    ("ggx", (0.2, 0.2), True), ("ggx", (0.05, 0.4), False),
    ("beckmann", (0.3, 0.3), False), ("beckmann", (0.1, 0.35), True),
    ("beckmann", (0.2, 0.2), True)])
def test_microfacet_distribution(dist, alphas, visible):
    import jax
    import jax.numpy as jnp
    from mitsuba2_tpu.render.microfacet import MicrofacetDistribution as DJ
    from mitsuba2_tpu_torch.render.microfacet import \
        MicrofacetDistribution as DT
    au, av = alphas
    dj = DJ(dist, jnp.float32(au), jnp.float32(av), visible)
    dt = DT(au, av, dist, visible)
    r = rng(7)
    wi, mh = hemisphere(r, 4096), hemisphere(r, 4096)
    u = r.random((4096, 2)).astype(np.float32)
    close(dt.eval(T(mh)), dj.eval(jnp.asarray(mh)), rtol=2e-5)
    close(dt.smith_g1(T(wi), T(mh)), dj.smith_g1(jnp.asarray(wi),
                                                  jnp.asarray(mh)))
    close(dt.pdf(T(wi), T(mh)), dj.pdf(jnp.asarray(wi), jnp.asarray(mh)),
          rtol=3e-5)
    m_t, pdf_t = dt.sample(T(wi), T(u[:, 0]), T(u[:, 1]))
    assert torch.equal(pdf_t, dt.pdf(T(wi), m_t))
    if dist == "beckmann" and visible:
        # the 12-step solve does not converge in its steps: rounding moves
        # its result. The port agrees with the JAX function op by op at
        # least as often as the JAX function agrees with itself jitted.
        with jax.disable_jit():
            m_e = np.asarray(dj.sample(jnp.asarray(wi), jnp.asarray(u))[0])
        m_j = np.asarray(jax.jit(lambda w, s: dj.sample(w, s)[0])(
            jnp.asarray(wi), jnp.asarray(u)))

        def share(a, b):
            return (np.abs(a - b).max(-1) <= 1e-5).mean()
        assert share(m_t.numpy(), m_e) >= share(m_j, m_e), (
            share(m_t.numpy(), m_e), share(m_j, m_e))
    else:
        m_j, _ = dj.sample(jnp.asarray(wi), jnp.asarray(u))
        np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=0,
                                   atol=5e-5)


def _bsdf_dicts():
    rgb = {"type": "rgb", "value": [0.3, 0.5, 0.7]}
    return {
        "diffuse": {"type": "diffuse", "reflectance": rgb},
        "dielectric": {"type": "dielectric"},
        "roughconductor ggx": {"type": "roughconductor",
                               "distribution": "ggx", "alpha": 0.2,
                               "material": "Au"},
        "roughconductor beckmann anisotropic": {
            "type": "roughconductor", "alpha_u": 0.1, "alpha_v": 0.3,
            "sample_visible": False, "material": "Cu"},
        "plastic": {"type": "plastic", "diffuse_reflectance": rgb},
        "plastic nonlinear": {"type": "plastic", "nonlinear": True,
                              "diffuse_reflectance": rgb},
        "roughplastic": {"type": "roughplastic", "distribution": "ggx",
                         "alpha": 0.2, "diffuse_reflectance": rgb},
        "roughplastic beckmann": {"type": "roughplastic", "alpha": 0.3,
                                  "sample_visible": False},
        "null": {"type": "null"},
    }


@pytest.mark.parametrize("variant", ["scalar_rgb", "scalar_spectral"])
@pytest.mark.parametrize("case", sorted(_bsdf_dicts()))
def test_bsdf_sample_eval_pdf(case, variant):
    import mitsuba2_tpu as mj
    import jax.numpy as jnp
    from mitsuba2_tpu.render.bsdf import BSDFContext as CJ
    from mitsuba2_tpu_torch.render.bsdf import BSDFContext as CT
    mj.set_variant(variant)
    mt.set_variant(variant)
    try:
        bj = mj.load_dict(dict(_bsdf_dicts()[case]))
        bt = mt.load_dict(dict(_bsdf_dicts()[case]))
        r = rng(8)
        n = 2048
        wi, wo = hemisphere(r, n, lower=True), hemisphere(r, n, lower=True)
        s1 = r.random(n).astype(np.float32)
        s2 = r.random((n, 2)).astype(np.float32)
        uv = r.random((n, 2)).astype(np.float32)
        wl = (360 + 470 * r.random((n, 4))).astype(np.float32) \
            if variant == "scalar_spectral" else np.zeros((n, 0), np.float32)
        sj = SimpleNamespace(t=jnp.zeros(n), wi=jnp.asarray(wi),
                             uv=jnp.asarray(uv), wavelengths=jnp.asarray(wl))
        st = SimpleNamespace(t=torch.zeros(n), wi=T(wi), uv=T(uv),
                             wavelengths=T(wl) if wl.shape[1] else None)
        act_j = jnp.ones(n, bool)
        act_t = torch.ones(n, dtype=torch.bool)
        close(bt.eval(CT(), st, T(wo), act_t),
              bj.eval(CJ(), sj, jnp.asarray(wo), act_j), rtol=3e-5)
        close(bt.pdf(CT(), st, T(wo), act_t),
              bj.pdf(CJ(), sj, jnp.asarray(wo), act_j), rtol=3e-5)
        bs_t, w_t = bt.sample(CT(), st, T(s1), T(s2), act_t)
        bs_j, w_j = bj.sample(CJ(), sj, jnp.asarray(s1), jnp.asarray(s2),
                              act_j)
        close_lanes(bs_t.wo, bs_j.wo, rtol=0, atol=5e-5)
        close_lanes(bs_t.pdf, bs_j.pdf, rtol=1e-4)
        close(bs_t.eta, bs_j.eta)
        np.testing.assert_array_equal(bs_t.sampled_type.numpy(),
                                      np.asarray(bs_j.sampled_type))
        close_lanes(w_t, w_j, rtol=1e-4, atol=1e-5)
    finally:
        mj.set_variant("scalar_rgb")
        mt.set_variant("scalar_rgb")


def _emitter_scenes(pkg, variant):
    """The matpreview scene (the envmap) and the Cornell box (the area
    light) of package ``pkg``."""
    import mitsuba2_tpu as mj
    if pkg is mj:
        from mitsuba2_tpu.python.test import scenes
    else:
        from mitsuba2_tpu_torch.python.test import scenes
    pkg.set_variant(variant)
    return (pkg.load_dict(scenes.matpreview_dict(8, 8, 1, 4)),
            pkg.load_dict(scenes.cornell_box_dict(width=8, height=8, spp=1)))


@pytest.mark.parametrize("variant", ["scalar_rgb", "scalar_spectral"])
def test_emitter_sampling(variant):
    import mitsuba2_tpu as mj
    import jax.numpy as jnp
    try:
        scenes_j = _emitter_scenes(mj, variant)
        scenes_t = _emitter_scenes(mt, variant)
        r = rng(9)
        n = 2048
        p = (r.random((n, 3)) * 0.6 - 0.3).astype(np.float32)
        u = r.random((n, 2)).astype(np.float32)
        wl = (360 + 470 * r.random((n, 4))).astype(np.float32) \
            if variant == "scalar_spectral" else np.zeros((n, 0), np.float32)
        for sj, st in zip(scenes_j, scenes_t):
            bsphere = st.wavefront_tables().bsphere
            ej, et = sj.emitters[0], st.emitters[0]
            it_j = SimpleNamespace(p=jnp.asarray(p), t=jnp.zeros(n),
                                   time=jnp.zeros(n),
                                   wavelengths=jnp.asarray(wl))
            it_t = SimpleNamespace(p=T(p), t=torch.zeros(n),
                                   wavelengths=T(wl) if wl.shape[1]
                                   else None)
            act_j, act_t = jnp.ones(n, bool), torch.ones(n, dtype=torch.bool)
            ds_j, sp_j = ej.sample_direction(it_j, jnp.asarray(u), act_j)
            ds_t, sp_t = et.sample_direction(it_t, T(u), act_t, bsphere)
            close(ds_t.d, ds_j.d, rtol=0, atol=2e-5)
            close(ds_t.pdf, ds_j.pdf, rtol=1e-4)
            close(ds_t.dist, ds_j.dist)
            close(sp_t, sp_j, rtol=1e-4, atol=1e-5)
            close(et.pdf_direction(it_t, ds_t, act_t),
                  ej.pdf_direction(it_j, ds_j, act_j), rtol=1e-4)
    finally:
        mj.set_variant("scalar_rgb")
        mt.set_variant("scalar_rgb")


def test_compute_surface_interaction_per_shape_kind():
    """Camera rays of the materials box (mesh faces with and without
    vertex normals, a disk, a cylinder) plus a sphere and a flipped sphere
    through both scenes' ``ray_intersect``: the same prims, and the
    records of the rays whose prims agree."""
    import mitsuba2_tpu as mj
    import jax.numpy as jnp
    from mitsuba2_tpu.core.ray import Ray as RJ
    from mitsuba2_tpu.python.test.scenes import cornell_box_dict as cornell_j
    from mitsuba2_tpu_torch.core.ray import Ray as RT
    from mitsuba2_tpu_torch.python.test.scenes import cornell_materials_dict
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    extra = {"ball": {"type": "sphere", "radius": 0.15,
                      "center": [0.4, 0.3, 0.2]},
             "bubble": {"type": "sphere", "radius": 0.15,
                        "center": [-0.4, 0.3, 0.2], "flip_normals": True},
             "bunny": {"type": "sphere", "radius": 0.1,
                       "center": [0.0, 0.6, 0.1]}}
    dt = cornell_materials_dict(8, 8, 1, 4)
    dj = cornell_materials_dict(8, 8, 1, 4, T=mj.Transform,
                                base=cornell_j(8, 8, 1, 4,
                                               rfilter="gaussian"))
    dt.update(extra)
    dj.update(extra)
    sj, st = mj.load_dict(dj), mt.load_dict(dt)
    r = rng(10)
    n = 8192
    o = np.tile(np.float32([0.0, 0.0, 3.9]), (n, 1)) \
        + (r.random((n, 3)) * 0.2 - 0.1).astype(np.float32)
    d = np.stack([r.random(n) * 1.0 - 0.5, r.random(n) * 1.0 - 0.5,
                  -np.ones(n)], 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    si_j = sj.ray_intersect(RJ.make(jnp.asarray(o), jnp.asarray(d)))
    si_t = st.ray_intersect(RT.make(T(o), T(d)))
    prim_j = np.asarray(si_j.prim_idx)
    agree = si_t.prim_idx.numpy() == prim_j
    assert agree.mean() > 0.999
    F = st.tables.n_faces
    kinds = {"face": prim_j < F, "sphere": (prim_j >= F) & (prim_j < F + 3),
             "quad": prim_j >= F + 3}
    for name, sel in kinds.items():
        assert sel.sum() > 20, name
    k = agree & np.asarray(si_j.is_valid())
    for a, b in ((si_t.p, si_j.p), (si_t.n, si_j.n), (si_t.uv, si_j.uv),
                 (si_t.wi, si_j.wi), (si_t.sh_frame.n, si_j.sh_frame.n),
                 (si_t.sh_frame.s, si_j.sh_frame.s)):
        close(a.numpy()[k], np.asarray(b)[k], rtol=0, atol=1e-4)
    for a, b in ((si_t.shape_idx, si_j.shape_idx),
                 (si_t.emitter_idx, si_j.emitter_idx)):
        np.testing.assert_array_equal(a.numpy()[k], np.asarray(b)[k])
    # BSDF ids name the same plugins (the JAX scene merges the diffuse
    # walls' BSDFs into one family, the port keeps each)
    bj = [type(sj.bsdfs[i]).__name__ for i in np.asarray(si_j.bsdf_idx)[k]]
    wt = st.wavefront_tables()
    bt = [type(wt.bsdfs[i]).__name__ for i in si_t.bsdf_idx.numpy()[k]]
    assert [b.replace("Merged", "") for b in bj] == bt or all(
        a == b or a.startswith("Merged") for a, b in zip(bj, bt))


def test_spectral_helpers():
    import jax.numpy as jnp
    from mitsuba2_tpu.core import spectrum as sj
    from mitsuba2_tpu_torch.core import spectrum as st
    r = rng(11)
    wl = (350 + 490 * r.random((4, 4096))).astype(np.float32)
    v = r.random((4, 4096)).astype(np.float32)
    close(st.spectrum_to_srgb_rows(T(v), T(wl)),
          sj.spectrum_to_srgb_rows(jnp.asarray(v), jnp.asarray(wl)),
          rtol=1e-5, atol=1e-6)
    for a, b in zip(st.cie1931_xyz_rows(T(wl[0])),
                    sj.cie1931_xyz_rows(jnp.asarray(wl[0]))):
        close(a, b, atol=1e-6)
    close(st.spectrum_to_xyz(T(v.T), T(wl.T)),
          sj.spectrum_to_xyz(jnp.asarray(v.T), jnp.asarray(wl.T)))
    close(st.luminance(T(v.T), T(wl.T)),
          sj.luminance(jnp.asarray(v.T), jnp.asarray(wl.T)))
    u = r.random(4096).astype(np.float32)
    for a, b in zip(st.sample_uniform_spectrum(T(u)),
                    sj.sample_uniform_spectrum(jnp.asarray(u))):
        close(a, b)
    close(st.pdf_uniform_spectrum(T(wl)),
          sj.pdf_uniform_spectrum(jnp.asarray(wl)))
    curve = ([400.0, 500.0, 600.0, 700.0], [0.2, 0.9, 0.4, 0.1])
    close(st.spectrum_to_rgb(*curve), sj.spectrum_to_rgb(*curve))
    close(st.spectrum_to_rgb(*curve, bounded=False),
          sj.spectrum_to_rgb(*curve, bounded=False))
