"""The polarizing BSDFs of the port (models/bsdfs.py ``polarizer``,
``retarder``, ``circular``, ``pplastic``) against the JAX package's on the
same numpy surface records made from a seed, lane for lane, in rgb,
spectral and mono: ``sample``, ``eval``, ``pdf``,
``eval_null_transmission``, ``eval_pol`` and ``sample_pol`` (the Mueller
matrices rotated into the transport bases), and the base class's
depolarizing ``eval_pol``/``sample_pol`` on a diffuse BSDF. Tolerance:
1e-5 relative and 1e-6 absolute on values and pdfs; sampled directions,
their pdfs and weights as tests/test_torch_surface_plugins.py holds them
(5e-5, 1e-4 relative, on 99.9% of the lanes); the rotated matrices
to 2e-5 of each lane's largest entry on 99.9% of the lanes (a Stokes
basis pair near opposite turns by an angle whose 2 asin form magnifies an
ulp, tests/test_torch_mueller.py)."""

import numpy as np
import pytest
import torch

from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_surface_plugins import (N, VARIANTS, load_both,
                                              surface_records, variant)
from tests.test_torch_wavefront import one_thread_fixture
from tests.test_torch_wavefront_modules import (T, close, close_lanes,
                                                hemisphere, rng)

_on_cpu = cpu_device_fixture()
_one_thread = one_thread_fixture()
_variant = variant


def _bsdf_dicts():
    return {
        "polarizer": {"type": "polarizer", "theta": 30.0,
                      "transmittance": 0.8},
        "polarizer default": {"type": "polarizer"},
        "retarder quarter 45": {"type": "retarder", "theta": 45.0},
        "retarder half 10": {"type": "retarder", "theta": 10.0,
                             "delta": 180.0},
        "circular right": {"type": "circular"},
        "circular left": {"type": "circular", "left_handed": True},
        "pplastic": {"type": "pplastic"},
        "pplastic colored": {"type": "pplastic", "int_ior": 1.7,
                             "diffuse_reflectance": {
                                 "type": "rgb", "value": [0.2, 0.3, 0.6]}},
        "diffuse depolarizes": {"type": "diffuse", "reflectance": {
            "type": "rgb", "value": [0.3, 0.5, 0.7]}},
    }


def matrices_close(got, want, share=0.999, rtol=2e-5):
    """Mueller matrices (n, ..., 4, 4) within ``rtol`` of each lane's
    largest entry (and 1e-6) on ``share`` of the lanes, all lanes within
    1e-3."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    n = len(want)
    scale = np.abs(want).reshape(n, -1).max(-1)
    err = np.abs(got - want).reshape(n, -1).max(-1)
    ok = err <= rtol * scale + 1e-6
    assert ok.mean() >= share, (ok.mean(), err.max())
    assert (err <= 1e-3 * np.maximum(scale, 1.0)).all(), err.max()


@pytest.mark.parametrize("variant", VARIANTS, indirect=True)
@pytest.mark.parametrize("case", sorted(_bsdf_dicts()))
def test_polarized_bsdf_lanes(case, variant):
    import jax.numpy as jnp
    from mitsuba2_tpu.render.bsdf import BSDFContext as CJ
    from mitsuba2_tpu_torch.render.bsdf import BSDFContext as CT
    bj, bt = load_both(_bsdf_dicts()[case])
    assert type(bt).__name__ == type(bj).__name__
    assert int(bt.flags()) == int(bj.flags())
    sj, st = surface_records(18, variant)
    r = rng(19)
    wo = hemisphere(r, N, lower=True)
    s1 = r.random(N).astype(np.float32)
    s2 = r.random((N, 2)).astype(np.float32)
    act_j, act_t = jnp.ones(N, bool), torch.ones(N, dtype=torch.bool)
    # every fourth lane inactive
    act_t[::4] = False
    act_j = jnp.asarray(act_t.numpy())
    close_lanes(bt.eval(CT(), st, T(wo), act_t),
                bj.eval(CJ(), sj, jnp.asarray(wo), act_j), rtol=1e-5)
    close(bt.pdf(CT(), st, T(wo), act_t),
          bj.pdf(CJ(), sj, jnp.asarray(wo), act_j), rtol=1e-5, atol=1e-6)
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
    nt = bt.eval_null_transmission(st, act_t)
    close(nt, np.broadcast_to(np.asarray(bj.eval_null_transmission(
        sj, act_j)), nt.shape), rtol=1e-5, atol=1e-6)
    # the Mueller matrices
    matrices_close(bt.eval_pol(CT(), st, T(wo), act_t),
                   bj.eval_pol(CJ(), sj, jnp.asarray(wo), act_j))
    bs_t, M_t = bt.sample_pol(CT(), st, T(s1), T(s2), act_t)
    bs_j, M_j = bj.sample_pol(CJ(), sj, jnp.asarray(s1), jnp.asarray(s2),
                              act_j)
    close_lanes(bs_t.wo, bs_j.wo, rtol=0, atol=5e-5)
    close_lanes(bs_t.pdf, bs_j.pdf, rtol=1e-4)
    matrices_close(M_t, M_j)
    # the (0, 0) entry is the scalar weight (pplastic: its first channel
    # on specular lanes, where the matrix is rescaled to it)
    if case.startswith("pplastic"):
        close(M_t[..., 0, 0][:, 0], w_t[:, 0], rtol=1e-5, atol=1e-6)
    elif not case.startswith("diffuse"):
        close(M_t[..., 0, 0], w_t, rtol=1e-5, atol=1e-6)


def test_elements_in_unpolarized_render_are_their_intensity_filters():
    """In the path wavefront an element is a null filter: the weight its
    sample returns is the (0, 0) entry, 0.5 for an ideal polarizer of
    any angle, and a retarder passes everything."""
    import mitsuba2_tpu_torch as mt
    from mitsuba2_tpu_torch.render.bsdf import BSDFContext
    mt.set_variant("scalar_rgb")
    _, st = surface_records(3, "scalar_rgb", n=64)
    act = torch.ones(64, dtype=torch.bool)
    for d, want in (({"type": "polarizer", "theta": 33.0}, 0.5),
                    ({"type": "retarder", "theta": 12.0}, 1.0),
                    ({"type": "circular"}, 0.5)):
        b = mt.load_dict(d)
        bs, w = b.sample(BSDFContext(), st, torch.zeros(64),
                         torch.zeros(64, 2), act)
        assert torch.allclose(w, torch.full_like(w, want), atol=1e-6)
        assert torch.equal(bs.wo, -st.wi)
