"""The port's warps against the JAX package's: every sample warp, density
and inverse on the same seeded samples within 1e-6 (absolute, and
relative for densities above one), and the chi^2 goodness-of-fit of each
sample/density pair the JAX package adds over the path's warps, through
the port's ``python/chi2.py`` at the JAX tests' parameters and sample
counts (tests/test_warp.py).

Two warps amplify the last bit of a transcendental, where XLA's and
torch's CPU libraries may round apart by an ulp: the vMF sample's
r = sqrt(1 - z^2) near the pole (one ulp of z moves r by |z| / r ulps),
held at 1e-6 in z and in the azimuth and at 1e-6 plus four ulps times
|z| / r in r; and the rough fiber's density, exp(kappa (h_z - 1)), held
at 1e-6 plus kappa times four ulps, relative. The rough fiber's sample is
held at 1e-6 on the same micro-normals."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mitsuba2_tpu.core import warp as wj
from mitsuba2_tpu_torch.core import warp as wt
from mitsuba2_tpu_torch.python.chi2 import (ChiSquareTest, PlanarDomain,
                                            SphericalDomain)
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()

TOL = 1e-6
# tests/test_warp.py's chi^2 settings
SAMPLES, RES = 100000, 31
WI = np.asarray([0.5, 0.0, 1.0]) / np.sqrt(1.25)
TANGENT = [1.0, 0.0, 0.0]


def _u(n=4096, dim=2, seed=0):
    u = np.random.RandomState(seed).rand(n, dim).astype(np.float32)
    # the domain's edges: 0 and the largest float below 1
    u[:4] = [[0.0] * dim, [np.float32(1 - 2 ** -24)] * dim,
             [0.5] * dim, [0.25] * dim]
    return u


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=TOL, atol=TOL)


def _both(name, *args):
    """The port's warp on torch tensors and the JAX one on the same
    values (numbers pass as they are)."""
    def conv(x, mod):
        if isinstance(x, np.ndarray):
            return torch.as_tensor(np.array(x)) if mod is wt \
                else jnp.asarray(x)
        return x
    return (getattr(wt, name)(*(conv(a, wt) for a in args)),
            getattr(wj, name)(*(conv(a, wj) for a in args)))


PLANAR = ["square_to_uniform_disk", "square_to_uniform_square_concentric",
          "square_to_std_normal", "square_to_tent"]
SPHERICAL = ["square_to_uniform_hemisphere"]


@pytest.mark.parametrize("name", PLANAR + SPHERICAL)
def test_warp_and_pdf_match_jax(name):
    u = _u()
    got, want = _both(name, u)
    _close(got, want)
    pdf = name + "_pdf"
    if hasattr(wj, pdf):
        x = np.asarray(want, np.float32)
        _close(*_both(pdf, x))
        # and off the warp's image
        off = np.random.RandomState(1).uniform(
            -1.5, 1.5, x.shape).astype(np.float32)
        _close(*_both(pdf, off))


def test_interval_warps_match_jax():
    u = _u(dim=1)[:, 0]
    _close(*_both("interval_to_tent", u))
    for a, b, c in ((0.0, 1.0, 4.0), (-1.0, 0.3, 2.0), (0.0, 0.0, 1.0)):
        _close(*_both("interval_to_nonuniform_tent", a, b, c, u))
    # the JAX tests' analytic values
    x = wt.interval_to_nonuniform_tent(
        0.0, 1.0, 4.0, torch.tensor([0.25, 1.0 - 1e-7]))
    assert abs(float(x[0]) - 1.0) < 1e-5 and abs(float(x[1]) - 4.0) < 1e-2
    assert abs(float(wt.interval_to_tent(torch.tensor(0.125))) + 0.5) < 1e-6


def test_concentric_inverse_matches_jax():
    u = _u()
    p = wt.square_to_uniform_disk_concentric(torch.as_tensor(u))
    got = wt.uniform_disk_to_square_concentric(p)
    _close(got, wj.uniform_disk_to_square_concentric(jnp.asarray(
        p.numpy())))
    np.testing.assert_allclose(got.numpy()[4:], u[4:], atol=1e-4)
    sq = wt.square_to_uniform_square_concentric(torch.as_tensor(u)).numpy()
    assert sq.min() >= 0 and sq.max() <= 1


ULP4 = 2.0 ** -21


def _close_sphere(got, want):
    """Unit directions held in z and in the azimuth at TOL, in r = |xy|
    at TOL plus four ulps of z carried through sqrt(1 - z^2)."""
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0, atol=TOL)
    r_g = np.hypot(got[:, 0], got[:, 1])
    r_w = np.hypot(want[:, 0], want[:, 1])
    bar = TOL + ULP4 * np.abs(want[:, 2]) / np.maximum(r_w, 1e-12)
    assert (np.abs(r_g - r_w) <= bar).all()
    wide = r_w > 1e-3
    np.testing.assert_allclose(got[wide, :2] / r_g[wide, None],
                               want[wide, :2] / r_w[wide, None], rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("kappa", [0.0, 0.5, 10.0, 100.0, 1e4])
def test_von_mises_fisher_matches_jax(kappa):
    u = _u()
    got, want = _both("square_to_von_mises_fisher", u, kappa)
    _close_sphere(got, want)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    _close(*_both("square_to_von_mises_fisher_pdf",
                  np.asarray(want, np.float32), kappa))


def test_rough_fiber_matches_jax(monkeypatch):
    u = _u()
    wi = WI.astype(np.float32)
    tangent = np.asarray(TANGENT, np.float32)
    kappa = 30.0
    # both constructions on the JAX package's micro-normals
    normals = np.asarray(wj.square_to_von_mises_fisher(jnp.asarray(u),
                                                       kappa))
    monkeypatch.setattr(wt, "square_to_von_mises_fisher",
                        lambda s, k: torch.as_tensor(normals))
    monkeypatch.setattr(wj, "square_to_von_mises_fisher",
                        lambda s, k: jnp.asarray(normals))
    got, want = _both("square_to_rough_fiber", u, wi, tangent, kappa)
    _close(got, want)
    monkeypatch.undo()
    got, want = _both("square_to_rough_fiber_pdf",
                      np.asarray(want, np.float32), wi, tangent, kappa)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL + kappa * ULP4, atol=TOL)


def _chi2(domain, sample, pdf):
    test = ChiSquareTest(domain, sample, pdf, sample_dim=2,
                         sample_count=SAMPLES, res=RES, ires=8, seed=0)
    assert test.run(0.01, test_count=20), test.messages


CHI2 = {
    "uniform_disk": (PlanarDomain(), wt.square_to_uniform_disk,
                     wt.square_to_uniform_disk_pdf),
    "std_normal": (PlanarDomain(((-4.0, 4.0), (-4.0, 4.0))),
                   wt.square_to_std_normal, wt.square_to_std_normal_pdf),
    "tent": (PlanarDomain(), wt.square_to_tent, wt.square_to_tent_pdf),
    "uniform_hemisphere": (SphericalDomain(),
                           wt.square_to_uniform_hemisphere,
                           wt.square_to_uniform_hemisphere_pdf),
    "rough_fiber": (SphericalDomain(),
                    lambda u: wt.square_to_rough_fiber(
                        u, torch.as_tensor(WI, dtype=torch.float32),
                        TANGENT, 30.0),
                    lambda v: wt.square_to_rough_fiber_pdf(
                        v, torch.as_tensor(WI, dtype=torch.float32),
                        TANGENT, 30.0)),
}
for _kappa in (0.5, 10.0, 100.0):
    CHI2[f"von_mises_fisher_{_kappa:g}"] = (
        SphericalDomain(),
        lambda u, k=_kappa: wt.square_to_von_mises_fisher(u, k),
        lambda v, k=_kappa: wt.square_to_von_mises_fisher_pdf(v, k))


@pytest.mark.parametrize("name", sorted(CHI2))
def test_warp_passes_chi2(name):
    _chi2(*CHI2[name])


def test_pdfs_normalized():
    """Uniform-direction MC over the sphere (tests/test_warp_pdfs.py)."""
    rs = np.random.RandomState(0)
    d = rs.randn(400_000, 3).astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True))
    for pdf, tol in ((wt.square_to_uniform_hemisphere_pdf, 0.02),
                     (lambda v: wt.square_to_von_mises_fisher_pdf(v, 8.0),
                      0.05)):
        assert abs(float(pdf(d).mean()) * 4 * np.pi - 1.0) < tol
