"""The port's Catmull-Rom splines (core/spline.py) and quadrature rules
(core/quad.py) against the JAX package's on the same numpy inputs made
from a seed: every function, query by query, and the reference's checks
of tests/test_core_math.py (a quadratic reproduced inside, the weights
form against direct evaluation, sampling against the density, the rules
integrating polynomials). Tolerance: 1e-5 relative and 1e-6 absolute
(the Newton solves 1e-5 absolute); the rules' nodes and weights bit for
bit (both cast the same float64 numpy values)."""

import numpy as np
import pytest
import torch

from mitsuba2_tpu_torch.core import quad as qt
from mitsuba2_tpu_torch.core import spline as st
from tests.test_torch_wavefront_modules import T, close, rng

RTOL, ATOL = 1e-5, 1e-6


def _sj():
    from mitsuba2_tpu.core import spline
    return spline


def _both(fn, *args):
    import jax.numpy as jnp
    conv = [(T(a), jnp.asarray(a)) if isinstance(a, np.ndarray) else (a, a)
            for a in args]
    got = getattr(st, fn)(*(c[0] for c in conv))
    want = getattr(_sj(), fn)(*(c[1] for c in conv))
    return got, want


def _close_all(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close_all(g, w, rtol, atol)
        return
    close(got, np.asarray(want), rtol, atol)


def _segment_args(seed, n=256):
    r = rng(seed)
    return [r.standard_normal(n).astype(np.float32) for _ in range(4)] \
        + [r.random(n).astype(np.float32)]


@pytest.mark.parametrize("fn", ["eval_spline", "eval_spline_d",
                                "eval_spline_i"])
def test_hermite_segments(fn):
    _close_all(*_both(fn, *_segment_args(1)))


def _curve(seed, n=9):
    r = rng(seed)
    values = np.cumsum(r.random(n) + 0.1).astype(np.float32)
    x = (r.random(300) * 1.4 - 0.2).astype(np.float32)   # some outside
    return values, x


def test_eval_1d_and_weights():
    values, x = _curve(2)
    _close_all(*_both("eval_1d", 0.0, 2.0, values, x))
    got, want = _both("eval_spline_weights", 0.0, 2.0, len(values), x)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close_all(got[2], want[2])
    # the weights reproduce the evaluation inside
    valid, base, w = got
    idx = (base[:, None] + torch.arange(4)).clamp(0, len(values) - 1)
    direct = st.eval_1d(0.0, 2.0, T(values), T(x))
    via = (w * T(values)[idx]).sum(-1)
    assert torch.allclose(via[valid], direct[valid], atol=1e-5)


def test_nonuniform_and_2d():
    r = rng(3)
    nodes = np.sort(r.random(7) * 3.0).astype(np.float32)
    values = r.standard_normal(7).astype(np.float32)
    x = (r.random(300) * 3.4 - 0.2).astype(np.float32)
    _close_all(*_both("eval_1d_nonuniform", nodes, values, x))
    ny = np.sort(r.random(5) * 2.0).astype(np.float32)
    grid = r.standard_normal((5, 7)).astype(np.float32)
    y = (r.random(300) * 2.2 - 0.1).astype(np.float32)
    _close_all(*_both("eval_2d", nodes, ny, grid, x, y), atol=1e-5)


def test_integrate_invert_sample():
    values, _ = _curve(4)
    cdf_t, cdf_j = _both("integrate_1d", 0.0, 1.0, values)
    _close_all(cdf_t, cdf_j)
    y = (rng(5).random(300) * float(values[-1] - values[0])
         + float(values[0])).astype(np.float32)
    _close_all(*_both("invert_1d", 0.0, 1.0, values, y), rtol=0, atol=1e-5)
    dens = (rng(6).random(9) + 0.2).astype(np.float32)
    cdf = st.integrate_1d(0.0, 1.0, T(dens)).numpy()
    u = rng(7).random(300).astype(np.float32)
    got, want = _both("sample_1d", 0.0, 1.0, dens, cdf, u)
    _close_all(got, want, rtol=1e-5, atol=1e-5)
    # the sampled values are the spline's, the pdf its normalized value
    x, fval, pdf = got
    ref = st.eval_1d(0.0, 1.0, T(dens), torch.clamp(x, 0.0, 1.0))
    assert torch.allclose(fval, ref, atol=1e-4)
    assert torch.allclose(pdf, fval / float(cdf[-1]), rtol=1e-5)


def test_quadratic_reproduced_inside():
    xs = np.linspace(0.5, 3.5, 50).astype(np.float32)
    values = (np.arange(5, dtype=np.float32) ** 2)
    got = st.eval_1d(0.0, 4.0, T(values), T(xs)).numpy()
    inside = (xs >= 1.0) & (xs <= 3.0)
    np.testing.assert_allclose(got[inside], xs[inside] ** 2, rtol=1e-5)


@pytest.mark.parametrize("rule,n", [
    ("gauss_legendre", 8), ("gauss_legendre", 1), ("gauss_lobatto", 8),
    ("gauss_lobatto", 2), ("composite_simpson", 31),
    ("composite_simpson_38", 13)])
def test_quadrature_rules(rule, n):
    from mitsuba2_tpu.core import quad as qj
    x, w = getattr(qt, rule)(n)
    xj, wj = getattr(qj, rule)(n)
    assert x.dtype == w.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(w.numpy(), np.asarray(wj))
    # each rule integrates the polynomials it is exact for
    deg = {"gauss_legendre": 2 * n - 1, "gauss_lobatto": 2 * n - 3,
           "composite_simpson": 3, "composite_simpson_38": 3}[rule]
    xd, wd = x.double(), w.double()
    for k in range(max(deg, 0) + 1):
        exact = (1.0 - (-1.0) ** (k + 1)) / (k + 1)
        assert abs(float((wd * xd ** k).sum()) - exact) < 1e-5, k


def test_quadrature_refusals():
    for fn, n in (("gauss_lobatto", 1), ("composite_simpson", 4),
                  ("composite_simpson_38", 5)):
        with pytest.raises(ValueError):
            getattr(qt, fn)(n)
