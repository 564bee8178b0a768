"""The port's Mueller calculus (render/mueller.py) against the JAX
package's on the same numpy inputs made from a seed: every function,
lane by lane, plus the physical checks of tests/test_polarized.py:13-65
(Malus's law, a polarizer's degree of polarization, the quarter-wave
plate, the rotator's round trip, Brewster's angle, the scalar Fresnel
term) as cases. Tolerance: 1e-5 relative and 2e-6 absolute (complex
Fresnel amplitudes 2e-5 relative, and near the critical angle an
absolute bound that grows as the square root's condition number); the
rotated matrices to 1e-5 of their largest entry, and where two Stokes
bases are near opposite, with a bound that grows as the angle's
condition number (``test_to_world_mueller``)."""

import numpy as np
import pytest
import torch

from mitsuba2_tpu_torch.render import mueller as mt
from tests.test_torch_wavefront_modules import T, close, hemisphere, rng

N = 512
RTOL, ATOL = 1e-5, 2e-6


def _mj():
    from mitsuba2_tpu.render import mueller
    return mueller


def _both(fn, *args):
    """fn of both packages on the same inputs (numpy arrays or numbers)
    -> (port tensor, JAX result as numpy)."""
    import jax.numpy as jnp
    conv = [(T(a), jnp.asarray(a)) if isinstance(a, np.ndarray) else (a, a)
            for a in args]
    got = getattr(mt, fn)(*(c[0] for c in conv))
    want = getattr(_mj(), fn)(*(c[1] for c in conv))
    return got, np.asarray(want)


def _angles(seed, n=N, lo=-np.pi, hi=np.pi):
    return (lo + (hi - lo) * rng(seed).random(n)).astype(np.float32)


@pytest.mark.parametrize("fn,arg", [
    ("depolarizer", "value"), ("absorber", "value"),
    ("linear_polarizer", "value"), ("linear_retarder", "angle"),
    ("rotator", "angle")])
def test_element_matrices(fn, arg):
    x = _angles(1) if arg == "angle" else rng(2).random(N).astype(
        np.float32)
    got, want = _both(fn, x)
    assert got.shape == (N, 4, 4)
    close(got, want, RTOL, ATOL)


def test_constant_elements_and_diattenuator():
    for fn in ("right_circular_polarizer", "left_circular_polarizer"):
        close(getattr(mt, fn)(), getattr(_mj(), fn)(), 0, 0)
    r = rng(3)
    x, y = (r.random(N).astype(np.float32) for _ in range(2))
    got, want = _both("diattenuator", x, y)
    close(got, want, RTOL, ATOL)
    # scalar arguments give one matrix
    close(mt.linear_polarizer(), _mj().linear_polarizer(), 0, 0)
    close(mt.depolarizer(0.5), _mj().depolarizer(0.5), 0, 0)


def test_rotated_element():
    import jax.numpy as jnp
    theta = _angles(4)
    M = rng(5).standard_normal((N, 4, 4)).astype(np.float32)
    got = mt.rotated_element(T(theta), T(M))
    want = _mj().rotated_element(jnp.asarray(theta), jnp.asarray(M))
    close(got, want, RTOL, 1e-5)


@pytest.mark.parametrize("eta", [(1.5, None), (1.0 / 1.33, None),
                                 (0.2, 3.9), (1.1, 2.4)],
                         ids=["glass", "inside water", "gold-like",
                              "copper-like"])
def test_specular_reflection(eta):
    """Dielectrics (total internal reflection included) and conductors'
    complex IORs, at normal, grazing and random incidence."""
    import jax.numpy as jnp
    ci = np.concatenate([[1.0, 1e-6, 1e-3, 0.02], rng(6).random(N - 4)]) \
        .astype(np.float32)
    eta_re, eta_im = eta
    # near the critical angle the transmitted cosine is the square root
    # of 1 - sin^2 / eta^2 ~ 0, which magnifies an ulp of the quotient
    # (the packages divide complex numbers by different rules) by
    # 1 / (2 sqrt|x|): the bound grows by that much there
    x = np.abs(1.0 - (1.0 - ci.astype(np.float64) ** 2)
               / np.abs(complex(eta_re, eta_im or 0.0) ** 2))
    atol = 1e-6 + 3e-7 / np.sqrt(np.maximum(x, 1e-12))
    r_t = mt._fresnel_amplitudes(T(ci), eta_re, eta_im)
    r_j = _mj()._fresnel_amplitudes(jnp.asarray(ci), eta_re, eta_im)
    for a, b in zip(r_t, r_j):
        a, b = a.numpy(), np.asarray(b)
        assert (np.abs(a - b) <= atol + 2e-5 * np.abs(b)).all()
    got = mt.specular_reflection(T(ci), eta_re, eta_im).numpy()
    want = np.asarray(_mj().specular_reflection(jnp.asarray(ci), eta_re,
                                                eta_im))
    assert got.dtype == np.float32
    assert (np.abs(got - want) <= atol[:, None, None]
            + 2e-5 * np.abs(want)).all()


def test_specular_transmission():
    ci = rng(7).random(N).astype(np.float32)
    for eta in (1.5, 1.0 / 1.5):
        got, want = _both("specular_transmission", ci, eta)
        close(got, want, RTOL, ATOL)


def test_stokes_bases_and_rotations():
    r = rng(8)
    w = hemisphere(r, N, lower=True)
    a = hemisphere(r, N, lower=True)
    b = hemisphere(r, N, lower=True)
    for fn, args in (("stokes_basis", (w,)), ("unit_angle", (a, b)),
                     ("rotate_stokes_basis", (w, a, b))):
        got, want = _both(fn, *args)
        close(got, want, RTOL, 1e-5)
    M = r.standard_normal((N, 4, 4)).astype(np.float32)
    got, want = _both("rotate_mueller_basis", M, w, a, b, -w, b, a)
    close(got, want, 3e-5, 3e-5)
    got, want = _both("rotate_mueller_basis_collinear", M, w, a, b)
    close(got, want, 3e-5, 3e-5)


def _frames(seed, n=N):
    """The same shading frames in both packages, as records with
    ``to_world``."""
    import jax.numpy as jnp
    from types import SimpleNamespace
    from mitsuba2_tpu.core.frame import Frame as FJ
    from mitsuba2_tpu_torch.core.frame import Frame as FT
    nrm = hemisphere(rng(seed), n)
    fj, ft = FJ.from_normal(jnp.asarray(nrm)), FT.from_normal(T(nrm))
    return (SimpleNamespace(to_world=ft.to_world),
            SimpleNamespace(to_world=fj.to_world))


def _basis_angles(si, fwd):
    """The angle ``to_world_mueller`` turns the Stokes basis of the local
    propagation directions ``fwd`` by (float32, the port's)."""
    from mitsuba2_tpu_torch.core import math as m
    w = m.normalize(si.to_world(fwd))
    cur = m.normalize(si.to_world(mt.stokes_basis(fwd)))
    return mt.unit_angle(cur, mt.stokes_basis(w)).double().numpy()


@pytest.mark.parametrize("channels", [0, 3], ids=["matrix", "spectrum"])
def test_to_world_mueller(channels):
    """``to_world_mueller`` on (n, 4, 4) and (n, C, 4, 4) matrices, and
    ``mueller_to_world``, to 1e-5 of each lane's largest entry. A basis
    pair near collinear takes the sign of a near-zero triple product,
    which may part between the packages; the angle is then near 0 (the
    turn is tiny) or near pi, where 2 asin(|b - a| / 2) magnifies an ulp
    of its argument by 1 / (pi - angle): there the bound grows by that
    condition number."""
    import jax.numpy as jnp
    si_t, si_j = _frames(9)
    r = rng(10)
    shape = (N, channels, 4, 4) if channels else (N, 4, 4)
    M = r.standard_normal(shape).astype(np.float32)
    wo = hemisphere(r, N, lower=True)
    wi = hemisphere(r, N)
    # a quarter of the lanes pass straight through (the null elements'
    # case: in and out along one direction)
    wo[: N // 4] = -wi[: N // 4]
    got = mt.to_world_mueller(si_t, T(M), T(-wo), T(wi)).numpy()
    want = np.asarray(_mj().to_world_mueller(
        si_j, jnp.asarray(M), jnp.asarray(-wo), jnp.asarray(wi)))
    gap = np.minimum(np.pi - _basis_angles(si_t, T(-wo)),
                     np.pi - _basis_angles(si_t, T(wi)))
    scale = np.maximum(np.abs(want).reshape(N, -1).max(-1), 1.0)
    bound = scale * (1e-5 + 1e-6 / np.maximum(gap, 1e-4))
    err = np.abs(got - want).reshape(N, -1).max(-1)
    assert (err <= bound).all(), (err / bound).max()
    # most lanes hold the plain bar
    assert (err <= 1e-5 * scale).mean() >= 0.98
    if not channels:
        got = mt.mueller_to_world(T(M), si_t, T(wo), T(wi)).numpy()
        want = np.asarray(_mj().mueller_to_world(
            jnp.asarray(M), si_j, jnp.asarray(wo), jnp.asarray(wi)))
        err = np.abs(got - want).reshape(N, -1).max(-1)
        assert (err <= 1e-5 * scale).all(), err.max()


# ---- the physical checks of tests/test_polarized.py:13-65 ----

def _malus():
    S_in = torch.tensor([1.0, 0.0, 0.0, 0.0])
    P0 = mt.linear_polarizer(1.0)
    for theta_deg in (0.0, 30.0, 45.0, 60.0, 90.0):
        th = np.deg2rad(theta_deg)
        P1 = mt.rotated_element(torch.tensor(th, dtype=torch.float32),
                                mt.linear_polarizer(1.0))
        S_out = P1 @ (P0 @ S_in)
        assert np.isclose(float(S_out[0]), 0.5 * np.cos(th) ** 2,
                          atol=1e-6), (theta_deg, S_out)


def _polarizer_polarizes():
    S = (mt.linear_polarizer(1.0) @ torch.tensor([1.0, 0, 0, 0])).numpy()
    assert np.allclose(S, [0.5, 0.5, 0, 0])
    assert np.isclose(np.linalg.norm(S[1:]) / S[0], 1.0)


def _quarter_wave_plate():
    S = torch.tensor([1.0, 0.0, 1.0, 0.0])
    QWP = mt.linear_retarder(torch.tensor(np.pi / 2, dtype=torch.float32))
    assert np.allclose((QWP @ S).numpy(), [1, 0, 0, 1], atol=1e-6)


def _rotator_roundtrip():
    th = torch.tensor(0.7)
    R = mt.rotator(th) @ mt.rotator(-th)
    assert np.allclose(R.numpy(), np.eye(4), atol=1e-6)


def _brewster():
    eta = 1.5
    M = mt.specular_reflection(torch.tensor(np.cos(np.arctan(eta)),
                                            dtype=torch.float32),
                               eta).numpy()
    assert np.isclose(M[0, 0], M[0, 1], atol=1e-6) and M[0, 0] > 0


def _scalar_fresnel():
    from mitsuba2_tpu_torch.render.fresnel import fresnel
    for ci in (0.2, 0.5, 0.9):
        c = torch.tensor(ci)
        M = mt.specular_reflection(c, 1.5)
        assert np.isclose(float(M[0, 0]), float(fresnel(c, 1.5)[0]),
                          atol=1e-5), ci


@pytest.mark.parametrize("check", [
    _malus, _polarizer_polarizes, _quarter_wave_plate, _rotator_roundtrip,
    _brewster, _scalar_fresnel], ids=lambda f: f.__name__.strip("_"))
def test_physical_checks(check):
    check()
