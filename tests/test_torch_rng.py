"""TEA streams of the PyTorch port against the JAX package, bit for bit.

Inputs are random uint32 words made with numpy from a fixed seed and fed
to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba2_tpu.core import rng as rng_j
from mitsuba2_tpu.ops import megakernel as mk_j
from mitsuba2_tpu_torch.core import rng as rng_t
from mitsuba2_tpu_torch.ops import path_kernel as pk_t
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()

N = 100_000


def _words(seed, n=N):
    r = np.random.default_rng(seed)
    return r.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.as_tensor(a.astype(np.int64))


def _np_u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("rounds", [4, 5])
def test_sample_tea_32_bit_exact(rounds):
    a, b = _words(1), _words(2)
    ja, jb = rng_j.sample_tea_32(jnp.asarray(a), jnp.asarray(b), rounds)
    ta, tb = rng_t.sample_tea_32(_t(a), _t(b), rounds)
    np.testing.assert_array_equal(ta.numpy(), _np_u32(ja))
    np.testing.assert_array_equal(tb.numpy(), _np_u32(jb))


def test_lane_key_bit_exact():
    seed, idx = _words(3), _words(4)
    j = rng_j.lane_key(jnp.asarray(seed), jnp.asarray(idx))
    t = rng_t.lane_key(_t(seed), _t(idx))
    np.testing.assert_array_equal(t.numpy(), _np_u32(j))


def test_uniform_float_bit_exact():
    key = _words(5)
    dims = _words(6) % 64
    j = np.asarray(rng_j.uniform_float(jnp.asarray(key), jnp.asarray(dims)))
    t = rng_t.uniform_float(_t(key), _t(dims)).numpy()
    assert t.dtype == np.float32
    np.testing.assert_array_equal(t.view(np.int32), j.view(np.int32))
    assert (t >= 0).all() and (t < 1).all()


def test_kernel_tea_u01_rng2_bit_exact():
    """The kernel-side helpers (megakernel.py:194-233) that csrc/rng.cuh
    implements: _tea's default 5 rounds, _u01 and _rng2."""
    a, b = _words(7), _words(8)
    ja, jb = mk_j._tea(jnp.asarray(a), jnp.asarray(b))
    ta, tb = pk_t._tea(_t(a), _t(b))
    np.testing.assert_array_equal(ta.numpy(), _np_u32(ja))
    np.testing.assert_array_equal(tb.numpy(), _np_u32(jb))
    ju = np.asarray(mk_j._u01(jnp.asarray(a)))
    tu = pk_t._u01(_t(a)).numpy()
    np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))
    for dim in (0, 2, 13, 42):
        j0, j1 = mk_j._rng2(jnp.asarray(a), dim)
        t0, t1 = pk_t._rng2(_t(a), dim)
        np.testing.assert_array_equal(t0.numpy(), np.asarray(j0))
        np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))


def test_concentric_and_mis():
    r = np.random.default_rng(9)
    u = r.random((2, N)).astype(np.float32)
    u[:, :4] = [[0.5, 0.5, 0.0, 0.25], [0.5, 0.0, 0.5, 0.75]]  # centre, axes
    jx, jy = mk_j._concentric(jnp.asarray(u[0]), jnp.asarray(u[1]))
    tx, ty = pk_t._concentric(torch.as_tensor(u[0]), torch.as_tensor(u[1]))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-6)
    assert (tx.numpy() ** 2 + ty.numpy() ** 2 <= 1 + 1e-6).all()
    a, b = r.random((2, N)).astype(np.float32) * 10.0
    a[:100] = 0.0
    np.testing.assert_allclose(
        pk_t._mis(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(mk_j._mis(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=0)
