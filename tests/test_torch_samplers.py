"""The port's samplers (models/samplers.py) and QMC sequences
(core/qmc.py) against the JAX package's, bit for bit: every draw is an
integer hash turned into a float32 the same way, so equality is the bar.
Then the statistics of the JAX battery (tests/test_sampler_battery.py) as
port cases of one parametrised test, and the guard that the grown sampler
state leaves the independent streams and the path kernel's image as they
were."""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core import qmc, rng
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()

SAMPLERS = ["independent", "stratified", "multijitter", "orthogonal",
            "ldsampler"]


def _grid(seed=5, n=4096):
    """Lanes of (pixel, sample index) made from numpy with a seed, wide
    enough to wrap the uint32 sums."""
    r = np.random.default_rng(seed)
    pixel = r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    pixel[:64] = np.arange(64)
    sample = r.integers(0, 1 << 20, n, dtype=np.uint64).astype(np.uint32)
    sample[:64] = np.arange(64)
    return pixel, sample


def _bits(x):
    """A float32 or uint32 array's bits as int64, from torch or JAX."""
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if x.dtype == np.float32:
        return x.view(np.int32).astype(np.int64)
    return x.astype(np.int64) & 0xFFFFFFFF


def _t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def test_rng_hashes_match_jax():
    import jax.numpy as jnp
    from mitsuba2_tpu.core import rng as rng_j
    r = np.random.default_rng(1)
    a = r.integers(0, 2**32, 8192, dtype=np.uint64).astype(np.uint32)
    b = r.integers(0, 2**32, 8192, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(_bits(rng.pcg_hash(_t(a))),
                          _bits(rng_j.pcg_hash(jnp.asarray(a))))
    assert np.array_equal(_bits(rng.hash_combine(_t(a), _t(b))),
                          _bits(rng_j.hash_combine(jnp.asarray(a),
                                                   jnp.asarray(b))))
    assert np.array_equal(_bits(rng.hash_combine(_t(a), 0x9E3779B9)),
                          _bits(rng_j.hash_combine(jnp.asarray(a),
                                                   jnp.uint32(0x9E3779B9))))


@pytest.mark.parametrize("fn", ["reverse_bits_u32", "radical_inverse_2",
                                "sobol_2", "sample_02"])
def test_qmc_base2_matches_jax(fn):
    import jax.numpy as jnp
    from mitsuba2_tpu.core import qmc as qmc_j
    r = np.random.default_rng(2)
    idx = r.integers(0, 2**32, 8192, dtype=np.uint64).astype(np.uint32)
    idx[:256] = np.arange(256)
    scr = r.integers(0, 2**32, (2, 8192), dtype=np.uint64).astype(np.uint32)
    args = [idx] + ([] if fn == "reverse_bits_u32" else [scr[0]]) \
        + ([scr[1]] if fn == "sample_02" else [])
    ours = getattr(qmc, fn)(*[_t(a) for a in args])
    theirs = getattr(qmc_j, fn)(*[jnp.asarray(a) for a in args])
    if fn != "sample_02":
        ours, theirs = (ours,), (theirs,)
    for a, b in zip(ours, theirs):
        assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("base_index", [0, 1, 2, 5, 17, 101, 1023])
def test_qmc_radical_inverses_match_jax(base_index):
    """The generic and the Faure-scrambled inverses, whose float32 digit
    sums must run in the reference's order, and the prime table."""
    import jax.numpy as jnp
    from mitsuba2_tpu.core import qmc as qmc_j
    r = np.random.default_rng(3)
    idx = r.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    idx[:64] = np.arange(64)
    base = qmc.prime_base(base_index)
    assert base == qmc_j.prime_base(base_index)
    perm = qmc.faure_permutation(base)
    assert np.array_equal(perm, qmc_j.faure_permutation(base))
    assert np.array_equal(
        _bits(qmc.radical_inverse(base_index, _t(idx))),
        _bits(qmc_j.radical_inverse(base_index, jnp.asarray(idx))))
    assert np.array_equal(
        _bits(qmc.scrambled_radical_inverse(base_index, _t(idx), perm)),
        _bits(qmc_j.scrambled_radical_inverse(base_index, jnp.asarray(idx),
                                              perm)))
    ri = qmc.RadicalInverse()
    assert ri.base(base_index) == base and ri.bases() == 1024
    assert np.array_equal(_bits(ri.eval_scrambled(base_index, _t(idx))),
                          _bits(qmc_j.RadicalInverse().eval_scrambled(
                              base_index, jnp.asarray(idx))))


def test_qmc_known_values():
    """tests/test_core_math.py:176-194 in the port: the first inverses,
    the (0,2)-sequence's stratification, a Faure permutation."""
    out = qmc.radical_inverse_2(_t([1, 2, 3]))
    assert np.allclose(out.numpy(), [0.5, 0.25, 0.75])
    out = qmc.radical_inverse(1, _t([1, 2, 3]))
    assert np.allclose(out.numpy(), [1 / 3, 2 / 3, 1 / 9], atol=1e-6)
    idx = torch.arange(256)
    h, _, _ = np.histogram2d(qmc.radical_inverse_2(idx).numpy(),
                             qmc.sobol_2(idx).numpy(), bins=16,
                             range=[[0, 1], [0, 1]])
    assert (h == 1).all()
    p = qmc.faure_permutation(5)
    assert sorted(p.tolist()) == [0, 1, 2, 3, 4] and p[2] == 2


def _pair(name, count, variant="scalar_rgb"):
    import mitsuba2_tpu as mj
    mj.set_variant(variant)
    mt.set_variant(variant)
    try:
        d = {"type": name, "sample_count": count, "seed": 11}
        return mj.load_dict(d), mt.load_dict(d)
    finally:
        mj.set_variant("scalar_rgb")
        mt.set_variant("scalar_rgb")


@pytest.mark.parametrize("count", [16, 20])
@pytest.mark.parametrize("name", SAMPLERS)
def test_sampler_draws_match_jax(name, count):
    """next_1d and next_2d in turn over 7 dimensions, three seeds, on a
    grid of (pixel, sample index) made from numpy with a seed: bit for
    bit the JAX sampler's; the sample count rounded as the reference
    rounds it (a square, p^2 for orthogonal)."""
    import jax.numpy as jnp
    sj, st = _pair(name, count)
    assert st.sample_count == sj.sample_count
    pixel, sample = _grid()
    for seed in (0, 3, 0xFFFFFFF0):
        a = sj.seed(jnp.uint32(seed), jnp.asarray(pixel),
                    jnp.asarray(sample))
        b = st.seed(seed, _t(pixel), _t(sample))
        assert np.array_equal(_bits(b.lane_id), _bits(a.lane_id))
        for step in ("1d", "2d", "2d", "1d", "1d", "2d"):
            va, a = getattr(sj, "next_" + step)(a)
            vb, b = getattr(st, "next_" + step)(b)
            assert vb.dtype == torch.float32
            assert np.array_equal(_bits(vb), _bits(va)), (seed, step, b.dim)
        assert b.dim == int(a.dim) == 9


def test_sampler_jitter_off_matches_jax():
    import jax.numpy as jnp
    import mitsuba2_tpu as mj
    pixel, sample = _grid(seed=9, n=1024)
    for name in ("stratified", "multijitter"):
        d = {"type": name, "sample_count": 9, "jitter": False}
        sj, st = mj.load_dict(d), mt.load_dict(d)
        a = sj.seed(jnp.uint32(4), jnp.asarray(pixel), jnp.asarray(sample))
        b = st.seed(4, _t(pixel), _t(sample))
        for step in ("1d", "2d"):
            va, a = getattr(sj, "next_" + step)(a)
            vb, b = getattr(st, "next_" + step)(b)
            assert np.array_equal(_bits(vb), _bits(va)), (name, step)


def _draws(name, n_pixels=64, spp=64, dims=2, seed=0):
    """(n_pixels * spp, dims) next_1d draws (the JAX battery's _draws)."""
    s = mt.load_dict({"type": name, "sample_count": spp})
    lane = torch.arange(n_pixels * spp)
    state = s.seed(seed, lane // spp, lane % spp)
    out = []
    for _ in range(dims):
        v, state = s.next_1d(state)
        out.append(v.numpy())
    return np.stack(out, -1)


def _uniform_marginals(name):
    x = _draws(name)
    for d in range(x.shape[-1]):
        h, _ = np.histogram(x[:, d], bins=16, range=(0, 1))
        expect = len(x) / 16
        assert ((h - expect) ** 2 / expect).sum() < 60.0, (d, h)
        assert (x[:, d] >= 0).all() and (x[:, d] < 1).all()


def _mean(name):
    assert abs(_draws(name).mean() - 0.5) < 0.01


def _deterministic(name):
    assert np.array_equal(_draws(name), _draws(name))


def _seed_decorrelates(name):
    v0 = _draws(name, 64, 16, 1, seed=0)[:, 0]
    v1 = _draws(name, 64, 16, 1, seed=7)[:, 0]
    assert not np.allclose(v0, v1)
    if name == "independent":
        assert abs(np.corrcoef(v0, v1)[0, 1]) < 0.1
    else:
        assert (np.abs(v0 - v1) > 1e-6).mean() > 0.5


def _stratification(name):
    spp = 64
    s = mt.load_dict({"type": name, "sample_count": spp})
    v, _ = s.next_1d(s.seed(0, torch.zeros(spp, dtype=torch.int64),
                            torch.arange(spp)))
    gaps = np.diff(np.concatenate([[0.0], np.sort(v.numpy()), [1.0]]))
    assert gaps.max() < 4.5 / spp, gaps.max()


def _no_axis_alignment(name):
    s = mt.load_dict({"type": name, "sample_count": 256})
    spp = s.sample_count
    uv, _ = s.next_2d(s.seed(1, torch.zeros(spp, dtype=torch.int64),
                             torch.arange(spp)))
    uv = uv.numpy()
    cells = (np.floor(uv[:, 0] * 4).astype(int) * 4
             + np.floor(uv[:, 1] * 4).astype(int))
    assert len(np.unique(np.clip(cells, 0, 15))) == 16


_PROPERTIES = {"uniform_marginals": _uniform_marginals, "mean": _mean,
               "deterministic": _deterministic,
               "seed_decorrelates": _seed_decorrelates,
               "no_axis_alignment": _no_axis_alignment,
               "stratification": _stratification}


@pytest.mark.parametrize("case", [
    (prop, name) for prop in _PROPERTIES for name in SAMPLERS
    if prop != "stratification" or name != "independent"],
    ids=lambda c: f"{c[0]}-{c[1]}")
def test_sampler_battery(case):
    """tests/test_sampler_battery.py's statistics, on the port's
    samplers."""
    prop, name = case
    _PROPERTIES[prop](name)


def test_independent_streams_unchanged():
    """The grown sampler state draws the independent streams of before:
    dimension d of a lane is TEA(lane key, d) with the lane key TEA(seed,
    TEA(pixel, sample)), for next_1d and next_2d alike."""
    pixel, sample = _grid(seed=4, n=2048)
    s = mt.load_dict({"type": "independent", "seed": 6})
    state = s.seed(9, _t(pixel), _t(sample))
    key = rng.lane_key(6 ^ 9, rng.sample_tea_32(_t(pixel), _t(sample))[0])
    assert torch.equal(state.key, key)
    dim = 0
    for step in ("2d", "2d", "1d", "1d", "1d", "2d"):
        v, state = getattr(s, "next_" + step)(state)
        k = 2 if step == "2d" else 1
        want = torch.stack([rng.uniform_float(key, dim + i)
                            for i in range(k)], -1)
        assert torch.equal(v, want if k == 2 else want[:, 0])
        dim += k


def test_structured_sampler_stays_on_the_path_kernel():
    """A stratified Cornell box renders on the path kernel, keyed by its
    TEA lanes: the plain version's image is the independent sampler's,
    bit for bit."""
    from mitsuba2_tpu_torch.python.test.scenes import cornell_box_dict
    imgs = []
    for name in ("independent", "stratified"):
        d = cornell_box_dict(8, 8, 4, 4)
        d["sensor"]["sampler"]["type"] = name
        scene = mt.load_dict(d)
        imgs.append(scene.integrator.render(scene, seed=2, spp=4))
        assert scene.integrator.last_engine == "kernel"
        assert scene.integrator.engine_reason is None
    assert torch.equal(imgs[0], imgs[1])
