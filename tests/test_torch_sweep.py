"""The face sweep (ops/sweep_kernel.py, csrc/sweep_kernel.cu): its product
against the JAX package's ``_dot3T`` (mitsuba2_tpu/ops/megakernel.py:149)
and against the kernel of benchmarks/mxu_shape_ceiling.py rebuilt here in
Pallas interpret mode, its closest hit against K2's plain twin
(ops/intersect.py ``closest_hit_reference``), and the CUDA kernel against
its plain version on the card.

Tolerances. ``_dot3T`` forms each product in three bf16 passes (about
2^-16 of the terms): on N(0,1) inputs of this size that is within 2e-4
absolute. With ``_dot3T`` patched to a float32 product (the JAX package is
not edited), the two float32 sums of four products differ only by their
rounding: within 1e-6 of the sum of the terms' magnitudes, the scale a
float32 dot product's error is relative to. The TPU tool's 8-row sums add
four such products: within 4e-4 absolute. The plain closest hit is K2's
face test in the same order of operations, so it agrees bit for bit; the
kernel on the card runs the path kernel's fused test and is held to K2's
bar (equal face ids and hit counts on at least 99.9% of rays, t within
1e-5 relative to max(1, |t|) and uv within 1e-5 on the rest).

The box-test ceiling's plain version runs the slab test as the walk does;
it is held bit for bit against a numpy slab test written out here (the
same subtractions, products, minima and maxima), and the kernel on the
card bit for bit against it.
"""

import numpy as np
import pytest
import torch

from mitsuba2_tpu_torch.ops import intersect, sweep_kernel as sk
from mitsuba2_tpu_torch.tools import shape_ceiling as sc

C, R = 128, 2048
ID_SHARE = 0.999


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _dot3T_f32(a, b):
    import jax
    import jax.numpy as jnp
    return jax.lax.dot_general(
        a, b, (((0,), (0,)), ((), ())), precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)


def test_product_matches_jax_dot3T():
    import jax.numpy as jnp
    from mitsuba2_tpu.ops import megakernel as mk
    W, odh = normal((4, 3 * C), 0), normal((4, 2 * R), 1)
    got = sk.sweep_product_reference(torch.as_tensor(W),
                                     torch.as_tensor(odh)).numpy()
    assert got.shape == (3 * C, 2 * R)
    want = np.asarray(mk._dot3T(jnp.asarray(W), jnp.asarray(odh)))
    assert np.abs(got - want).max() <= 2e-4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mk, "_dot3T", _dot3T_f32)
        want = np.asarray(mk._dot3T(jnp.asarray(W), jnp.asarray(odh)))
    scale = np.abs(W).T.astype(np.float64) @ np.abs(odh).astype(np.float64)
    assert (np.abs(got - want) <= 1e-6 * scale).all()


def test_product_matches_tpu_ceiling_kernel():
    """benchmarks/mxu_shape_ceiling.py's inline kernel (:44-52) at 2
    chunks x 2 iterations x 1 tile, through the same pallas_call in
    interpret mode, against the port's product sliced and summed the same
    way."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from mitsuba2_tpu.ops import megakernel as mk
    n_chunks, iters, tiles = 2, 2, 1
    W, odh = normal((4, n_chunks * 3 * C), 2), normal((4, 2 * R), 3)

    def kernel(w_ref, odh_ref, out_ref):
        acc = jnp.zeros((8, R), jnp.float32)
        for it in range(iters):
            for c in range(n_chunks):
                Wc = w_ref[:, c * 3 * C:(c + 1) * 3 * C]
                OD = mk._dot3T(Wc, odh_ref[:])
                acc = acc + OD[(it % 48) * 8:(it % 48) * 8 + 8, :R]
        out_ref[...] = acc

    w, o = jnp.asarray(W), jnp.asarray(odh)
    f = pl.pallas_call(
        kernel, grid=(tiles,),
        in_specs=[pl.BlockSpec(w.shape, lambda i: (0, 0)),
                  pl.BlockSpec(o.shape, lambda i: (0, 0))],
        out_specs=pl.BlockSpec((8, R), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((tiles * 8, R), jnp.float32),
        interpret=True)
    want = np.asarray(f(w, o))
    P = sk.sweep_product_reference(torch.as_tensor(W),
                                   torch.as_tensor(odh)).numpy()
    got = sum(P[c * 3 * C + (it % 48) * 8:c * 3 * C + (it % 48) * 8 + 8, :R]
              for it in range(iters) for c in range(n_chunks))
    assert want.shape == got.shape == (8, R)
    assert np.abs(got - want).max() <= 4e-4


def test_product_layout_is_k2s_woop_dots():
    """The product of ``woop_product_rows`` and ``ray_columns`` is K2's
    [o,1] . w and [d,0] . w of every ray and face row, bit for bit."""
    woop = torch.as_tensor(normal((16, 12), 4))
    o, d = (torch.as_tensor(x) for x in normal((2, 8, 3), 5))
    P = sk.sweep_product_reference(sk.woop_product_rows(woop),
                                   sk.ray_columns(o, d))
    for a in range(3):
        po, pd = intersect._woop_dots(woop[:, 4 * a:4 * a + 4], o, d)
        assert torch.equal(P[16 * a:16 * (a + 1), :8], po.T)
        assert torch.equal(P[16 * a:16 * (a + 1), 8:], pd.T)


def test_sweep_reference_matches_closest_hit_reference():
    """Each iteration k is K2's closest hit over [k * MINT_STEP, inf): the
    last one's t, uv and face ids and the count of iterations that hit,
    on 128 random faces x 256 rays."""
    iters, F, n = 16, 128, 256
    woop = torch.as_tensor(normal((F, 12), 6))
    o, d = (torch.as_tensor(x) for x in normal((2, n, 3), 7))
    t, uv, prim, hits = sk.sweep_reference(woop, o, d, iters)
    count = torch.zeros(n, dtype=torch.int32)
    for k in range(iters):
        rt, ruv, rprim = intersect.closest_hit_reference(
            woop, o, d, torch.full((n,), k * sk.MINT_STEP),
            torch.full((n,), float("inf")))
        count += (rprim >= 0).to(torch.int32)
    assert torch.equal(prim, rprim) and torch.equal(hits, count)
    assert torch.equal(t, rt) and torch.equal(uv, ruv)
    assert 0.3 < float((prim >= 0).float().mean()) < 1.0
    # the iterations differ: some rays hit in some of them only
    assert bool(((hits > 0) & (hits < iters)).any())


def test_wrapper_runs_plain_version_on_cpu():
    woop = torch.as_tensor(normal((40, 12), 8))
    o, d = (torch.as_tensor(x) for x in normal((2, 33, 3), 9))
    sk.reset_launch_counts()
    for shared in (True, False):
        got = sk.sweep(woop, o, d, 3, shared)
        want = sk.sweep_reference(woop, o, d, 3)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sum(sk.sweep.launches_by_kernel.values()) == 0
    with pytest.raises(ValueError, match="shared"):
        sk.sweep(torch.zeros((sk.MAX_SHARED_FACES + 1, 12)), o, d, 1)
    with pytest.raises(ValueError, match="float32"):
        sk.sweep(woop.double(), o, d, 1)
    assert sk.kernel_name(True) == "sweep_kernel[shared]"
    assert sk.kernel_name(False) == "sweep_kernel[global]"


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
def test_cuda_sweep_matches_plain_version(shared):
    """Each instantiation on the card against its plain version, at a
    ragged ray count and a table in shared memory or beyond L1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    F, n, iters = (2048, 4099, 5) if shared else (20011, 1027, 2)
    woop = torch.as_tensor(normal((F, 12), 10)).cuda()
    o, d = (torch.as_tensor(x).cuda() for x in normal((2, n, 3), 11))
    name = sk.kernel_name(shared)
    before = sk.sweep.launches_by_kernel[name]
    t, uv, prim, hits = sk.sweep(woop, o, d, iters, shared)
    torch.cuda.synchronize()
    assert sk.sweep.launches_by_kernel[name] == before + 1
    rt, ruv, rprim, rhits = sk.sweep_reference(woop, o, d, iters)
    same = prim == rprim
    assert same.float().mean() >= ID_SHARE
    assert (hits == rhits).float().mean() >= ID_SHARE
    ok = same & (rprim >= 0)
    assert ok.float().mean() > 0.3
    torch.testing.assert_close(t[ok] / rt[ok].abs().clamp(min=1.0),
                               rt[ok] / rt[ok].abs().clamp(min=1.0),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(uv[ok], ruv[ok], rtol=0, atol=1e-5)


def numpy_box_sweep(lines, o, d, iters):
    """Every ray against every child box of the lines (L, 32), in numpy
    float32 -> (nearest entry t of the last iteration, hits summed)."""
    W = 4
    lo = lines[:, :3 * W].reshape(-1, 3, W).transpose(0, 2, 1).reshape(-1, 3)
    hi = lines[:, 3 * W:6 * W].reshape(-1, 3, W).transpose(0, 2, 1).reshape(
        -1, 3)
    inv = (np.float32(1) / np.where(np.abs(d) > np.float32(1e-12), d,
                                    np.float32(1e-12))).astype(np.float32)
    a = (lo[None] - o[:, None]) * inv[:, None]
    b = (hi[None] - o[:, None]) * inv[:, None]
    near_in = np.minimum(a, b).max(-1)
    far = np.maximum(a, b).min(-1)
    hits = np.zeros(len(o), np.int32)
    for k in range(iters):
        tn = np.maximum(near_in, np.float32(k * sk.MINT_STEP))
        hit = tn <= far
        hits += hit.sum(1).astype(np.int32)
    return np.where(hit, tn, np.inf).min(1).astype(np.float32), hits


def test_box_sweep_reference_matches_numpy_slab():
    """The box ceiling's plain version on 64 lines (256 boxes) x 300 rays,
    4 iterations, against the numpy slab test, bit for bit; the
    iterations differ (mint grows), and both hits and misses occur."""
    lines, o, d = sc.box_inputs(64, 300, "cpu", seed=3)
    near, hits = sk.box_sweep_reference(lines, o, d, 4)
    want_near, want_hits = numpy_box_sweep(lines.numpy(), o.numpy(),
                                           d.numpy(), 4)
    np.testing.assert_array_equal(near.numpy(), want_near)
    np.testing.assert_array_equal(hits.numpy(), want_hits)
    assert bool(torch.isinf(near).any()) and bool(torch.isfinite(near).any())
    assert len(set(hits.tolist())) > 10
    # the iterations differ: some rays hit a box in some of them only
    assert bool((hits % 4 != 0).any())


def test_box_wrapper_runs_plain_version_on_cpu():
    lines, o, d = sc.box_inputs(9, 33, "cpu")
    sk.reset_launch_counts()
    for shared in (True, False):
        got = sk.box_sweep(lines, o, d, 3, shared)
        want = sk.box_sweep_reference(lines, o, d, 3)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sum(sk.sweep.launches_by_kernel.values()) == 0
    with pytest.raises(ValueError, match="shared"):
        sk.box_sweep(torch.zeros((sk.MAX_SHARED_LINES + 1, 32)), o, d, 1)
    with pytest.raises(ValueError, match="float32"):
        sk.box_sweep(lines.double(), o, d, 1)
    assert sk.kernel_name(True, boxes=True) == "sweep_kernel[boxes, shared]"
    # the ceiling's line layout is the walk's: boxes lo <= hi, refs 0
    W = 4
    ints = lines.view(torch.int32)
    assert bool((lines[:, :3 * W] <= lines[:, 3 * W:6 * W]).all())
    assert bool((ints[:, 6 * W:7 * W] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shared, L", [(True, 1024), (True, 1023),
                                      (False, 8191), (False, 1)])
def test_cuda_box_sweep_matches_plain_version(shared, L):
    """Each box instantiation on the card against its plain version, bit
    for bit, at a ragged ray count, the line count whole or ragged against
    the loop's unroll and lines ahead (one line: every line ahead the
    last)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, iters = (4099, 3) if shared else (1027, 1)
    lines, o, d = sc.box_inputs(L, n, "cuda", seed=12)
    name = sk.kernel_name(shared, boxes=True)
    before = sk.sweep.launches_by_kernel[name]
    near, hits = sk.box_sweep(lines, o, d, iters, shared)
    torch.cuda.synchronize()
    assert sk.sweep.launches_by_kernel[name] == before + 1
    rnear, rhits = sk.box_sweep_reference(lines, o, d, iters)
    assert torch.equal(hits, rhits)
    assert torch.equal(near.view(torch.int32), rnear.view(torch.int32))
