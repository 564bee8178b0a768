"""The scene's ray queries: K2's plain twin (ops/intersect.py) against the
JAX package's ``WoopIntersector`` (Pallas interpret mode), the port's
``Scene.ray_intersect_preliminary`` and ``Scene.ray_test`` against the JAX
``Scene``'s, and the K2 kernel against its plain twin on the card.

Tolerances. Against ``WoopIntersector``: the reference forms its Woop
products in three bf16 passes (``_dot3``, about 2^-16 relative), which
moves t by up to 3.4e-4 relative and uv by up to 6.1e-4 on this mesh;
``_dot3`` is patched to a float32 product for the comparison (the JAX
package is not edited), and the bar is then equal face ids on at least
99.9% of rays, t within 1e-5 relative and uv within 1e-5 on the rest.
Measured: every face id equal, t within 4.9e-7 relative, uv within 8.5e-6.
Against the
JAX ``Scene``: on the CPU it intersects with Möller-Trumbore, not Woop
rows, so the two can break an exact tie between coplanar faces (the
matpreview stand's bottom lies in the floor's plane) differently. The bar
is equal face ids, or a tie at an equal t, on at least 99.9% of rays and
equal face ids on at least 99%; equal shapes and hits on the rays whose
face ids agree; t within 1e-5 relative (1e-6 absolute for hits nearer than
0.1) and uv within 1e-3 (a thin face's barycentrics are ill-conditioned in
either form) on them. Measured: biggeo and hero every face id equal, t
within 2.7e-6 relative, uv within 1.6e-5; matpreview 2 coplanar ties of
1024 rays broken the other way.
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core.ray import Ray
from mitsuba2_tpu_torch.ops import intersect, intersect_kernel as ik
from tests.test_torch_bvh import _jax_scene_and_port_scene
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()

N_RAYS = 1024
ID_SHARE = 0.999


def rays(n, seed, center=(0.0, 0.2, 0.0), spread=0.8):
    """(o, d, mint, maxt) float32 numpy: half the rays aimed at the
    region around ``center`` from outside it, half anywhere; some segments
    start late or end early."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)) * 3.0 + center
    d = rng.normal(size=(n, 3))
    d[: n // 2] = center - o[: n // 2] + rng.normal(
        size=(n // 2, 3)) * spread
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mint = np.where(rng.uniform(size=n) < 0.2, 1.5, 1e-4)
    maxt = np.where(rng.uniform(size=n) < 0.2, 3.0, np.inf)
    return tuple(x.astype(np.float32) for x in (o, d, mint, maxt))


def _t(x):
    return torch.as_tensor(x)


@pytest.fixture(scope="module")
def biggeo():
    """The JAX and the port's 1,220-face biggeo scenes."""
    return _jax_scene_and_port_scene("biggeo")


def test_plain_twin_matches_jax_woop_intersector(biggeo):
    import jax.numpy as jnp
    from mitsuba2_tpu.ops import intersect_pallas as ip
    sj, st = biggeo
    o, d, mint, maxt = rays(N_RAYS, 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ip, "_dot3", lambda a, b: jnp.dot(
            a, b, precision="highest", preferred_element_type=jnp.float32))
        woop = ip.WoopIntersector(st.v0, st.e1, st.e2, interpret=True)
        tj, uvj, pj = (np.asarray(x) for x in woop(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(mint),
            jnp.asarray(maxt)))
    t, uv, prim = intersect.closest_hit_reference(
        st.tables.woop, _t(o), _t(d), _t(mint), _t(maxt))
    same = prim.numpy() == pj
    assert same.mean() >= ID_SHARE
    hit = same & (pj >= 0)
    assert 0.2 < hit.mean() < 0.9
    np.testing.assert_allclose(t.numpy()[hit], tj[hit], rtol=1e-5, atol=0)
    np.testing.assert_allclose(uv.numpy()[hit], uvj[hit], rtol=0, atol=1e-5)
    assert np.isinf(t.numpy()[~hit & same]).all()
    assert (uv.numpy()[prim.numpy() < 0] == 0).all()
    hit_any = intersect.any_hit_reference(
        st.tables.woop, _t(o), _t(d), _t(mint), _t(maxt)).numpy()
    assert (hit_any == np.isfinite(tj)).mean() >= ID_SHARE


def test_wrapper_runs_plain_twin_on_cpu(biggeo):
    st = biggeo[1]
    args = tuple(_t(x) for x in rays(64, 2))
    before = (ik.isect_closest.launches, ik.isect_any.launches)
    t, uv, prim = ik.isect_closest(st.tables, *args)
    hit = ik.isect_any(st.tables, *args)
    assert (ik.isect_closest.launches, ik.isect_any.launches) == before
    assert prim.dtype == torch.int32 and t.shape == (64,)
    assert uv.shape == (64, 2) and hit.dtype == torch.bool
    want = intersect.closest_hit_reference(st.tables.woop, *args)
    for a, b in zip((t, uv, prim), want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="contiguous float32"):
        ik.isect_any(st.tables, args[0].double(), *args[1:])


def test_ray_from_numpy_lands_on_the_scene_device(biggeo):
    """A Ray made from numpy goes where scenes load (``set_device``), so it
    meets the scene's tables without the caller moving it."""
    st = biggeo[1]
    o, d, mint, maxt = rays(64, 6)
    ray = Ray.make(o, d, mint=mint, maxt=maxt)
    assert all(x.device == st.device for x in ray)
    hits = st.ray_intersect_preliminary(ray)
    assert hits.t.device == st.device and bool(torch.isfinite(hits.t).any())
    prev = mt.device()
    try:
        mt.set_device("meta")
        assert all(x.device.type == "meta" for x in Ray.make(o, d))
        # a tensor's own device wins
        assert all(x.device.type == "cpu" for x in Ray.make(_t(o), _t(d)))
    finally:
        mt.set_device(prev)


def _queries(sj, st, o, d, mint, maxt, active):
    from mitsuba2_tpu.core.ray import Ray as RayJ
    import jax.numpy as jnp
    rj = RayJ.make(jnp.asarray(o), jnp.asarray(d), mint=jnp.asarray(mint),
                   maxt=jnp.asarray(maxt))
    pj = sj.ray_intersect_preliminary(rj, jnp.asarray(active))
    hj = np.asarray(sj.ray_test(rj, jnp.asarray(active)))
    rt = Ray.make(o, d, mint=mint, maxt=maxt)
    pt = st.ray_intersect_preliminary(rt, _t(active))
    ht = st.ray_test(rt, _t(active)).numpy()
    return pj, hj, pt, ht


@pytest.mark.parametrize("name", ["biggeo", "hero", "matpreview"])
def test_scene_queries_match_jax_scene(name):
    sj, st = _jax_scene_and_port_scene(name)
    center = {"biggeo": (0, 0.2, 0), "hero": (0, 0, 1.1),
              "matpreview": (0, 0, 1.0)}[name]
    o, d, mint, maxt = rays(N_RAYS, 3, center)
    active = np.random.default_rng(4).uniform(size=N_RAYS) < 0.9
    pj, hj, pt, ht = _queries(sj, st, o, d, mint, maxt, active)
    prim_j = np.asarray(pj.prim_idx)
    prim_t = pt.prim_idx.numpy()
    same = prim_t == prim_j
    tie = ~same & (prim_t >= 0) & (prim_j >= 0) & np.isclose(
        pt.t.numpy(), np.asarray(pj.t), rtol=1e-6, atol=0)
    assert (same | tie).mean() >= ID_SHARE and same.mean() >= 0.99
    assert (pt.shape_idx.numpy() == np.asarray(pj.shape_idx))[same].all()
    hit = same & (prim_j >= 0)
    assert 0.2 < hit.mean() < 0.9
    assert (prim_t[~active] == -1).all() and not ht[~active].any()
    np.testing.assert_allclose(pt.t.numpy()[hit], np.asarray(pj.t)[hit],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pt.prim_uv.numpy()[hit],
                               np.asarray(pj.prim_uv)[hit], rtol=0,
                               atol=1e-3)
    assert np.isinf(pt.t.numpy()[same & (prim_j < 0)]).all()
    assert (ht == hj)[same].all()
    if name == "matpreview":
        # the sphere: prim id F + 0, its shape, uv 0
        sph = prim_t == st.tables.n_faces
        assert sph.any() and (pt.prim_uv.numpy()[sph] == 0).all()
        assert (pt.shape_idx.numpy()[sph]
                == st.shapes.index(next(s for s in st.shapes
                                        if s.is_analytic()))).all()


@pytest.mark.cuda
def test_cuda_isect_matches_plain_twin():
    """K2 on the card against its plain twin, on a mesh above the
    shared-memory tier's size: equal face ids, t and uv on every ray (the
    kernel's face test is unfused, in the twin's order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mitsuba2_tpu_torch.python.test.scenes import bumpy_sphere_dict
    mt.set_variant("scalar_rgb")
    prev = mt.device()
    try:
        mt.set_device("cuda")
        scene = mt.load_dict(bumpy_sphere_dict(8, 8, 2, 3, 64, 40))
    finally:
        mt.set_device(prev)
    args = tuple(_t(x).cuda() for x in rays(1 << 15, 5))
    before = (ik.isect_closest.launches, ik.isect_any.launches)
    t, uv, prim = ik.isect_closest(scene.tables, *args)
    hit = ik.isect_any(scene.tables, *args)
    torch.cuda.synchronize()
    assert (ik.isect_closest.launches, ik.isect_any.launches) == (
        before[0] + 1, before[1] + 1)
    rt, ruv, rprim = intersect.closest_hit_reference(scene.tables.woop,
                                                     *args)
    same = prim == rprim
    assert same.float().mean() >= ID_SHARE
    ok = same & (rprim >= 0)
    torch.testing.assert_close(t[ok], rt[ok], rtol=1e-6, atol=0)
    torch.testing.assert_close(uv[ok], ruv[ok], rtol=0, atol=1e-6)
    rhit = intersect.any_hit_reference(scene.tables.woop, *args)
    assert (hit == rhit).float().mean() >= ID_SHARE
