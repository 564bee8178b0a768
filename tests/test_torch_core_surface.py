"""The rest of the core's public surface against the JAX package's, on the
same inputs made from a numpy seed: the TEA helpers and PCG32 bit for
bit, transforms (AnimatedTransform at t = 0, 0.25, 0.5, 1),
distributions, bounding boxes and the math helpers within 1e-6, ray
differentials, uv partials and normal derivatives on
tests/test_core_math.py's scenes within 1e-5, and the render layer's
small names (records, shapes' areas, the scene's bounding sphere and
media flags, BSDF and emitter bases, samplers, textures)."""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mitsuba2_tpu as mj
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu.core import (bbox as bbox_j, distr_1d as d1_j,
                               distr_2d as d2_j, math as math_j, rng as rng_j)
from mitsuba2_tpu.core.transform import (AnimatedTransform as AnimJ,
                                         Transform as TJ)
from mitsuba2_tpu_torch.core import (bbox as bbox_t, distr_1d as d1_t,
                                     distr_2d as d2_t, math as math_t,
                                     rng as rng_t)
from mitsuba2_tpu_torch.core.transform import (AnimatedTransform as AnimT,
                                               Transform as TT)
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()

TOL = 1e-6
DIFF_TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------- rng

def _words(n=2048, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 2 ** 32, n, dtype=np.uint64),
            rs.randint(0, 2 ** 32, n, dtype=np.uint64))


def test_tea_helpers_bit_for_bit():
    a, b = _words()
    ja, jb = jnp.asarray(a, jnp.uint32), jnp.asarray(b, jnp.uint32)
    ta, tb = torch.as_tensor(a.astype(np.int64)), \
        torch.as_tensor(b.astype(np.int64))
    for rounds in (1, 4):
        for got, want in zip(rng_t.sample_tea_64(ta, tb, rounds),
                             rng_j.sample_tea_64(ja, jb, rounds)):
            assert np.array_equal(_np(got), np.asarray(want, np.int64))
        got = rng_t.sample_tea_float32(ta, tb, rounds)
        assert got.dtype == torch.float32
        assert np.array_equal(_np(got), np.asarray(
            rng_j.sample_tea_float32(ja, jb, rounds)))
    assert rng_t.sample_tea_float is rng_t.sample_tea_float32
    for dim in (0, 7, 2 ** 31 + 5):
        for got, want in zip(rng_t.uniform_float2(ta, dim),
                             rng_j.uniform_float2(ja, dim)):
            assert np.array_equal(_np(got), np.asarray(want))
        assert np.array_equal(_np(rng_t.uniform_uint32(ta, dim)), np.asarray(
            rng_j.uniform_uint32(ja, dim), np.int64))
    assert rng_t.U32 == torch.int64


def test_pcg32_streams():
    # O'Neill's pcg32-demo, seeded with (42, 54)
    oneill = [0xa15c02b7, 0x7b47f409, 0xba1d3330, 0x83d2f293, 0xbfa4784b,
              0xcbed606e]
    p = rng_t.PCG32(42, 54)
    assert [p.next_uint32() for _ in range(6)] == oneill
    for seeds in ((), (42, 54), (7, 3)):
        pt, pj = rng_t.PCG32(*seeds), rng_j.PCG32(*seeds)
        assert [pt.next_uint32() for _ in range(16)] \
            == [pj.next_uint32() for _ in range(16)]
        assert [pt.next_float32() for _ in range(16)] \
            == [pj.next_float32() for _ in range(16)]
    assert (rng_t.PCG32_DEFAULT_STATE, rng_t.PCG32_DEFAULT_STREAM,
            rng_t.PCG32_MULT) == (rng_j.PCG32_DEFAULT_STATE,
                                  rng_j.PCG32_DEFAULT_STREAM,
                                  rng_j.PCG32_MULT)


# ---------------------------------------------------------- transforms

def _pts(n=256, seed=3):
    return np.random.RandomState(seed).randn(n, 3).astype(np.float32)


def _composed(T):
    return (T.translate([1.0, -2.0, 0.5]) @ T.rotate([1, 2, 3], 40.0)
            @ T.scale([2.0, 0.5, 1.5]))


def test_transform_methods_match_jax():
    p = _pts()
    tt, tj = _composed(TT), _composed(TJ)
    _close(tt.transform_normal(torch.as_tensor(p)),
           tj.transform_normal(jnp.asarray(p)))
    o_t, d_t = tt.transform_ray(torch.as_tensor(p), torch.as_tensor(p[::-1]
                                                                    .copy()))
    o_j, d_j = tj.transform_ray(jnp.asarray(p), jnp.asarray(p[::-1].copy()))
    _close(o_t, o_j)
    _close(d_t, d_j)
    _close(tt.translation, tj.translation)
    for near, far in ((0.1, 100.0), (1.0, 3.0)):
        _close(TT.orthographic(near, far).matrix,
               TJ.orthographic(near, far).matrix)
    for t_, j_ in ((tt, tj), (TT.rotate([0, 1, 0], 30), TJ.rotate([0, 1, 0],
                                                                  30)),
                   (TT.translate([1, 2, 3]), TJ.translate([1, 2, 3]))):
        assert t_.has_scale() == j_.has_scale()
    assert tt.has_scale() and not TT.translate([1, 2, 3]).has_scale()


def _animated(T, A):
    a = A()
    a.append(0.0, T.translate([0, 0, 0]))
    a.append(0.5, T.translate([1, 0, 0.5]) @ T.rotate([0, 0, 1], 60)
             @ T.scale([1.0, 2.0, 1.0]))
    a.append(1.0, T.translate([2, 0, 0]) @ T.rotate([1, 1, 0], 170))
    return a


@pytest.mark.parametrize("t", [0.0, 0.25, 0.5, 1.0])
def test_animated_transform_matches_jax(t):
    at, aj = _animated(TT, AnimT), _animated(TJ, AnimJ)
    _close(at.eval(t).matrix, aj.eval(t).matrix)
    _close(at.eval(t).inverse_transpose, aj.eval(t).inverse_transpose)
    p = _pts(16)
    _close(at.eval(t).transform_point(torch.as_tensor(p)),
           aj.eval(t).transform_point(jnp.asarray(p)))


def test_animated_transform_surface():
    at, aj = _animated(TT, AnimT), _animated(TJ, AnimJ)
    assert not at.is_static and aj.is_static == at.is_static
    for got, want in zip(at.translation_bounds(), aj.translation_bounds()):
        _close(got, want)
    # the JAX tests' forms: a one-element time, the empty and the static
    # transform
    _close(at.eval(torch.tensor([0.5])).matrix, aj.eval(0.5).matrix)
    assert np.array_equal(AnimT().eval(0.3).matrix, np.eye(4))
    one = AnimT()
    one.append(2.0, TT.translate([1, 2, 3]))
    assert one.is_static
    _close(one.eval(7.0).matrix, TT.translate([1, 2, 3]).matrix)


def test_dictio_keeps_animated_transform():
    from mitsuba2_tpu_torch.core.dictio import _fill_props
    from mitsuba2_tpu_torch.core.properties import (NamedReference,
                                                    Properties)
    anim = _animated(TT, AnimT)
    props = Properties("perspective")
    _fill_props(props, {"to_world": anim}, {})
    assert props["to_world"] is anim
    props.mark_queried("to_world")
    assert "to_world" not in props.unqueried()
    assert isinstance(NamedReference("x"), str)


# ------------------------------------------------------- distributions

def test_continuous_distribution_matches_jax():
    rs = np.random.RandomState(4)
    pdf = (rs.rand(37) + 0.05).astype(np.float32)
    pdf[5] = 0.0
    ct = d1_t.ContinuousDistribution.create([2.0, 5.0], pdf)
    cj = d1_j.ContinuousDistribution.create([2.0, 5.0], jnp.asarray(pdf))
    assert ct.size == cj.size == 37
    for a, b in zip((ct.cdf, ct.integral, ct.normalization, ct.interval_size),
                    (cj.cdf, cj.integral, cj.normalization, cj.interval_size)):
        _close(a, b)
    u = rs.rand(4096).astype(np.float32)
    x = rs.uniform(1.5, 5.5, 4096).astype(np.float32)
    for name in ("eval_pdf", "eval_pdf_normalized", "eval_cdf"):
        _close(getattr(ct, name)(torch.as_tensor(x)),
               getattr(cj, name)(jnp.asarray(x)), 1e-5)
    _close(ct.sample(torch.as_tensor(u)), cj.sample(jnp.asarray(u)))
    for got, want in zip(ct.sample_pdf(torch.as_tensor(u)),
                         cj.sample_pdf(jnp.asarray(u))):
        _close(got, want, 1e-5)
    # the JAX battery's shape: mass near the center
    d = d1_t.ContinuousDistribution.create([0.0, 1.0],
                                           [0.0, 1.0, 2.0, 1.0, 0.0])
    s = d.sample(torch.linspace(0.01, 0.99, 1024))
    assert abs(float(s.median()) - 0.5) < 0.02


def test_discrete_distribution_extras_match_jax():
    rs = np.random.RandomState(5)
    pmf = rs.rand(40).astype(np.float32)
    pmf[[3, 17]] = 0.0
    dt = d1_t.DiscreteDistribution.create(pmf)
    dj = d1_j.DiscreteDistribution.create(jnp.asarray(pmf))
    idx = np.arange(40)
    _close(dt.eval_cdf_normalized(torch.as_tensor(idx)),
           dj.eval_cdf_normalized(jnp.asarray(idx)))
    u = rs.rand(4096).astype(np.float32)
    for got, want in zip(dt.sample_pmf(torch.as_tensor(u)),
                         dj.sample_pmf(jnp.asarray(u))):
        _close(got, want)
    for got, want in zip(dt.sample_reuse_pmf(torch.as_tensor(u)),
                         dj.sample_reuse_pmf(jnp.asarray(u))):
        _close(got, want)


def test_2d_distribution_extras_match_jax():
    rs = np.random.RandomState(6)
    pmf = (rs.rand(5, 7) + 0.01).astype(np.float32)
    dt = d2_t.DiscreteDistribution2D.create(torch.as_tensor(pmf))
    dj = d2_j.DiscreteDistribution2D.create(jnp.asarray(pmf))
    pos = np.stack([rs.randint(0, 7, 512), rs.randint(0, 5, 512)], -1)
    _close(dt.eval(torch.as_tensor(pos)), dj.eval(jnp.asarray(pos)))
    _close(dt.pdf(torch.as_tensor(pos)), dj.pdf(jnp.asarray(pos)))
    data = (rs.rand(8, 12) + 0.1).astype(np.float32)
    assert d2_t.Hierarchical2D.create(data).res \
        == tuple(d2_j.Hierarchical2D.create(jnp.asarray(data)).res)


# -------------------------------------------------------- bbox and math

def test_bounding_box_matches_jax():
    p = _pts(64)
    bt = bbox_t.BoundingBox.from_points(torch.as_tensor(p))
    bj = bbox_j.BoundingBox.from_points(jnp.asarray(p))
    _close(bt.min, bj.min)
    _close(bt.max, bj.max)
    q = _pts(256, 9) * 1.5
    assert np.array_equal(_np(bt.contains(torch.as_tensor(q))),
                          np.asarray(bj.contains(jnp.asarray(q))))
    _close(bt.distance_squared(torch.as_tensor(q)),
           bj.distance_squared(jnp.asarray(q)))
    assert np.array_equal(_np(bt.contains(torch.as_tensor(q), strict=True)),
                          np.asarray(bj.contains(jnp.asarray(q),
                                                 strict=True)))
    _close(bt.center, bj.center)
    _close(bt.extents, bj.extents)
    _close(bt.surface_area(), bj.surface_area(), 1e-5)
    for got, want in zip(bt.bounding_sphere(), bj.bounding_sphere()):
        _close(got, want)
    other_t = bbox_t.BoundingBox(torch.zeros(3), torch.full((3,), 4.0))
    other_j = bbox_j.BoundingBox(jnp.zeros(3), jnp.full((3,), 4.0))
    e_t, e_j = bt.expand(other_t), bj.expand(other_j)
    _close(e_t.min, e_j.min)
    _close(e_t.max, e_j.max)
    inv = bbox_t.BoundingBox.invalid((2,))
    assert not bool(inv.valid().any()) and bool(bt.valid())
    assert bool(inv.expand(bbox_t.BoundingBox(torch.zeros(2, 3),
                                              torch.ones(2, 3))).valid()
                .all())


def test_math_helpers_match_jax():
    rs = np.random.RandomState(7)
    x = rs.uniform(-1, 1, 512).astype(np.float32)
    for order in (0, 1, 2, 5, 9):
        _close(math_t.legendre_p(order, torch.as_tensor(x)),
               math_j.legendre_p(order, jnp.asarray(x)), 1e-5)
        for got, want in zip(math_t.legendre_pd(order, torch.as_tensor(x)),
                             math_j.legendre_pd(order, jnp.asarray(x))):
            _close(got, want, 1e-4)
    theta = rs.uniform(0, np.pi, 512).astype(np.float32)
    phi = rs.uniform(-np.pi, np.pi, 512).astype(np.float32)
    d_t = math_t.spherical_direction(torch.as_tensor(theta),
                                     torch.as_tensor(phi))
    _close(d_t, math_j.spherical_direction(jnp.asarray(theta),
                                           jnp.asarray(phi)))
    for got, want in zip(math_t.spherical_coordinates(d_t),
                         math_j.spherical_coordinates(jnp.asarray(_np(d_t)))):
        _close(got, want, 1e-5)
    c = rs.uniform(-0.1, 2.0, 512).astype(np.float32)
    for name in ("linear_to_srgb", "srgb_to_linear"):
        _close(getattr(math_t, name)(torch.as_tensor(c)),
               getattr(math_j, name)(jnp.asarray(c)))
    a, b = _pts(32, 1), _pts(32, 2)
    _close(math_t.abs_dot(torch.as_tensor(a), torch.as_tensor(b), True),
           math_j.abs_dot(jnp.asarray(a), jnp.asarray(b), True))
    _close(math_t.clamp(torch.as_tensor(x), -0.5, 0.25),
           math_j.clamp(jnp.asarray(x), -0.5, 0.25))
    _close(math_t.fmadd(torch.as_tensor(x), 3.0, 1.0),
           math_j.fmadd(jnp.asarray(x), 3.0, 1.0))
    _close(math_t.rcp(torch.as_tensor(c[c > 0.1])),
           math_j.rcp(jnp.asarray(c[c > 0.1])))
    _close(math_t.vec2(torch.as_tensor(x), 2.0),
           math_j.vec2(jnp.asarray(x), 2.0))
    assert [_np(u).tolist() for u in math_t.unstack(torch.as_tensor(a))] \
        == [np.asarray(u).tolist() for u in math_j.unstack(jnp.asarray(a))]
    for name in ("FourPi", "Infinity", "SqrtTwo", "InvSqrtTwo"):
        assert float(getattr(math_t, name)) == float(getattr(math_j, name))
    with pytest.raises(NotImplementedError):
        math_t.find_interval(4, lambda i: i)


def test_ray_differential_surface():
    from mitsuba2_tpu_torch.core.ray import Ray, RayDifferential
    o, d = torch.as_tensor(_pts(8)), torch.as_tensor(_pts(8, 4))
    ray = Ray.make(o, d)
    rd = RayDifferential.from_ray(ray)
    assert not rd.has_differentials and bool((rd.o_x == 0).all())
    rd = RayDifferential(ray, o + 1.0, o - 1.0, d + 0.5, d - 0.5, True)
    half = rd.scale_differential(0.5)
    _close(half.o_x, o + 0.5)
    _close(half.d_y, d - 0.25)
    assert half.has_differentials
    assert torch.equal(ray.replace(maxt=ray.mint).maxt, ray.mint)


def test_progress_reporter_and_constants():
    from mitsuba2_tpu.core.logger import ProgressReporter as PJ
    from mitsuba2_tpu_torch.core.logger import ProgressReporter as PT
    outs = []
    for cls in (PT, PJ):
        buf = io.StringIO()
        pr = cls("TestOp", total=4, stream=buf)
        for i in range(4):
            pr.update(i + 1)
        # the timings aside, the two print the same bars
        outs.append([line.split("(ETA")[0]
                     for line in buf.getvalue().split("\r")])
    assert outs[0] == outs[1] and "100.0%" in outs[0][-1]
    import importlib
    vj = importlib.import_module("mitsuba2_tpu.variants")
    vt = importlib.import_module("mitsuba2_tpu_torch.variants")
    assert (vt.MTS_WAVELENGTH_MIN, vt.MTS_WAVELENGTH_MAX) \
        == (vj.MTS_WAVELENGTH_MIN, vj.MTS_WAVELENGTH_MAX)


# --------------------------------------------- differentials (the JAX tests')

def _camera(pkg):
    return pkg.load_dict({
        "type": "perspective", "fov": 45.0,
        "to_world": pkg.Transform.look_at([0, 0, 3], [0, 0, 0], [0, 1, 0]),
        "film": {"type": "hdrfilm", "width": 64, "height": 64,
                 "rfilter": {"type": "box"}},
        "sampler": {"type": "independent", "sample_count": 1}})


def _rect_scene(pkg, scene_cls):
    rect = pkg.load_dict({"type": "rectangle"})
    return scene_cls(shapes=[rect.expand()[0]])


@pytest.fixture(scope="module")
def differentials():
    """tests/test_core_math.py:243-282's uv partials in both packages at
    a few more positions -> {name: (port, JAX)}."""
    from mitsuba2_tpu.render.scene import Scene as SJ
    from mitsuba2_tpu_torch.render.scene import Scene as ST
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    pos = np.asarray([[0.5, 0.5], [0.3, 0.6], [0.45, 0.52], [0.62, 0.38]],
                     np.float32)
    n = len(pos)
    rd_t, _, _ = _camera(mt).sample_ray_differential(
        0.0, torch.zeros(n), torch.as_tensor(pos), torch.zeros((n, 2)))
    rd_j, _ = _camera(mj).sample_ray_differential(
        0.0, jnp.zeros(n), jnp.asarray(pos), jnp.zeros((n, 2)), True)
    st, sj = _rect_scene(mt, ST), _rect_scene(mj, SJ)
    out = {"rd": (rd_t, rd_j)}
    for scale in (1.0, 0.5):
        a = rd_t.scale_differential(scale)
        b = rd_j.scale_differential(scale)
        out[scale] = (st.ray_intersect(a.ray).compute_uv_partials(a),
                      sj.ray_intersect(b.ray).compute_uv_partials(b))
    return out


def test_sample_ray_differential_matches_jax(differentials):
    rd_t, rd_j = differentials["rd"]
    assert rd_t.has_differentials and rd_j.has_differentials
    for name in ("o_x", "o_y", "d_x", "d_y"):
        _close(getattr(rd_t, name), getattr(rd_j, name), DIFF_TOL)
    _close(rd_t.ray.o, rd_j.ray.o, DIFF_TOL)
    _close(rd_t.ray.d, rd_j.ray.d, DIFF_TOL)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_uv_partials_match_jax(differentials, scale):
    si_t, si_j = differentials[scale]
    assert si_t.has_uv_partials() and bool(si_t.is_valid().all())
    _close(si_t.duv_dx, si_j.duv_dx, DIFF_TOL)
    _close(si_t.duv_dy, si_j.duv_dy, DIFF_TOL)
    # the JAX test's analytic footprint: one pixel of the 45 degree view
    expect = 2 * 3 * np.tan(np.radians(22.5)) / 2 / 64 * scale
    assert abs(abs(float(si_t.duv_dx[0, 0])) - expect) < 0.1 * expect


def test_uv_partials_guard_degenerate_lanes():
    """No NaN where a neighbour ray is parallel to the tangent plane or
    the parameterization degenerates, and none in the gradient."""
    from mitsuba2_tpu_torch.core.frame import Frame
    from mitsuba2_tpu_torch.core.ray import Ray, RayDifferential
    from mitsuba2_tpu_torch.render.interaction import SurfaceInteraction
    si = SurfaceInteraction.invalid(3)
    p = torch.zeros((3, 3), requires_grad=True)
    dp_du = torch.tensor([[1.0, 0, 0], [0, 0, 0], [1.0, 0, 0]])
    dp_dv = torch.tensor([[0, 1.0, 0], [0, 0, 0], [1.0, 0, 0]])
    si = si._replace(p=p, dp_du=dp_du, dp_dv=dp_dv, t=torch.ones(3),
                     sh_frame=Frame(*si.sh_frame))
    o = torch.tensor([[0.0, 0.0, 1.0]] * 3)
    down = torch.tensor([[0.1, 0.0, -1.0]] * 3)
    flat = torch.tensor([[1.0, 0.0, 0.0]] * 3)
    rd = RayDifferential(Ray.make(o, down), o, o, flat, down, True)
    out = si.compute_uv_partials(rd)
    assert bool(torch.isfinite(out.duv_dx).all())
    assert bool((out.duv_dx == 0).all())          # parallel in x
    assert bool((out.duv_dy[1:] == 0).all())      # degenerate lanes
    (out.duv_dy.sum()).backward()
    assert bool(torch.isfinite(p.grad).all())


def _hit(pkg, scene, o, d):
    from importlib import import_module
    Ray = import_module(f"{pkg.__name__}.core.ray").Ray
    n = len(o)
    if pkg is mt:
        ray = Ray.make(torch.as_tensor(o, dtype=torch.float32),
                       torch.as_tensor(d, dtype=torch.float32),
                       mint=1e-4)
    else:
        ray = Ray.make(jnp.asarray(o, jnp.float32),
                       jnp.asarray(d, jnp.float32), mint=jnp.full(n, 1e-4),
                       maxt=jnp.full(n, np.inf), time=jnp.zeros(n),
                       wavelengths=jnp.zeros((n, 0)))
    return scene.ray_intersect(ray)


# tests/test_core_math.py:287-329's shapes side by side in one scene (one
# JAX compile), each with rays over it: (shape dict, offset along x, ray
# origins relative to the offset)
NORMAL_SHAPES = {
    "rectangle": ({"type": "rectangle"}, 0.0,
                  [[0.2, 0.1, 5.0], [-0.7, 0.4, 5.0]]),
    "sphere": ({"type": "sphere", "radius": 2.0}, 10.0,
               [[0.5, 0.3, 5.0], [-1.1, 0.9, 5.0], [0.0, 2.6, 5.0]]),
    "tessellated sphere": ({"type": "sphere", "radius": 1.0,
                            "resolution_hint": 64,
                            "emitter": {"type": "area", "radiance": {
                                "type": "rgb", "value": 0.0}}}, 20.0,
                           [[0.3, 0.2, 5.0], [-0.5, -0.6, 5.0]]),
    "cylinder": ({"type": "cylinder", "radius": 0.5, "p0": [0, -1, 0],
                  "p1": [0, 1, 0]}, 30.0,
                 [[0.1, 0.2, 5.0], [-0.3, -0.5, 5.0]]),
    "disk": ({"type": "disk"}, 40.0, [[0.1, 0.2, 5.0]]),
}


def _placed(pkg, d, dx):
    d = dict(d)
    T = pkg.Transform
    if d["type"] == "sphere":
        d["center"] = [dx, 0.0, 0.0]
    else:
        d["to_world"] = T.translate([dx, 0.0, 0.0]) \
            @ d.get("to_world", T.identity())
    return pkg.load_dict(d).expand()[0]


@pytest.fixture(scope="module")
def normal_derivatives():
    """Both packages' hits and normal derivatives on the shapes' rays ->
    ({shape: lane indices}, port (si, (du, dv)), JAX (si, (du, dv)))."""
    from mitsuba2_tpu.render.scene import Scene as SJ
    from mitsuba2_tpu_torch.render.scene import Scene as ST
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    lanes, origins = {}, []
    for name, (_, dx, o) in NORMAL_SHAPES.items():
        lanes[name] = list(range(len(origins), len(origins) + len(o)))
        origins += [[x + dx, y, z] for x, y, z in o]
    dirs = [[0.0, 0.0, -1.0]] * len(origins)
    out = []
    for pkg, cls in ((mt, ST), (mj, SJ)):
        sc = cls(shapes=[_placed(pkg, d, dx)
                         for d, dx, _ in NORMAL_SHAPES.values()])
        si = _hit(pkg, sc, origins, dirs)
        out.append((si, sc.normal_derivative(si)))
    return lanes, out[0], out[1]


@pytest.mark.parametrize("name", sorted(NORMAL_SHAPES))
def test_normal_derivative_matches_jax(normal_derivatives, name):
    lanes, (si_t, (du_t, dv_t)), (si_j, (du_j, dv_j)) = normal_derivatives
    k = lanes[name]
    assert np.array_equal(_np(si_t.is_valid())[k],
                          np.asarray(si_j.is_valid())[k])
    _close(du_t[k], np.asarray(du_j)[k], DIFF_TOL)
    _close(dv_t[k], np.asarray(dv_j)[k], DIFF_TOL)
    if name == "rectangle":
        assert float(du_t[k].abs().max()) == 0 == float(dv_t[k].abs().max())
    if name == "sphere":
        _close(du_t[k[0]], si_t.dp_du[k[0]] / 2.0, DIFF_TOL)
        assert not bool(si_t.is_valid()[k[2]])        # the miss
        assert float(du_t[k[2]].abs().max()) == 0
    if name == "tessellated sphere":
        d, n = _np(du_t)[k[0]], _np(si_t.sh_frame.n)[k[0]]
        assert np.linalg.norm(d) > 1e-3 and abs(np.dot(d, n)) < 1e-4


# ------------------------------------------------ the render layer's names

def test_interaction_records():
    from mitsuba2_tpu_torch.render import interaction as it
    from mitsuba2_tpu_torch.render import records
    from mitsuba2_tpu.render.interaction import SurfaceInteraction as SIJ
    assert it.PreliminaryIntersection is records.PreliminaryIntersection
    assert records.BSDFSample is records.BSDFSample3
    got = it.SurfaceInteraction.invalid(5, 4)
    want = SIJ.invalid(5, 4)
    for name in ("t", "p", "n", "uv", "wi", "dp_du", "dp_dv", "shape_idx",
                 "prim_idx", "wavelengths", "bsdf_idx", "emitter_idx"):
        assert np.array_equal(_np(getattr(got, name)),
                              np.asarray(getattr(want, name))), name
    assert not got.has_uv_partials() and not bool(got.is_valid().any())
    mi = it.zero_mi(4, 3, "cpu")
    assert not bool(mi.is_valid().any())
    v = torch.as_tensor(_pts(4))
    _close(mi.to_world(mi.to_local(v)), v)


def test_shape_areas_match_jax():
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")

    def shapes(pkg):
        T = pkg.Transform
        return {
            "rectangle": {"type": "rectangle",
                          "to_world": T.scale([2.0, 0.5, 1.0])},
            "sphere": {"type": "sphere", "radius": 1.5},
            "disk": {"type": "disk", "to_world": T.rotate([1, 0, 0], 30)
                     @ T.scale([2.0, 0.7, 1.0])},
            "cylinder": {"type": "cylinder", "radius": 0.4,
                         "p0": [0, 0, 0], "p1": [0, 2, 1]},
            "cube": {"type": "cube", "to_world": T.scale([1.0, 2.0, 0.5])},
        }
    for name, d in shapes(mt).items():
        st = mt.load_dict(d)
        sj = mj.load_dict(shapes(mj)[name])
        assert abs(st.surface_area() - sj.surface_area()) \
            <= 1e-5 * sj.surface_area(), name
        assert st.is_emitter() == sj.is_emitter() is False
        if st.is_mesh():
            _close(st.face_areas(), sj.face_areas())
            st.recompute_vertex_normals()
            sj.recompute_vertex_normals()
            _close(st.normals, sj.normals)
            assert not st.face_normals_only
    with pytest.raises(NotImplementedError):
        mt.render.shape.Shape().surface_area()


def _media_scene(pkg):
    return pkg.load_dict({
        "type": "scene",
        "fog": {"type": "cube", "interior": {"type": "homogeneous"},
                "bsdf": {"type": "null"}},
        "cloud": {"type": "sphere", "center": [3, 0, 0],
                  "interior": {"type": "heterogeneous"},
                  "bsdf": {"type": "null"}}})


def test_scene_bounding_sphere_and_media_flags():
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    st, sj = _media_scene(mt), _media_scene(mj)
    c_t, r_t = st.bounding_sphere()
    c_j, r_j = sj.bounding_sphere()
    _close(c_t, c_j)
    assert abs(r_t - r_j) < 1e-6 and c_t.device == st.device
    idx = np.asarray([-1, 0, 1, 1, 0], np.int32)
    assert np.array_equal(
        _np(st.medium_is_homogeneous(torch.as_tensor(idx))),
        np.asarray(sj.medium_is_homogeneous(jnp.asarray(idx))))
    for mt_, mj_ in zip(st.media, sj.media):
        assert mt_.has_spectral_extinction() == mj_.has_spectral_extinction()


def test_bsdf_emitter_sampler_names():
    from mitsuba2_tpu_torch.render.bsdf import BSDF, BSDFContext
    from mitsuba2_tpu_torch.render.emitter import Emitter
    from mitsuba2_tpu.render.bsdf import BSDFContext as CtxJ
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    assert tuple(BSDFContext().reverse()) == tuple(CtxJ().reverse())
    assert BSDFContext().reverse().reverse() == BSDFContext()
    for d in ({"type": "diffuse"}, {"type": "plastic"},
              {"type": "roughconductor"}, {"type": "dielectric"}):
        bt, bj = mt.load_dict(d), mj.load_dict(d)
        assert bt.component_count() == bj.component_count()
        assert bt.needs_differentials() == bj.needs_differentials()
    base = BSDF()
    for call in (lambda: base.sample(None, None, None, None, None),
                 lambda: base.eval(None, None, None, None),
                 lambda: base.pdf(None, None, None, None)):
        with pytest.raises(NotImplementedError):
            call()
    e = Emitter()
    for call in (lambda: e.eval(None, None),
                 lambda: e.sample_direction(None, None, None),
                 lambda: e.pdf_direction(None, None, None),
                 lambda: e.sample_ray(None, None, None, None, None)):
        with pytest.raises(NotImplementedError):
            call()
    sc = _media_scene(mt)
    e.set_scene(sc)
    _close(e._scene_bsphere[0], sc.bounding_sphere()[0])
    from mitsuba2_tpu_torch.render.microfacet import MicrofacetDistribution
    md = MicrofacetDistribution(0.3, 0.4)
    a = 0.2
    assert MicrofacetDistribution(a, a).is_isotropic() \
        and not md.is_isotropic()
    assert md.scale_alpha(2.0)[:2] == (0.6, 0.8)
    s = mt.load_dict({"type": "stratified", "sample_count": 16, "seed": 3})
    c = s.clone()
    assert type(c) is type(s) and c is not s
    assert (c.sample_count, c.base_seed) == (16, 3)
    st = c.seed(0, torch.arange(8), torch.zeros(8, dtype=torch.int64))
    so = s.seed(0, torch.arange(8), torch.zeros(8, dtype=torch.int64))
    assert torch.equal(c.next_2d(st)[0], s.next_2d(so)[0])


@pytest.mark.parametrize("variant", ["scalar_rgb", "scalar_mono",
                                     "scalar_spectral"])
def test_rgb_to_variant_spectrum_matches_jax(variant):
    from mitsuba2_tpu.render.texture import rgb_to_variant_spectrum as fj
    from mitsuba2_tpu_torch.render.texture import \
        rgb_to_variant_spectrum as ft
    mj.set_variant(variant)
    mt.set_variant(variant)
    rs = np.random.RandomState(8)
    rgb = rs.rand(16, 3).astype(np.float32)
    wav = rs.uniform(360, 830, (16, 4)).astype(np.float32)
    # the spectral model's fit is held at 1e-4 (ROADMAP, sRGB fit rounding)
    _close(ft(torch.as_tensor(rgb), torch.as_tensor(wav)),
           fj(jnp.asarray(rgb), jnp.asarray(wav)),
           1e-4 if variant == "scalar_spectral" else TOL)
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")


def test_measured_to_string():
    from mitsuba2_tpu_torch.python.test.scenes import measured_ggx_path
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    d = {"type": "measured", "filename": measured_ggx_path()}
    assert mt.load_dict(d).to_string() == mj.load_dict(d).to_string()
