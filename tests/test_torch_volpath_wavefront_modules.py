"""The volpath wavefront's modules against their JAX counterparts on the
same numpy inputs, made from a seed: medium sampling and
``eval_tr_and_pdf`` (homogeneous and heterogeneous, rgb and spectral), the
grid volume's channels, ``BoundingBox.ray_intersect``, the phase functions
on a medium record, the scene's ``medium_transition`` and ``.vol`` files;
then the reference's analytic bars (tests/test_media.py) on the port's
renders, the host waits of a render, and the card against the CPU.

Tolerance: 1e-6 relative for the lookups that both packages compute in
the same order (bit for bit where noted); 1e-5 for the sampled distances
and points, the coefficients and the transmittance (the libraries' log,
exp and the spectral model's sqrt differ in the last bit, and a
distance's ulp moves the point at which the grid is read).
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core.ray import Ray
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_volpath_wavefront import SEED, slab

_on_cpu = cpu_device_fixture()


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def close(got, want, rtol=1e-6, atol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture
def variants():
    """Sets both packages' variant; back to scalar_rgb afterwards."""
    import mitsuba2_tpu as mj

    def use(name):
        mj.set_variant(name)
        mt.set_variant(name)
        return mj
    yield use
    use("scalar_rgb")


def media(T_):
    """A chromatic homogeneous medium and a heterogeneous one over a
    rotated, scaled box with an 8x6x5 grid, as dicts on the Transform
    ``T_``."""
    grid = np.random.default_rng(7).uniform(
        0.1, 3.0, (8, 6, 5)).astype(np.float32)
    return {
        "homogeneous": {"type": "homogeneous",
                        "sigma_t": {"type": "rgb", "value": [0.5, 0.9, 1.4]},
                        "albedo": {"type": "rgb", "value": [0.9, 0.7, 0.5]},
                        "scale": 1.5},
        "heterogeneous": {"type": "heterogeneous",
                          "sigma_t": {"type": "grid3d", "data": grid},
                          "albedo": {"type": "rgb", "value": [0.3, 0.6, 0.9]},
                          "scale": 0.7,
                          "to_world": (T_.rotate([0, 1, 1], 30)
                                       @ T_.translate([-1, -1, -1])
                                       @ T_.scale([2.0, 1.5, 2.5]))}}


def rays(n, seed, spectral):
    r = np.random.default_rng(seed)
    o = r.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    d = r.standard_normal((n, 3))
    d[: n // 8, 1:] = 0.0                      # axis-parallel rays
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    maxt = r.uniform(0.5, 6.0, n).astype(np.float32)
    maxt[::5] = np.inf
    wl = r.uniform(360.0, 830.0, (n, 4)).astype(np.float32) \
        if spectral else None
    return o, d, np.zeros(n, np.float32), maxt, wl


@pytest.mark.parametrize("kind", ["homogeneous", "heterogeneous"])
@pytest.mark.parametrize("variant", ["scalar_rgb", "scalar_spectral"])
def test_medium_sampling_matches_jax(variants, monkeypatch, kind, variant):
    import jax.numpy as jnp
    from mitsuba2_tpu.core.ray import Ray as RayJ
    from mitsuba2_tpu.models.media_impl import Grid3DVolume
    from mitsuba2_tpu_torch.models.media import Medium
    monkeypatch.setattr(Grid3DVolume, "_FACTORIZED_MAX_ROWS", 0)
    mj = variants(variant)
    medj = mj.load_dict(media(mj.Transform)[kind])
    medt = mt.load_dict(media(mt.Transform)[kind])
    from mitsuba2_tpu_torch.variants import current
    n, nch = 4096, current().n_channels
    o, d, mint, maxt, wl = rays(n, 11, variant == "scalar_spectral")
    r = np.random.default_rng(12)
    u = r.uniform(0, 1, n).astype(np.float32)
    channel = r.integers(0, nch, n).astype(np.int32)
    active = r.uniform(0, 1, n) < 0.9
    rj = RayJ.make(o, d, mint=mint, maxt=maxt,
                   wavelengths=None if wl is None else jnp.asarray(wl))
    mij = medj.sample_interaction(rj, jnp.asarray(u), jnp.asarray(channel),
                                  jnp.asarray(active))
    mit = medt.sample_interaction(
        Ray(T(o), T(d), T(mint), T(maxt)), T(u), T(channel), T(active), 0,
        None if wl is None else T(wl))
    tj = np.asarray(mij.t)
    assert (np.isfinite(tj) == torch.isfinite(mit.t).numpy()).all()
    hit = np.isfinite(tj)
    assert 0.1 < hit.mean() < 0.95, hit.mean()
    close(mit.t[hit], tj[hit], rtol=1e-5)
    close(mit.mint, mij.mint)
    close(mit.p[hit], np.asarray(mij.p)[hit], rtol=1e-5, atol=1e-5)
    close(mit.wi, mij.wi)
    for a, b in zip(mit.sh_frame, mij.sh_frame):
        close(a, b)
    for name in ("sigma_s", "sigma_n", "sigma_t", "combined_extinction"):
        close(getattr(mit, name)[hit], np.asarray(getattr(mij, name))[hit],
              rtol=1e-5)
    assert (mit.medium_idx == 0).all()
    si_t = r.uniform(0.0, 5.0, n).astype(np.float32)
    tr_j, pdf_j = medj.eval_tr_and_pdf(mij, jnp.asarray(si_t),
                                       jnp.asarray(active))
    tr_t, pdf_t = Medium.eval_tr_and_pdf(mit, T(si_t))
    close(tr_t, tr_j, rtol=1e-5)
    close(pdf_t, pdf_j, rtol=1e-5)


@pytest.mark.parametrize("variant,channels", [
    ("scalar_rgb", 4), ("scalar_spectral", 4), ("scalar_mono", 4),
    ("scalar_spectral", 3), ("scalar_rgb", 1)])
def test_grid_volume_channels_match_jax(variants, monkeypatch, variant,
                                        channels):
    """``Grid3DVolume.eval``: a grid's channels in the variant's (the
    first C, or the first repeated), against the JAX lookup's gather
    branch bit for bit and its matmul branch within 1e-6."""
    import jax.numpy as jnp
    from mitsuba2_tpu.models.media_impl import Grid3DVolume as GridJ
    from mitsuba2_tpu_torch.models.media_impl import Grid3DVolume
    variants(variant)
    r = np.random.default_rng(channels)
    data = r.uniform(0.1, 2.0, (5, 4, 3, channels)).astype(np.float32)
    pts = r.uniform(-0.1, 1.1, (2048, 3)).astype(np.float32)
    got = Grid3DVolume(data=data).eval(T(pts))
    close(got, GridJ(data=data).eval(jnp.asarray(pts)), atol=1e-6)
    monkeypatch.setattr(GridJ, "_FACTORIZED_MAX_ROWS", 0)
    want = np.asarray(GridJ(data=data).eval(jnp.asarray(pts)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_bounding_box_ray_intersect_matches_jax():
    import jax.numpy as jnp
    from mitsuba2_tpu.core.bbox import BoundingBox as BoxJ
    from mitsuba2_tpu_torch.core.bbox import BoundingBox
    o, d, _, _, _ = rays(4096, 5, False)
    d[:64, 0] = 0.0                             # in-plane rays
    o[:32, 0] = -1.0
    lo = np.asarray([-1.0, -0.5, -2.0], np.float32)
    hi = np.asarray([1.0, 0.75, 0.5], np.float32)
    hj, nj, fj = BoxJ(jnp.asarray(lo), jnp.asarray(hi)).ray_intersect(
        jnp.asarray(o), jnp.asarray(d))
    ht, nt, ft = BoundingBox(T(lo), T(hi)).ray_intersect(T(o), T(d))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    assert 0.2 < ht.float().mean() < 0.9
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


@pytest.mark.parametrize("props", [{"type": "hg", "g": 0.6},
                                   {"type": "isotropic"}])
def test_phase_functions_on_a_medium_record(variants, props):
    """``sample(mi, u2, active)`` and ``eval(mi, wo, active)`` are the
    ``(wi, ...)`` forms on ``mi.wi``, and match the JAX functions on the
    JAX record; through the scene's dispatch, the lanes outside the
    medium keep +z and pdf 0."""
    import jax.numpy as jnp
    from mitsuba2_tpu.render.interaction import MediumInteraction as MIJ
    from mitsuba2_tpu_torch.render.interaction import zero_mi
    mj = variants("scalar_rgb")
    r = np.random.default_rng(3)
    n = 1024
    wi = r.standard_normal((n, 3))
    wi = (wi / np.linalg.norm(wi, axis=1, keepdims=True)).astype(np.float32)
    wo = np.roll(wi, 1, 0)
    u = r.uniform(0, 1, (n, 2)).astype(np.float32)
    mi = zero_mi(n, 3, "cpu")._replace(wi=T(wi))
    pt, pj = mt.load_dict(props), mj.load_dict(props)
    active = torch.ones(n, dtype=torch.bool)
    wo_t, pdf_t = pt.sample(mi, T(u), active)
    wo_w, pdf_w = pt.sample(T(wi), T(u))
    assert torch.equal(wo_t, wo_w) and torch.equal(pdf_t, pdf_w)
    assert torch.equal(pt.eval(mi, T(wo), active), pt.eval(T(wi), T(wo)))
    mij = MIJ(*[None] * len(MIJ._fields))._replace(wi=jnp.asarray(wi))
    wo_j, pdf_j = pj.sample(mij, jnp.asarray(u))
    close(wo_t, wo_j, atol=5e-6)
    close(pdf_t, pdf_j, rtol=1e-5)
    close(pt.eval(mi, T(wo), active), pj.eval(mij, jnp.asarray(wo)),
          rtol=1e-6)


def transitions(pkg):
    """A null cube bounding a medium, a sphere with a medium inside, then
    a disk and a cylinder whose media differ from both."""
    T_ = pkg.Transform
    med = media(T_)
    return {"type": "scene",
            "cube": {"type": "cube", "bsdf": {"type": "null"},
                     "interior": med["heterogeneous"]},
            "ball": {"type": "sphere", "radius": 0.5, "center": [3, 0, 0],
                     "bsdf": {"type": "null"},
                     "interior": med["homogeneous"]},
            "disk": {"type": "disk", "to_world": T_.translate([-3, 0, 0]),
                     "bsdf": {"type": "null"},
                     "exterior": {"type": "homogeneous"}},
            "tube": {"type": "cylinder", "radius": 0.5,
                     "to_world": T_.translate([0, 3, -1]),
                     "bsdf": {"type": "null"},
                     "interior": {"type": "homogeneous", "scale": 2.0}},
            "sensor": {"type": "perspective"}}


def test_medium_transition_matches_jax(variants):
    """Rays from outside and inside toward every shape: faces and the
    sphere cross into their shape's media as in the JAX scene. A disk or
    cylinder hit takes its own shape's media in the port; the JAX scene
    reads the sphere columns at its prim id (the last sphere's media),
    ROADMAP.md queue 3."""
    import jax.numpy as jnp
    from mitsuba2_tpu.core.ray import Ray as RayJ
    mj = variants("scalar_rgb")
    sj, st = mj.load_dict(transitions(mj)), mt.load_dict(transitions(mt))
    assert [type(x).__name__ for x in st.media] \
        == [type(x).__name__ for x in sj.media]
    assert len(st.media) == 4
    targets = np.asarray([[0, 0, 0], [3, 0, 0], [-3, 0, 0], [0, 3, -0.5]],
                         np.float32)
    r = np.random.default_rng(9)
    n = 2048
    tgt = targets[np.arange(n) % 4] + r.uniform(-0.3, 0.3, (n, 3))
    d = r.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    # half the rays start inside their target
    o = (tgt - d * np.where(np.arange(n) < n // 2, 3.0, 0.05)[:, None]) \
        .astype(np.float32)
    start = r.integers(-1, 4, n).astype(np.int32)
    si_j = sj.ray_intersect(RayJ.make(o, d), None)
    si_t = st.ray_intersect(Ray.make(T(o), T(d)))
    hit = np.isfinite(np.asarray(si_j.t))
    assert (hit == si_t.is_valid().numpy()).all() and hit.mean() > 0.8
    want = np.asarray(sj.medium_transition(si_j, jnp.asarray(d),
                                           jnp.asarray(start), True))
    got = st.medium_transition(si_t, T(d), T(start),
                               torch.ones(n, dtype=torch.bool)).numpy()
    shape = si_t.shape_idx.numpy()
    quad = hit & (shape >= 2)
    assert (got[~quad] == want[~quad]).all()
    # the disk (shape 2) has exterior medium 2 only, the tube (shape 3)
    # interior medium 3 only
    entering = (d * si_t.n.numpy()).sum(1) < 0
    own = np.where(shape == 2, np.where(entering, -1, 2),
                   np.where(entering, 3, -1))
    assert (got[quad] == own[quad]).all()
    assert quad.sum() > 100 and (got[quad] != want[quad]).any()


def test_vol_files_cross_packages(tmp_path):
    """A grid written by either package's ``write_vol`` reads back in the
    other's ``read_vol`` and as a ``grid3d`` volume's ``filename``."""
    from mitsuba2_tpu.utils import vol as vol_j
    from mitsuba2_tpu_torch.utils import vol as vol_t
    r = np.random.default_rng(0)
    data = r.uniform(0, 1, (4, 5, 6, 2)).astype(np.float32)
    bbox = (-1.0, -2.0, -3.0, 1.0, 2.0, 3.0)
    for write, read, name in ((vol_j.write_vol, vol_t.read_vol, "j.vol"),
                              (vol_t.write_vol, vol_j.read_vol, "t.vol")):
        path = str(tmp_path / name)
        write(path, data, bbox)
        back, box = read(path)
        np.testing.assert_array_equal(back, data)
        assert tuple(box) == bbox
    vol = mt.load_dict({"type": "grid3d", "filename": str(tmp_path / "j.vol")})
    np.testing.assert_array_equal(vol.data, data)
    vol_t.write_vol(str(tmp_path / "one.vol"), data[..., 0])
    assert vol_t.read_vol(str(tmp_path / "one.vol"))[0].shape == (4, 5, 6, 1)


def _unrenderable():
    """name -> (variant, edit(scene), the missing piece)."""
    from mitsuba2_tpu_torch.models.media import Medium

    class Bare(Medium):
        """A medium without the wavefront's sampling hooks."""

    class Cloudy:
        """A phase function object without ``sample``/``eval``."""

    def bare_medium(scene):
        scene.media[0] = Bare()

    def bare_phase(scene):
        scene.media[0].phase_function = Cloudy()

    return {"medium": ("scalar_rgb", bare_medium,
                       "medium Bare has no wavefront sampling"),
            "phase": ("scalar_rgb", bare_phase,
                      "phase Cloudy has no wavefront sample/eval")}


def test_polarized_slab_renders_as_the_unpolarized_one():
    """The slab in ``scalar_rgb_polarized`` renders on the volpath
    wavefront, bit for bit the ``scalar_rgb`` image (the reference's
    wavefronts read no polarized flag; K3's gate refuses the variant)."""
    imgs = {}
    for variant in ("scalar_rgb_polarized", "scalar_rgb"):
        mt.set_variant(variant)
        try:
            scene = mt.load_dict(slab(mt, 4, 2))
            imgs[variant] = scene.integrator.render(scene, seed=SEED, spp=2)
            assert scene.integrator.last_engine == "wavefront"
        finally:
            mt.set_variant("scalar_rgb")
    assert torch.equal(imgs["scalar_rgb_polarized"], imgs["scalar_rgb"])
    assert float(imgs["scalar_rgb"].mean()) > 0.0


@pytest.mark.parametrize("case", sorted(_unrenderable()))
def test_unrenderable_volpath_scene_raises_the_missing_piece(case):
    """A volpath scene outside K3's scope that the wavefront cannot render
    either raises ``NotImplementedError`` with the missing piece, K3's
    reason beside it."""
    variant, edit, piece = _unrenderable()[case]
    mt.set_variant(variant)
    try:
        scene = mt.load_dict(slab(mt, 4, 1))
        if edit is not None:
            edit(scene)
        with pytest.raises(NotImplementedError, match=piece) as err:
            scene.integrator.render(scene, seed=0, spp=1)
        assert scene.integrator.engine_reason in str(err.value)
        assert scene.integrator.last_engine is None
    finally:
        mt.set_variant("scalar_rgb")


# ---- the reference's analytic bars (tests/test_media.py), on the port ----

def absorbing_slab(sigma_t, albedo, spp, max_depth=16, kind="homogeneous",
                   grid=None, thickness=1.0, integrator="volpath"):
    """tests/test_media.py ``_slab_scene`` on the port's Transform: a
    camera looking down -z through a medium-filled box at an area light
    of radiance 4 behind it."""
    T_ = mt.Transform
    if kind == "homogeneous":
        medium = {"type": "homogeneous",
                  "sigma_t": {"type": "rgb", "value": [sigma_t] * 3},
                  "albedo": {"type": "rgb", "value": [albedo] * 3}}
    else:
        medium = {"type": "heterogeneous",
                  "sigma_t": {"type": "grid3d", "data": grid},
                  "albedo": {"type": "rgb", "value": [albedo] * 3},
                  "to_world": (T_.translate([-1, -1, -thickness / 2])
                               @ T_.scale([2, 2, thickness]))}
    return {"type": "scene",
            "integrator": {"type": integrator, "max_depth": max_depth},
            "sensor": {"type": "perspective", "fov": 10.0,
                       "to_world": T_.look_at([0, 0, 4], [0, 0, 0],
                                              [0, 1, 0]),
                       "film": {"type": "hdrfilm", "width": 6, "height": 6,
                                "rfilter": {"type": "box"}},
                       "sampler": {"type": "independent",
                                   "sample_count": spp}},
            "slab": {"type": "cube",
                     "to_world": T_.scale([1.0, 1.0, thickness / 2]),
                     "bsdf": {"type": "null"}, "interior": medium},
            "light": {"type": "rectangle",
                      "to_world": T_.translate([0, 0, -2.5]) @ T_.scale(2.0),
                      "emitter": {"type": "area",
                                  "radiance": {"type": "rgb",
                                               "value": [4.0] * 3}}}}


def render(d, seed=0, spp=None, force=False):
    scene = mt.load_dict(d)
    scene.integrator._disable_kernel = force
    img = scene.integrator.render(scene, seed=seed, spp=spp)
    assert torch.isfinite(img).all()
    return img.numpy(), scene.integrator


def test_beer_lambert_through_a_homogeneous_slab():
    """A pure absorber: L exp(-sigma_t thickness), rtol 0.05."""
    img, integ = render(absorbing_slab(1.3, 0.0, 400))
    assert integ.last_engine == "wavefront"
    np.testing.assert_allclose(img.mean((0, 1)), 4.0 * np.exp(-1.3),
                               rtol=0.05)


@pytest.mark.parametrize("force", [False, True])
def test_beer_lambert_through_a_constant_grid(force):
    """Delta tracking through a constant 0.8 grid, thickness 2, rtol
    0.08: the volumetric kernel's plain version, and the wavefront."""
    grid = np.full((4, 4, 4), 0.8, np.float32)
    img, integ = render(absorbing_slab(0.0, 0.0, 600, kind="heterogeneous",
                                       grid=grid, thickness=2.0),
                        force=force)
    assert integ.last_engine == ("wavefront" if force else "kernel")
    np.testing.assert_allclose(img.mean((0, 1)), 4.0 * np.exp(-1.6),
                               rtol=0.08)


def test_vacuum_volpath_matches_path():
    """Without media volpath agrees with the path tracer within 3%."""
    from mitsuba2_tpu_torch.python.test.scenes import cornell_box_dict
    d = cornell_box_dict(width=16, height=16, spp=128, max_depth=4)
    img_p, _ = render(d, spp=128)
    d["integrator"] = {"type": "volpath", "max_depth": 4}
    img_v, integ = render(d, spp=128)
    assert integ.last_engine == "wavefront"
    assert abs(img_v.mean() / img_p.mean() - 1.0) < 0.03


def test_volpathmis_matches_volpath_in_media():
    """The MIS estimator agrees with NEE alone through a scattering
    medium within 5%."""
    d = absorbing_slab(1.0, 0.8, 96, max_depth=12)
    a, _ = render(d, seed=5)
    d["integrator"] = {"type": "volpathmis", "max_depth": 12}
    b, integ = render(d, seed=5)
    assert integ.last_engine == "wavefront"
    assert abs(a.mean() - b.mean()) < 0.05 * max(a.mean(), 1e-3)


def test_volpathmis_spectral_matches_rgb(variants):
    """Spectral volpathmis (the per-channel MIS weights through null
    collisions) against rgb with wavelength-flat coefficients, within
    12%, at 8^2 x 96 (the reference's test renders 16^2)."""
    grid = np.random.default_rng(3).uniform(
        0.3, 2.2, (8, 8, 8)).astype(np.float32)

    def make():
        return slab(mt, 8, 96, max_depth=12, integrator="volpathmis",
                    box=True, medium=lambda T_: {
                        "type": "heterogeneous",
                        "sigma_t": {"type": "grid3d", "data": grid},
                        "albedo": {"type": "rgb", "value": [0.7] * 3},
                        "to_world": (T_.translate([-1, -1, -1])
                                     @ T_.scale(2.0)),
                        "phase": {"type": "hg", "g": 0.2}})

    variants("scalar_rgb")
    d = make()
    d["light"]["emitter"]["radiance"]["value"] = [5.0] * 3
    img_rgb, _ = render(d, seed=2, force=True)
    variants("scalar_spectral")
    d = make()
    d["light"]["emitter"]["radiance"]["value"] = [5.0] * 3
    img_sp, integ = render(d, seed=7)
    assert integ.last_engine == "wavefront"
    assert abs(img_sp.mean() - img_rgb.mean()) <= 0.12 * img_rgb.mean()


def test_volpath_host_waits_are_the_designed_ones():
    """A render after the first waits for the device only at each loop's
    any-lane test (every turn and the test that ends the loop) and at the
    BSDF partition's lane counts, once a turn of the main loop
    (core/profiler.py ``HostTransfers``)."""
    from mitsuba2_tpu_torch.core.profiler import HostTransfers
    mt.set_variant("scalar_rgb")
    st = mt.load_dict(slab(mt, 8, 2, integrator="volpathmis"))
    st.integrator.render(st, seed=0, spp=2)
    with HostTransfers() as host:
        st.integrator.render(st, seed=0, spp=2)
    trips = st.integrator.last_trips
    ops = {}
    for (op, _), n in host.counts.items():
        ops[op] = ops.get(op, 0) + n
    assert set(ops) == {"__bool__", "tolist"}, host.lines()
    assert ops["tolist"] == trips[-1]
    assert ops["__bool__"] == sum(trips) + len(trips)


@pytest.mark.cuda
def test_cuda_volpath_wavefront_matches_cpu():
    """The gaussian slab's wavefront on the card against the CPU at 32^2 x
    4, depth 16 (K2 on the card, its plain twin on the CPU): equal trip
    counts, then the CPU tests' bar on the lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tests.test_torch_wavefront import lane_errors
    mt.set_variant("scalar_rgb")
    out = {}
    for dev in ("cuda", "cpu"):
        mt.set_device(dev)
        try:
            st = mt.load_dict(slab(mt, 32, 4))
            sensor = st.sensors[0]
            _, rgb = st.integrator.wavefront_lanes(st, sensor, sensor.sampler,
                                                   SEED, 0, 4)
            out[dev] = (rgb.cpu().numpy(), list(st.integrator.last_trips))
        finally:
            mt.set_device("cpu")
    assert out["cuda"][1] == out["cpu"][1]
    err = lane_errors(out["cuda"][0], out["cpu"][0])
    assert (err > 1e-3).sum() <= 2
    assert (err <= 1e-4).mean() >= 0.99
    a, b = out["cuda"][0].mean(), out["cpu"][0].mean()
    assert abs(a - b) <= 1e-5 * abs(b)
