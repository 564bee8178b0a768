"""Film crop windows in the port. Both hand-written kernels build their
rays from the whole field of view, so their gate refuses a crop ("crop
window") and a cropped scene renders on the wavefronts, which place the
window: on the 16^2 Cornell box and the volpath slab, an 8x8 crop at
(4, 4) is the JAX wavefront's cropped render per pixel within 1e-5 at
4 spp. The aspect of a crop is the film's (perspective.cpp; the JAX
camera takes the crop's, ROADMAP "Reference behaviour"): a crop's rays
are the full film's rays through the same film points, and an 8x6 crop
at (5, 3) is held to the full film's same window statistically, its row
means within 4 standard errors of their difference. ``set_crop_window``
rebuilds the camera and moves the parameter epoch, so a render after it
is a fresh load's bit for bit, on the kernel and on the wavefront."""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.python.test.scenes import cornell_box_dict
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_volpath_wavefront import jax_image, jax_trips, slab
from tests.test_torch_wavefront import cornell, jax_lanes, port_lanes

_on_cpu = cpu_device_fixture()
_jax_trips = jax_trips

SEED = 3
PIX_ATOL = 1e-5
CROP = dict(crop_offset_x=4, crop_offset_y=4, crop_width=8, crop_height=8)
WIDE = dict(crop_offset_x=5, crop_offset_y=3, crop_width=8, crop_height=6)
# standard errors the row means of a crop and of the full film's window
# may differ by
N_SE = 4.0


def _cropped(d, crop):
    d["sensor"]["film"].update(crop)
    return d


def _assert_jax_pixels(make, spp, integrators, trips=None):
    """The port's render of ``make(package)`` leaves the kernel with
    "crop window" for each of ``integrators`` and the first one's is the
    JAX wavefront's (its lanes splatted as the JAX drive does) per pixel
    within PIX_ATOL."""
    import mitsuba2_tpu as mj
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    sj = mj.load_dict(make(mj, integrators[0]))
    ref_lanes = jax_lanes(sj, SEED, spp)
    ref = jax_image(sj, ref_lanes, spp)
    want_trips = list(trips) if trips is not None else None
    for k, name in enumerate(integrators):
        st = mt.load_dict(make(mt, name))
        img = st.integrator.render(st, seed=SEED, spp=spp)
        assert st.integrator.last_engine == "wavefront"
        assert st.integrator.engine_reason == "crop window"
        assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
        if k:
            continue
        if want_trips is not None:
            assert st.integrator.last_trips == want_trips
        pos, rgb = port_lanes(st, SEED, spp)
        np.testing.assert_allclose(pos, ref_lanes[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(rgb, ref_lanes[1], rtol=0, atol=PIX_ATOL)
        np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=PIX_ATOL)


def test_cornell_crop_matches_jax_wavefront():
    _assert_jax_pixels(
        lambda pkg, _: _cropped(cornell(pkg, 16, 4), CROP), 4, ["path"])


def test_slab_crop_matches_jax_wavefront(_jax_trips):
    def make(pkg, integrator):
        return _cropped(slab(pkg, 16, 4, box=True, integrator=integrator),
                        CROP)
    _assert_jax_pixels(make, 4, ["volpath", "volpathmis"], _jax_trips)


def test_uncropped_film_stays_on_kernel():
    for crop in ({}, dict(crop_offset_x=0, crop_offset_y=0, crop_width=16,
                          crop_height=16)):
        sc = mt.load_dict(_cropped(cornell_box_dict(16, 16, 1, 2), crop))
        sc.integrator.render(sc, seed=SEED, spp=1)
        assert sc.integrator.last_engine == "kernel"
        assert sc.integrator.engine_reason is None
    # an offset alone is a crop
    sc = mt.load_dict(_cropped(cornell_box_dict(16, 16, 1, 2), dict(
        crop_offset_x=1, crop_width=15)))
    sc.integrator.render(sc, seed=SEED, spp=1)
    assert sc.integrator.engine_reason == "crop window"


def _camera(crop=None, kind="perspective", **kw):
    film = {"type": "hdrfilm", "width": 16, "height": 12,
            "rfilter": {"type": "box"}}
    film.update(crop or {})
    d = {"type": kind, "fov": 40.0, "film": film,
         "to_world": mt.Transform.look_at([0.2, 0.1, 4], [0, 0, 0],
                                          [0, 1, 0])}
    d.update(kw)
    return mt.load_dict(d)


@pytest.mark.parametrize("kind,kw", [
    ("perspective", {}), ("perspective", {"fov_axis": "y"}),
    ("perspective", {"fov_axis": "diagonal"}),
    ("thinlens", {"aperture_radius": 0.1, "focus_distance": 4.0})])
def test_crop_rays_are_the_full_films(kind, kw):
    """A crop's rays through its positions are the full film's through
    the same film points, and x_fov does not depend on the crop."""
    full = _camera(kind=kind, **kw)
    rs = np.random.RandomState(0)
    u = torch.as_tensor(rs.rand(256, 2).astype(np.float32))
    ap = torch.as_tensor(rs.rand(256, 2).astype(np.float32))
    # crops of other aspects than the film's 4:3
    for crop in (dict(crop_offset_x=5, crop_offset_y=3, crop_width=8,
                      crop_height=8),
                 dict(crop_offset_x=2, crop_offset_y=1, crop_width=6,
                      crop_height=10)):
        cam = _camera(crop, kind=kind, **kw)
        assert cam.x_fov == full.x_fov
        w, h = crop["crop_width"], crop["crop_height"]
        film_pos = (u * torch.tensor([w, h]) + torch.tensor(
            [crop["crop_offset_x"], crop["crop_offset_y"]])) \
            / torch.tensor([16.0, 12.0])
        got = cam.sample_ray(0.0, torch.zeros(256), u, ap)[0]
        want = full.sample_ray(0.0, torch.zeros(256), film_pos, ap)[0]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_rays_with_the_films_aspect_match_jax():
    """With no crop, or a crop of the film's aspect, the camera is the JAX
    package's: the same x_fov and the same rays."""
    import jax.numpy as jnp
    import mitsuba2_tpu as mj
    mj.set_variant("scalar_rgb")
    crops = ({}, dict(crop_offset_x=4, crop_offset_y=3, crop_width=8,
                      crop_height=6))
    rs = np.random.RandomState(1)
    u = rs.rand(128, 2).astype(np.float32)
    for crop in crops:
        for kw in ({}, {"fov_axis": "y"}, {"fov_axis": "smaller"}):
            def make(pkg):
                film = {"type": "hdrfilm", "width": 16, "height": 12}
                film.update(crop)
                d = {"type": "perspective", "fov": 40.0, "film": film,
                     "to_world": pkg.Transform.look_at(
                         [0.2, 0.1, 4], [0, 0, 0], [0, 1, 0])}
                d.update(kw)
                return pkg.load_dict(d)
            ct, cj = make(mt), make(mj)
            assert ct.x_fov == cj.x_fov
            rt = ct.sample_ray(0.0, torch.zeros(128), torch.as_tensor(u),
                               None)[0]
            rj = cj.sample_ray(0.0, jnp.zeros(128), jnp.asarray(u),
                               jnp.zeros((128, 2)))[0]
            for a, b in ((rt.o, rj.o), (rt.d, rj.d), (rt.maxt, rj.maxt)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-6)


def _pixel_stats(scene, spp):
    """Per pixel of ``scene``'s film, the mean luminance of its lanes and
    the variance of that mean -> two (h, w) arrays."""
    sensor = scene.sensors[0]
    w, h = sensor.film.crop_size
    _, rgb = scene.integrator.wavefront_lanes(scene, sensor, sensor.sampler,
                                              SEED, 0, spp)
    y = rgb.numpy().astype(np.float64).mean(-1).reshape(h, w, spp)
    return y.mean(-1), y.var(-1, ddof=1) / spp


def test_wide_crop_matches_full_films_window():
    """An 8x6 crop at (5, 3) of the 16^2 Cornell box (another aspect than
    the film's) against the same window of the full film: every row mean
    within N_SE standard errors of the two's difference."""
    spp = 64
    full = mt.load_dict(cornell_box_dict(16, 16, spp, 4))
    crop = mt.load_dict(_cropped(cornell_box_dict(16, 16, spp, 4), WIDE))
    crop.integrator.render(crop, seed=SEED, spp=1)
    assert crop.integrator.engine_reason == "crop window"
    m_f, v_f = _pixel_stats(full, spp)
    m_c, v_c = _pixel_stats(crop, spp)
    x0, y0, w, h = 5, 3, 8, 6
    m_f, v_f = m_f[y0:y0 + h, x0:x0 + w], v_f[y0:y0 + h, x0:x0 + w]
    diff = m_c.mean(1) - m_f.mean(1)
    se = np.sqrt(v_c.sum(1) + v_f.sum(1)) / w
    assert (np.abs(diff) <= N_SE * se).all(), (diff, se)
    # the window is not a flat one: the rows differ by far more than this
    assert np.ptp(m_f.mean(1)) > 10 * se.max()


def test_set_crop_window_is_a_fresh_load():
    """On the kernel and on the wavefront, across the kernel's cache: a
    render after set_crop_window is a fresh load's bit for bit."""
    spp = 2
    sc = mt.load_dict(cornell_box_dict(16, 16, spp, 3))
    full = sc.integrator.render(sc, seed=SEED, spp=spp)
    assert sc.integrator.last_engine == "kernel"
    film = sc.sensors[0].film
    for crop in (CROP, WIDE):
        film.set_crop_window((crop["crop_offset_x"], crop["crop_offset_y"]),
                             (crop["crop_width"], crop["crop_height"]))
        img = sc.integrator.render(sc, seed=SEED, spp=spp)
        assert sc.integrator.last_engine == "wavefront"
        assert sc.integrator.engine_reason == "crop window"
        fresh = mt.load_dict(_cropped(cornell_box_dict(16, 16, spp, 3),
                                      crop))
        want = fresh.integrator.render(fresh, seed=SEED, spp=spp)
        assert torch.equal(img, want)
    film.set_crop_window((0, 0), (16, 16))
    again = sc.integrator.render(sc, seed=SEED, spp=spp)
    assert sc.integrator.last_engine == "kernel"
    assert torch.equal(again, full)


def test_set_crop_window_on_the_volumetric_kernel():
    spp = 2

    def load(crop=None):
        d = slab(mt, 16, spp, max_depth=4, box=True)
        return mt.load_dict(_cropped(d, crop or {}))
    sc = load()
    full = sc.integrator.render(sc, seed=SEED, spp=spp)
    assert sc.integrator.last_engine == "kernel"
    sc.sensors[0].film.set_crop_window((4, 4), (8, 8))
    img = sc.integrator.render(sc, seed=SEED, spp=spp)
    assert sc.integrator.engine_reason == "crop window"
    fresh = load(CROP)
    assert torch.equal(img, fresh.integrator.render(fresh, seed=SEED,
                                                    spp=spp))
    sc.sensors[0].film.set_crop_window((0, 0), (16, 16))
    assert torch.equal(sc.integrator.render(sc, seed=SEED, spp=spp), full)
    assert sc.integrator.last_engine == "kernel"


def test_cropped_bands_ride_the_wavefront():
    """parallel/mesh.py under a crop: the bands take the wavefront's band
    (not the path kernel's pixel_base bands over the crop) and are the
    single render's bit for bit under the box filter."""
    from mitsuba2_tpu_torch.parallel.mesh import (
        default_mesh, render_multichip_pixel_sharded)
    spp = 2
    sc = mt.load_dict(_cropped(cornell_box_dict(16, 16, spp, 3), CROP))
    single = sc.integrator.render(sc, seed=SEED, spp=spp)
    banded = render_multichip_pixel_sharded(
        sc, seed=SEED, spp=spp, mesh=default_mesh(["cpu", "cpu"]))
    assert sc.integrator.last_engine == "wavefront"
    assert sc.integrator.engine_reason == "crop window"
    assert torch.equal(banded, single)
