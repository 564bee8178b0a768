"""Polarized rendering and the measured BSDFs on the port's wavefronts:
the ``stokes`` integrator on ``cornell_stokes`` (a polarizer under the
light, a retarder and a circular polarizer before the boxes, a pplastic
tall box) against the JAX package's ``stokes`` lane for lane on S0-S3
(``jax_lanes`` against ``wavefront_lanes``, the S components converted as
the radiance is, ``SPECTRAL_AOVS``); ``cornell_measured`` (a ``measured``
and a ``measured_polarized`` box) on the path wavefront against the JAX
path wavefront; the Malus scene of tests/test_polarized.py:68-128 through
the port; the ``_polarized`` variants on the path wavefront bit for bit
the unpolarized ones; the plain box under ``stokes`` (no polarizing
element): S1-S3 exactly zero and S0 the path image's mean; the
integrator's settings and host waits.

The parity bar is tests/test_torch_wavefront.py's (99% of pixels within
1e-4 relative, means within 1e-5, no lane beyond 1e-3 unless named).
S1-S3 of a lane are also held to 1e-4 of its S0 (plus 1e-6): a Stokes
basis pair near opposite turns by an angle that magnifies an ulp
(tests/test_torch_mueller.py), so their absolute error follows the
intensity, not their own size."""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.python.test import scenes as scenes_t
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_sensors import make_of
from tests.test_torch_surface_plugins_render import card_against_cpu
from tests.test_torch_wavefront import (SEED, assert_wavefront_parity,
                                        jax_lanes, one_thread_fixture,
                                        port_lanes, render_pair)

_on_cpu = cpu_device_fixture()
_one_thread = one_thread_fixture()

REASON = "non-path integrator subclass"


def stokes_pair(variant, width=16, spp=4):
    """cornell_stokes in both packages at ``width``^2 x ``spp``, depth 6:
    the images and lanes held to the parity bar, and S1-S3 of every lane
    within 1e-4 of its S0 -> the port's image (h, w, 12)."""
    import mitsuba2_tpu as mj
    make = make_of("cornell_stokes_dict", width, spp)
    mj.set_variant(variant)
    mt.set_variant(variant)
    try:
        sj = mj.load_dict(make(mj))
        ref = np.asarray(sj.integrator.render(sj, seed=SEED, spp=spp))
        st = mt.load_dict(make(mt))
        img = st.integrator.render(st, seed=SEED, spp=spp)
        assert st.integrator.last_engine == "wavefront"
        assert st.integrator.engine_reason == REASON
        assert img.shape == (width, width, 12) and torch.isfinite(img).all()
        lanes, ref_lanes = port_lanes(st, SEED, spp), jax_lanes(sj, SEED,
                                                                spp)
        assert_wavefront_parity(img.numpy(), ref, lanes, ref_lanes, 0, ())
        s0 = np.abs(ref_lanes[1][:, :3]).max(-1)
        err = np.abs(lanes[1][:, 3:] - ref_lanes[1][:, 3:]).max(-1)
        assert (err <= 1e-4 * s0 + 1e-6).all(), (err - 1e-4 * s0).max()
        return img
    finally:
        mj.set_variant("scalar_rgb")
        mt.set_variant("scalar_rgb")


def _components(img):
    return [img[..., 3 * k:3 * k + 3] for k in range(4)]


def test_cornell_stokes_matches_jax_stokes():
    """S0 is the image, S1-S3 its nine AOV channels; each of S1, S2 and
    S3 is non-zero somewhere (the polarizer's light seen through its
    pane, the retarder's and the circular pane's circular light, the
    plastic's Fresnel reflection)."""
    img = stokes_pair("scalar_rgb")
    s0, *s = _components(img)
    assert float(s0.mean()) > 0.05
    for k, c in enumerate(s, 1):
        assert float(c.abs().max()) > 1e-3, k


@pytest.mark.slow
def test_cornell_stokes_spectral_polarized_matches_jax_stokes():
    stokes_pair("scalar_spectral_polarized")


@pytest.mark.parametrize("variant", [
    "scalar_rgb", pytest.param("scalar_spectral", marks=pytest.mark.slow)])
def test_cornell_measured_matches_jax_path_wavefront(variant):
    """The path kernel's gate refuses the measured BSDFs; the path
    wavefront renders the box lane for lane as the JAX path wavefront."""
    st, img = render_pair(make_of("cornell_measured_dict", 16, 4), variant,
                          16, 4, force=False)
    assert st.integrator.engine_reason == "unsupported BSDF MeasuredBSDF"
    assert float(img.mean()) > 0.05


def _malus_dict(theta2, polarizers=2):
    """tests/test_polarized.py's scene: a wide light behind two polarizer
    plates (theta 0 and ``theta2``), seen head on through a 5-degree
    pinhole."""
    T = mt.Transform
    d = {"type": "scene",
         "integrator": {"type": "stokes", "max_depth": 4},
         "sensor": {"type": "perspective", "fov": 5.0,
                    "to_world": T.look_at([0, 0, 5], [0, 0, 0], [0, 1, 0]),
                    "film": {"type": "hdrfilm", "width": 4, "height": 4,
                             "rfilter": {"type": "box"}},
                    "sampler": {"type": "independent", "sample_count": 8}},
         "pol_a": {"type": "rectangle", "to_world": T.translate([0, 0, 2]),
                   "bsdf": {"type": "polarizer", "theta": 0.0}},
         "light": {"type": "rectangle",
                   "to_world": T.translate([0, 0, -1]) @ T.scale(3.0),
                   "emitter": {"type": "area", "radiance": {
                       "type": "rgb", "value": [1.0, 1.0, 1.0]}}}}
    if polarizers == 2:
        d["pol_b"] = {"type": "rectangle",
                      "to_world": T.translate([0, 0, 1]),
                      "bsdf": {"type": "polarizer", "theta": theta2}}
    return d


def test_malus_law_through_the_port():
    """Two polarizers: S0 = cos^2(dtheta) / 2 (tests/test_polarized.py:
    68-104); one horizontal polarizer: S1 = S0 = 1/2, S2 = S3 = 0
    (:107-128)."""
    mt.set_variant("scalar_rgb")
    for theta2, want in ((0.0, 0.5), (45.0, 0.25), (90.0, 0.0)):
        scene = mt.load_dict(_malus_dict(theta2))
        img = scene.integrator.render(scene, seed=0)
        assert abs(float(img[..., :3].mean()) - want) < 0.02, (theta2, img)
    scene = mt.load_dict(_malus_dict(0.0, polarizers=1))
    s0, s1, s2, s3 = _components(scene.integrator.render(scene, seed=0))
    assert torch.allclose(s0, torch.full_like(s0, 0.5), atol=0.02)
    assert torch.allclose(s1.abs(), s0, atol=0.02)
    assert float(s2.abs().max()) < 1e-5 and float(s3.abs().max()) < 1e-5


@pytest.mark.parametrize("variant", ["scalar_rgb_polarized",
                                     "scalar_spectral_polarized"])
def test_polarized_variant_renders_as_the_unpolarized_wavefront(variant):
    """The Cornell box in a polarized variant leaves the path kernel
    (gate: "polarized variant") and renders on the path wavefront bit for
    bit as the unpolarized variant's box forced onto it."""
    imgs = {}
    for v, force in ((variant, False), (variant.replace("_polarized", ""),
                                        True)):
        mt.set_variant(v)
        try:
            scene = mt.load_dict(scenes_t.cornell_box_dict(8, 8, 4, 6))
            scene.integrator._disable_kernel = force
            imgs[v] = scene.integrator.render(scene, seed=SEED, spp=4)
            assert scene.integrator.last_engine == "wavefront"
            if not force:
                assert scene.integrator.engine_reason == "polarized variant"
        finally:
            mt.set_variant("scalar_rgb")
    a, b = imgs.values()
    assert torch.equal(a, b) and float(b.mean()) > 0.0


def test_plain_box_under_stokes_is_unpolarized():
    """Without a polarizing element every BSDF depolarizes: S1-S3 are
    exactly zero, and S0 is the path wavefront's image within the noise
    of 16,384 paths (the two integrators draw other streams: the path
    draws a Russian-roulette number each bounce)."""
    mt.set_variant("scalar_rgb")
    d = scenes_t.cornell_box_dict(32, 32, 16, 6)
    path = mt.load_dict(d)
    path.integrator._disable_kernel = True
    ref = path.integrator.render(path, seed=SEED, spp=16)
    d["integrator"] = {"type": "stokes", "max_depth": 6}
    scene = mt.load_dict(d)
    s0, *s = _components(scene.integrator.render(scene, seed=SEED, spp=16))
    for c in s:
        assert float(c.abs().max()) == 0.0
    a, b = float(s0.mean()), float(ref.mean())
    assert abs(a - b) <= 0.03 * b, (a, b)


def test_stokes_settings():
    """aov_names; max_depth below 0 means 16; a nested integrator's
    max_depth wins (mitsuba2_tpu/models/integrators.py:1037-1044)."""
    mt.set_variant("scalar_rgb")
    s = mt.load_dict({"type": "stokes"})
    assert s.max_depth == 6 and s.SPECTRAL_AOVS
    assert s.aov_names() == [f"S{i}.{c}" for i in (1, 2, 3) for c in "rgb"]
    assert mt.load_dict({"type": "stokes", "max_depth": -1}).max_depth == 16
    nested = mt.load_dict({"type": "stokes", "max_depth": 3,
                           "inner": {"type": "path", "max_depth": 9}})
    assert nested.max_depth == 9


@pytest.mark.parametrize("fixture", ["cornell_stokes_dict",
                                     "cornell_measured_dict"])
def test_host_waits_are_the_designed_ones(fixture):
    """A render of the slice's scenes (stokes; path over the measured
    boxes) waits for the device where the path wavefront does: the
    bounce loop's any-lane test and the BSDF partition's lane counts
    (core/profiler.py ``HostTransfers``); no table or constant is copied
    from the host in a pass."""
    from mitsuba2_tpu_torch.core.profiler import HostTransfers
    mt.set_variant("scalar_rgb")
    scene = mt.load_dict(getattr(scenes_t, fixture)(8, 8, 2, 6))
    scene.integrator.render(scene, seed=0, spp=2)
    with HostTransfers() as host:
        scene.integrator.render(scene, seed=0, spp=2)
    assert scene.integrator.last_engine == "wavefront"
    ops = {}
    for (op, _), n in host.counts.items():
        ops[op] = ops.get(op, 0) + n
    assert set(ops) == {"__bool__", "tolist"}, host.lines()
    assert ops["tolist"] <= ops["__bool__"] <= ops["tolist"] + 1 <= 6


@pytest.mark.cuda
@pytest.mark.parametrize("fixture,variant", [
    ("cornell_stokes_dict", "scalar_rgb"),
    ("cornell_stokes_dict", "scalar_spectral_polarized"),
    ("cornell_measured_dict", "scalar_rgb"),
    ("cornell_box_dict", "scalar_rgb_polarized")])
def test_cuda_slice_scenes_match_cpu(fixture, variant):
    """The slice's scenes on the card (K2 there, its plain twin on the
    CPU) against the CPU at 32^2 x 4, S1-S3 included (chip_smoke.py holds
    them the same way)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    card_against_cpu(lambda pkg, w, spp: getattr(scenes_t, fixture)(
        w, w, spp, 6), variant, ties=True)


def test_plugin_registries_differ_only_by_the_differentiable_integrators():
    """With this slice's seven plugins the port registers every plugin of
    the JAX package but ``rb`` and ``prb`` (queue 1 item 6)."""
    from mitsuba2_tpu.core import object as oj
    from mitsuba2_tpu_torch.core import object as ot
    oj._ensure_loaded()
    ot._ensure_loaded()
    assert set(oj._REGISTRY) - set(ot._REGISTRY) == {
        ("integrator", "rb"), ("integrator", "prb")}
    for name in ("polarizer", "retarder", "circular", "pplastic",
                 "measured", "measured_polarized"):
        assert ("bsdf", name) in ot._REGISTRY
    assert ("integrator", "stokes") in ot._REGISTRY
