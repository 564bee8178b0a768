"""The slice's scenes on the port's path wavefront against the JAX path
wavefront, at equal seed (tests/test_torch_wavefront.py has the bar and
the lane helpers): ``cornell_surfaces`` (twosided walls, a bump-mapped
floor, a normal-mapped back wall, a rough glass box, a gold-and-diffuse
blend, a thin pane, a masked card and a copper panel) and
``cornell_lights`` (a blackbody spot, a point light with a curve
spectrum, a projector, a directional light, a uniform constant
environment and a wall of a regular spectrum), each at 16^2 x 4, depth 6,
the JAX wavefront run once in tier-1 (its image is its film's splat of
its lanes) and again in each other mode behind ``slow``.

The glass box stands on the floor, as in the bench's box, so its base
and the floor are coplanar faces. K2's Woop test and the JAX CPU path's
Moller-Trumbore place a hit up to ~1e-5 apart and break that tie apart
(as on the materials box's glass base, ROADMAP.md queue 3): a path that
reaches the base from inside the glass goes on from the floor's bump map
in one package and from the glass in the other. Those lanes are named
(``SURFACE_TIES``) and each is traced call by call in both packages: its
first other prim is the other one of two coplanar faces, hit at one
point (``assert_coplanar_ties``). No other lane parts.
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_volpath_wavefront import jax_image
from tests.test_torch_wavefront import (SEED, assert_coplanar_ties,
                                        assert_wavefront_parity, jax_lanes,
                                        lane_errors, port_lanes)

_on_cpu = cpu_device_fixture()

WIDTH, SPP, MAX_DEPTH = 16, 4, 6
# the lanes of cornell_surfaces at WIDTH^2 x SPP, seed SEED, that part
# from the JAX wavefront at the glass box's base (its faces 16 and 17)
# and the floor (face 1), in every mode
SURFACE_TIES = (206, 356, 713, 716, 779, 858, 859)


def surfaces(pkg, width=WIDTH, spp=SPP):
    return _scene(pkg, "cornell_surfaces_dict", width, spp)


def lights(pkg, width=WIDTH, spp=SPP):
    return _scene(pkg, "cornell_lights_dict", width, spp)


def _scene(pkg, name, width, spp):
    """The port's fixture ``name`` on ``pkg``'s Cornell dict and
    Transform (the Cornell dict itself for ``cornell_box_dict``)."""
    from mitsuba2_tpu_torch.python.test import scenes
    if pkg is mt:
        base = scenes.cornell_box_dict(width, width, spp, MAX_DEPTH)
    else:
        from mitsuba2_tpu.python.test.scenes import cornell_box_dict as cj
        base = cj(width, width, spp, MAX_DEPTH)
    if name == "cornell_box_dict":
        return base
    return getattr(scenes, name)(width, width, spp, MAX_DEPTH, base=base,
                                 T=pkg.Transform)


def path_pair(make, variant, traced=()):
    """The JAX wavefront's lanes and their splat, and the port's render
    and lanes, of the dicts ``make(package)``, held to the parity bar
    with no lane allowed to part but the ``traced`` ones, each at a tie of
    coplanar faces; the port's engine is the wavefront, its reason the JAX
    gate's -> (port scene, port image)."""
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.ops.megakernel import megakernel_ineligibility
    mj.set_variant(variant)
    mt.set_variant(variant)
    try:
        sj = mj.load_dict(make(mj))
        ref_lanes = jax_lanes(sj, SEED, SPP)
        ref = jax_image(sj, ref_lanes, SPP)
        st = mt.load_dict(make(mt))
        img = st.integrator.render(st, seed=SEED, spp=SPP)
        assert st.integrator.last_engine == "wavefront"
        assert st.integrator.engine_reason == megakernel_ineligibility(sj)
        assert img.shape == (WIDTH, WIDTH, 3) and torch.isfinite(img).all()
        assert_wavefront_parity(img.numpy(), ref, port_lanes(st, SEED, SPP),
                                ref_lanes, 0, traced)
        assert_coplanar_ties(st, sj, traced, SPP)
        return st, img
    finally:
        mj.set_variant("scalar_rgb")
        mt.set_variant("scalar_rgb")


def test_cornell_surfaces_matches_jax_wavefront():
    st, img = path_pair(surfaces, "scalar_rgb", SURFACE_TIES)
    assert st.integrator.engine_reason == "unsupported BSDF BumpMap"
    assert 0.05 < float(img.mean()) < 1.0


def test_cornell_lights_matches_jax_wavefront():
    st, img = path_pair(lights, "scalar_rgb")
    assert st.integrator.engine_reason == "unsupported BSDF SmoothDiffuse"
    assert 0.05 < float(img.mean()) < 2.0


def test_mixed_delta_and_area_emitters_match_jax_wavefront():
    """The scene's uniform pick among its emitters, its pdf and the MIS
    with delta and area emitters side by side: the Cornell box's area
    light beside the lights scene's point and spot."""
    def mixed(pkg):
        d = _scene(pkg, "cornell_box_dict", WIDTH, SPP)
        extra = lights(pkg)
        d["point"], d["spot"] = extra["point"], extra["spot"]
        return d

    st, _ = path_pair(mixed, "scalar_rgb")
    assert [type(e).__name__ for e in st.emitters] == [
        "PointEmitter", "SpotEmitter", "AreaEmitter"]


@pytest.mark.slow
@pytest.mark.parametrize("variant", ["scalar_spectral", "scalar_mono"])
@pytest.mark.parametrize("scene", ["surfaces", "lights"])
def test_other_modes_match_jax_wavefront(scene, variant):
    if scene == "surfaces":
        path_pair(surfaces, variant, SURFACE_TIES)
    else:
        path_pair(lights, variant)


@pytest.mark.parametrize("variant", ["scalar_spectral", "scalar_mono"])
@pytest.mark.parametrize("scene", ["surfaces", "lights"])
def test_renders_in_every_mode(scene, variant):
    """Each scene renders on the wavefront in the spectral and mono
    variants (their parity with the JAX wavefront runs behind ``slow``);
    the surfaces near their rgb image's mean."""
    make = surfaces if scene == "surfaces" else lights
    means = {}
    for v in ("scalar_rgb", variant):
        mt.set_variant(v)
        try:
            st = mt.load_dict(make(mt, 16, 16))
            img = st.integrator.render(st, seed=SEED, spp=16)
        finally:
            mt.set_variant("scalar_rgb")
        assert st.integrator.last_engine == "wavefront"
        assert img.shape == (16, 16, 3) and torch.isfinite(img).all()
        means[v] = float(img.mean())
    if scene == "surfaces":
        # the same scene through another color model: metameric, not
        # equal
        assert abs(means[variant] / means["scalar_rgb"] - 1) < 0.25, means
    else:
        # the blackbody spot is its spectral radiance per nm at the hero
        # wavelengths, but its CIE-integrated rgb (times 1 / 106.75) in
        # the other modes, as in the JAX package: no metamer
        assert means[variant] > 0, means


def test_host_waits_are_the_designed_ones():
    """The wrappers run their children on their own partition lanes (no
    second partition) and the delta and constant emitters sample on the
    device: a render waits only for the depth loop's test and the BSDF
    partition's counts (core/profiler.py ``HostTransfers``)."""
    from mitsuba2_tpu_torch.core.profiler import HostTransfers
    mt.set_variant("scalar_rgb")
    for make in (surfaces, lights):
        st = mt.load_dict(make(mt, 8, 2))
        st.integrator.render(st, seed=0, spp=2)
        with HostTransfers() as host:
            st.integrator.render(st, seed=0, spp=2)
        ops = {}
        for (op, _), n in host.counts.items():
            ops[op] = ops.get(op, 0) + n
        assert set(ops) == {"__bool__", "tolist"}, host.lines()
        assert ops["tolist"] <= ops["__bool__"] <= ops["tolist"] + 1 \
            <= MAX_DEPTH


def card_against_cpu(make, variant, width=32, spp=4, max_parting=2,
                     ties=False):
    """One pass's lanes of ``make(mt, width, spp)`` on the card against
    the CPU's: at most ``max_parting`` lanes beyond 1e-3 besides, with
    ``ties``, the lanes whose card and CPU traces first part at a tie of
    coplanar faces (at most ``MAX_TIE_SHARE`` of the lanes), the rest at
    the parity bar's 99% within 1e-4 and means within 1e-5."""
    from mitsuba2_tpu_torch.tools import wavefront_spread as ws
    mt.set_variant(variant)
    lanes, scenes = {}, {}
    try:
        for dev in ("cuda", "cpu"):
            mt.set_device(dev)
            st = mt.load_dict(make(mt, width, spp))
            sensor = st.sensors[0]
            # the kernel's gate refuses the scene (an integrator without
            # a kernel has none): the wavefront renders it
            kernel = getattr(st.integrator, "_kernel", None)
            assert kernel is None or kernel(st, sensor) is None
            _, rgb = st.integrator.wavefront_lanes(
                st, sensor, sensor.sampler, SEED, 0, spp)
            lanes[dev], scenes[dev] = rgb.double().cpu().numpy(), st
        err = lane_errors(lanes["cuda"], lanes["cpu"])
        parted = np.flatnonzero(err > 1e-3)
        tied = []
        if ties and len(parted):
            card, cpu = (ws.lane_trace(scenes[d], SEED, spp, parted)
                         for d in ("cuda", "cpu"))
            tied = [k for k in parted
                    if ws.tie_parting(scenes["cpu"], card[k], cpu[k])]
    finally:
        mt.set_device("cpu")
        mt.set_variant("scalar_rgb")
    others = sorted(set(parted.tolist()) - set(tied))
    assert len(others) <= max_parting, others
    assert len(tied) <= ws.MAX_TIE_SHARE * len(err), tied
    keep = err <= 1e-3
    assert (err[keep] <= 1e-4).mean() >= 0.99
    a, b = lanes["cuda"][keep].mean(), lanes["cpu"][keep].mean()
    assert abs(a - b) <= 1e-5 * abs(b), (a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["scalar_rgb", "scalar_spectral"])
@pytest.mark.parametrize("scene", ["surfaces", "lights"])
def test_cuda_surface_scenes_match_cpu(scene, variant):
    """Both scenes on the card (K2 there, its plain twin on the CPU)
    against the CPU at 32^2 x 4 (chip_smoke.py holds the same), the glass
    base's ties with the floor traced and set apart."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if scene == "surfaces":
        card_against_cpu(surfaces, variant, ties=True)
    else:
        card_against_cpu(lights, variant)
