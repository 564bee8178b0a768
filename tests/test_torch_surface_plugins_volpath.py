"""The surface plugins on the port's volpath wavefront against the JAX
volpath wavefront (tests/test_torch_volpath_wavefront.py has the bar, the
trip counts and the helpers), at 16^2 x 4, depth 6: ``fog_spot``, a spot
and a point light inside a homogeneous medium bounded by a null cube, over
a diffuse floor, with a masked card in the medium, under ``volpath`` and
``volpathmis`` (the delta emitters' samples skip the MIS weights, and the
NEE shadow walks ratio-track the fog and pass the card's null lobe with
its ``eval_null_transmission``); and the vacuum ``cornell_surfaces`` and
``cornell_lights``. Each JAX scene runs once in tier-1; the other modes
run behind ``slow``. No lane parts but, in ``cornell_surfaces``, the
lanes that reach the glass box's base, coplanar with the floor, and part
at that tie (``VOLPATH_SURFACE_TIES``, each traced in both packages as
tests/test_torch_surface_plugins_render.py traces its own)."""

import pytest
import torch

import mitsuba2_tpu_torch as mt
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_volpath_wavefront import jax_trips, volpath_pair
from tests.test_torch_wavefront import one_thread_fixture

_on_cpu = cpu_device_fixture()
_one_thread = one_thread_fixture()
_jax_trips = jax_trips

WIDTH, SPP, MAX_DEPTH = 16, 4, 6
# the lanes of cornell_surfaces under volpath and volpathmis at WIDTH^2 x
# SPP that part from the JAX wavefront at the glass base's tie with the
# floor
VOLPATH_SURFACE_TIES = (270, 588, 658, 786, 848, 855, 859)
REASON = "medium HomogeneousMedium (heterogeneous only)"


def fog(integrator):
    from mitsuba2_tpu_torch.python.test.scenes import fog_spot_dict

    def make(pkg):
        return fog_spot_dict(WIDTH, WIDTH, SPP, MAX_DEPTH,
                             integrator=integrator, T=pkg.Transform)
    return make


def _jax_reason(integrator):
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.ops.volmegakernel import vol_megakernel_ineligibility
    return vol_megakernel_ineligibility(mj.load_dict(fog(integrator)(mj)))


@pytest.mark.parametrize("integrator", ["volpath", "volpathmis"])
def test_fog_spot_matches_jax_wavefront(_jax_trips, integrator):
    st, img = volpath_pair(_jax_trips, fog(integrator), "scalar_rgb", SPP,
                           reason=REASON)
    assert REASON == _jax_reason(integrator)
    # every NEE ran a shadow walk through the fog
    assert len(st.integrator.last_trips) > 1
    assert 0.01 < float(img.mean()) < 1.0


@pytest.mark.slow
@pytest.mark.parametrize("variant,integrator", [
    ("scalar_spectral", "volpathmis"), ("scalar_mono", "volpath")])
def test_fog_spot_other_modes_match_jax_wavefront(_jax_trips, variant,
                                                  integrator):
    volpath_pair(_jax_trips, fog(integrator), variant, SPP,
                 reason="non-rgb variant")


def cornell(scene, integrator):
    """cornell_surfaces or cornell_lights under a volpath integrator (a
    vacuum scene: the shadow rays through ``ray_test``)."""
    from tests.test_torch_surface_plugins_render import lights, surfaces

    def make(pkg):
        d = (surfaces if scene == "surfaces" else lights)(pkg)
        d["integrator"] = {"type": integrator, "max_depth": MAX_DEPTH}
        return d
    return make


def _ties(scene):
    return VOLPATH_SURFACE_TIES if scene == "surfaces" else ()


@pytest.mark.parametrize("scene,integrator", [
    ("surfaces", "volpath"), ("lights", "volpathmis")])
def test_cornell_scenes_match_jax_volpath_wavefront(_jax_trips, scene,
                                                    integrator):
    """The surface plugins on the volpath wavefront: the wrappers' null
    lobes and the thin pane's, the delta emitters, and under volpathmis
    the constant environment's pdf against the BSDFs'."""
    st, img = volpath_pair(_jax_trips, cornell(scene, integrator),
                           "scalar_rgb", SPP,
                           reason="0 media (kernel supports exactly 1)",
                           traced=_ties(scene))
    assert len(st.integrator.last_trips) == 1
    assert torch.isfinite(img).all() and float(img.mean()) > 0.05


@pytest.mark.slow
@pytest.mark.parametrize("scene,integrator", [
    ("surfaces", "volpathmis"), ("lights", "volpath")])
def test_cornell_scenes_spectral_match_jax_volpath_wavefront(
        _jax_trips, scene, integrator):
    volpath_pair(_jax_trips, cornell(scene, integrator), "scalar_spectral",
                 SPP, reason="non-rgb variant", traced=_ties(scene))


def test_fog_spot_walks_pass_the_card(monkeypatch):
    """The shadow walks reach the card and pass its null lobe: the mask's
    ``eval_null_transmission`` sees walking lanes, and lets through
    what its checkerboard opacity does not stop."""
    from mitsuba2_tpu_torch.models.bsdfs import MaskBSDF
    from mitsuba2_tpu_torch.python.test.scenes import fog_spot_dict
    seen = []
    passed = MaskBSDF.eval_null_transmission

    def counted(self, si, active):
        out = passed(self, si, active)
        seen.append((int(active.sum()), float(out[active].sum())))
        return out

    monkeypatch.setattr(MaskBSDF, "eval_null_transmission", counted)
    mt.set_variant("scalar_rgb")
    st = mt.load_dict(fog_spot_dict(WIDTH, WIDTH, SPP, MAX_DEPTH))
    img = st.integrator.render(st, seed=1, spp=SPP)
    assert torch.isfinite(img).all()
    lanes = sum(n for n, _ in seen)
    through = sum(v for _, v in seen)
    assert lanes > 0 and 0 < through < lanes * 3, (lanes, through)


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["volpath", "volpathmis"])
def test_cuda_fog_spot_matches_cpu(integrator):
    """fog_spot on the card against the CPU at 32^2 x 4 (chip_smoke.py
    holds the same): equal trip counts, then at most 2 lanes beyond 1e-3
    and the rest at the parity bar."""
    import numpy as np
    from tests.test_torch_wavefront import lane_errors
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from mitsuba2_tpu_torch.python.test.scenes import fog_spot_dict
    mt.set_variant("scalar_rgb")
    out = {}
    try:
        for dev in ("cuda", "cpu"):
            mt.set_device(dev)
            st = mt.load_dict(fog_spot_dict(32, 32, 4, MAX_DEPTH,
                                            integrator=integrator))
            sensor = st.sensors[0]
            _, rgb = st.integrator.wavefront_lanes(st, sensor,
                                                   sensor.sampler, 3, 0, 4)
            out[dev] = (rgb.double().cpu().numpy(),
                        list(st.integrator.last_trips))
    finally:
        mt.set_device("cpu")
    assert out["cuda"][1] == out["cpu"][1]
    err = lane_errors(out["cuda"][0], out["cpu"][0])
    keep = err <= 1e-3
    assert (~keep).sum() <= 2, np.flatnonzero(~keep)
    assert (err[keep] <= 1e-4).mean() >= 0.99
