"""The port's integrators without a kernel (models/integrators.py:
``depth``, ``direct``, ``aov``, ``moment``) against the JAX wavefront,
lane for lane with their AOV channels (tests/test_torch_wavefront.py's
bar), with the structured samplers the Cornell fixtures give them; the
AOV layout, the second moments and the refusals."""

import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.python.test import scenes as scenes_t
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_sensors import make_of
from tests.test_torch_surface_plugins_render import card_against_cpu
from tests.test_torch_wavefront import render_pair

_on_cpu = cpu_device_fixture()

REASON = "non-path integrator subclass"


def _pair(fixture, variant, width, spp, edit=None):
    make = make_of(fixture, width, spp)
    st, img = render_pair(make if edit is None else
                          (lambda pkg: edit(make(pkg))), variant, width,
                          spp, force=False)
    assert st.integrator.engine_reason == REASON
    return st, img


def test_depth_matches_jax_wavefront():
    def depth(d):
        d["integrator"] = {"type": "depth"}
        return d
    _, img = _pair("cornell_direct_dict", "scalar_rgb", 12, 4, depth)
    assert float(img.amax()) > 3.0 and float(img.amin()) >= 0.0


@pytest.mark.parametrize("case", [
    ("scalar_rgb", 16, {}), ("scalar_spectral", 16, {}),
    ("scalar_rgb", 8, {"emitter_samples": 2, "bsdf_samples": 3}),
    ("scalar_mono", 8, {"shading_samples": 2})],
    ids=["rgb", "spectral", "rgb-2-3", "mono-shading-2"])
def test_direct_matches_jax_wavefront(case):
    """Emission, the emitter strategy's samples and the BSDF strategy's
    with their power-2 weights over the strategies' sample fractions."""
    variant, width, counts = case

    def edit(d):
        d["integrator"].update(counts)
        return d
    st, _ = _pair("cornell_direct_dict", variant, width, 4, edit)
    integ = st.integrator
    if counts:
        assert (integ.emitter_samples, integ.bsdf_samples) == \
            ((2, 3) if "bsdf_samples" in counts else (2, 2))


def test_aov_matches_jax_wavefront():
    """cornell_aov: depth, shading normal, position and uv of the first
    hit, and the nested path's rgb, under multijitter."""
    st, img = _pair("cornell_aov_dict", "scalar_rgb", 16, 4)
    assert st.integrator.aov_names() == [
        "dd", "nn.x", "nn.y", "nn.z", "pp.x", "pp.y", "pp.z", "uv.x",
        "uv.y", "nested_0.r", "nested_0.g", "nested_0.b"]
    assert img.shape == (16, 16, 15)
    # the color channels are the nested path's rgb
    assert torch.equal(img[..., :3], img[..., 12:])


def test_every_aov_type_matches_jax_wavefront():
    """Each of ``AOVIntegrator.TYPES``, and two nested integrators (a path
    and a depth) whose mean the color channels carry, in mono (a nested
    one-channel radiance repeated into its three AOV channels)."""
    from mitsuba2_tpu_torch.models.integrators import AOVIntegrator
    types = ",".join(f"a{i}:{t}" for i, t in enumerate(AOVIntegrator.TYPES))

    def edit(d):
        d["integrator"] = {"type": "aov", "aovs": types,
                           "a_path": {"type": "path", "max_depth": 3},
                           "b_depth": {"type": "depth"}}
        return d
    st, img = _pair("cornell_aov_dict", "scalar_mono", 8, 4, edit)
    assert img.shape[-1] == 3 + 1 + 3 + 2 + 3 * 4 + 1 + 1 + 6


def test_aov_depth_channel_is_the_depth_render():
    d = scenes_t.cornell_aov_dict(8, 8, 4, 4)
    scene = mt.load_dict(d)
    aov = scene.integrator.render(scene, seed=2, spp=4)
    d["integrator"] = {"type": "depth"}
    scene = mt.load_dict(d)
    depth = scene.integrator.render(scene, seed=2, spp=4)
    assert torch.equal(aov[..., 3], depth[..., 0])


def test_moment_matches_jax_wavefront():
    """cornell_moment: the nested path's radiance and its square's
    per-pixel mean, under orthogonal arrays (p = 2 at 4 spp); each second
    moment at least the square of the mean."""
    st, img = _pair("cornell_moment_dict", "scalar_rgb", 12, 4)
    assert st.integrator.aov_names() == ["m2_0.r", "m2_0.g", "m2_0.b"]
    assert st.sensors[0].sampler.p == 2
    mean, m2 = img[..., :3].double(), img[..., 3:].double()
    assert bool((m2 >= mean * mean * (1 - 1e-5) - 1e-12).all())


def test_refusals():
    with pytest.raises(ValueError, match="unknown AOV type"):
        mt.load_dict({"type": "aov", "aovs": "x:albedo"})
    with pytest.raises(RuntimeError, match="needs nested integrators"):
        mt.load_dict({"type": "moment"})
    # a polarized variant renders on the wavefront as the unpolarized one
    # (the reference's wavefronts read no polarized flag)
    imgs = {}
    for variant in ("scalar_rgb_polarized", "scalar_rgb"):
        mt.set_variant(variant)
        try:
            scene = mt.load_dict(scenes_t.cornell_direct_dict(8, 8, 4, 2))
            imgs[variant] = scene.integrator.render(scene, seed=0, spp=4)
            assert scene.integrator.engine_reason == REASON
            assert scene.integrator.last_engine == "wavefront"
        finally:
            mt.set_variant("scalar_rgb")
    assert torch.equal(imgs["scalar_rgb_polarized"], imgs["scalar_rgb"])
    assert float(imgs["scalar_rgb"].mean()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("fixture", [
    "cornell_thinlens_dict", "cornell_direct_dict", "cornell_aov_dict",
    "cornell_moment_dict", "cornell_mesh_attribute_dict"])
def test_cuda_slice_scenes_match_cpu(fixture):
    """The slice's Cornell scenes on the card (K2 there, its plain twin on
    the CPU) against the CPU at 32^2 x 4, AOV channels included
    (chip_smoke.py holds thinlens, direct and the mesh-attribute box the
    same way)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    card_against_cpu(lambda pkg, w, spp: getattr(scenes_t, fixture)(
        w, w, spp, 6), "scalar_rgb", ties=True)
