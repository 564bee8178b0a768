"""``_double`` variants render in the port as in the reference: the
kernels' gates refuse them ("double-precision variant") and the
wavefronts render them in float32, which is what the JAX package does (its
wavefront runs in float32, since nothing there enables 64-bit floats).
``path`` and ``volpath`` in ``scalar_rgb_double`` and
``scalar_spectral_double``, lane for lane against the JAX wavefront
(tests/test_torch_wavefront.py's bar; the volpath trip counts first)."""

import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.python.test.scenes import cornell_box_dict
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_volpath_wavefront import jax_trips  # noqa: F401
from tests.test_torch_volpath_wavefront import slab, volpath_pair
from tests.test_torch_wavefront import cornell, render_pair

_on_cpu = cpu_device_fixture()

REASON = "double-precision variant"


@pytest.mark.parametrize("variant", ["scalar_rgb_double",
                                     "scalar_spectral_double"])
def test_path_double_matches_jax_wavefront(variant):
    """The Cornell box, which the path kernel takes in the float32
    variants, goes to the wavefront with the gate's reason and holds the
    JAX wavefront's lanes."""
    st, img = render_pair(lambda pkg: cornell(pkg, 12, 4), variant, 12, 4,
                          force=False)
    assert st.integrator.engine_reason == REASON
    assert img.dtype == torch.float32


@pytest.mark.parametrize("variant", ["scalar_rgb_double",
                                     "scalar_spectral_double"])
def test_volpath_double_matches_jax_wavefront(jax_trips, variant):  # noqa: F811
    """The slab under a box film, which the volumetric kernel takes in
    scalar_rgb, goes to the volpath wavefront with the gate's reason."""
    volpath_pair(jax_trips, lambda pkg: slab(pkg, 8, 4, max_depth=6,
                                             box=True),
                 variant, 4, reason=REASON)


def test_double_renders_float32_as_float():
    """A _double render is the float32 wavefront's image, bit for bit:
    the Cornell box in scalar_rgb_double against scalar_rgb forced onto
    the wavefront at the same seed."""
    imgs = []
    for variant, force in (("scalar_rgb_double", False),
                           ("scalar_rgb", True)):
        mt.set_variant(variant)
        try:
            assert mt.variant_config().dtype == torch.float32
            scene = mt.load_dict(cornell_box_dict(8, 8, 4, 4))
            scene.integrator._disable_kernel = force
            imgs.append(scene.integrator.render(scene, seed=1, spp=4))
            assert scene.integrator.last_engine == "wavefront"
        finally:
            mt.set_variant("scalar_rgb")
    assert torch.equal(imgs[0], imgs[1])
