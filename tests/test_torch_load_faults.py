"""Two load faults of the port against the reference, closed: the
integrators' ``timeout`` property with the cooperative stop (``cancel``,
``should_stop``, ``develop_partial``; ``mitsuba2_tpu/render/integrator.py
:24-65`` and the drive's check between passes, ``:140-153``), and the
media's ``sample_emitters`` (``mitsuba2_tpu/models/media_impl.py:155``).

Before, a ``path``, ``volpath`` or ``volpathmis`` dict with ``timeout``,
and a ``homogeneous`` or ``heterogeneous`` medium with
``sample_emitters``, failed to load in the port (an unreferenced
property) and loaded in the reference. The stop is held as the
reference's ``tests/test_tooling.py::test_cancel_and_timeout`` holds it,
on the Cornell box forced into several passes by a small wavefront cap,
and more sharply: a render stopped after its first pass is that pass's
image, bit for bit. The renders are the path kernel's and the volumetric
kernel's plain versions on the CPU (the Cornell box at 32x32, 8 spp a
pass); the JAX package only loads one dict (no render).
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.python.test.scenes import (cornell_box_dict,
                                                   volpath_slab_dict)
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()

W, SPP, PASSES, SEED = 32, 32, 4, 5


def cornell_in_passes(**integrator):
    """The Cornell box at W^2 x SPP, its kernel's wavefront cap set so
    that a render takes PASSES passes."""
    mt.set_variant("scalar_rgb")
    d = cornell_box_dict(W, W, SPP, 3)
    d["integrator"].update(integrator)
    scene = mt.load_dict(d)
    scene.integrator.MAX_WAVEFRONT_KERNEL = W * W * SPP // PASSES
    return scene


def test_path_dict_with_timeout_loads_in_both_packages():
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.python.test.scenes import \
        cornell_box_dict as jax_cornell_box_dict
    mj.set_variant("scalar_rgb")
    d = jax_cornell_box_dict(8, 8, 4, 3)
    d["integrator"]["timeout"] = 2.5
    assert mj.load_dict(d).integrator.timeout == 2.5
    assert cornell_in_passes(timeout=2.5).integrator.timeout == 2.5
    assert cornell_in_passes().integrator.timeout == -1.0


@pytest.mark.parametrize("kind", ["volpath", "volpathmis"])
def test_volpath_dicts_with_timeout_load(kind):
    mt.set_variant("scalar_rgb")
    d = volpath_slab_dict(8, 8, 4, 3)
    d["integrator"].update(type=kind, timeout=0.75)
    integ = mt.load_dict(d).integrator
    assert integ.timeout == 0.75 and not integ.should_stop()


def test_tiny_timeout_stops_after_the_first_pass():
    """A render whose timeout has passed by the first check stops after
    one pass: a finite image whose mean is within 10% of the full
    render's (the reference's bar), equal to the first pass alone and to
    ``develop_partial``."""
    scene = cornell_in_passes()
    integ = scene.integrator
    assert integ.develop_partial() is None
    full = integ.render(scene, seed=SEED, spp=SPP)
    assert torch.equal(integ.develop_partial(), full)
    integ.timeout = 1e-9
    partial = integ.render(scene, seed=SEED, spp=SPP)
    integ.timeout = -1.0
    assert torch.isfinite(partial).all()
    mean = float(full.mean())
    assert abs(float(partial.mean()) - mean) < 0.1 * max(mean, 1e-3)
    assert not torch.equal(partial, full)
    first = integ.render(scene, seed=SEED, spp=SPP // PASSES)
    assert torch.equal(partial, first)
    assert torch.equal(integ.develop_partial(), first)


def test_cancel_makes_should_stop_true():
    scene = cornell_in_passes()
    integ = scene.integrator
    assert not integ.should_stop()
    integ.cancel()
    assert integ.should_stop()
    # a render starts afresh, as the reference's does: cancel() is for a
    # render in progress
    img = integ.render(scene, seed=SEED, spp=SPP)
    assert not integ.should_stop()
    assert torch.isfinite(img).all()


@pytest.mark.parametrize("medium", [
    {"type": "homogeneous", "sigma_t": 1.5, "albedo": 0.5},
    {"type": "heterogeneous",
     "sigma_t": {"type": "grid3d",
                 "data": np.full((2, 2, 2), 0.5, np.float32)}},
])
@pytest.mark.parametrize("sample_emitters", [False, True, None])
def test_media_keep_sample_emitters(medium, sample_emitters):
    d = dict(medium)
    if sample_emitters is not None:
        d["sample_emitters"] = sample_emitters
    med = mt.load_dict(d)
    assert med.use_emitter_sampling is (sample_emitters is not False)


def test_sample_emitters_leaves_the_volpath_image_as_it_is():
    """The reference keeps the flag and reads it nowhere; the slab with
    it off renders the same image as with it on."""
    mt.set_variant("scalar_rgb")
    imgs = []
    for flag in (True, False):
        d = volpath_slab_dict(16, 16, 4, 4)
        d["slab"]["interior"]["sample_emitters"] = flag
        scene = mt.load_dict(d)
        assert scene.media[0].use_emitter_sampling is flag
        imgs.append(scene.integrator.render(scene, seed=SEED, spp=4))
    assert torch.isfinite(imgs[0]).all()
    assert torch.equal(*imgs)
