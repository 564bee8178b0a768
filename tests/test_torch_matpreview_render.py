"""The matpreview slice as a whole: ``load_dict`` + ``scene.integrator.render``
of the PyTorch port against the JAX integrator on its path kernel (Pallas
interpret mode through the ``_force_megakernel`` test hook), from the same
scene dict and seed, and the plain version on the reference's own tables.

Tolerance. The reference runs its own polynomial atan2/acos here
(megakernel.py:174-191), which the port does not copy: the port computes
them exactly. That alone moves pixels by up to ~3e-4 relative, so the bar
is at least 99% of pixels within 1e-3 relative and image means within 1e-4.
Measured at this size and seed: every pixel within 1e-3 (98.4% within
1e-4, the worst 2.1e-4), means 3.0e-5 apart. test_torch_matpreview.py
holds the patched reference at 1e-4.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import path_kernel as pk
from tests.test_torch_matpreview import (W, SPP, MAX_DEPTH, RR_DEPTH, FULL,
                                         jax_tables, port_scene)
from tests.test_torch_path_kernel import (
    box_develop, pixel_errors, cpu_device_fixture)

_on_cpu = cpu_device_fixture()

REPO = Path(__file__).resolve().parent.parent
SEED = 5
PIX_RTOL, PIX_SHARE, MEAN_RTOL = 1e-3, 0.99, 1e-4


def assert_images_agree(a, b):
    err = pixel_errors(a, b)
    assert (err <= PIX_RTOL).mean() >= PIX_SHARE, np.quantile(err, 0.99)
    assert abs(a.mean() - b.mean()) <= MEAN_RTOL * abs(b.mean()), \
        (a.mean(), b.mean())


@pytest.fixture(scope="module")
def reference():
    """The JAX integrator's image of matpreview on its path kernel, and
    the tables that kernel rendered from."""
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.python.test.scenes import matpreview_dict as mp_j
    mj.set_variant("scalar_rgb")
    d = mp_j(W, W, SPP, MAX_DEPTH)
    d["integrator"]["rr_depth"] = RR_DEPTH
    scene = mj.load_dict(d)
    scene.integrator._force_megakernel = True
    img = np.asarray(scene.integrator.render(scene, seed=SEED, spp=SPP))
    assert scene.integrator.last_engine == "megakernel"
    mk = scene.integrator._mk_cache[1]
    tables, cam = jax_tables(mk, scene.sensors[0])
    return img, tables, cam


def test_render_matches_jax_integrator(reference):
    ref = reference[0]
    st = port_scene()
    img = st.integrator.render(st, seed=SEED, spp=SPP)
    assert st.integrator.last_engine == "kernel"
    assert st.integrator.engine_reason is None
    assert img.shape == (W, W, 3) and img.dtype == torch.float32
    assert img.device == torch.device("cpu")
    assert torch.isfinite(img).all()
    assert_images_agree(img.numpy(), ref)


def test_plain_version_matches_unpatched_jax_kernel(reference):
    ref, tables, cam = reference
    assert tables.flags & pk.TEMPLATE_FLAGS == FULL
    rad = pk.path_radiance_reference(tables, cam, SEED, 0, SPP, W, W,
                                     MAX_DEPTH, RR_DEPTH)
    assert_images_agree(box_develop(rad, W, W, SPP).numpy(), ref)


def test_scene_dict_is_the_reference_dict():
    """The port's matpreview dict is the reference's, key for key and
    value for value (transforms compared by matrix); only the sky file
    differs, and its texels are the same."""
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.python.test.scenes import matpreview_dict as mp_j
    from mitsuba2_tpu_torch.python.test.scenes import matpreview_dict as mp_t

    def same(a, b, path):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                if k != "filename":
                    same(a[k], b[k], f"{path}.{k}")
        elif hasattr(a, "matrix"):
            np.testing.assert_allclose(np.asarray(a.matrix),
                                       np.asarray(b.matrix), rtol=1e-6,
                                       atol=1e-7, err_msg=path)
        else:
            assert a == b, path

    dj, dt = mp_j(8, 8, 2, 3), mp_t(8, 8, 2, 3)
    same(dj, dt, "scene")
    assert dj["envmap"]["filename"] != dt["envmap"]["filename"]
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    env_j = mj.load_dict(dj).environment_emitter
    env_t = mt.load_dict(dt).environment_emitter
    np.testing.assert_array_equal(np.asarray(env_j.bitmap._rgb_np),
                                  env_t.data)
    assert env_t.res == env_j.res == (128, 64)


def test_matpreview_render_imports_no_jax():
    code = (
        "import sys\n"
        "import mitsuba2_tpu_torch as mi\n"
        "from mitsuba2_tpu_torch.python.test.scenes import matpreview_dict\n"
        "mi.set_variant('scalar_rgb')\n"
        "mi.set_device('cpu')\n"
        "s = mi.load_dict(matpreview_dict(4, 4, 2, 3))\n"
        "img = s.integrator.render(s, seed=0, spp=2)\n"
        "assert img.shape == (4, 4, 3) and s.integrator.last_engine\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'mitsuba2_tpu.')) or m == 'mitsuba2_tpu')\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.cuda
def test_cuda_render_goes_through_kernel_and_matches_cpu():
    """matpreview on the card: one launch of its instantiation per pass,
    and the image of the CPU render (plain version) per pixel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tests.test_torch_path_kernel import assert_images_agree as strict
    prev = mt.device()
    try:
        images = {}
        for dev in ("cpu", "cuda"):
            mt.set_device(dev)
            scene = port_scene(width=32, spp=8, max_depth=6)
            before = pk.path_radiance.launches_by_kernel[(FULL, 3)]
            images[dev] = scene.integrator.render(scene, seed=2, spp=8)
            assert scene.integrator.last_engine == "kernel"
            assert pk.path_radiance.launches_by_kernel[(FULL, 3)] \
                == before + (dev == "cuda")
    finally:
        mt.set_device(prev)
    assert images["cuda"].device.type == "cuda"
    strict(images["cuda"].cpu().numpy(), images["cpu"].numpy())
