"""The mono path (K1e, one luminance channel) on the Cornell box: the
port's mono tables against the JAX package's DiffusePathMegakernel
tables, and its plain PyTorch version against the JAX path kernel (Pallas
interpret mode) per pixel, on the reference's own tables and through
``load_dict`` + ``render``.

Tolerances. Mono tables hold luminances computed in float32 on both
sides: within 1e-6. Per pixel, the bar of test_torch_path_kernel.py: at
least 99% of pixels within 1e-4 relative, image means within 1e-5.
Measured at this size on the reference's tables: every pixel within
6.9e-5, means 1.4e-6 apart.
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import path_kernel as pk
from tests.test_torch_path_kernel import (
    assert_images_agree, box_develop, cpu_device_fixture)
from tests.test_torch_spectral import (
    MAX_DEPTH, RR_DEPTH, SEED, SPP, W, jax_reference, match_faces,
    port_scene)

_on_cpu = cpu_device_fixture()


@pytest.fixture(scope="module")
def reference():
    return jax_reference("scalar_mono", "cornell")


def test_mono_tables_match_jax(reference):
    """Light rows and face rows carry the luminance, repeated over the
    three color slots; the mono kernel reads the first."""
    mk, (ref, _), _ = reference
    t = port_scene("scalar_mono", "cornell").tables
    mt.set_variant("scalar_rgb")
    assert t.nc == ref.nc == mk.nc == 1 and t.spd.shape == (0, 4)
    np.testing.assert_allclose(t.lights.numpy(), ref.lights.numpy(),
                               rtol=1e-6, atol=1e-6)
    lum = t.lights.numpy()[0, 14:17]
    np.testing.assert_allclose(lum, lum[0])
    np.testing.assert_allclose(
        lum[0], np.dot([18.387, 13.9873, 6.75357],
                       [0.212671, 0.715160, 0.072169]), rtol=1e-6)
    # the columns the Cornell kernel reads (normal, light pdf, albedo,
    # kind, emission, alpha; the reference packs only those for Cornell)
    it, ij = match_faces(t, ref)
    np.testing.assert_allclose(t.fattr.numpy()[it, :12],
                               ref.fattr.numpy()[ij, :12], rtol=1e-6,
                               atol=1e-6)
    alb = t.fattr.numpy()[:, pk.C_ALB:pk.C_ALB + 3]
    np.testing.assert_array_equal(alb, alb[:, :1].repeat(3, 1))


def test_plain_version_matches_jax_kernel(reference):
    _, (tables, cam), ref = reference
    rad = pk.path_radiance_reference(tables, cam, SEED, 0, SPP, W, W,
                                     MAX_DEPTH, RR_DEPTH)
    assert torch.isfinite(rad).all()
    # mono writes its one channel to all three output rows
    assert torch.equal(rad[0], rad[1]) and torch.equal(rad[0], rad[2])
    assert_images_agree(box_develop(rad, W, W, SPP).numpy(), ref)


def test_render_matches_jax_kernel(reference):
    st = port_scene("scalar_mono", "cornell")
    img = st.integrator.render(st, seed=SEED, spp=SPP)
    mt.set_variant("scalar_rgb")
    assert st.integrator.last_engine == "kernel"
    assert img.shape == (W, W, 3) and torch.isfinite(img).all()
    assert_images_agree(img.numpy(), reference[2])
