"""The spectral path (K1e) on the matpreview scene: the port's spectral
env planes, conductor IOR columns and sphere rows against the JAX
package's DiffusePathMegakernel tables, its plain PyTorch version against
the JAX path kernel (Pallas interpret mode) per pixel, on the reference's
own tables and through ``load_dict`` + ``render``, and the metameric
check against the rgb render.

Tolerances. As in test_torch_spectral.py, with the reference's polynomial
atan2/acos patched to exact math for its render, as
test_torch_matpreview.py does: at least 99% of pixels within 1e-4
relative, image means within 1e-5. Measured at this size on the
reference's tables: 99.6% of pixels within 1e-4, the worst 1.6e-4, means
2.8e-6 apart. The metameric bound is the JAX test's own
(tests/test_spectral.py): 10%, looser than Cornell's because the IOR
curve between its samples is a model choice.
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import path_kernel as pk
from tests.test_torch_path_kernel import (
    assert_images_agree, box_develop, cpu_device_fixture)
from tests.test_torch_spectral import (
    FULL, MAX_DEPTH, RR_DEPTH, SEED, SPP, W, assert_attr_rows_agree,
    assert_coeff_close, jax_reference, match_faces, port_scene)

_on_cpu = cpu_device_fixture()


@pytest.fixture(scope="module")
def reference():
    return jax_reference("scalar_spectral", "matpreview", exact_math=True)


def test_env_planes_match_jax(reference):
    """Texels [c0, c1, c2, scale]: the coefficients of rgb / (2 max(rgb))
    and the scale with the whitepoint folded in. The sampling grid stays
    the luminance one of the rgb mode."""
    mk, (ref, _), _ = reference
    t = port_scene("scalar_spectral", "matpreview").tables
    assert t.env.shape == ref.env.shape == (mk.env_h, mk.env_w, 4)
    np.testing.assert_allclose(t.env[..., 3].numpy(), ref.env[..., 3].numpy(),
                               rtol=1e-6)
    assert_coeff_close(t.env[..., :3].reshape(-1, 3).numpy(),
                       ref.env[..., :3].reshape(-1, 3).numpy())
    rgb = port_scene("scalar_rgb", "matpreview").tables
    for name in ("env_marg", "env_cond", "env_pmf"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      getattr(ref, name).numpy(), name)
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      getattr(rgb, name).numpy(), name)
    assert t.p_env == ref.p_env == 1.0
    mt.set_variant("scalar_rgb")


def test_conductor_and_sphere_rows_match_jax(reference):
    """eta and k hold the IOR quadratics, [x_lo, x_hi] the curve fits'
    span (Au on the sphere, Al on the stand)."""
    _, (ref, _), _ = reference
    t = port_scene("scalar_spectral", "matpreview").tables
    mt.set_variant("scalar_rgb")
    it, ij = match_faces(t, ref)
    assert_attr_rows_agree(t.fattr.numpy()[it], ref.fattr.numpy()[ij])
    assert t.n_spheres == ref.n_spheres == 1
    np.testing.assert_allclose(t.sph.numpy(), ref.sph.numpy(), rtol=1e-6)
    assert_attr_rows_agree(t.sattr.numpy(), ref.sattr.numpy())
    span = t.sattr.numpy()[0, [pk.C_XLO, pk.C_XHI]]
    np.testing.assert_allclose(span, [-1.0, 1.0], atol=1e-6)   # 360-830 nm
    ggx = t.fattr.numpy()[:, pk.C_KIND] == pk.KIND_GGX
    assert ggx.sum() == 12
    # Al's curve spans 360-830 nm as well; the stand's k(x) exceeds 1
    k = t.fattr.numpy()[ggx][0, pk.C_K:pk.C_K + 3]
    assert np.polyval(k, 0.0) > 5.0


def test_plain_version_matches_jax_kernel(reference):
    _, (tables, cam), ref = reference
    assert tables.flags & pk.TEMPLATE_FLAGS == FULL and tables.nc == 4
    rad = pk.path_radiance_reference(tables, cam, SEED, 0, SPP, W, W,
                                     MAX_DEPTH, RR_DEPTH)
    assert torch.isfinite(rad).all()
    assert_images_agree(box_develop(rad, W, W, SPP).numpy(), ref)


def test_render_matches_jax_kernel(reference):
    st = port_scene("scalar_spectral", "matpreview")
    img = st.integrator.render(st, seed=SEED, spp=SPP)
    mt.set_variant("scalar_rgb")
    assert st.integrator.last_engine == "kernel"
    assert img.shape == (W, W, 3) and torch.isfinite(img).all()
    assert_images_agree(img.numpy(), reference[2])


def test_spectral_render_is_metameric_to_rgb():
    means = {}
    for variant in ("scalar_rgb", "scalar_spectral"):
        st = port_scene(variant, "matpreview", width=24, spp=32)
        means[variant] = float(st.integrator.render(st, seed=1,
                                                    spp=32).mean())
    mt.set_variant("scalar_rgb")
    assert abs(means["scalar_spectral"] - means["scalar_rgb"]) \
        <= 0.10 * means["scalar_rgb"], means
