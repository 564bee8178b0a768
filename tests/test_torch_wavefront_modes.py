"""The port's general wavefront in the spectral and mono variants, and on
the materials box under its gaussian film (``ImageBlock.put``), against
the JAX wavefront at equal seed, at test_torch_wavefront.py's parity bar
(per lane, and per pixel on every pixel no divergent lane reaches; each
divergent lane named and traced in ROADMAP.md queue 3)."""

import pytest

import mitsuba2_tpu_torch as mt
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_wavefront import cornell, matpreview, render_pair

_on_cpu = cpu_device_fixture()


@pytest.mark.parametrize("variant,force", [("scalar_spectral", True),
                                           ("scalar_mono", True)])
def test_cornell_color_mode_matches_jax_wavefront(variant, force):
    render_pair(lambda pkg: cornell(pkg, 16, 4), variant, 16, 4,
                force=force)


def test_spectral_matpreview_matches_jax_wavefront():
    """The sky's per-texel sigmoid spectra, the conductor IOR curves and
    the spectral checkerboard, at 16^2 x 4. Lane 623's camera ray differs
    by an ulp between the packages and grazes the hero sphere, whose small
    discriminant moves the hit by 3.7e-6 relative; a chain of rough
    bounces between the sphere and the floor pulls it apart by 5e-3."""
    render_pair(lambda pkg: matpreview(pkg, 16, 4), "scalar_spectral", 16,
                4, force=True, traced=(623,))


def test_materials_box_matches_jax_wavefront():
    """Glass, plastics, bitmaps, a disk and a cylinder under the gaussian
    film, forced onto the wavefront at 12^2 x 2. The gaussian's footprint
    is 2 pixels around a sample's pixel. Lane 224 meets the floor and the
    glass box's coplanar base, where Woop and Moller-Trumbore pick
    different faces, and goes through the glass elsewhere."""
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.python.test.scenes import cornell_box_dict as cornell_j
    from mitsuba2_tpu_torch.python.test.scenes import cornell_materials_dict

    def make(pkg):
        if pkg is mt:
            return cornell_materials_dict(12, 12, 2, 6)
        return cornell_materials_dict(
            12, 12, 2, 6, T=mj.Transform,
            base=cornell_j(12, 12, 2, 6, rfilter="gaussian"))

    st, img = render_pair(make, "scalar_rgb", 12, 2, force=True, border=2,
                          traced=(224,))
    block = st.integrator.render(st, seed=0, spp=2, develop=False)
    assert block.shape == (16, 16, 4)
