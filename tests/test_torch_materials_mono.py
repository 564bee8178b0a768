"""The materials scene in ``scalar_mono``: the plain version against the
JAX Pallas path kernel (interpret mode, patched as in
tests/test_torch_materials.py) on the reference's own tables, and the
port's tables rendering the same image.

The bitmaps are swapped for constant colors, as
tests/test_torch_materials_spectral.py does: the JAX kernel packs a mono
texture's payload flattened to (h w, 3), one atlas row a texel, so a 64x64
texture overflows its 2048 atlas rows and the kernel refuses to build
(ROADMAP queue 3); the port's mono texels are held against the JAX
texture's luminance in tests/test_torch_materials_modules.py. Tolerance:
PERF.md's bar, at least 99% of pixels within 1e-4 relative, means within
1e-5.
"""

import numpy as np

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.ops import splat as sp
from mitsuba2_tpu_torch.python.test.scenes import cornell_materials_dict
from tests.test_torch_materials import (W, SPP, MAX_DEPTH, RR_DEPTH, SEED,
                                        develop_block, jax_dict, jax_tables,
                                        patched_render)
from tests.test_torch_materials_spectral import without_bitmaps
from tests.test_torch_path_kernel import (assert_images_agree,
                                          cpu_device_fixture)

_on_cpu = cpu_device_fixture()


def test_mono_plain_version_matches_jax_kernel():
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.ops.megakernel import DiffusePathMegakernel
    try:
        scene = mj.load_dict(without_bitmaps(jax_dict("scalar_mono")))
        mk = DiffusePathMegakernel(scene, interpret=True)
        mk.max_depth, mk.rr_depth = MAX_DEPTH, RR_DEPTH
        block = patched_render(mk, scene.sensors[0], SEED, SPP)
        tables, cam = jax_tables(mk, scene.sensors[0])
    finally:
        mj.set_variant("scalar_rgb")
    assert tables.nc == 1 and tables.flags & pk.TEMPLATE_FLAGS == \
        pk.HAS_SPHERES | pk.HAS_LOBES
    args = (SEED, 0, SPP, W, W, MAX_DEPTH, RR_DEPTH)
    rad = pk.path_radiance_reference(tables, cam, *args)
    mt.set_variant("scalar_mono")
    try:
        d = without_bitmaps(cornell_materials_dict(W, W, SPP, MAX_DEPTH))
        d["integrator"]["rr_depth"] = RR_DEPTH
        st = mt.load_dict(d)
        assert (st.tables.nc, st.tables.flags & pk.TEMPLATE_FLAGS) == \
            (1, pk.HAS_SPHERES | pk.HAS_LOBES)
        rf = st.sensors[0].film.rfilter
        ours = sp.splat_reference(rad, SEED, 0, SPP, W, W, rf).numpy()
        assert_images_agree(develop_block(ours), develop_block(block))
        own = pk.path_radiance_reference(
            st.tables, pk.camera_row(st.sensors[0], "cpu"), *args)
        assert_images_agree(
            develop_block(sp.splat_reference(own, SEED, 0, SPP, W, W,
                                             rf).numpy()),
            develop_block(block))
        assert np.isfinite(ours).all()
        # one luminance: the three output channels are equal
        assert np.array_equal(ours[..., 0], ours[..., 1])
    finally:
        mt.set_variant("scalar_rgb")
