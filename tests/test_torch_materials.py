"""The path kernel module on the materials scene (the Cornell box with a
glass tall box, a rough plastic short box, plastic floor and ceiling, a
bitmap back wall, a textured disk rug and a plastic cylinder rod, under
the default gaussian film): its plain PyTorch version against the JAX
package's Pallas path kernel (interpret mode) on the reference's own
tables, the port's tables rendering the same lanes, the film splat of the
whole pass, the first-hit shares of the new kinds, and the CUDA kernel
against the plain version on the card in every color mode.

Tolerance. The JAX kernel is patched to exact ``jnp.arctan2``/``arccos``
(its polynomials move the disk's and cylinder's uv) and to a float32
``_dot3`` (its three bf16 passes round the Woop products and the atlas
fetch's row mix by about 2^-16), as tests/test_torch_matpreview.py and
tests/test_torch_intersect.py patch them; the JAX package itself is not
edited. The bar is PERF.md's: at least 99% of pixels within 1e-4 relative,
image means within 1e-5. Measured at this size: every pixel within
4.3e-5, equal means.
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.ops import splat as sp
from mitsuba2_tpu_torch.python.test.scenes import cornell_materials_dict
from tests.test_torch_path_kernel import (assert_images_agree, box_develop,
                                          cpu_device_fixture)

_on_cpu = cpu_device_fixture()

W, SPP, MAX_DEPTH, RR_DEPTH, SEED = 16, 4, 3, 2, 3
FLAGS = pk.HAS_SPHERES | pk.HAS_LOBES
# the first-hit kinds the scene must show on at least 1% of camera rays
NEW_KINDS = ("dielectric", "plastic", "roughplastic", "bitmap", "disk",
             "cylinder")


def jax_dict(variant="scalar_rgb", width=W, spp=SPP, max_depth=MAX_DEPTH):
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.core.transform import Transform as TJ
    from mitsuba2_tpu.python.test.scenes import cornell_box_dict as cj
    mj.set_variant(variant)
    return cornell_materials_dict(
        width, width, spp, max_depth, T=TJ,
        base=cj(width, width, spp, max_depth, rfilter="gaussian"))


def patched_render(mk, sensor, seed, spp):
    """The JAX kernel's pass with exact atan2/acos and a float32 _dot3."""
    import jax
    import jax.numpy as jnp
    import mitsuba2_tpu.ops.megakernel as mk_mod
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mk_mod, "_atan2", jnp.arctan2)
        mp.setattr(mk_mod, "_acos",
                   lambda x: jnp.arccos(jnp.clip(x, -1.0, 1.0)))
        mp.setattr(mk_mod, "_dot3", lambda a, b: jnp.dot(
            a, b, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32))
        return np.asarray(mk.render_pass(sensor, seed, 0, spp))


def jax_tables(mk, sensor):
    """(PathTables, camera row) of a DiffusePathMegakernel's tables."""
    from tests.test_torch_matpreview import jax_cam
    return pk.tables_from_reference(
        np.asarray(mk.woop), np.asarray(mk._fattr()), np.asarray(mk.lights),
        jax_cam(sensor), sph=np.asarray(mk.sph),
        sattr=np.asarray(mk._sattr()), qd=np.asarray(mk.qd),
        qattr=np.asarray(mk._qattr()),
        atlas=np.asarray(mk.atlas) if mk.has_bitmap else None, nc=mk.nc)


@pytest.fixture(scope="module")
def reference():
    """The JAX kernel's scene, tables and gaussian-splatted block."""
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.ops.megakernel import DiffusePathMegakernel
    scene = mj.load_dict(jax_dict())
    mk = DiffusePathMegakernel(scene, interpret=True)
    mk.max_depth, mk.rr_depth = MAX_DEPTH, RR_DEPTH
    block = patched_render(mk, scene.sensors[0], SEED, SPP)
    tables, cam = jax_tables(mk, scene.sensors[0])
    return tables, cam, block


def port_scene(width=W, spp=SPP, max_depth=MAX_DEPTH):
    mt.set_variant("scalar_rgb")
    d = cornell_materials_dict(width, width, spp, max_depth)
    d["integrator"]["rr_depth"] = RR_DEPTH
    return mt.load_dict(d)


def develop_block(block, b=2):
    core = block[b:-b, b:-b]
    return core[..., :3] / core[..., 3:]


def test_plain_version_matches_jax_kernel(reference):
    """Per pixel, after the same gaussian splat: the plain version's lanes
    through the plain splat against the JAX kernel's block."""
    tables, cam, block = reference
    assert tables.flags & pk.TEMPLATE_FLAGS == FLAGS
    assert tables.n_quads == 2 and tables.tex.shape == (2 * 64 * 64, 4)
    rad = pk.path_radiance_reference(tables, cam, SEED, 0, SPP, W, W,
                                     MAX_DEPTH, RR_DEPTH)
    assert rad.shape == (3, W * W * SPP) and torch.isfinite(rad).all()
    assert (rad >= 0).all()
    st = port_scene()
    ours = sp.splat_reference(rad, SEED, 0, SPP, W, W,
                              st.sensors[0].film.rfilter).numpy()
    assert ours.shape == block.shape == (W + 4, W + 4, 4)
    assert_images_agree(develop_block(ours), develop_block(block))


def test_port_tables_render_like_reference_tables(reference):
    """The port's own packing renders the reference tables' lanes bit for
    bit (same face order, same columns, same texels)."""
    tables, cam, _ = reference
    st = port_scene()
    args = (SEED, 0, SPP, W, W, MAX_DEPTH, RR_DEPTH)
    ours = pk.path_radiance_reference(
        st.tables, pk.camera_row(st.sensors[0], "cpu"), *args)
    assert torch.equal(ours, pk.path_radiance_reference(tables, cam, *args))


def test_render_goes_through_kernel_and_splat():
    """load_dict + render on the CPU: the plain versions of the path
    kernel and of the splat, the developed (h, w, 3) image, no launch."""
    st = port_scene(width=8, spp=2)
    before = (pk.path_radiance.launches, sp.splat.launches)
    img = st.integrator.render(st, seed=1, spp=2)
    assert st.integrator.last_engine == "kernel"
    assert st.integrator.engine_reason is None
    assert (pk.path_radiance.launches, sp.splat.launches) == before
    block = st.integrator.render(st, seed=1, spp=2, develop=False)
    assert block.shape == (12, 12, 4)
    rad = pk.path_radiance_reference(
        st.tables, pk.camera_row(st.sensors[0], "cpu"), 1, 0, 2, 8, 8,
        MAX_DEPTH, RR_DEPTH)
    want = sp.splat_reference(rad, 1, 0, 2, 8, 8, st.sensors[0].film.rfilter)
    torch.testing.assert_close(block, want)
    torch.testing.assert_close(img, develop_block(want))


@pytest.mark.parametrize("width, spp", [(W, SPP), (64, 16)])
def test_new_kinds_are_first_hits(width, spp):
    """Every new kind is the first hit of at least 1% of camera rays, at
    the CPU tests' shape and at chip_smoke.py's parity shape."""
    st = port_scene(width=width, spp=spp, max_depth=1)
    stats = {}
    pk.path_radiance_reference(st.tables, pk.camera_row(st.sensors[0],
                                                        "cpu"),
                               SEED, 0, spp, width, width, 1, RR_DEPTH,
                               stats=stats)
    n = width * width * spp
    shares = {k: stats.get(f"first_{k}", 0) / n for k in NEW_KINDS}
    assert min(shares.values()) >= 0.01, shares


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["scalar_rgb", "scalar_spectral",
                                     "scalar_mono"])
def test_cuda_kernel_matches_plain_version(variant):
    """The spheres+lobes instantiation of each color mode against the plain
    version on the card, at the main path's depth, and the splat kernel
    against its plain version on its lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mt.set_variant(variant)
    prev = mt.device()
    try:
        mt.set_device("cuda")
        scene = mt.load_dict(cornell_materials_dict(32, 32, 16, 6))
    finally:
        mt.set_device(prev)
        mt.set_variant("scalar_rgb")
    nc = scene.tables.nc
    assert scene.tables.flags & pk.TEMPLATE_FLAGS == FLAGS
    cam = pk.camera_row(scene.sensors[0], scene.device)
    args = (scene.tables, cam, SEED, 0, 16, 32, 32, 6, 5)
    before = pk.path_radiance.launches_by_kernel[(FLAGS, nc)]
    got = pk.path_radiance(*args)
    torch.cuda.synchronize()
    assert pk.path_radiance.launches_by_kernel[(FLAGS, nc)] == before + 1
    want = pk.path_radiance_reference(*args)
    assert_images_agree(box_develop(got, 32, 32, 16).cpu().numpy(),
                        box_develop(want, 32, 32, 16).cpu().numpy())
    rf = scene.sensors[0].film.rfilter
    block = sp.splat(got, SEED, 0, 16, 32, 32, rf)
    ref = sp.splat_reference(got, SEED, 0, 16, 32, 32, rf)
    torch.testing.assert_close(block, ref, rtol=1e-5, atol=1e-6)
