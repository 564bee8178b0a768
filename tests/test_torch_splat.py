"""The film splat of the path kernel's samples (ops/splat.py): its plain
PyTorch version against the JAX path kernel's ``render_pass`` with a
gaussian film (the reference's default), against the image block's
general per-sample splat, and the CUDA kernel against the plain version on
the card for every filter.

Tolerance. Both sides splat the same lanes up to the path kernels' float
rounding: the JAX kernel is patched to a float32 ``_dot3`` (its three bf16
passes round the Woop products by about 2^-16), the Cornell box at depth 2
has no lobe that amplifies rounding, and the sums run in another order.
The bar: every block pixel within 1e-5 relative or 1e-6 absolute.
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.ops import splat as sp
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()

W, SPP, MAX_DEPTH, SEED = 12, 4, 2, 5
FILTER_TYPES = ("box", "tent", "gaussian", "mitchell", "catmullrom",
                "lanczos")


def assert_blocks_agree(got, want):
    assert got.shape == want.shape
    err = np.abs(got - want)
    ok = (err <= 1e-5 * np.abs(want)) | (err <= 1e-6)
    assert ok.all(), (err.max(), (err / np.abs(want).clip(1e-30)).max())


def jax_splat_parity(rfilter):
    """The JAX kernel's block of a 12x12 Cornell box under ``rfilter``
    against the plain version's lanes of its tables through the plain
    splat."""
    import jax
    import jax.numpy as jnp
    import mitsuba2_tpu as mj
    import mitsuba2_tpu.ops.megakernel as mk_mod
    from mitsuba2_tpu.python.test.scenes import cornell_box_dict as cj
    from tests.test_torch_matpreview import jax_cam
    mj.set_variant("scalar_rgb")
    scene = mj.load_dict(cj(W, W, SPP, MAX_DEPTH, rfilter=rfilter))
    mk = mk_mod.DiffusePathMegakernel(scene, interpret=True)
    mk.max_depth, mk.rr_depth = MAX_DEPTH, 5
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mk_mod, "_dot3", lambda a, b: jnp.dot(
            a, b, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32))
        block = np.asarray(mk.render_pass(scene.sensors[0], SEED, 0, SPP))
    tables, cam = pk.tables_from_reference(
        np.asarray(mk.woop), np.asarray(mk._fattr()), np.asarray(mk.lights),
        jax_cam(scene.sensors[0]))
    rad = pk.path_radiance_reference(tables, cam, SEED, 0, SPP, W, W,
                                     MAX_DEPTH, 5)
    mt.set_variant("scalar_rgb")
    rf = mt.load_dict({"type": rfilter})
    b = int(np.ceil(rf.radius - 0.5))
    ours = sp.splat_reference(rad, SEED, 0, SPP, W, W, rf).numpy()
    assert ours.shape == (W + 2 * b, W + 2 * b, 4)
    assert_blocks_agree(ours, block)


def test_plain_splat_matches_jax_render_pass_gaussian():
    jax_splat_parity("gaussian")


@pytest.mark.parametrize("rfilter", FILTER_TYPES)
def test_plain_splat_is_the_image_blocks_splat(rfilter):
    """The tap loop puts each lane where ImageBlock.put puts a sample at
    its film position (the jitter re-derived from the lane key)."""
    from mitsuba2_tpu_torch.render.film import ImageBlock
    mt.set_variant("scalar_rgb")
    rf = mt.load_dict({"type": rfilter})
    w, h, spp = 7, 5, 3
    rng = np.random.default_rng(11)
    rad = torch.as_tensor(rng.random((3, w * h * spp)).astype(np.float32))
    got = sp.splat_reference(rad, 9, 6, spp, w, h, rf)
    key, pixel = pk.lane_keys(9, 6, spp, torch.arange(w * h * spp))
    jx, jy = pk._rng2(key, 0)
    pos = torch.stack([(pixel % w).float() + jx, (pixel // w).float() + jy],
                      1)
    block = ImageBlock((w, h), 3, rf, "cpu")
    want = block.put(block.create(), pos, rad.T)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_box_filter_keeps_the_per_pixel_sum():
    """Under the box filter the pass is the per-pixel sum and the sample
    count, no border; the splat of the same lanes gives the same block."""
    from tests.test_torch_render import _dicts
    _, d = _dicts(6, 4, 3, 2)
    mt.set_variant("scalar_rgb")
    scene = mt.load_dict(d)
    block = scene.integrator.render(scene, seed=2, spp=4, develop=False)
    assert block.shape == (6, 6, 4)
    assert torch.all(block[..., 3] == 4.0)
    rad = pk.path_radiance_reference(
        scene.tables, pk.camera_row(scene.sensors[0], "cpu"), 2, 0, 4, 6, 6,
        3, 2)
    torch.testing.assert_close(sp.splat_reference(
        rad, 2, 0, 4, 6, 6, scene.sensors[0].film.rfilter), block)


def test_wrapper_runs_plain_version_on_cpu_and_refuses_other_devices():
    mt.set_variant("scalar_rgb")
    rf = mt.load_dict({"type": "gaussian"})
    rad = torch.rand(3, 4 * 4 * 2, generator=torch.Generator().manual_seed(1))
    before = sp.splat.launches
    torch.testing.assert_close(sp.splat(rad, 1, 0, 2, 4, 4, rf),
                               sp.splat_reference(rad, 1, 0, 2, 4, 4, rf))
    assert sp.splat.launches == before
    with pytest.raises(ValueError, match="no splat kernel"):
        sp.splat(rad.to("meta"), 1, 0, 2, 4, 4, rf)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(40, 24, 64), (37, 11, 3), (37, 11, 48)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("rfilter", FILTER_TYPES)
def test_cuda_splat_matches_plain_version(rfilter, shape):
    """The splat kernel against its plain version on random lanes, at a
    shape of whole tiles and at an odd one whose spp is no multiple of the
    kernel's four samples a turn; signed filters are held against the
    block's largest value. A second launch gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mt.set_variant("scalar_rgb")
    rf = mt.load_dict({"type": rfilter})
    w, h, spp = shape
    g = torch.Generator(device="cuda").manual_seed(3)
    rad = torch.rand(3, w * h * spp, generator=g, device="cuda")
    before = sp.splat.launches
    got = sp.splat(rad, 4, 64, spp, w, h, rf)
    torch.cuda.synchronize()
    assert sp.splat.launches == before + 1
    want = sp.splat_reference(rad, 4, 64, spp, w, h, rf)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))
    assert torch.equal(got, sp.splat(rad, 4, 64, spp, w, h, rf))
