"""The biggeo path (bench.py's big-mesh config: a displaced sphere from an
OBJ file over a floor under an area light) as a whole: ``load_dict`` +
``scene.integrator.render`` of the port against the JAX integrator on its
path kernel (Pallas interpret mode, the ``_force_megakernel`` test hook),
from the same scene dict and seed, at 16^2 x 4 spp, depth 3, on a
1,220-face mesh (nu=32, nv=20), which takes the reference's streamed tier
and the port's BVH tier (more than 1024 faces). The port's face tables
equal the reference's row for row, in its face order.

Tolerance: the Cornell bar of test_torch_path_kernel.py, at least 99% of
pixels within 1e-4 relative and image means within 1e-5; nothing of the
reference is patched (its bf16 Woop products flip no hit here). Measured:
every pixel within 3.6e-5, means 1.0e-6 apart; with the reference's HBM
tier forced (``MK_HBM=1``, a slow test) the same.
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import bvh, path_kernel as pk
from mitsuba2_tpu_torch.python.test.scenes import (bumpy_sphere_dict,
                                                   cornell_box_dict)
from tests.test_torch_mesh_io import jax_bumpy_dict
from tests.test_torch_path_kernel import (
    assert_images_agree, box_develop, cpu_device_fixture)

_on_cpu = cpu_device_fixture()

W, SPP, MAX_DEPTH, SEED = 16, 4, 3, 5
NU, NV = 32, 20


def jax_render(hbm=False):
    """The JAX integrator's image of biggeo on its path kernel, and its
    megakernel object."""
    import os
    import mitsuba2_tpu as mj
    mj.set_variant("scalar_rgb")
    scene = mj.load_dict(jax_bumpy_dict(W, W, SPP, MAX_DEPTH, NU, NV))
    scene.integrator._force_megakernel = True
    with pytest.MonkeyPatch.context() as mp:
        if hbm:
            mp.setitem(os.environ, "MK_HBM", "1")
        img = np.asarray(scene.integrator.render(scene, seed=SEED, spp=SPP))
    assert scene.integrator.last_engine == "megakernel"
    mk = scene.integrator._mk_cache[1]
    assert mk.streamed and mk.hbm == hbm
    return img, mk


@pytest.fixture(scope="module")
def reference():
    return jax_render()


def port_scene(width=W, spp=SPP, max_depth=MAX_DEPTH, nu=NU, nv=NV):
    mt.set_variant("scalar_rgb")
    return mt.load_dict(bumpy_sphere_dict(width, width, spp, max_depth,
                                          nu, nv))


def test_render_matches_jax_kernel(reference):
    st = port_scene()
    assert st.tables.n_faces == 1220
    assert st.tables.flags & pk.TEMPLATE_FLAGS == pk.HAS_BVH
    img = st.integrator.render(st, seed=SEED, spp=SPP)
    assert st.integrator.last_engine == "kernel"
    assert st.integrator.engine_reason is None
    assert img.shape == (W, W, 3) and img.dtype == torch.float32
    assert torch.isfinite(img).all()
    assert_images_agree(img.numpy(), reference[0])


@pytest.mark.slow
def test_render_matches_jax_hbm_tier():
    ref, _ = jax_render(hbm=True)
    st = port_scene()
    img = st.integrator.render(st, seed=SEED, spp=SPP)
    assert_images_agree(img.numpy(), ref)


def test_face_tables_are_the_references_row_for_row(reference):
    """Woop rows and every attribute column of each face equal the
    reference kernel's at the same face id (its padding faces aside)."""
    mk = reference[1]
    st = port_scene()
    F = st.tables.n_faces
    A = np.asarray(mk._fattr())
    ref_attr = pk._attr_from_reference(A)[:F]
    # the columns the reference packs for this scene's BSDFs (no uv or
    # to_uv rows without a checker); the port's to_uv is the identity
    packed = pk._attr_from_reference(np.ones((len(A), 1)))[0] == 1
    assert packed[:pk.C_ETA].all()
    np.testing.assert_allclose(st.tables.fattr.numpy()[:, packed],
                               ref_attr[:, packed], rtol=1e-6, atol=1e-7)
    to_uv = st.tables.fattr.numpy()[:, pk.C_TOUV0:pk.C_TOUV1 + 4]
    assert (to_uv == [1, 0, 0, 0, 0, 1, 0, 0]).all()
    # the reference's streamed layout: (4, chunk * 3C) per-chunk blocks
    C = mk.chunk
    W4 = np.asarray(mk.woop).reshape(4, -1, 3, C)       # axis col, chunk
    rows = np.transpose(W4, (1, 3, 2, 0)).reshape(-1, 12)[:F]
    np.testing.assert_array_equal(st.tables.woop.numpy(), rows)


def test_bench_configs_are_accepted_at_full_size():
    """bench.py's biggeo (262,148 faces with floor and light) and hero
    (203,778) scenes pass the kernel's gate unchanged; a scene above the
    reference's cap is refused with its reason."""
    from mitsuba2_tpu_torch.python.test.scenes import hero_serialized_dict
    mt.set_variant("scalar_rgb")
    for d, faces in ((bumpy_sphere_dict(256, 256, 32, 5, 512, 257), 262148),
                     (hero_serialized_dict(256, 256, 32, 5), 203778)):
        scene = mt.load_dict(d)
        integ = scene.integrator
        assert scene.tables.n_faces == faces
        assert integ._kernel_for(scene, scene.sensors[0]) is not None
        assert integ.engine_reason is None
        assert scene.tables.bvh_depth <= bvh.STACK_DEPTH
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pk, "MAX_FACES_HBM", faces - 1)
            assert pk.path_kernel_ineligibility(scene) == \
                f"face count {faces} > {faces - 1}"


def test_plain_version_counts_the_walk():
    """With ``stats`` the plain version counts the BVH tier's box and face
    tests of every ray it traces, from the walk of the device tree."""
    st = port_scene(width=8, spp=2)
    stats = {}
    pk.path_radiance_reference(st.tables, pk.camera_row(st.sensors[0], "cpu"),
                               SEED, 0, 2, 8, 8, MAX_DEPTH, 5, stats=stats)
    rays = stats["rays"]
    assert 5.0 < stats["walk_boxes"] / rays < 100.0
    assert 1.0 < stats["walk_faces"] / rays < 20.0
    assert 0 < stats["shadow_walk_faces"] < stats["walk_faces"]
    assert "shadow_faces" not in stats
    # the binary walk, which the bound counts, beside the wide walk the
    # kernel runs: fewer node reads, the same hits (as many at most more
    # face tests)
    for key in ("walk", "shadow_walk"):
        assert 0 < stats[f"{key}_wide_nodes"] < 0.7 * stats[f"{key}_nodes"]
        assert 0 < stats[f"{key}_wide_faces"] <= 1.2 * stats[
            f"{key}_faces"]


def test_plain_version_of_chosen_lanes():
    """The plain version of a strided set of lanes (every k-th pixel, all
    its samples, as chip_smoke.py holds the main run) equals those columns
    of the whole image's."""
    st = port_scene(width=8, spp=2)
    args = (st.tables, pk.camera_row(st.sensors[0], "cpu"), SEED, 0, 2, 8,
            8, MAX_DEPTH, 5)
    lanes = (torch.arange(0, 64, 7)[:, None] * 2
             + torch.arange(2)).reshape(-1)
    some = pk.path_radiance_reference(*args, lanes=lanes)
    assert some.shape == (3, len(lanes))
    assert torch.equal(some, pk.path_radiance_reference(*args)[:, lanes])


_CUDA_CASES = {"biggeo rgb": ("scalar_rgb", "biggeo"),
               "biggeo spectral": ("scalar_spectral", "biggeo"),
               "biggeo mono": ("scalar_mono", "biggeo"),
               "hero rgb": ("scalar_rgb", "hero"),
               "hero spectral": ("scalar_spectral", "hero")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_CUDA_CASES))
def test_cuda_bvh_tier_matches_plain_version(case):
    """The BVH tier's instantiations against the plain version on the card,
    in each color mode, on meshes of about 5,000 faces."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mitsuba2_tpu_torch.python.test.scenes import hero_serialized_dict
    variant, name = _CUDA_CASES[case]
    mt.set_variant(variant)
    prev = mt.device()
    try:
        mt.set_device("cuda")
        make = bumpy_sphere_dict if name == "biggeo" else hero_serialized_dict
        scene = mt.load_dict(make(32, 32, 8, 5, 64, 40))
    finally:
        mt.set_device(prev)
    tables = scene.tables
    assert tables.flags & pk.HAS_BVH
    key = (tables.flags & pk.TEMPLATE_FLAGS, tables.nc)
    cam = pk.camera_row(scene.sensors[0], scene.device)
    args = (tables, cam, SEED, 0, 8, 32, 32, 5, 3)
    before = pk.path_radiance.launches_by_kernel[key]
    got = pk.path_radiance(*args)
    torch.cuda.synchronize()
    assert pk.path_radiance.launches_by_kernel[key] == before + 1
    want = pk.path_radiance_reference(*args)
    assert_images_agree(box_develop(got, 32, 32, 8).cpu().numpy(),
                        box_develop(want, 32, 32, 8).cpu().numpy())


@pytest.mark.cuda
def test_cuda_bvh_tier_forced_on_cornell_matches_shared_tier():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mt.set_variant("scalar_rgb")
    prev = mt.device()
    try:
        mt.set_device("cuda")
        scene = mt.load_dict(cornell_box_dict(32, 32, 16))
    finally:
        mt.set_device(prev)
    cam = pk.camera_row(scene.sensors[0], scene.device)
    args = (cam, SEED, 0, 16, 32, 32, 6, 3)
    shared = pk.path_radiance(scene.tables, *args)
    forced = pk.path_radiance(pk.with_bvh_tier(scene.tables), *args)
    assert_images_agree(box_develop(forced, 32, 32, 16).cpu().numpy(),
                        box_develop(shared, 32, 32, 16).cpu().numpy())
