"""Multi-device rendering (parallel/mesh.py) on meshes of repeated CPU
devices: sample-sharded and banded renders against the port's
single-device render, the band arguments of the path kernel's and the
splat's plain versions against the matching rows of a whole film, the
scene's and the kernels' replicas on another device, and the JAX
package's ``render_multichip`` and ``render_multichip_pixel_sharded``.

Tolerance. A sample-sharded render sums its shards' blocks in another
order than a single render sums its pass: 2e-5 absolute, the JAX
package's bar (tests/test_parallel.py). Bands under the box filter do not
overlap, and their lanes are keyed on their global pixels: bit for bit.
Under a wider filter the overlap-add of the band borders reorders sums:
2e-5. Against the JAX package, the bars of the Cornell parity tests
(tests/test_torch_path_kernel.py: 99% of pixels within 1e-4 relative,
means within 1e-5) at 16^2: at 8^2 one pixel is 1.6% of the image, and
the JAX kernel's bf16 Woop products move one pixel of the 8^2 Cornell box
at seed 3 by 1.5e-4.
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.ops import splat as sp
from mitsuba2_tpu_torch.parallel.mesh import (Mesh, default_mesh,
                                              render_multichip,
                                              render_multichip_pixel_sharded)
from mitsuba2_tpu_torch.python.test import scenes
from tests.test_torch_path_kernel import (assert_images_agree,
                                          cpu_device_fixture)

_on_cpu = cpu_device_fixture()

W, SPP, DEPTH, SEED = 16, 8, 3, 3
ATOL = 2e-5
CPU = torch.device("cpu")


def cpu_mesh(n):
    return default_mesh([CPU] * n)


_SCENES = {}


def scene_of(name):
    """Each scene loaded once a module, at 16^2 x 8 spp, depth 3."""
    if name not in _SCENES:
        mt.set_variant("scalar_rgb")
        make = {"cornell": scenes.cornell_box_dict,
                "materials": scenes.cornell_materials_dict,
                "direct": scenes.cornell_direct_dict,
                "volpath": scenes.volpath_slab_dict}[name]
        scene = mt.load_dict(make(W, W, SPP, DEPTH))
        single = scene.integrator.render(scene, seed=SEED, spp=SPP)
        _SCENES[name] = (scene, single, scene.integrator.last_engine)
    return _SCENES[name]


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("name, engine", [("cornell", "kernel"),
                                          ("direct", "wavefront"),
                                          ("volpath", "kernel")])
def test_sample_sharded_matches_single_device(name, engine, n):
    """The Cornell box on the path kernel's plain version, the ``direct``
    integrator on the wavefront and the volpath slab on the volumetric
    kernel's plain version."""
    scene, single, single_engine = scene_of(name)
    assert single_engine == engine
    img = render_multichip(scene, seed=SEED, spp=SPP, mesh=cpu_mesh(n))
    assert scene.integrator.last_engine == engine
    assert img.shape == single.shape
    assert (img - single).abs().max() <= ATOL


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("name", ["cornell", "direct"])
def test_box_bands_match_single_device_bit_for_bit(name, n):
    scene, single, engine = scene_of(name)
    img = render_multichip_pixel_sharded(scene, seed=SEED, spp=SPP,
                                         mesh=cpu_mesh(n))
    assert scene.integrator.last_engine == engine
    assert torch.equal(img, single)


@pytest.mark.parametrize("n", [2, 8])
def test_gaussian_bands_match_single_device(n):
    """The materials box's gaussian film on the path kernel (its lobes
    flag) and the splat: the band borders overlap by the filter's."""
    scene, single, engine = scene_of("materials")
    assert engine == "kernel"
    img = render_multichip_pixel_sharded(scene, seed=SEED, spp=SPP,
                                         mesh=cpu_mesh(n))
    assert scene.integrator.last_engine == "kernel"
    assert (img - single).abs().max() <= ATOL


def test_volumetric_kernel_bands_ride_the_wavefront():
    """The volumetric kernel renders whole films: the slab's bands take
    the volpath wavefront, as the JAX package's do."""
    scene, single, _ = scene_of("volpath")
    img = render_multichip_pixel_sharded(scene, seed=SEED, spp=SPP,
                                         mesh=cpu_mesh(2))
    assert scene.integrator.last_engine == "wavefront"
    assert img.shape == single.shape and bool(torch.isfinite(img).all())


def test_aov_channels_shard_and_band():
    """An ``aov`` render keeps its 3 + 12 channels through both axes."""
    mt.set_variant("scalar_rgb")
    scene = mt.load_dict(scenes.cornell_aov_dict(8, 8, 4, DEPTH))
    single = scene.integrator.render(scene, seed=SEED, spp=4)
    mesh = cpu_mesh(2)
    img = render_multichip(scene, seed=SEED, spp=4, mesh=mesh)
    assert img.shape == single.shape == (8, 8, 15)
    assert (img - single).abs().max() <= ATOL
    assert torch.equal(render_multichip_pixel_sharded(
        scene, seed=SEED, spp=4, mesh=mesh), single)


def test_undevelop_block_is_the_sum_of_the_shards():
    scene, single, _ = scene_of("cornell")
    data = render_multichip(scene, seed=SEED, spp=SPP, mesh=cpu_mesh(2),
                            develop=False)
    assert data.shape == (W, W, 4)
    assert torch.all(data[..., 3] == SPP)


def test_mesh_errors_are_the_jax_packages():
    scene, _, _ = scene_of("cornell")
    with pytest.raises(ValueError, match=r"spp \(8\) must divide by mesh "
                                         r"size \(3\)"):
        render_multichip(scene, seed=SEED, spp=SPP, mesh=cpu_mesh(3))
    with pytest.raises(ValueError, match=r"film height \(16\) must divide "
                                         r"by mesh \(3\)"):
        render_multichip_pixel_sharded(scene, seed=SEED, spp=SPP,
                                       mesh=cpu_mesh(3))
    with pytest.raises(ValueError, match="at least one device"):
        Mesh([])


def test_default_mesh_follows_the_ports_device():
    """With the port's device the CPU, the default mesh is the CPU alone
    (the CLI's ``--cpu --multichip``)."""
    mesh = default_mesh()
    assert mesh.devices == [CPU] and mesh.axis_name == "chips"
    assert default_mesh(["cpu", "cpu"], axis_name="x").size == 2


def test_replicas_move_the_packed_tensors():
    """A scene's replica on another device (the meta device here) holds
    its own kernel tables, ray-query shape ids and quad rows and shares
    the plugins; the kernel objects move with ``to``, once a device; on
    the scene's own device each is itself."""
    scene, _, _ = scene_of("cornell")
    assert scene.replica(CPU) is scene
    meta = scene.replica("meta")
    assert meta is scene.replica("meta") and meta.replica_of is scene
    assert meta.device == torch.device("meta")
    assert meta.tables.device == torch.device("meta")
    assert meta._face_shape_dev.device == torch.device("meta")
    assert meta._quad_dev.device == torch.device("meta")
    assert meta.shapes is scene.shapes and meta.emitters is scene.emitters
    assert scene.tables.device == CPU
    mk = scene.integrator._kernel_for(scene, scene.sensors[0])
    assert mk.to(CPU) is mk
    moved = mk.to("meta")
    assert moved is mk.to("meta") and moved is not mk
    assert moved.tables.device == moved.cam.device == torch.device("meta")
    assert mk.tables.device == CPU
    assert scene.integrator._kernel(meta, scene.sensors[0]) is moved
    vol, _, _ = scene_of("volpath")
    vk = vol.integrator._kernel_for(vol, vol.sensors[0])
    assert vk.to("meta").tables.device == torch.device("meta")
    assert vol.integrator._kernel(vol, vol.sensors[0], banded=True) is None


def test_lane_keys_of_a_band_are_the_films_rows():
    full_keys, full_pix = pk.lane_keys(SEED, 4, 3, torch.arange(W * W * 3))
    lanes = torch.arange(W * 5 * 3)
    keys, pix = pk.lane_keys(SEED, 4, 3, lanes, pixel_base=6 * W)
    rows = slice(6 * W * 3, 11 * W * 3)
    assert torch.equal(keys, full_keys[rows])
    assert torch.equal(pix, full_pix[rows])


def test_plain_path_kernel_band_is_the_films_rows():
    scene, _, _ = scene_of("cornell")
    cam = pk.camera_row(scene.sensors[0], CPU)
    args = (scene.tables, cam, SEED, 0, 4, W, W, DEPTH, 5)
    full = pk.path_radiance_reference(*args)
    band = pk.path_radiance_reference(*args, row0=5, n_rows=7)
    assert band.shape == (3, W * 7 * 4)
    assert torch.equal(band, full[:, W * 5 * 4:W * 12 * 4])
    assert torch.equal(pk.path_radiance(*args, row0=5, n_rows=7), band)


@pytest.mark.parametrize("rfilter", ["box", "gaussian", "lanczos"])
def test_plain_splat_bands_add_up_to_the_films_block(rfilter):
    """The bands' blocks, added at their rows, are the film's block:
    bit for bit under the box filter, within 2e-5 where borders
    overlap."""
    mt.set_variant("scalar_rgb")
    rf = mt.load_dict({"type": rfilter})
    spp, h = 4, 12
    rgb = torch.rand((3, W * h * spp), generator=torch.Generator()
                     .manual_seed(1))
    full = sp.splat_reference(rgb, SEED, 2, spp, W, h, rf)
    b = (full.shape[0] - h) // 2
    acc = torch.zeros_like(full)
    for row0, n_rows in ((0, 5), (5, 4), (9, 3)):
        lanes = rgb[:, row0 * W * spp:(row0 + n_rows) * W * spp]
        band = sp.splat(lanes.contiguous(), SEED, 2, spp, W, h, rf,
                        row0=row0, n_rows=n_rows)
        assert band.shape == (n_rows + 2 * b, W + 2 * b, 4)
        acc[row0:row0 + n_rows + 2 * b] += band
    if rfilter == "box":
        assert torch.equal(acc, full)
    else:
        assert (acc - full).abs().max() <= ATOL


def test_matches_jax_multichip():
    """The port's sample-sharded and banded Cornell box (the path
    kernel's plain version) against the JAX package's
    ``render_multichip`` and ``render_multichip_pixel_sharded`` through
    its path kernel (interpret mode) on 2 virtual CPU devices."""
    import jax
    import mitsuba2_tpu as mj
    from jax.sharding import Mesh as JMesh
    from mitsuba2_tpu.parallel import mesh as jmesh
    from mitsuba2_tpu.python.test.scenes import cornell_box_dict as cj
    mj.set_variant("scalar_rgb")
    jscene = mj.load_dict(cj(width=W, height=W, spp=SPP, max_depth=DEPTH))
    jm = JMesh(np.asarray(jax.devices()[:2]), ("chips",))
    want_mc = np.asarray(jmesh.render_multichip(
        jscene, seed=SEED, spp=SPP, mesh=jm, force_megakernel=True))
    want_px = np.asarray(jmesh.render_multichip_pixel_sharded(
        jscene, seed=SEED, spp=SPP, mesh=jm, force_megakernel=True))
    assert jscene.integrator.last_engine == "megakernel"
    scene, _, _ = scene_of("cornell")
    mesh = cpu_mesh(2)
    assert_images_agree(render_multichip(scene, seed=SEED, spp=SPP,
                                         mesh=mesh).numpy(), want_mc)
    assert_images_agree(render_multichip_pixel_sharded(
        scene, seed=SEED, spp=SPP, mesh=mesh).numpy(), want_px)


@pytest.mark.cuda
def test_cuda_bands_match_plain_version():
    """On the card: the path kernel's and the splat kernel's band
    launches against their plain versions on the same rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mt.set_variant("scalar_rgb")
    prev = mt.device()
    try:
        mt.set_device("cuda")
        scene = mt.load_dict(scenes.cornell_materials_dict(32, 32, 4, 4))
    finally:
        mt.set_device(prev)
    cam = pk.camera_row(scene.sensors[0], scene.device)
    args = (scene.tables, cam, SEED, 0, 4, 32, 32, 4, 5)
    got = pk.path_radiance(*args, row0=8, n_rows=16)
    want = pk.path_radiance_reference(*args, row0=8, n_rows=16)
    rel = ((got - want).abs() / want.abs().clamp(min=1e-3)).amax(0)
    assert float((rel <= 1e-4).float().mean()) >= 0.99
    rf = scene.sensors[0].film.rfilter
    block = sp.splat(want, SEED, 0, 4, 32, 32, rf, row0=8, n_rows=16)
    ref = sp.splat_reference(want, SEED, 0, 4, 32, 32, rf, row0=8,
                             n_rows=16)
    err = (block - ref).abs()
    assert bool(((err <= 1e-5 * ref.abs()) | (err <= 1e-6)).all())
