"""The volpath slice (ops/volpath_kernel.py): the plain PyTorch version of
the volumetric kernel against the JAX package's ``_volpath_kernel`` (Pallas
interpret mode) on the reference's own tables, ``load_dict`` +
``scene.integrator.render`` of the port against the same image, the
wrapper's behaviour, and the CUDA kernel against the plain version on the
card for all 16 instantiations.

This file renders the bench slab (bench.py ``bench_volpath``: a 16^3
heterogeneous medium, HG g = 0.3, under ``volpath``, the main path's
scope); test_torch_volpath_surfaces.py and test_torch_volpath_mis.py
render the GGX + dielectric and the volpathmis arms. Each file renders the
JAX kernel once, in a module fixture, so that xdist spreads them.

Tolerance: the bar of tests/test_torch_path_kernel.py, at least 99% of
pixels within 1e-4 relative and image means within 1e-5. Both sides draw
the same TEA and mix32 streams. The reference fetches sigma_t through
``_dot3T``'s bf16 three-pass products (about 2^-16 relative), which can
flip a delta-tracking accept test ``u < sigma / majorant`` and move a
whole sample, so the reference fixture patches
``mitsuba2_tpu.ops.volmegakernel._dot3T`` to an exact float32
``dot_general`` for its render (the JAX package's files stay as they
are). ``_dot3`` (the Woop tests) and ``_dotpick`` (the attribute and
light-row picks) needed no patch: with ``_dot3`` patched as well the
reference image was the same, and ``_dotpick``'s hi/lo split is exact for
one-hot picks. Measured at this size (16x16x16 spp, max_depth 3,
rr_depth 1, seed 3): every pixel within 8.6e-7 relative, image means
equal to float rounding; the unpatched reference agrees too (1.0e-6).

The JAX package is imported inside the fixtures that need it, so that the
card's test run (``-m cuda``, see README) needs no JAX.
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.ops import volpath_kernel as vk
from mitsuba2_tpu_torch.python.test.scenes import volpath_slab_dict
from tests.test_torch_path_kernel import (assert_images_agree, box_develop,
                                          cpu_device_fixture)

_on_cpu = cpu_device_fixture()

W, SPP, MAX_DEPTH, RR_DEPTH, SEED = 16, 16, 3, 1, 3


def surfaces(T, metal=True, glass=True):
    """A GGX aluminium floor and a glass pane in front of the slab
    (tests/test_volmegakernel.py:246-255), built on the Transform ``T``."""
    out = {}
    if metal:
        out["metal"] = {"type": "rectangle",
                        "to_world": (T.translate([0, -2.5, 0])
                                     @ T.rotate([1, 0, 0], -90)
                                     @ T.scale(3.0)),
                        "bsdf": {"type": "roughconductor", "alpha": 0.4,
                                 "distribution": "ggx", "material": "Al"}}
    if glass:
        out["glass"] = {"type": "rectangle",
                        "to_world": T.translate([0, 0, 1.6]) @ T.scale(1.4),
                        "bsdf": {"type": "dielectric"}}
    return out


def jax_slab_dict(width=W, height=W, spp=SPP, max_depth=MAX_DEPTH,
                  grid=None, albedo=0.8, g=0.3, extra=None):
    """bench.py's ``bench_volpath`` dict, on the JAX Transform, at the
    given size; ``extra(T)`` adds top-level entries."""
    from mitsuba2_tpu.core.transform import Transform as T
    if grid is None:
        grid = np.random.default_rng(0).uniform(
            0.2, 2.0, (16, 16, 16)).astype(np.float32)
    d = {"type": "scene",
         "integrator": {"type": "volpath", "max_depth": max_depth},
         "slab": {"type": "cube", "bsdf": {"type": "null"},
                  "interior": {"type": "heterogeneous",
                               "sigma_t": {"type": "grid3d", "data": grid},
                               "albedo": {"type": "rgb",
                                          "value": [albedo] * 3},
                               "to_world": (T.translate([-1, -1, -1])
                                            @ T.scale(2.0)),
                               "phase": {"type": "hg", "g": g}}},
         "light": {"type": "rectangle",
                   "to_world": T.translate([0, 0, -2.5]) @ T.scale(2.0),
                   "emitter": {"type": "area",
                               "radiance": {"type": "rgb",
                                            "value": [4.0] * 3}}},
         "sensor": {"type": "perspective", "fov": 35.0,
                    "to_world": T.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]),
                    "film": {"type": "hdrfilm", "width": width,
                             "height": height,
                             "rfilter": {"type": "box"}},
                    "sampler": {"type": "independent",
                                "sample_count": spp}}}
    if extra is not None:
        d.update(extra(T))
    return d


def jax_cam(sensor):
    """The JAX sensor's camera row, as the port's ``camera_row`` lays it
    out."""
    mat = np.asarray(sensor.world_transform.matrix, np.float32)
    return torch.as_tensor(np.concatenate([
        mat[:3, :3].reshape(-1), mat[:3, 3],
        [np.tan(np.deg2rad(sensor.x_fov) * 0.5)],
        np.zeros(3)]).astype(np.float32))


def jax_reference(g=0.3, mis=False, extra=None):
    """-> (image (W, W, 3), the reference's tables as VolPathTables, its
    camera row): the JAX kernel in interpret mode on the slab, with
    ``_dot3T`` exact (see the module docstring)."""
    import jax
    import jax.numpy as jnp
    import mitsuba2_tpu as mj
    import mitsuba2_tpu.ops.volmegakernel as vm

    def exact_dot3T(aT, b):
        return jax.lax.dot_general(
            aT, b, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)

    mj.set_variant("scalar_rgb")
    scene = mj.load_dict(jax_slab_dict(g=g, extra=extra))
    mk = vm.VolPathMegakernel(scene, interpret=True, mis=mis)
    mk.max_depth, mk.rr_depth = MAX_DEPTH, RR_DEPTH
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vm, "_dot3T", exact_dot3T)
        acc = np.asarray(mk.render_pass(scene.sensors[0], SEED, 0, SPP))
    return (acc[..., :3] / acc[..., 3:], vk.vol_tables_from_reference(mk),
            jax_cam(scene.sensors[0]))


def port_slab(g=0.3, mis=False, extra=None, **kw):
    """The port's slab scene at the tests' size, rr_depth RR_DEPTH."""
    mt.set_variant("scalar_rgb")
    d = volpath_slab_dict(W, W, SPP, MAX_DEPTH, g=g, **kw)
    if extra is not None:
        d.update(extra(mt.Transform))
    d["integrator"]["rr_depth"] = RR_DEPTH
    if mis:
        d["integrator"]["type"] = "volpathmis"
    return mt.load_dict(d)


def check_against_reference(reference, flags, mis=False, g=0.3,
                            extra=None):
    """The plain version on the reference's tables, and the port's own
    load_dict + render, against the reference image."""
    ref, tables, cam = reference
    assert tables.flags == flags
    rad = vk.volpath_radiance_reference(tables, cam, SEED, 0, SPP, W, W,
                                        MAX_DEPTH, RR_DEPTH, mis=mis)
    assert rad.shape == (3, W * W * SPP) and rad.dtype == torch.float32
    assert torch.isfinite(rad).all() and (rad >= 0).all()
    assert_images_agree(box_develop(rad, W, W, SPP).numpy(), ref)

    scene = port_slab(g=g, mis=mis, extra=extra)
    img = scene.integrator.render(scene, seed=SEED, spp=SPP)
    assert scene.integrator.last_engine == "kernel"
    assert scene.integrator.engine_reason is None
    assert img.shape == (W, W, 3) and img.device == torch.device("cpu")
    assert torch.isfinite(img).all()
    assert_images_agree(img.numpy(), ref)


@pytest.fixture(scope="module")
def reference():
    return jax_reference()


def test_plain_version_and_render_match_jax_kernel(reference):
    check_against_reference(reference, vk.HAS_HG)


def test_port_tables_render_like_reference_tables(reference):
    """The port's own tables give the reference's lanes."""
    _, tables, cam = reference
    scene = port_slab()
    mine = vk.build_vol_tables(scene)
    args = (cam, SEED, 0, 2, W, W, MAX_DEPTH, RR_DEPTH)
    assert torch.equal(vk.volpath_radiance_reference(mine, *args),
                       vk.volpath_radiance_reference(tables, *args))


def test_plain_version_is_lane_local(reference):
    """A lane's radiance depends only on its (pixel, sample) key: lane
    chunking and pass splitting change nothing."""
    _, tables, cam = reference
    args = (tables, cam, SEED, 0, SPP, W, W, MAX_DEPTH, RR_DEPTH)
    full = vk.volpath_radiance_reference(*args)
    old = vk._CHUNK_ELEMS
    try:
        vk._CHUNK_ELEMS = 333 * vk.NULL_BUDGET
        chunked = vk.volpath_radiance_reference(*args)
    finally:
        vk._CHUNK_ELEMS = old
    assert torch.equal(full, chunked)
    second = vk.volpath_radiance_reference(tables, cam, SEED, 8, 8, W, W,
                                           MAX_DEPTH, RR_DEPTH)
    assert torch.equal(full.reshape(3, W * W, SPP)[:, :, 8:],
                       second.reshape(3, W * W, 8))


def test_render_passes_keep_the_image():
    """Rendering in passes (the integrator's wavefront cap) sums the same
    lanes as one pass."""
    scene = port_slab()
    integ = scene.integrator
    one = integ.render(scene, seed=SEED, spp=8)
    old = integ.MAX_WAVEFRONT_KERNEL
    try:
        integ.MAX_WAVEFRONT_KERNEL = W * W * 2
        split = integ.render(scene, seed=SEED, spp=8)
    finally:
        integ.MAX_WAVEFRONT_KERNEL = old
    torch.testing.assert_close(split, one, rtol=1e-6, atol=1e-7)


def test_wrapper_runs_plain_version_on_cpu(reference):
    _, tables, cam = reference
    before = vk.volpath_radiance.launches
    out = vk.volpath_radiance(tables, cam, SEED, 0, 2, W, W, MAX_DEPTH,
                              RR_DEPTH)
    assert vk.volpath_radiance.launches == before      # no kernel launched
    assert torch.equal(out, vk.volpath_radiance_reference(
        tables, cam, SEED, 0, 2, W, W, MAX_DEPTH, RR_DEPTH))


def test_wrapper_refuses_devices_without_a_kernel(reference):
    _, tables, cam = reference
    with pytest.raises(ValueError, match="no volpath kernel for device meta"):
        vk.volpath_radiance(tables.to("meta"), cam.to("meta"), SEED, 0, 1,
                            W, W, 2, 5)


def cuda_scenes():
    """(flags, scene dict) of one small scene per instantiation: the slab
    with g 0.3 or 0 (isotropic), with or without the GGX floor and the
    glass pane, under volpath or volpathmis (16x16 at 8 spp, depth 8,
    rr_depth 2), as tools/time_paths.py builds them for ``--compare``."""
    from mitsuba2_tpu_torch.python.test import scenes
    from mitsuba2_tpu_torch.tools.time_paths import VOL_PATHS, vol_dict
    return [(p.flags, vol_dict(p, scenes, mt.Transform, vk))
            for p in VOL_PATHS if p.flags >= 0]


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version_in_every_instantiation():
    """Each of the 16 instantiations against the plain version on the
    card, on the port's own tables, its persistent launch's grid and a
    relaunch into an output of NaN bit-identical; the render goes through
    the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mt.set_variant("scalar_rgb")
    prev = mt.device()
    try:
        mt.set_device("cuda")
        for flags, d in cuda_scenes():
            scene = mt.load_dict(d)
            integ = scene.integrator
            tables = vk.build_vol_tables(scene)
            assert tables.flags | (vk.MIS if integ.USE_MIS else 0) == flags
            cam = pk.camera_row(scene.sensors[0], scene.device)
            args = (tables, cam, SEED, 0, 8, 16, 16, 8, 2)
            before = vk.volpath_radiance.launches_by_kernel[flags]
            got = vk.volpath_radiance(*args, mis=integ.USE_MIS)
            torch.cuda.synchronize()
            assert vk.volpath_radiance.launches_by_kernel[flags] \
                == before + 1
            # persistent: a grid of the SMs x the resident blocks; lanes
            # reach threads in no fixed order, and a relaunch into an
            # output of NaN must write every lane, bit for bit the same
            info = vk.volpath_radiance.last_launch[flags]
            assert info["blocks_per_sm"] >= 1
            assert info["grid"] == info["sms"] * info["blocks_per_sm"]
            again = torch.full_like(got, float("nan"))
            vk.launch(*args, integ.USE_MIS, again,
                      torch.zeros(1, dtype=torch.int32, device="cuda"))
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            want = vk.volpath_radiance_reference(*args, mis=integ.USE_MIS)
            assert_images_agree(box_develop(got, 16, 16, 8).cpu().numpy(),
                                box_develop(want, 16, 16, 8).cpu().numpy())
            img = integ.render(scene, seed=SEED, spp=8)
            assert integ.last_engine == "kernel"
            assert img.device.type == "cuda"
            assert vk.volpath_radiance.launches_by_kernel[flags] \
                == before + 2
    finally:
        mt.set_device(prev)
