"""The path kernel module: its plain PyTorch version against the JAX
package's Pallas path kernel (interpret mode) on the reference's own
tables, and the CUDA kernel against the plain version on the card.

Tolerance. Both sides draw the same TEA streams, so they agree lane by
lane up to float rounding. The JAX intersection runs its Woop products
through bf16 3-pass matmuls (about 2^-16 relative error), so a lane that
grazes an edge, a shadow boundary or a roulette threshold can in principle
take the other branch and move its pixel by a whole sample. The bar is
therefore statistical: at least 99% of pixels within 1e-4 relative (the
largest channel error of a pixel, against max(|ref|, 1e-3)), and the image
mean within 1e-5 relative. Measured at this size: every pixel within
7.3e-5, image means 1.4e-6 apart, no branch flips.

The JAX package is imported inside the fixture that needs it, so that the
card's test run (``-m cuda``, see README) needs no JAX.
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.python.test.scenes import cornell_box_dict as cornell_t

W, SPP, MAX_DEPTH, RR_DEPTH, SEED = 16, 16, 4, 2, 3
PIX_RTOL, PIX_SHARE, MEAN_RTOL = 1e-4, 0.99, 1e-5


def cpu_device_fixture():
    """A module-scoped autouse fixture that loads this module's scenes on
    the CPU (the port's default device is ``cuda``) and runs its torch ops
    on one CPU thread, restoring both afterwards. Each test_torch_*.py
    module binds one. One thread: the test workers share the machine's
    cores, and torch's default of a thread per core in every worker
    oversubscribes them; the tests' tensors are too small for the threads
    to pay."""
    @pytest.fixture(scope="module", autouse=True)
    def _on_cpu():
        prev, threads = mt.device(), torch.get_num_threads()
        mt.set_device("cpu")
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)
        mt.set_device(prev)
    return _on_cpu


_on_cpu = cpu_device_fixture()


def pixel_errors(a, b):
    """Largest relative channel error of each pixel of (h, w, 3) images."""
    return (np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max(-1)


def assert_images_agree(a, b):
    err = pixel_errors(a, b)
    assert (err <= PIX_RTOL).mean() >= PIX_SHARE, np.quantile(err, 0.99)
    assert abs(a.mean() - b.mean()) <= MEAN_RTOL * abs(b.mean()), \
        (a.mean(), b.mean())


def box_develop(rad, w, h, spp):
    return rad.reshape(3, w * h, spp).mean(dim=2).T.reshape(h, w, 3)


@pytest.fixture(scope="module")
def reference():
    """The JAX kernel's tables, camera row and interpret-mode image."""
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.ops.megakernel import DiffusePathMegakernel
    from mitsuba2_tpu.python.test.scenes import cornell_box_dict as cornell_j
    mj.set_variant("scalar_rgb")
    d = cornell_j(width=W, height=W, spp=SPP, max_depth=MAX_DEPTH)
    scene = mj.load_dict(d)
    mk = DiffusePathMegakernel(scene, interpret=True)
    mk.max_depth, mk.rr_depth = MAX_DEPTH, RR_DEPTH
    acc = np.asarray(mk.render_pass(scene.sensors[0], SEED, 0, SPP))
    sensor = scene.sensors[0]
    mat = np.asarray(sensor.world_transform.matrix, np.float32)
    cam = np.concatenate([mat[:3, :3].reshape(-1), mat[:3, 3],
                          [np.tan(np.deg2rad(sensor.x_fov) * 0.5)],
                          np.zeros(3)]).astype(np.float32)
    tables, cam = pk.tables_from_reference(
        np.asarray(mk.woop), np.asarray(mk._fattr()), np.asarray(mk.lights),
        cam)
    return tables, cam, acc[..., :3] / acc[..., 3:]


def test_plain_version_matches_jax_kernel(reference):
    tables, cam, ref = reference
    rad = pk.path_radiance_reference(tables, cam, SEED, 0, SPP, W, W,
                                     MAX_DEPTH, RR_DEPTH)
    assert rad.shape == (3, W * W * SPP) and rad.dtype == torch.float32
    assert torch.isfinite(rad).all() and (rad >= 0).all()
    assert_images_agree(box_develop(rad, W, W, SPP).numpy(), ref)


def test_plain_version_is_lane_local(reference):
    """A lane's radiance depends only on its (pixel, sample) key: the lane
    chunking of the plain version and pass splitting change nothing."""
    tables, cam, _ = reference
    args = (tables, cam, SEED, 0, SPP, W, W, MAX_DEPTH, RR_DEPTH)
    full = pk.path_radiance_reference(*args)
    old = pk._CHUNK_ELEMS
    try:
        pk._CHUNK_ELEMS = 333 * tables.n_faces
        chunked = pk.path_radiance_reference(*args)
    finally:
        pk._CHUNK_ELEMS = old
    assert torch.equal(full, chunked)
    # samples 8..15 of every pixel, rendered as their own pass
    second = pk.path_radiance_reference(tables, cam, SEED, 8, 8, W, W,
                                        MAX_DEPTH, RR_DEPTH)
    assert torch.equal(full.reshape(3, W * W, SPP)[:, :, 8:],
                       second.reshape(3, W * W, 8))


def test_wrapper_runs_plain_version_on_cpu(reference):
    tables, cam, _ = reference
    before = pk.path_radiance.launches
    out = pk.path_radiance(tables, cam, SEED, 0, 2, W, W, MAX_DEPTH,
                           RR_DEPTH)
    assert pk.path_radiance.launches == before      # no kernel launched
    assert torch.equal(out, pk.path_radiance_reference(
        tables, cam, SEED, 0, 2, W, W, MAX_DEPTH, RR_DEPTH))


def test_wrapper_refuses_devices_without_a_kernel(reference):
    tables, cam, _ = reference
    meta = tables.to("meta")
    with pytest.raises(ValueError, match="no path kernel for device meta"):
        pk.path_radiance(meta, cam.to("meta"), SEED, 0, 1, W, W, 2, 5)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The CUDA kernel against the plain version on the card, on the
    port's own Cornell tables (the main path's depth, RR exercised)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mt.set_variant("scalar_rgb")
    prev = mt.device()
    try:
        mt.set_device("cuda")
        scene = mt.load_dict(cornell_t(width=32, height=32, spp=16))
    finally:
        mt.set_device(prev)
    cam = pk.camera_row(scene.sensors[0], scene.device)
    args = (scene.tables, cam, SEED, 0, 16, 32, 32, 6, 3)
    before = pk.path_radiance.launches
    got = pk.path_radiance(*args)
    torch.cuda.synchronize()
    assert pk.path_radiance.launches == before + 1
    want = pk.path_radiance_reference(*args)
    assert_images_agree(box_develop(got, 32, 32, 16).cpu().numpy(),
                        box_develop(want, 32, 32, 16).cpu().numpy())
