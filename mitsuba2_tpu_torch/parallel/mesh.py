"""Multi-device rendering over a mesh of torch devices.

Counterpart of ``mitsuba2_tpu/parallel/mesh.py``. Monte Carlo rendering is
embarrassingly parallel over samples and pixels, so a render shards one of
two ways:

- **sample axis** (``render_multichip``): every device renders the whole
  film at spp / n samples a pixel, shard i the samples from i * spp / n
  (sample ids are global, so the counter-based streams need no
  coordination), and the shards' image blocks are summed into the first
  device;
- **pixel axis** (``render_multichip_pixel_sharded``): every device
  renders a band of film rows at every sample, each lane keyed on its
  global pixel id, so that the bands together are the single-device
  render sample for sample; the bands' blocks are assembled on the first
  device with an overlap-add of the filter border.

The design is the JAX package's single controller (its ``shard_map``),
not ``torch.distributed``: one process drives every device of the mesh.
For each shard it takes the scene's replica on the shard's device
(``Scene.replica``: the packed tables moved there once, the plugins'
values cached per device) and launches the shard's passes on that
device's current stream; no shard waits for another before the reduce,
so the devices' kernels run side by side. A shard renders through
whatever engine a single-device render of the scene takes: the path
kernel, the volumetric kernel or the wavefront; a band takes the path
kernel where its gate passes and the wavefront otherwise (the volumetric
kernel renders whole films). A mesh may repeat a device (the CPU tests'
mesh) or mix devices: a ``[cuda:0, cpu]`` mesh runs the placement and the
cross-device reduce on a machine with one card, its CPU shard on the
plain versions because its device is the CPU. Nothing falls back on its
own: a shard whose kernel fails to build or launch raises.

A sample-sharded render equals the single-device render within float
rounding where the shards' passes split the samples where the single
render's do (the passes of the volpath wavefront, whose loops draw for a
whole pass, fix its sample streams): each shard takes the single
render's pass size where its samples are a multiple of it.
"""

from __future__ import annotations

import contextlib

import torch

from ..render.film import ImageBlock, border
from ..render.integrator import pass_spp
from ..variants import device as _port_device, resolve_device


class Mesh:
    """The devices of a render and the name of their one axis (the role
    of a ``jax.sharding.Mesh`` of one axis)."""

    def __init__(self, devices, axis_name: str = "chips"):
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_name = axis_name

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis_name={self.axis_name!r})")


def default_mesh(devices=None, axis_name: str = "chips") -> Mesh:
    """A mesh of ``devices``; by default every CUDA device the process
    sees, or the CPU alone where the port's device is the CPU
    (``set_device("cpu")``)."""
    if devices is None:
        if _port_device().type == "cpu":
            devices = [torch.device("cpu")]
        else:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
            if not devices:
                raise RuntimeError(
                    "no CUDA device for the default mesh; pass devices= "
                    "or call set_device('cpu') first")
    return Mesh(devices, axis_name)


def _on(device):
    """The context that makes ``device`` current for a shard's launches."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def render_multichip(scene, sensor=0, seed=0, spp=None, mesh=None,
                     axis_name: str = "chips", develop=True):
    """Sample-axis-sharded render: each device of the mesh renders spp / n
    samples of the whole film; the blocks are summed into the mesh's first
    device -> the (h, w, 3 + AOV channels) image there, or with
    ``develop=False`` the summed accumulation block (one weight channel
    more)."""
    if isinstance(sensor, int):
        sensor = scene.sensors[sensor]
    integrator = scene.integrator
    film = sensor.film
    sampler = sensor.sampler
    if mesh is None:
        mesh = default_mesh(axis_name=axis_name)
    n_dev = mesh.size
    if spp is None:
        spp = sampler.sample_count
    if spp % n_dev != 0:
        raise ValueError(f"spp ({spp}) must divide by mesh size ({n_dev})")
    spp_per_dev = spp // n_dev
    # the single render's pass boundaries, where the shard's samples fall
    # on them
    k = pass_spp(integrator, scene, sensor, spp)
    if spp_per_dev % k:
        k = pass_spp(integrator, scene, sensor, spp_per_dev)
    blocks = []
    for i, dev in enumerate(mesh.devices):
        replica = scene.replica(dev)
        with _on(dev):
            data = None
            for p in range(spp_per_dev // k):
                block = integrator.render_wavefront(
                    replica, sensor, sampler, seed, i * spp_per_dev + p * k,
                    k, spp)
                data = block if data is None else data + block
        blocks.append(data)
    home = mesh.devices[0]
    data = blocks[0]
    for block in blocks[1:]:
        data = data + block.to(home)
    w, h = film.crop_size
    block = ImageBlock((w, h), 3 + len(integrator.aov_names()), film.rfilter,
                       home)
    return block.develop(data) if develop else data


def render_multichip_pixel_sharded(scene, sensor=0, seed=0, spp=None,
                                   mesh=None, axis_name: str = "chips"):
    """Pixel-axis sharding: each device renders a band of h / n film rows
    at every sample; the bands' blocks, their borders overlapping by the
    filter's, are added at their rows on the mesh's first device and
    developed -> the (h, w, 3 + AOV channels) image there. Under the box
    filter the bands do not overlap and the image is the single-device
    render's bit for bit where both take the same passes."""
    if isinstance(sensor, int):
        sensor = scene.sensors[sensor]
    integrator = scene.integrator
    film = sensor.film
    sampler = sensor.sampler
    if mesh is None:
        mesh = default_mesh(axis_name=axis_name)
    n_dev = mesh.size
    if spp is None:
        spp = sampler.sample_count
    w, h = film.crop_size
    if h % n_dev != 0:
        raise ValueError(f"film height ({h}) must divide by mesh ({n_dev})")
    band_h = h // n_dev
    bands = []
    for i, dev in enumerate(mesh.devices):
        with _on(dev):
            bands.append(_render_band(scene.replica(dev), sensor, sampler,
                                      integrator, seed, i * band_h, band_h,
                                      spp))
    home = mesh.devices[0]
    b = border(film.rfilter)
    full = torch.zeros((h + 2 * b, w + 2 * b, bands[0].shape[-1]),
                       dtype=torch.float32, device=home)
    for i, band in enumerate(bands):
        full[i * band_h:i * band_h + band_h + 2 * b] += band.to(home)
    block = ImageBlock((w, h), full.shape[-1] - 1, film.rfilter, home)
    return block.develop(full)


def _render_band(scene, sensor, sampler, integrator, seed, row0, band_h,
                 spp):
    """Render every lane of the band of film rows ``row0 .. row0 +
    band_h`` on the scene's device, in passes within the band's cap ->
    the band's padded accumulation block (band_h + 2b, w + 2b, C + 1)."""
    k = pass_spp(integrator, scene, sensor, spp, rows=band_h, banded=True)
    data = None
    for p in range(spp // k):
        block = integrator.render_wavefront(scene, sensor, sampler, seed,
                                            p * k, k, spp, row0=row0,
                                            n_rows=band_h)
        data = block if data is None else data + block
    return data
