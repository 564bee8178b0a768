"""The film splat of the path kernel's samples: host side, plain PyTorch
version and the CUDA kernel's wrapper.

Counterpart of the separable shift-splat at the end of
``DiffusePathMegakernel.render_pass`` (mitsuba2_tpu/ops/megakernel.py:
3041-3073, XLA code there, not a Pallas kernel). Every lane of a pass is one
sample of pixel ``lane // spp`` at film position (px + jx, py + jy), its
jitter re-derived from the lane's TEA key at sampler dimension 0 exactly as
the path kernel drew it. Tap (ox, oy), each in [-b, b] with b = ceil(radius
- 1/2), puts the sample's [r, g, b, 1] times f(ox + 1/2 - jx) f(oy + 1/2 -
jy) into block pixel (b + px + ox, b + py + oy) of the (h + 2b, w + 2b, 4)
block (imageblock.cpp:62 semantics; ``render/film.py ImageBlock.put`` is
the general per-sample splat).

``splat`` runs the hand-written kernel (csrc/splat_kernel.cu) for samples on
a CUDA device and ``splat_reference`` -- the reference's tap loop in plain
PyTorch -- for samples on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from ..render.film import border
from .path_kernel import _rng2, lane_keys

# filter constants csrc/splat_kernel.cu takes, and its widest stencil
MAX_PARAMS, MAX_TAPS = 8, 9


def splat_reference(rgb, seed, sample_base, spp, width, height, rfilter):
    """(3, n) per-lane radiance of a pass, n = width * height * spp ->
    the (height + 2b, width + 2b, 4) block: per tap, the samples weighted
    by the filter summed per pixel, then added at the tap's offset."""
    dev = rgb.device
    n = width * height * spp
    key, _ = lane_keys(seed, sample_base, spp, torch.arange(n, device=dev))
    jx, jy = _rng2(key, 0)
    b = border(rfilter)
    fx = [rfilter.eval((o + 0.5) - jx) for o in range(-b, b + 1)]
    fy = [rfilter.eval((o + 0.5) - jy) for o in range(-b, b + 1)]
    vals4 = torch.cat([rgb, torch.ones((1, n), device=dev)])
    acc = torch.zeros((height + 2 * b, width + 2 * b, 4), device=dev)
    for ti in range(2 * b + 1):
        for tj in range(2 * b + 1):
            tap = (vals4 * (fx[tj] * fy[ti])).reshape(
                4, width * height, spp).sum(dim=2)
            acc[ti:ti + height, tj:tj + width] += tap.T.reshape(
                height, width, 4)
    return acc


class _SplatArgs(ctypes.Structure):
    """csrc/splat_kernel.cu's SplatArgs, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in ("rgb", "taps", "out")]
                + [("params", ctypes.c_float * MAX_PARAMS),
                   ("seed", ctypes.c_uint32),
                   ("sample_base", ctypes.c_uint32)]
                + [(name, ctypes.c_int) for name in (
                    "filter", "border", "spp", "width", "height")])


def splat(rgb, seed, sample_base, spp, width, height, rfilter):
    """The pass's image block (see ``splat_reference``): the CUDA kernel
    for samples on a CUDA device, the plain version for samples on the
    CPU. A build or launch failure raises."""
    dev = rgb.device
    if dev.type == "cpu":
        return splat_reference(rgb, seed, sample_base, spp, width, height,
                               rfilter)
    if dev.type != "cuda":
        raise ValueError(f"no splat kernel for device {dev}")
    n = width * height * spp
    if rgb.dtype != torch.float32 or not rgb.is_contiguous() \
            or tuple(rgb.shape) != (3, n):
        raise ValueError(f"rgb must be a contiguous float32 (3, {n}) "
                         f"tensor, got {tuple(rgb.shape)} {rgb.dtype}")
    if n >= 1 << 31:
        raise ValueError(f"{n} lanes overflow the kernel's int32 lane ids")
    b = border(rfilter)
    if 2 * b + 1 > MAX_TAPS:
        raise ValueError(f"filter radius {rfilter.radius} needs "
                         f"{2 * b + 1} taps a row > {MAX_TAPS}")
    fid, params = rfilter.kernel_params()
    k = 2 * b + 1
    taps = torch.empty((width * height, k * k * 4), dtype=torch.float32,
                       device=dev)
    out = torch.empty((height + 2 * b, width + 2 * b, 4),
                      dtype=torch.float32, device=dev)
    if n == 0:
        return out.zero_()
    args = _SplatArgs(rgb.data_ptr(), taps.data_ptr(), out.data_ptr(),
                      (ctypes.c_float * MAX_PARAMS)(*params),
                      seed & 0xFFFFFFFF, sample_base & 0xFFFFFFFF, fid, b,
                      spp, width, height)
    fn = _splat_render()
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(args), torch.cuda.current_stream(
            dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"splat_kernel launch failed: CUDA error {err}")
    splat.launches += 1
    return out


# kernel launches (one per splat: its tap and gather passes)
splat.launches = 0


def reset_launch_counts():
    splat.launches = 0


def libraries():
    """(name, defines) of the kernel's library, for ``build.build_all``."""
    return [("splat_kernel", {})]


def _splat_render():
    """csrc/splat_kernel.cu's C entry point, built on first use."""
    from .build import load
    fn = load("splat_kernel").splat_render
    fn.argtypes = [ctypes.POINTER(_SplatArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
