"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (the path
kernel once per color mode and the volumetric kernel, in parallel nvcc
processes) and prints each kernel instantiation's registers and spills.
Then, for each path -- the Cornell box (the main path), the matpreview
scene (a rough gold sphere under an HDR sky above a checker floor), both
again under ``scalar_spectral``, and the Cornell box under ``scalar_mono``,
all at 256x256, 64 spp, max_depth 6; and the volpath slab (bench.py's
volpath config: a 16^3 heterogeneous medium in a null box before an area
light) at 256x256, 16 spp, max_depth 16 -- it checks the path's kernel
against its plain PyTorch version on the card at 64x64x16 spp, renders the
path through ``set_variant``, ``load_dict`` and
``scene.integrator.render`` on the port's default device, checks that the
render went through the path's kernel instantiation and that the image is
sane, and times render, kernel and plain version at the path's shape
beside the kernel's bound. Prints one JSON line of kernel results, the
card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero, and so
does a machine without CUDA: nothing runs on the CPU instead.
"""

import json
import re
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

WIDTH, SPP, MAX_DEPTH = 256, 64, 6
PARITY_WIDTH, PARITY_SPP, SEED = 64, 16, 7
# the tolerance of the CPU tests (tests/test_torch_path_kernel.py)
PIX_RTOL, PIX_SHARE, MEAN_RTOL = 1e-4, 0.99, 1e-5
REPEATS = 5
# the card's published peaks (H100 SXM, dense): fp32 outside the tensor
# cores, and HBM bandwidth
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# fp32 FLOPs (an FMA counts 2), counted roughly from csrc/path_kernel.cu:
# per path the camera ray, and in spectral mode per channel the hero
# wavelength, its D65 lookup and its share of the CIE develop; per traced
# ray the Woop t test of each face (two dot products, a division) and the
# quadratic of each sphere; per shadow ray the tests its loop runs before
# the first occluder; per shaded bounce the NEE sample, MIS, BSDF sample,
# frame and throughput update (a fixed part and a part per channel; in
# spectral mode the sigmoid and D65 evaluations per channel), with the GGX
# eval and visible-normal sample and two Fresnel terms per channel on a
# conductor; per escape the env lookup (atan2, acos, a bilinear fetch) and
# per env NEE sample its sin/cos and fetch. Compares, the binary searches
# and the TEA integer work are not counted, so the bound is a lower one.
PATH_FLOPS, SPECTRAL_PATH_FLOPS_PER_CHANNEL = 40, 60
FACE_FLOPS, SPHERE_FLOPS = 12, 20
SHADE_FLOPS, SHADE_FLOPS_PER_CHANNEL = 200, 40
SPECTRAL_SHADE_FLOPS_PER_CHANNEL = 25
GGX_FLOPS, GGX_FLOPS_PER_CHANNEL = 190, 50
ENV_ESCAPE_FLOPS, ENV_NEE_FLOPS = 80, 100
SPECTRAL_ENV_FLOPS_PER_CHANNEL = 12
# the volpath path (bench.py bench_volpath): 256x256, 16 spp, max_depth 16
VOL_SPP, VOL_MAX_DEPTH = 16, 16
# fp32 FLOPs of the volumetric kernel, counted roughly from
# csrc/volpath_kernel.cu: per round the box interval (about 55) and the
# Woop t test of each opaque face (FACE_FLOPS); per delta-tracking or
# ratio-tracking step the free-flight distance (a logf counted as one);
# per grid fetch the medium-local point, three clamped axes and seven
# lerps; per NEE evaluation the light sample, the direction, the pdf, the
# phase or BSDF value, the shadow ray's box interval and the sum (its face
# tests counted apart); per phase sample the HG inversion, the frame and
# the direction; per surface event the emission, frame, lobe sample and
# spawn. mix32 and TEA integer work and compares are not counted, so the
# bound is a lower one.
VOL_ROUND_FLOPS, VOL_STEP_FLOPS, VOL_FETCH_FLOPS = 55, 6, 80
VOL_NEE_FLOPS, VOL_PHASE_FLOPS, VOL_SURFACE_FLOPS = 130, 50, 110


def log(*args):
    print(*args, flush=True)


def timed(fn, repeats=REPEATS, warm_up=True):
    """-> (last result, median milliseconds) of fn() on the card, timed
    with CUDA events, after one warm-up call unless told otherwise."""
    out = fn() if warm_up else None
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return out, statistics.median(times)


def develop(rad, w, spp):
    return rad.reshape(3, w * w, spp).mean(dim=2).T.reshape(w, w, 3)


def compare(got, want, label):
    """Per-pixel agreement of two (w, w, 3) images -> max abs error."""
    g = got.double().cpu().numpy()
    r = want.double().cpu().numpy()
    err = (np.abs(g - r) / np.maximum(np.abs(r), 1e-3)).max(-1)
    share = float((err <= PIX_RTOL).mean())
    mean_rel = abs(g.mean() - r.mean()) / abs(r.mean())
    log(f"{label}: max pixel rel diff {err.max():.3e}, p99 "
        f"{np.quantile(err, 0.99):.3e}, share within {PIX_RTOL:g} "
        f"{share:.6f}, mean rel diff {mean_rel:.3e}")
    if share < PIX_SHARE or mean_rel > MEAN_RTOL:
        raise SystemExit(f"{label}: kernel and plain version disagree")
    return float(np.abs(g - r).max())


def ptxas_report(build_log, kernel="path_kernel"):
    """-> {template arguments: 'N registers, ... spill ...'} of ``kernel``'s
    instantiations from the compiler's -Xptxas=-v output of one library:
    (flags, nc) for the path kernel, (flags,) for the volumetric one."""
    out, inst = {}, None
    for line in build_log.splitlines():
        m = re.search(kernel + r"ILi(\d+)E(?:Li(\d+)E)?", line)
        if m:
            inst = tuple(int(g) for g in m.groups() if g is not None)
        if inst is None:
            continue
        if "spill" in line or "stack frame" in line:
            out[inst] = line.strip()
        elif "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out[inst] = f"{regs} registers; {out.get(inst, '')}"
    return out


def bound(pk, tables, stats, n_stats, n_paths):
    """-> (ms, 'operations' or 'bytes'): the least time the card could
    take for n_paths paths, from the per-lane work counted by the plain
    version (``stats`` over ``n_stats`` lanes of the same scene)."""
    per = {k: v / n_stats for k, v in stats.items()}
    nc = tables.nc
    spectral = nc == pk.MODE_NC["spectral"]
    shade = SHADE_FLOPS + SHADE_FLOPS_PER_CHANNEL * nc
    env = ENV_ESCAPE_FLOPS, ENV_NEE_FLOPS
    path = PATH_FLOPS
    if spectral:
        path += SPECTRAL_PATH_FLOPS_PER_CHANNEL * nc
        shade += SPECTRAL_SHADE_FLOPS_PER_CHANNEL * nc
        env = tuple(e + SPECTRAL_ENV_FLOPS_PER_CHANNEL * nc for e in env)
    flops = n_paths * (
        path + per.get("rays", 0.0) * (tables.n_faces * FACE_FLOPS
                                       + tables.n_spheres * SPHERE_FLOPS)
        + per.get("shadow_faces", 0.0) * FACE_FLOPS
        + per.get("shadow_spheres", 0.0) * SPHERE_FLOPS
        + per.get("shaded", 0.0) * shade
        + per.get("ggx", 0.0) * (GGX_FLOPS + GGX_FLOPS_PER_CHANNEL * nc)
        + per.get("escaped", 0.0) * env[0]
        + per.get("env_nee", 0.0) * env[1])
    return roofline(flops, tables, n_paths)


def vol_bound(tables, stats, n_stats, n_paths):
    """-> (ms, 'operations' or 'bytes'): the least time the card could
    take for n_paths volpath paths, from the per-lane work counted by the
    plain version (``stats`` over ``n_stats`` lanes of the same scene)."""
    per = {k: v / n_stats for k, v in stats.items()}
    flops = n_paths * (
        PATH_FLOPS
        + per["rounds"] * (VOL_ROUND_FLOPS + tables.n_faces * FACE_FLOPS)
        + (per["delta_steps"] + per["ratio_steps"]) * VOL_STEP_FLOPS
        + (per["delta_fetches"] + per["ratio_fetches"]) * VOL_FETCH_FLOPS
        + per["nee"] * VOL_NEE_FLOPS
        + per.get("shadow_faces", 0.0) * FACE_FLOPS
        + per["phase"] * VOL_PHASE_FLOPS
        + per["surface"] * VOL_SURFACE_FLOPS)
    log("  per path: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                   sorted(per.items())))
    return roofline(flops, tables, n_paths)


def roofline(flops, tables, n_paths):
    """-> (ms, 'operations' or 'bytes'): the larger of ``flops`` over the
    fp32 peak and the bytes (the tables read once, 12 B written per path)
    over the HBM rate."""
    table_bytes = sum(t.numel() * t.element_size() for t in tables.tensors())
    nbytes = 12 * n_paths + table_bytes
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    log(f"  bound: {flops / n_paths:.0f} FLOP/path, {flops / 1e9:.3f} GFLOP "
        f"-> {t_ops * 1e3:.4f} ms; {nbytes / 1e6:.3f} MB -> "
        f"{t_bytes * 1e3:.4f} ms")
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


class Route(NamedTuple):
    """One path's kernel, as ``drive`` uses it."""
    label: str          # the instantiation's name
    key: object         # its key in ``radiance.launches_by_kernel``
    radiance: object    # the kernel's wrapper
    reference: object   # its plain version (takes ``stats=``)
    reset: object       # sets the launch counts to 0
    tables: object      # scene -> its tables for the kernel
    bound: object       # (tables, stats, n_stats, n_paths) -> (ms, by)
    source: str
    replaces: str


def drive(mi, pk, name, make_dict, spp, max_depth, mean_band, route):
    """Parity, main-path render and timing of one path -> its entry of the
    kernels line."""
    t_path = time.perf_counter()

    # ---- parity: kernel against its plain version on the same tables ----
    scene = mi.load_dict(make_dict(PARITY_WIDTH, PARITY_WIDTH, PARITY_SPP,
                                   max_depth))
    if scene.device.type != "cuda":
        raise SystemExit(f"{name}: the default device is {scene.device}")
    cam = pk.camera_row(scene.sensors[0], scene.device)
    args = (route.tables(scene), cam, SEED, 0, PARITY_SPP, PARITY_WIDTH,
            PARITY_WIDTH, max_depth, scene.integrator.rr_depth)
    got = route.radiance(*args)
    torch.cuda.synchronize()
    stats = {}
    want = route.reference(*args, stats=stats)
    lane_rel = ((got - want).abs() / want.abs().clamp(min=1e-3)).amax(0)
    beyond = float((lane_rel > PIX_RTOL).float().mean())
    log(f"{name} parity {PARITY_WIDTH}^2 x {PARITY_SPP} spp, depth "
        f"{max_depth}: lanes not bit-identical "
        f"{float((got != want).any(0).float().mean()):.4f}, lanes beyond "
        f"{PIX_RTOL:g} relative {beyond:.6f}")
    max_abs_err = compare(develop(got, PARITY_WIDTH, PARITY_SPP),
                          develop(want, PARITY_WIDTH, PARITY_SPP),
                          f"{name} parity")

    # ---- the path itself, through the user's entry points ----
    scene = mi.load_dict(make_dict(WIDTH, WIDTH, spp, max_depth))
    integrator = scene.integrator
    route.reset()
    img = integrator.render(scene, seed=0, spp=spp)
    torch.cuda.synchronize()
    launches = route.radiance.launches_by_kernel[route.key]
    if integrator.last_engine != "kernel":
        raise SystemExit(f"{name} left the kernel: {integrator.engine_reason}")
    if launches < 1:
        raise SystemExit(f"{name} launched no {route.label}")
    mean = float(img.mean())
    if img.shape != (WIDTH, WIDTH, 3) or img.device.type != "cuda" \
            or not bool(torch.isfinite(img).all()) \
            or not mean_band[0] < mean < mean_band[1]:
        raise SystemExit(f"{name} image is wrong: {tuple(img.shape)} "
                         f"{img.device} mean {mean}")
    log(f"{name}: {WIDTH}^2 x {spp} spp, depth {max_depth}: {launches} "
        f"launch(es) of {route.label}, image mean {mean:.6f}, channel means "
        f"{[round(float(x), 6) for x in img.mean(dim=(0, 1))]}")

    n_paths = WIDTH * WIDTH * spp
    _, render_ms = timed(lambda: integrator.render(scene, seed=0, spp=spp))
    tables = route.tables(scene)
    cam = pk.camera_row(scene.sensors[0], scene.device)
    args = (tables, cam, 0, 0, spp, WIDTH, WIDTH, max_depth,
            integrator.rr_depth)
    k_rad, kernel_ms = timed(lambda: route.radiance(*args))
    # the plain version is the kernel's reference, not a yardstick of
    # speed: one timed call
    p_rad, plain_ms = timed(lambda: route.reference(*args), repeats=1,
                            warm_up=False)
    bound_ms, bound_by = route.bound(
        tables, stats, PARITY_WIDTH * PARITY_WIDTH * PARITY_SPP, n_paths)
    log(f"{name} render (kernel, end to end): {render_ms:.3f} ms median of "
        f"{REPEATS}, {n_paths / render_ms / 1e3:.3f} Mpaths/s")
    log(f"{name} kernel: {kernel_ms:.3f} ms, {n_paths / kernel_ms / 1e3:.3f} "
        f"Mpaths/s, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{100 * bound_ms / kernel_ms:.2f}% of bound; plain version: "
        f"{plain_ms:.3f} ms, {n_paths / plain_ms / 1e3:.3f} Mpaths/s")
    compare(develop(k_rad, WIDTH, spp), develop(p_rad, WIDTH, spp),
            f"{name} main-path shape")
    log(f"{name}: {time.perf_counter() - t_path:.1f} s")
    return {"name": route.label, "route": "cuda", "source": route.source,
            "replaces": route.replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def run_path(mi, pk, name, variant, make_dict, flags, mean_band):
    """One path of the path kernel under ``variant`` (256^2 x 64 spp,
    depth 6) -> its entry of the kernels line."""
    mi.set_variant(variant)
    nc = pk.MODE_NC[mi.variant_config().color_mode]

    def tables(scene):
        if (scene.tables.flags & pk.TEMPLATE_FLAGS, scene.tables.nc) \
                != (flags, nc):
            raise SystemExit(f"{name}: scene tables carry flags "
                             f"{scene.tables.flags}, nc {scene.tables.nc}")
        return scene.tables

    return drive(mi, pk, name, make_dict, SPP, MAX_DEPTH, mean_band, Route(
        pk.kernel_name(flags, nc), (flags, nc), pk.path_radiance,
        pk.path_radiance_reference, pk.reset_launch_counts, tables,
        lambda *a: bound(pk, *a), "mitsuba2_tpu_torch/csrc/path_kernel.cu",
        "mitsuba2_tpu/ops/megakernel.py:365"))


def run_volpath(mi, pk, vk, volpath_slab_dict):
    """The volpath slab (256^2 x 16 spp, depth 16) through the volumetric
    kernel's hg instantiation -> its entry of the kernels line."""
    mi.set_variant("scalar_rgb")
    flags = vk.HAS_HG

    def tables(scene):
        t = vk.build_vol_tables(scene)
        if t.flags != flags:
            raise SystemExit(f"volpath: scene tables carry flags {t.flags}")
        return t

    return drive(mi, pk, "volpath", volpath_slab_dict, VOL_SPP,
                 VOL_MAX_DEPTH, (0.3, 5.0), Route(
                     vk.kernel_name(flags), flags, vk.volpath_radiance,
                     vk.volpath_radiance_reference, vk.reset_launch_counts,
                     tables, vol_bound,
                     "mitsuba2_tpu_torch/csrc/volpath_kernel.cu",
                     "mitsuba2_tpu/ops/volmegakernel.py:186"))


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing is run on the CPU "
              "instead", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    import mitsuba2_tpu_torch as mi
    from mitsuba2_tpu_torch.ops import build, path_kernel as pk
    from mitsuba2_tpu_torch.ops import volpath_kernel as vk
    from mitsuba2_tpu_torch.python.test.scenes import (
        cornell_box_dict, matpreview_dict, volpath_slab_dict)

    nvcc = build.find_nvcc()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}"
        f"; nvcc: {nvcc or 'not found'}")

    # ---- build: one library per color mode and the volumetric kernel's,
    # in parallel ----
    t0 = time.perf_counter()
    build.build_all(pk.libraries() + vk.libraries())
    log(f"build: path_kernel, 3 color modes x 16 instantiations, and "
        f"volpath_kernel, 16 instantiations, in "
        f"{time.perf_counter() - t0:.2f} s")
    for nc in (3, 4, 1):
        lib = "path_kernel" + build._tag(pk.library_defines(nc))
        report = ptxas_report(build.build_logs.get(lib, ""))
        for inst in sorted(report):
            log(f"  ptxas {pk.kernel_name(*inst)}: {report[inst]}")
    report = ptxas_report(build.build_logs.get("volpath_kernel", ""),
                          "volpath_kernel")
    for inst in sorted(report):
        log(f"  ptxas {vk.kernel_name(*inst)}: {report[inst]}")

    full = pk.HAS_SPHERES | pk.HAS_ENV | pk.HAS_GGX | pk.HAS_CHECKER
    paths = [
        ("cornell", "scalar_rgb", cornell_box_dict, 0, (0.05, 1.0)),
        ("matpreview", "scalar_rgb", matpreview_dict, full, (0.2, 5.0)),
        ("cornell_spectral", "scalar_spectral", cornell_box_dict, 0,
         (0.05, 1.0)),
        ("matpreview_spectral", "scalar_spectral", matpreview_dict, full,
         (0.2, 5.0)),
        ("cornell_mono", "scalar_mono", cornell_box_dict, 0, (0.05, 1.0)),
    ]
    kernels = [run_path(mi, pk, *p) for p in paths]
    kernels.append(run_volpath(mi, pk, vk, volpath_slab_dict))

    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
