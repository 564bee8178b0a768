"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels and its host BVH builder from the sources
in this checkout (the path kernel twice per color mode, without and with
its lobes flag, the film splat, the volumetric kernel, the intersection
kernel and csrc/bvh.cpp, in parallel compiler processes) and prints each
kernel instantiation's registers and spills. Then, for each path -- the
Cornell box (the main path), the matpreview scene (a rough gold sphere
under an HDR sky above a checker floor), both again under
``scalar_spectral``, and the Cornell box under ``scalar_mono``, all at
256x256, 64 spp, max_depth 6; the volpath slab (bench.py's volpath config:
a 16^3 heterogeneous medium in a null box before an area light) at
256x256, 16 spp, max_depth 16; the two big-mesh paths of the BVH tier,
biggeo (a 262,144-face displaced sphere from an OBJ file) and hero (a
203,776-face .serialized mesh in GGX gold under the sky on a checker
floor), at 256x256, 32 spp, max_depth 5; and the materials Cornell box
(glass, plastic, rough plastic and bitmap surfaces, a disk and a cylinder,
the default gaussian film) under ``scalar_rgb`` and ``scalar_spectral`` at
256x256, 64 spp, max_depth 6 -- it checks the path's kernel against its
plain PyTorch version on the card (64x64x16 spp; 32x32x4 spp for the big
meshes, whose plain version sweeps every face), renders the path through
``set_variant``, ``load_dict`` and ``scene.integrator.render`` on the
port's default device, checks that the render went through the path's
kernel instantiation (and the splat kernel, under a film filter other than
the box) and that the image is sane, times render, kernel, splat and plain
version beside the kernel's bound, and holds the kernel's lanes at the main
shape against the plain version's (for the big meshes, those of every 31st
pixel) and the splat kernel's block against its plain version's. The
materials scene's kernel is also held against its plain version under
``scalar_mono`` at the parity shape, and its first hits must show every new
kind on at least 1% of camera rays. It holds the BVH tier forced on the
Cornell box against the shared-memory tier, and drives the scene's ray
queries (``Scene.ray_intersect_preliminary`` and ``Scene.ray_test``, the
intersection kernel's closest-hit and any-hit entries) on biggeo's
2,097,152 camera rays and as many rays toward its light, against their
plain twin on 65,536 of each. Prints one JSON line of kernel results, the
card's name and power limit, and as its last line ``{"ok": true,
"device": {...}}``. Any failed phase exits non-zero, and so does a machine
without CUDA: nothing runs on the CPU instead.
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
# the big-mesh paths (bench.py biggeo, hero): 256x256, 32 spp, max_depth
# 5; parity and the plain version's time at 32x32x4 spp
BIG_SPP, BIG_MAX_DEPTH = 32, 5
BIG_PARITY_WIDTH, BIG_PARITY_SPP = 32, 4
# the plain version at the main shape on every 31st pixel (2,115 pixels,
# all their samples)
BIG_PLAIN_STRIDE = 31
# the ray queries: kernel against plain twin on this many rays of each
# set, the bound's walk counts from this many
ISECT_PARITY_RAYS, ISECT_COUNT_RAYS = 65536, 8192
# the ray queries' tolerance: prims equal on this share of rays, t and uv
# of the rays whose prims agree within this (relative to max(1, |t|))
ISECT_PRIM_SHARE, ISECT_ATOL = 0.999, 1e-5
# the tolerance of the CPU tests (tests/test_torch_path_kernel.py)
PIX_RTOL, PIX_SHARE, MEAN_RTOL = 1e-4, 0.99, 1e-5
# the image means of the materials scene's main run, whose glass box sends
# caustic paths to the light: float rounding decides whether about one
# lane in 10^4 reaches the light's edge, and a few such bright lanes move
# the mean of 4,194,304 lanes by about 4e-5 (PERF.md §2)
CAUSTIC_MEAN_RTOL = 1e-4
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
# In the BVH tier (csrc/bvh.cuh) a ray's face work is the walk's: per box
# test of a child box six subtractions and six multiplications, per face
# test the Woop t (FACE_FLOPS), with the walk's counts from ops/
# intersect.py ``traverse`` over the plain version's rays.
PATH_FLOPS, SPECTRAL_PATH_FLOPS_PER_CHANNEL = 40, 60
FACE_FLOPS, SPHERE_FLOPS, BOX_FLOPS = 12, 20, 12
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
# the lobes flag's work (csrc/path_kernel.cu): per disk or cylinder test
# the ray into the object frame (two 3x3 products) and the disk's plane or
# the cylinder's quadratic (a square root, a division); per dielectric
# event a Fresnel term and the reflected or refracted direction, and per
# channel the throughput; per plastic event (smooth or rough) the Fresnel
# terms at wi, wo and the sampled direction, the coat's probability, the
# base's denominator, its NEE value and the cosine sample, per channel the
# base's value twice; per rough plastic event the coat's GGX evaluation
# toward the light and at the sampled direction and, where picked, a
# visible-normal sample; per bitmap fetch the texel coordinates and the
# three-channel bilinear lerp of its four texels
QUAD_FLOPS = 60
DIEL_FLOPS, DIEL_FLOPS_PER_CHANNEL = 45, 3
PLASTIC_FLOPS, PLASTIC_FLOPS_PER_CHANNEL = 150, 10
ROUGH_PLASTIC_FLOPS, ROUGH_PLASTIC_FLOPS_PER_CHANNEL = 190, 4
BITMAP_FLOPS = 50
# the splat (csrc/splat_kernel.cu): per lane 2K filter values (an exp or a
# sine or a cubic, about 20 FLOPs each) and K x 4 products, per lane and
# tap 4 multiply-adds; per block pixel the K^2 x 4 tap sums
SPLAT_FILTER_FLOPS = 20
# the new kinds that must be the first hit of at least this share of the
# materials scene's camera rays
NEW_KINDS = ("dielectric", "plastic", "roughplastic", "bitmap", "disk",
             "cylinder")
MIN_FIRST_HIT_SHARE = 0.01


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


def develop(rad, w, spp, h=None):
    """Per-lane radiance (3, h * w * spp) -> the (h, w, 3) box-filtered
    image (h = w unless given)."""
    h = w if h is None else h
    return rad.reshape(3, h * w, spp).mean(dim=2).T.reshape(h, w, 3)


def compare(got, want, label, mean_rtol=MEAN_RTOL):
    """Per-pixel agreement of two (w, w, 3) images -> max abs error."""
    g = got.double().cpu().numpy()
    r = want.double().cpu().numpy()
    err = (np.abs(g - r) / np.maximum(np.abs(r), 1e-3)).max(-1)
    share = float((err <= PIX_RTOL).mean())
    mean_rel = abs(g.mean() - r.mean()) / abs(r.mean())
    log(f"{label}: max pixel rel diff {err.max():.3e}, p99 "
        f"{np.quantile(err, 0.99):.3e}, share within {PIX_RTOL:g} "
        f"{share:.6f}, mean rel diff {mean_rel:.3e}")
    if share < PIX_SHARE or mean_rel > mean_rtol:
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


def log_ptxas(lib, report, shown, name):
    """One line per library (instantiations, register range, how many
    spill) and one per instantiation in ``shown``."""
    regs = [int(v.split()[0]) for v in report.values()]
    spills = [k for k, v in report.items()
              if not re.search(r"\b0 bytes spill stores", v)]
    log(f"  ptxas {lib}: {len(report)} instantiations, "
        f"{min(regs, default=0)}-{max(regs, default=0)} registers, "
        f"{len(spills)} with spills")
    for inst in sorted(shown & set(report)):
        log(f"    {name(inst)}: {report[inst]}")


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
    if tables.flags & pk.HAS_BVH:
        faces = ((per["walk_boxes"] + per.get("shadow_walk_boxes", 0.0))
                 * BOX_FLOPS
                 + (per["walk_faces"] + per.get("shadow_walk_faces", 0.0))
                 * FACE_FLOPS)
        log("  walk per path: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(per.items()) if "walk" in k)
            + f"; per ray {per['walk_boxes'] / per['rays']:.2f} box and "
            f"{per['walk_faces'] / per['rays']:.2f} face tests")
    else:
        faces = (per.get("rays", 0.0) * tables.n_faces
                 + per.get("shadow_faces", 0.0)) * FACE_FLOPS
    flops = n_paths * (
        path + faces
        + per.get("rays", 0.0) * tables.n_spheres * SPHERE_FLOPS
        + per.get("shadow_spheres", 0.0) * SPHERE_FLOPS
        + (per.get("quad_tests", 0.0) + per.get("shadow_quads", 0.0))
        * QUAD_FLOPS
        + per.get("shaded", 0.0) * shade
        + per.get("ggx", 0.0) * (GGX_FLOPS + GGX_FLOPS_PER_CHANNEL * nc)
        + per.get("dielectric", 0.0)
        * (DIEL_FLOPS + DIEL_FLOPS_PER_CHANNEL * nc)
        + per.get("plastic", 0.0)
        * (PLASTIC_FLOPS + PLASTIC_FLOPS_PER_CHANNEL * nc)
        + per.get("roughplastic", 0.0)
        * (ROUGH_PLASTIC_FLOPS + ROUGH_PLASTIC_FLOPS_PER_CHANNEL * nc)
        + per.get("bitmap", 0.0) * BITMAP_FLOPS
        + per.get("escaped", 0.0) * env[0]
        + per.get("env_nee", 0.0) * env[1])
    if tables.flags & pk.HAS_LOBES:
        log("  lobes per path: " + ", ".join(
            f"{k} {per.get(k, 0.0):.4f}" for k in (
                "dielectric", "plastic", "roughplastic", "bitmap",
                "quad_tests", "shadow_quads")))
    return roofline(flops, tables, n_paths)


def splat_bound(n_lanes, k, n_block):
    """-> (ms, 'operations' or 'bytes'): the splat's least time: 12 bytes
    read per lane and 16 written per block pixel, against its FLOPs."""
    flops = n_lanes * (2 * k * SPLAT_FILTER_FLOPS + 4 * k + 8 * k * k) \
        + n_block * 4 * k * k
    return roofline(flops, 16 * n_block, n_lanes, out_bytes=0, in_bytes=12,
                    what="lane")


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


def read_tables(tables):
    """The tables an instantiation reads: a path kernel's shared-memory
    tier reads no traversal tree, its BVH tier not the face-order Woop
    rows."""
    from mitsuba2_tpu_torch.ops.path_kernel import HAS_BVH
    if not hasattr(tables, "bvh_nodes"):
        return tables.tensors()
    skip = ({"woop"} if tables.flags & HAS_BVH
            else {"bvh_nodes", "bvh_woop", "bvh_prim"})
    return [v for k, v in tables._asdict().items()
            if isinstance(v, torch.Tensor) and k not in skip]


def roofline(flops, tables, n_items, out_bytes=12, in_bytes=0, what="path"):
    """-> (ms, 'operations' or 'bytes'): the larger of ``flops`` over the
    fp32 peak and the bytes (the tables read once: ``read_tables`` of a
    table set, or a byte count; ``in_bytes`` read and ``out_bytes``
    written per item) over the HBM rate."""
    table_bytes = tables if isinstance(tables, int) else sum(
        t.numel() * t.element_size() for t in read_tables(tables))
    nbytes = (in_bytes + out_bytes) * n_items + table_bytes
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    log(f"  bound: {flops / n_items:.0f} FLOP/{what}, {flops / 1e9:.3f} "
        f"GFLOP -> {t_ops * 1e3:.4f} ms; {nbytes / 1e6:.3f} MB -> "
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
    # the parity shape (width, spp); the plain version runs at the main
    # shape, on every ``plain_stride``-th pixel only where it is not 0
    parity: tuple = (PARITY_WIDTH, PARITY_SPP)
    plain_stride: int = 0
    # whether the parity run's first hits must show every NEW_KINDS kind
    first_hits: bool = False
    # the bar of the image means at the main shape
    mean_rtol: float = MEAN_RTOL


def check_first_hits(name, stats, n):
    """The parity run's first-hit share of each new kind -> SystemExit if
    one is below MIN_FIRST_HIT_SHARE."""
    shares = {k: stats.get(f"first_{k}", 0) / n for k in NEW_KINDS}
    log(f"{name} first-hit shares: " + ", ".join(
        f"{k} {v:.4f}" for k, v in shares.items()))
    if min(shares.values()) < MIN_FIRST_HIT_SHARE:
        raise SystemExit(f"{name}: a new kind is the first hit of less "
                         f"than {MIN_FIRST_HIT_SHARE:.0%} of camera rays")


def check_splat(name, rad, spp, rfilter, launches):
    """The splat kernel on a pass's lanes against its plain version: every
    block pixel within 1e-5 relative or 1e-6 absolute -> its entry of the
    kernels line."""
    from mitsuba2_tpu_torch.ops import splat as sp
    block, splat_ms = timed(lambda: sp.splat(rad, 0, 0, spp, WIDTH, WIDTH,
                                             rfilter))
    want, plain_ms = timed(lambda: sp.splat_reference(
        rad, 0, 0, spp, WIDTH, WIDTH, rfilter), repeats=1, warm_up=False)
    err = (block - want).abs()
    ok = (err <= 1e-5 * want.abs()) | (err <= 1e-6)
    rel = float((err / want.abs().clamp(min=1e-30)).max())
    log(f"{name} splat {type(rfilter).__name__} block "
        f"{tuple(block.shape)}: max rel diff {rel:.3e}, block pixels "
        f"within 1e-5 or 1e-6 {float(ok.float().mean()):.6f}")
    if not bool(ok.all()):
        raise SystemExit(f"{name}: splat kernel and plain version disagree")
    k = 2 * ((block.shape[0] - WIDTH) // 2) + 1
    bound_ms, bound_by = splat_bound(rad.shape[1], k,
                                     block.shape[0] * block.shape[1])
    log(f"{name} splat: kernel {splat_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), {100 * bound_ms / splat_ms:.2f}% of bound; plain "
        f"version {plain_ms:.3f} ms")
    return {"name": f"splat_kernel[{name}]", "route": "cuda",
            "source": "mitsuba2_tpu_torch/csrc/splat_kernel.cu",
            "replaces": "mitsuba2_tpu/ops/megakernel.py:3041",
            "launches": launches, "max_abs_err": float(err.max()),
            "ms": splat_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def drive(mi, pk, name, make_dict, spp, max_depth, mean_band, route):
    """Parity, main-path render and timing of one path -> its entries of
    the kernels line: the path's kernel, and the splat's where the film
    filter is not the box."""
    from mitsuba2_tpu_torch.models.rfilters import BoxFilter
    from mitsuba2_tpu_torch.ops import splat as sp
    t_path = time.perf_counter()

    # ---- parity: kernel against its plain version on the same tables ----
    pw, pspp = route.parity
    scene = mi.load_dict(make_dict(pw, pw, pspp, max_depth))
    if scene.device.type != "cuda":
        raise SystemExit(f"{name}: the default device is {scene.device}")
    cam = pk.camera_row(scene.sensors[0], scene.device)
    p_args = (route.tables(scene), cam, SEED, 0, pspp, pw, pw, max_depth,
              scene.integrator.rr_depth)
    got = route.radiance(*p_args)
    torch.cuda.synchronize()
    stats = {}
    want = route.reference(*p_args, stats=stats)
    lane_rel = ((got - want).abs() / want.abs().clamp(min=1e-3)).amax(0)
    beyond = float((lane_rel > PIX_RTOL).float().mean())
    log(f"{name} parity {pw}^2 x {pspp} spp, depth {max_depth}: lanes not "
        f"bit-identical {float((got != want).any(0).float().mean()):.4f}, "
        f"lanes beyond {PIX_RTOL:g} relative {beyond:.6f}")
    max_abs_err = compare(develop(got, pw, pspp), develop(want, pw, pspp),
                          f"{name} parity")
    if route.first_hits:
        check_first_hits(name, stats, pw * pw * pspp)

    # ---- the path itself, through the user's entry points ----
    scene = mi.load_dict(make_dict(WIDTH, WIDTH, spp, max_depth))
    integrator = scene.integrator
    rfilter = scene.sensors[0].film.rfilter
    route.reset()
    sp.reset_launch_counts()
    img = integrator.render(scene, seed=0, spp=spp)
    torch.cuda.synchronize()
    launches = route.radiance.launches_by_kernel[route.key]
    splat_launches = sp.splat.launches
    if not isinstance(rfilter, BoxFilter) and splat_launches < 1:
        raise SystemExit(f"{name} launched no splat_kernel")
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
    entries = []
    if not isinstance(rfilter, BoxFilter):
        entries.append(check_splat(name, k_rad, spp, rfilter,
                                   splat_launches))
    # the plain version is the kernel's reference, not a yardstick of
    # speed: one timed call, on the main run's lanes or on those of a
    # strided sample of its pixels (all their samples)
    n_pix, kw = WIDTH * WIDTH, {}
    if route.plain_stride:
        pix = torch.arange(0, n_pix, route.plain_stride, device=cam.device)
        n_pix = len(pix)
        kw["lanes"] = (pix[:, None] * spp
                       + torch.arange(spp, device=cam.device)).reshape(-1)
        k_rad = k_rad[:, kw["lanes"]]
    p_rad, plain_ms = timed(lambda: route.reference(*args, **kw),
                            repeats=1, warm_up=False)
    bound_ms, bound_by = route.bound(tables, stats, pw * pw * pspp, n_paths)
    log(f"{name} render (end to end: kernel, film develop"
        f"{'' if isinstance(rfilter, BoxFilter) else ' through the splat'}):"
        f" {render_ms:.3f} ms median of {REPEATS}, "
        f"{n_paths / render_ms / 1e3:.3f} Mpaths/s")
    n_plain = n_pix * spp
    log(f"{name} kernel: {kernel_ms:.3f} ms, {n_paths / kernel_ms / 1e3:.3f} "
        f"Mpaths/s, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{100 * bound_ms / kernel_ms:.2f}% of bound; plain version: "
        f"{plain_ms:.3f} ms for {n_plain} paths, "
        f"{n_plain / plain_ms / 1e3:.3f} Mpaths/s")
    lane_rel = ((k_rad - p_rad).abs() / p_rad.abs().clamp(min=1e-3)).amax(0)
    log(f"{name} main-path shape, {n_pix} pixels x {spp} spp: lanes beyond "
        f"{PIX_RTOL:g} relative "
        f"{float((lane_rel > PIX_RTOL).float().mean()):.6f}")
    max_abs_err = max(max_abs_err, compare(
        develop(k_rad, n_pix, spp, 1), develop(p_rad, n_pix, spp, 1),
        f"{name} main-path shape", route.mean_rtol))
    log(f"{name}: {time.perf_counter() - t_path:.1f} s")
    return [{"name": route.label, "route": "cuda", "source": route.source,
             "replaces": route.replaces, "launches": launches,
             "max_abs_err": max_abs_err, "ms": kernel_ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None}] + entries


def run_path(mi, pk, name, variant, make_dict, flags, mean_band,
             spp=SPP, max_depth=MAX_DEPTH, **route):
    """One path of the path kernel under ``variant`` (256^2 x 64 spp,
    depth 6 unless told otherwise) -> its entries of the kernels line.
    ``route`` overrides ``Route`` fields (parity shape, replaces, first
    hits)."""
    mi.set_variant(variant)
    nc = pk.MODE_NC[mi.variant_config().color_mode]

    def tables(scene):
        if (scene.tables.flags & pk.TEMPLATE_FLAGS, scene.tables.nc) \
                != (flags, nc):
            raise SystemExit(f"{name}: scene tables carry flags "
                             f"{scene.tables.flags}, nc {scene.tables.nc}")
        return scene.tables

    fields = dict(replaces="mitsuba2_tpu/ops/megakernel.py:365")
    fields.update(route)
    return drive(mi, pk, name, make_dict, spp, max_depth, mean_band, Route(
        pk.kernel_name(flags, nc), (flags, nc), pk.path_radiance,
        pk.path_radiance_reference, pk.reset_launch_counts, tables,
        lambda *a: bound(pk, *a), "mitsuba2_tpu_torch/csrc/path_kernel.cu",
        **fields))


def check_bvh_tier_on_cornell(mi, pk, cornell_box_dict):
    """The BVH tier forced on the Cornell box against its shared-memory
    tier: the same lanes at 64^2 x 16 spp, and both timed at the main
    shape."""
    mi.set_variant("scalar_rgb")
    times = {}
    for width, spp in ((PARITY_WIDTH, PARITY_SPP), (WIDTH, SPP)):
        scene = mi.load_dict(cornell_box_dict(width, width, spp, MAX_DEPTH))
        cam = pk.camera_row(scene.sensors[0], scene.device)
        args = (cam, SEED, 0, spp, width, width, MAX_DEPTH,
                scene.integrator.rr_depth)
        tiers = {"shared": scene.tables,
                 "bvh": pk.with_bvh_tier(scene.tables)}
        if width == PARITY_WIDTH:
            out = {k: pk.path_radiance(t, *args) for k, t in tiers.items()}
            compare(develop(out["bvh"], width, spp),
                    develop(out["shared"], width, spp),
                    "cornell, the BVH tier against the shared tier")
            continue
        for k, t in tiers.items():
            times[k] = timed(lambda: pk.path_radiance(t, *args))[1]
    log(f"cornell {WIDTH}^2 x {SPP} spp kernel: shared tier "
        f"{times['shared']:.3f} ms, BVH tier forced {times['bvh']:.3f} ms "
        f"({times['bvh'] / times['shared']:.3f}x)")


def light_rays(scene, Ray, hits, ray, n, seed):
    """``n`` rays from the hit points of ``ray`` (cycled) toward uniform
    points of the scene's area-light triangles, on the reference's shadow
    segment (mitsuba2_tpu/render/scene.py _shadow_ray: mint RayEpsilon
    (1 + max |p|), maxt dist (1 - ShadowEpsilon), ShadowEpsilon being ten
    RayEpsilon)."""
    from mitsuba2_tpu_torch.core.math import RayEpsilon
    dev = ray.o.device
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    hit = torch.isfinite(hits.t).nonzero()[:, 0]
    idx = hit[torch.arange(n, device=dev) % len(hit)]
    p = ray.o[idx] + ray.d[idx] * hits.t[idx, None]
    rows = scene.tables.lights[scene.tables.lights[:, 12] <= 1.0]
    tri = rows[torch.randint(len(rows), (n,), generator=g, device=dev)]
    s = torch.sqrt(torch.rand(n, generator=g, device=dev))[:, None]
    b2 = torch.rand(n, generator=g, device=dev)[:, None] * s
    q = tri[:, 0:3] + tri[:, 3:6] * (1.0 - s) + tri[:, 6:9] * b2
    dl = q - p
    dist = dl.norm(dim=1)
    return Ray.make(p, dl / dist[:, None],
                    mint=RayEpsilon * (1.0 + p.abs().max(dim=1).values),
                    maxt=dist * (1.0 - 10.0 * RayEpsilon))


def every_kth(ray, count):
    """``count`` rays spread over a ray batch (every k-th), as the
    (o, d, mint, maxt) arguments of the queries."""
    k = max(1, ray.o.shape[0] // count)
    return tuple(x[::k][:count].contiguous() for x in ray)


def isect_parity(name, got, want):
    """The intersection kernel's closest-hit or any-hit outputs against its
    plain twin's -> the largest abs error (of t over the rays whose prims
    agree, or of the 0/1 hits)."""
    if name == "isect_any":
        same = got == want
        share = float(same.float().mean())
        err = float((got.float() - want.float()).abs().max())
        ok = share >= ISECT_PRIM_SHARE
        detail = f"hits {float(want.float().mean()):.4f}"
    else:
        (t, uv, prim), (rt, ruv, rprim) = got, want
        same = prim == rprim
        share = float(same.float().mean())
        both = same & (rprim >= 0)
        scale = rt[both].abs().clamp(min=1.0)
        t_err = float(((t[both] - rt[both]).abs() / scale).max())
        uv_err = float((uv[both] - ruv[both]).abs().max())
        misses_agree = bool(torch.isinf(t[same & (rprim < 0)]).all())
        err = float((t[both] - rt[both]).abs().max())
        ok = (share >= ISECT_PRIM_SHARE and t_err <= ISECT_ATOL
              and uv_err <= ISECT_ATOL and misses_agree)
        detail = (f"hits {float((rprim >= 0).float().mean()):.4f}, t rel "
                  f"err {t_err:.3e}, uv err {uv_err:.3e}")
    log(f"    parity: equal on {share:.6f} of {len(same)} rays, {detail}")
    if not ok:
        raise SystemExit(f"{name}: kernel and plain twin disagree")
    return err


def run_isect(mi, pk, ik, isx, bumpy_sphere_dict):
    """The scene's ray queries on biggeo through the intersection kernel:
    ``Scene.ray_intersect_preliminary`` on the 2,097,152 camera rays of a
    256^2 x 32 spp image and on as many rays toward the light,
    ``Scene.ray_test`` on the light rays; each entry point against its
    plain twin on 65,536 rays of both sets, timed on 2,097,152 -> the two
    entries of the kernels line."""
    from mitsuba2_tpu_torch.core.ray import Ray
    t_phase = time.perf_counter()
    mi.set_variant("scalar_rgb")
    scene = mi.load_dict(bumpy_sphere_dict(WIDTH, WIDTH, BIG_SPP,
                                           BIG_MAX_DEPTH, 512, 257))
    tables = scene.tables
    cam_ray = Ray.make(*pk.camera_rays(
        pk.camera_row(scene.sensors[0], scene.device), WIDTH, WIDTH,
        BIG_SPP, SEED))
    n = cam_ray.o.shape[0]

    # ---- the queries through the user's entry points ----
    ik.reset_launch_counts()
    hits = scene.ray_intersect_preliminary(cam_ray)
    light_ray = light_rays(scene, Ray, hits, cam_ray, n, SEED)
    to_light = scene.ray_intersect_preliminary(light_ray)
    occluded = scene.ray_test(light_ray)
    torch.cuda.synchronize()
    launches = {"isect_closest": ik.isect_closest.launches,
                "isect_any": ik.isect_any.launches}
    if min(launches.values()) < 1:
        raise SystemExit(f"the ray queries missed the kernel: {launches}")
    hit_share = float(torch.isfinite(hits.t).float().mean())
    occ_share = float(occluded.float().mean())
    F = tables.n_faces
    for pi in (hits, to_light):
        valid = (pi.prim_idx >= -1) & (pi.prim_idx < F) \
            & (torch.isfinite(pi.t) == (pi.prim_idx >= 0)) \
            & ((pi.shape_idx >= 0) == (pi.prim_idx >= 0))
        if pi.t.shape != (n,) or not bool(valid.all()):
            raise SystemExit("the ray queries' records are malformed")
    if not (0.3 < hit_share < 1.0 and 0.0 < occ_share < 1.0) or not bool(
            (torch.isfinite(to_light.t) == occluded).all()):
        raise SystemExit(f"the ray queries are implausible: hits "
                         f"{hit_share}, occluded {occ_share}")
    log(f"ray queries on biggeo ({F} faces): {n} camera rays, "
        f"{hit_share:.4f} hit; {n} rays toward the light, {occ_share:.4f} "
        f"occluded; launches {launches}")

    # the plain twin's face-order Woop rows (the BVH tier's tables carry
    # only the tree-order rows)
    woop = pk.face_woop(tables)
    entries = []
    for name, fn, ref, main, out_bytes in (
            ("isect_closest", ik.isect_closest, isx.closest_hit_reference,
             cam_ray, 16),
            ("isect_any", ik.isect_any, isx.any_hit_reference, light_ray,
             1)):
        errs = []
        for label, ray in (("camera", cam_ray), ("light", light_ray)):
            sub = every_kth(ray, ISECT_PARITY_RAYS)
            got = fn(tables, *sub)
            torch.cuda.synchronize()
            log(f"  {name}, {label} rays:")
            errs.append(isect_parity(name, got, ref(woop, *sub)))
            ms = timed(lambda: fn(tables, *ray))[1]
            log(f"    kernel on {n} rays: {ms:.4f} ms, "
                f"{n / ms / 1e3:.3f} Mrays/s")
        sub = every_kth(main, ISECT_PARITY_RAYS)
        kernel_ms = timed(lambda: fn(tables, *main))[1]
        plain_ms = timed(lambda: ref(woop, *sub), repeats=1,
                         warm_up=False)[1]
        walk = isx.traverse(tables.bvh_nodes, tables.bvh_woop,
                            tables.bvh_prim,
                            *every_kth(main, ISECT_COUNT_RAYS),
                            any_hit=name == "isect_any", k2=True)
        boxes = float(walk["boxes"].float().mean())
        faces = float(walk["faces"].float().mean())
        # the nodes and face rows the sample's walks read, once: a lower
        # bound on what all the rays' walks read
        read = isx.bytes_read(walk)
        log(f"  {name} walk per ray: {boxes:.2f} box tests, {faces:.2f} "
            f"face tests; the sample's walks read "
            f"{int(walk['node_reads'].sum())} of {len(walk['node_reads'])} "
            f"nodes and {int(walk['face_reads'][:, 0].sum())} of "
            f"{len(walk['face_reads'])} faces, {read / 1e6:.3f} MB")
        bound_ms, bound_by = roofline(
            n * (boxes * BOX_FLOPS + faces * FACE_FLOPS), read, n,
            out_bytes=out_bytes, in_bytes=32, what="ray")
        log(f"{name}: kernel {kernel_ms:.4f} ms on {n} rays, bound "
            f"{bound_ms:.4f} ms ({bound_by}), "
            f"{100 * bound_ms / kernel_ms:.2f}% of bound; plain twin "
            f"{plain_ms:.3f} ms on {ISECT_PARITY_RAYS} rays")
        entries.append({
            "name": name, "route": "cuda",
            "source": "mitsuba2_tpu_torch/csrc/intersect_kernel.cu",
            "replaces": "mitsuba2_tpu/ops/intersect_pallas.py:81",
            "launches": launches[name], "max_abs_err": max(errs),
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
    log(f"ray queries: {time.perf_counter() - t_phase:.1f} s")
    return entries


def run_volpath(mi, pk, vk, volpath_slab_dict):
    """The volpath slab (256^2 x 16 spp, depth 16) through the volumetric
    kernel's hg instantiation -> its entries of the kernels line."""
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


def check_mono_materials(mi, pk, cornell_materials_dict):
    """The materials scene's kernel under ``scalar_mono`` against its plain
    version at the parity shape, and one render through the user's entry
    points there -> its entry of the kernels line (times and bound at the
    parity shape)."""
    mi.set_variant("scalar_mono")
    flags, pw, pspp = pk.HAS_SPHERES | pk.HAS_LOBES, PARITY_WIDTH, \
        PARITY_SPP
    scene = mi.load_dict(cornell_materials_dict(pw, pw, pspp, MAX_DEPTH))
    if scene.tables.flags & pk.TEMPLATE_FLAGS != flags:
        raise SystemExit(f"mono materials: tables carry {scene.tables.flags}")
    cam = pk.camera_row(scene.sensors[0], scene.device)
    args = (scene.tables, cam, SEED, 0, pspp, pw, pw, MAX_DEPTH,
            scene.integrator.rr_depth)
    got, kernel_ms = timed(lambda: pk.path_radiance(*args))
    stats = {}
    want, plain_ms = timed(lambda: pk.path_radiance_reference(
        *args, stats=stats), repeats=1, warm_up=False)
    max_abs_err = compare(develop(got, pw, pspp), develop(want, pw, pspp),
                          "cornell_materials_mono parity")
    pk.reset_launch_counts()
    img = scene.integrator.render(scene, seed=0, spp=pspp)
    torch.cuda.synchronize()
    launches = pk.path_radiance.launches_by_kernel[(flags, 1)]
    if launches < 1 or scene.integrator.last_engine != "kernel" \
            or not bool(torch.isfinite(img).all()):
        raise SystemExit("mono materials: the render left the kernel")
    n = pw * pw * pspp
    bound_ms, bound_by = bound(pk, scene.tables, stats, n, n)
    log(f"cornell_materials_mono at {pw}^2 x {pspp} spp: kernel "
        f"{kernel_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); plain "
        f"version {plain_ms:.3f} ms; image mean {float(img.mean()):.6f}")
    return {"name": pk.kernel_name(flags, 1), "route": "cuda",
            "source": "mitsuba2_tpu_torch/csrc/path_kernel.cu",
            "replaces": "mitsuba2_tpu/ops/megakernel.py:365",
            "launches": launches, "max_abs_err": max_abs_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


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
    from mitsuba2_tpu_torch.ops import intersect as isx
    from mitsuba2_tpu_torch.ops import intersect_kernel as ik
    from mitsuba2_tpu_torch.ops import splat as sp
    from mitsuba2_tpu_torch.ops import volpath_kernel as vk
    from mitsuba2_tpu_torch.python.test.scenes import (
        bumpy_sphere_dict, cornell_box_dict, cornell_materials_dict,
        hero_serialized_dict, matpreview_dict, volpath_slab_dict)

    nvcc = build.find_nvcc()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}"
        f"; nvcc: {nvcc or 'not found'}")

    # ---- build: two libraries per color mode, the splat, the volumetric
    # and the intersection kernel's and the host BVH builder, in parallel ----
    t0 = time.perf_counter()
    jobs = (pk.libraries() + sp.libraries() + vk.libraries()
            + ik.libraries() + [("bvh", {})])
    build.build_all(jobs)
    log(f"build: {len(jobs)} libraries -- path_kernel, 3 color modes x 2 "
        f"libraries x 32 instantiations (192), splat_kernel, "
        f"volpath_kernel, 16 instantiations, intersect_kernel and the BVH "
        f"builder -- in {time.perf_counter() - t0:.2f} s")
    # each library's register range, and each instantiation a path below
    # runs (the full reports stay beside the libraries, build.py)
    full = pk.HAS_SPHERES | pk.HAS_ENV | pk.HAS_GGX | pk.HAS_CHECKER
    materials = pk.HAS_SPHERES | pk.HAS_LOBES
    on_paths = (0, full, pk.HAS_BVH, (full & ~pk.HAS_SPHERES) | pk.HAS_BVH,
                materials)
    def build_log(name, defines=None):
        path = build.library_path(name, defines).with_suffix(".log")
        return path.read_text() if path.exists() else ""

    for nc in (3, 4, 1):
        for lobes in (False, True):
            report = ptxas_report(build_log(
                "path_kernel", pk.library_defines(nc, lobes)))
            log_ptxas(f"path_kernel, PK_NC={nc}, PK_LOBES={int(lobes)}",
                      report, {(f, nc) for f in on_paths},
                      lambda inst: pk.kernel_name(*inst))
    fn = None
    for line in build_log("splat_kernel").splitlines():
        m = re.search(r"(splat_(?:taps|gather))E9SplatArgs", line)
        fn = m.group(1) if m else fn
        if fn and "Used" in line:
            log(f"  ptxas {fn}: {line.split(':', 1)[1].strip()}")
    log_ptxas("volpath_kernel",
              ptxas_report(build_log("volpath_kernel"), "volpath_kernel"),
              {(vk.HAS_HG,)}, lambda inst: vk.kernel_name(*inst))
    entry = None
    for line in build_log("intersect_kernel").splitlines():
        m = re.search(r"(isect_\w+_kernel)", line)
        entry = m.group(1) if m else entry
        if entry and "Used" in line:
            log(f"  ptxas {entry}: {line.split(':', 1)[1].strip()}")

    paths = [
        ("cornell", "scalar_rgb", cornell_box_dict, 0, (0.05, 1.0)),
        ("matpreview", "scalar_rgb", matpreview_dict, full, (0.2, 5.0)),
        ("cornell_spectral", "scalar_spectral", cornell_box_dict, 0,
         (0.05, 1.0)),
        ("matpreview_spectral", "scalar_spectral", matpreview_dict, full,
         (0.2, 5.0)),
        ("cornell_mono", "scalar_mono", cornell_box_dict, 0, (0.05, 1.0)),
    ]
    kernels = [e for p in paths for e in run_path(mi, pk, *p)]
    kernels += run_volpath(mi, pk, vk, volpath_slab_dict)
    # the big meshes: the BVH tier, parity and the walk counts at 32^2 x 4
    # spp, the plain version on every 31st pixel of the main shape
    big = dict(spp=BIG_SPP, max_depth=BIG_MAX_DEPTH,
               parity=(BIG_PARITY_WIDTH, BIG_PARITY_SPP),
               plain_stride=BIG_PLAIN_STRIDE)
    kernels += run_path(
        mi, pk, "biggeo", "scalar_rgb",
        lambda w, h, spp, depth: bumpy_sphere_dict(w, h, spp, depth, 512,
                                                   257),
        pk.HAS_BVH, (0.03, 0.5), **big)
    kernels += run_path(
        mi, pk, "hero", "scalar_rgb", hero_serialized_dict,
        (full & ~pk.HAS_SPHERES) | pk.HAS_BVH, (0.2, 5.0), **big)
    kernels += run_isect(mi, pk, ik, isx, bumpy_sphere_dict)
    check_bvh_tier_on_cornell(mi, pk, cornell_box_dict)
    # the materials scene: the lobes flag's instantiation and the splat
    for name, variant in (("cornell_materials", "scalar_rgb"),
                          ("cornell_materials_spectral", "scalar_spectral")):
        kernels += run_path(mi, pk, name, variant, cornell_materials_dict,
                            materials, (0.03, 1.0), first_hits=True,
                            mean_rtol=CAUSTIC_MEAN_RTOL)
    kernels.append(check_mono_materials(mi, pk, cornell_materials_dict))

    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
