"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels and its host BVH builder from the sources
in this checkout (the path kernel twice per color mode, without and with
its lobes flag, the film splat, the volumetric kernel, the intersection
kernel, the face sweep and csrc/bvh.cpp, in parallel compiler processes)
and prints each
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
kind on at least 1% of camera rays. Each path kernel and volumetric
kernel launch of the main run prints its grid, which must be the card's
SMs times the blocks resident on each (every family of both runs
persistent blocks), its shared memory and ptxas's registers and spills,
and two launches of each must give bit-identical outputs (lanes reach
threads in no fixed order). It holds the BVH tier and
the lobes flag, each forced on the Cornell box, against the flag-free
kernel and times all three, and drives the scene's ray
queries (``Scene.ray_intersect_preliminary`` and ``Scene.ray_test``, the
intersection kernel's closest-hit and any-hit entries) on biggeo's
2,097,152 camera rays and as many rays toward its light, against their
plain twin on 65,536 of each, bit for bit. Both walk the scene's 4-wide
BVH (csrc/bvh.cuh); their bounds count the tests of the binary walk over
the same leaves, and the wide walk's counts are logged beside. Last comes
the measurement path: the face-test and box-test ceilings through
``tools/shape_ceiling.py`` (the sweep kernel's shared-memory and global
face instantiations beside ``torch.matmul`` of the same product, and its
two box instantiations over tables of the walk's 128-byte node lines),
each instantiation's timed outputs against its plain version on the same
inputs, each path kernel's face tests a second against the face ceilings
and its wide walk's box tests against the L2 box ceiling, and the
per-depth utilization report and the
lane-occupancy count (``core/profiler.py``) of the Cornell box and of the
materials box. Prints one JSON line of kernel results, the
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

from mitsuba2_tpu_torch.core import profiler as prof
# the path kernel's paths and their main shapes, the ray queries' light
# rays, and the splat library's ptxas report
from mitsuba2_tpu_torch.tools.time_paths import (PATHS, light_rays,
                                                 splat_ptxas)

# the main shape of the volpath slab, of the Cornell box's forced flags
# and of the per-depth reports
WIDTH, SPP, MAX_DEPTH = 256, 64, 6
PARITY_WIDTH, PARITY_SPP, SEED = 64, 16, 7
# the big-mesh paths (bench.py biggeo, hero): parity and the plain
# version's time at 32x32x4 spp
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
# the shape of the lane-occupancy count (width, spp): 64 spp, so that a
# warp of a one-thread-per-lane launch holds 32 samples of one pixel
OCC_SHAPE = (32, 64)
# the volpath path (bench.py bench_volpath): 256x256, 16 spp, max_depth 16
VOL_SPP, VOL_MAX_DEPTH = 16, 16
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
    out, times = prof.cuda_times(fn, repeats, warm_up)
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
    if tables.flags & pk.HAS_BVH:
        log("  walk per path: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(per.items()) if "walk" in k)
            + "; per camera or bounce ray: " + "; ".join(
                f"{what} {per[k + '_nodes'] / per['rays']:.2f} nodes, "
                f"{per[k + '_boxes'] / per['rays']:.2f} box and "
                f"{per[k + '_faces'] / per['rays']:.2f} face tests"
                for what, k in (("binary walk (the bound's)", "walk"),
                                ("wide walk (the kernel's)", "walk_wide"))))
    if tables.flags & pk.HAS_LOBES:
        log("  lobes per path: " + ", ".join(
            f"{k} {per.get(k, 0.0):.4f}" for k in (
                "dielectric", "plastic", "roughplastic", "bitmap",
                "quad_tests", "shadow_quads")))
    return roofline(prof.path_kernel_flop_count(tables, stats, n_stats,
                                                n_paths), tables, n_paths)


def splat_bound(n_lanes, k, n_block):
    """-> (ms, 'operations' or 'bytes'): the splat's least time: 12 bytes
    read per lane and 16 written per block pixel, against its FLOPs."""
    return roofline(prof.splat_flop_count(n_lanes, k, n_block), 16 * n_block,
                    n_lanes, out_bytes=0, in_bytes=12, what="lane")


def vol_bound(tables, stats, n_stats, n_paths):
    """-> (ms, 'operations' or 'bytes'): the least time the card could
    take for n_paths volpath paths, from the per-lane work counted by the
    plain version (``stats`` over ``n_stats`` lanes of the same scene)."""
    per = {k: v / n_stats for k, v in stats.items()}
    log("  per path: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                   sorted(per.items())))
    return roofline(prof.volpath_flop_count(tables, stats, n_stats, n_paths),
                    tables, n_paths)


def roofline(flops, tables, n_items, out_bytes=12, in_bytes=0, what="path"):
    """-> (ms, 'operations' or 'bytes') of ``prof.roofline``, logging its
    two times."""
    b = prof.roofline(flops, tables, n_items, out_bytes, in_bytes)
    log(f"  bound: {flops / n_items:.0f} FLOP/{what}, {flops / 1e9:.3f} "
        f"GFLOP -> {b.ops_ms:.4f} ms; {b.nbytes / 1e6:.3f} MB -> "
        f"{b.bytes_ms:.4f} ms")
    return b.ms, b.by


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
    # its key in PTXAS, if it is not ``key``
    ptxas_key: object = None
    # threads a block of its persistent launch
    block: int = 128


def check_first_hits(name, stats, n):
    """The parity run's first-hit share of each new kind -> SystemExit if
    one is below MIN_FIRST_HIT_SHARE."""
    shares = {k: stats.get(f"first_{k}", 0) / n for k in NEW_KINDS}
    log(f"{name} first-hit shares: " + ", ".join(
        f"{k} {v:.4f}" for k, v in shares.items()))
    if min(shares.values()) < MIN_FIRST_HIT_SHARE:
        raise SystemExit(f"{name}: a new kind is the first hit of less "
                         f"than {MIN_FIRST_HIT_SHARE:.0%} of camera rays")


def check_splat(name, rad, width, spp, rfilter, launches):
    """The splat kernel on a pass's lanes against its plain version: every
    block pixel within 1e-5 relative or 1e-6 absolute -> its entry of the
    kernels line."""
    from mitsuba2_tpu_torch.ops import splat as sp
    from mitsuba2_tpu_torch.tools.time_paths import batched_ms
    block, splat_ms = timed(lambda: sp.splat(rad, 0, 0, spp, width, width,
                                             rfilter))
    # no atomics, a fixed order of sums: a relaunch gives the same bits
    same = torch.equal(block, sp.splat(rad, 0, 0, spp, width, width,
                                       rfilter))
    log(f"{name} splat: two launches bit-identical: {same}")
    if not same:
        raise SystemExit(f"{name}: two launches of splat_kernel differ")
    want, plain_ms = timed(lambda: sp.splat_reference(
        rad, 0, 0, spp, width, width, rfilter), repeats=1, warm_up=False)
    err = (block - want).abs()
    ok = (err <= 1e-5 * want.abs()) | (err <= 1e-6)
    rel = float((err / want.abs().clamp(min=1e-30)).max())
    log(f"{name} splat {type(rfilter).__name__} block "
        f"{tuple(block.shape)}: max rel diff {rel:.3e}, block pixels "
        f"within 1e-5 or 1e-6 {float(ok.float().mean()):.6f}")
    if not bool(ok.all()):
        raise SystemExit(f"{name}: splat kernel and plain version disagree")
    k = 2 * ((block.shape[0] - width) // 2) + 1
    bound_ms, bound_by = splat_bound(rad.shape[1], k,
                                     block.shape[0] * block.shape[1])
    b2b_ms = batched_ms(lambda: sp.splat(rad, 0, 0, spp, width, width,
                                         rfilter))
    log(f"{name} splat: kernel {splat_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), {100 * bound_ms / splat_ms:.2f}% of bound; back to "
        f"back {b2b_ms:.4f} ms a call ({100 * bound_ms / b2b_ms:.2f}%); "
        f"plain version {plain_ms:.3f} ms")
    return {"name": f"splat_kernel[{name}]", "route": "cuda",
            "source": "mitsuba2_tpu_torch/csrc/splat_kernel.cu",
            "replaces": "mitsuba2_tpu/ops/megakernel.py:3041",
            "launches": launches, "max_abs_err": float(err.max()),
            "ms": splat_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def drive(mi, pk, name, make_dict, width, spp, max_depth, mean_band,
          route):
    """Parity, and render and timing at the main shape (width^2 x spp,
    max_depth) of one path -> (its entries of
    the kernels line: the path's kernel, and the splat's where the film
    filter is not the box; for the path kernel {name: (face tests a second
    of its main run, the ceiling that bounds them, 'shared' or 'l2', the
    wide walk's box tests a second)}, else {})."""
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
    t_plain = time.perf_counter()
    want = route.reference(*p_args, stats=stats)
    torch.cuda.synchronize()
    log(f"{name} parity plain version, with its counts: "
        f"{time.perf_counter() - t_plain:.1f} s")
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
    scene = mi.load_dict(make_dict(width, width, spp, max_depth))
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
    if img.shape != (width, width, 3) or img.device.type != "cuda" \
            or not bool(torch.isfinite(img).all()) \
            or not mean_band[0] < mean < mean_band[1]:
        raise SystemExit(f"{name} image is wrong: {tuple(img.shape)} "
                         f"{img.device} mean {mean}")
    log(f"{name}: {width}^2 x {spp} spp, depth {max_depth}: {launches} "
        f"launch(es) of {route.label}, image mean {mean:.6f}, channel means "
        f"{[round(float(x), 6) for x in img.mean(dim=(0, 1))]}")

    n_paths = width * width * spp
    _, render_ms = timed(lambda: integrator.render(scene, seed=0, spp=spp))
    tables = route.tables(scene)
    cam = pk.camera_row(scene.sensors[0], scene.device)
    args = (tables, cam, 0, 0, spp, width, width, max_depth,
            integrator.rr_depth)
    k_rad, kernel_ms = timed(lambda: route.radiance(*args))
    if route.key in route.radiance.last_launch:
        log_launch(name, route, n_paths)
        # lanes are handed to threads in no fixed order; a lane's result
        # depends on its key alone
        same = torch.equal(k_rad, route.radiance(*args))
        log(f"{name}: two launches bit-identical: {same}")
        if not same:
            raise SystemExit(f"{name}: two launches of {route.label} differ")
    entries = []
    if not isinstance(rfilter, BoxFilter):
        entries.append(check_splat(name, k_rad, width, spp, rfilter,
                                   splat_launches))
    # the plain version is the kernel's reference, not a yardstick of
    # speed: one timed call, on the main run's lanes or on those of a
    # strided sample of its pixels (all their samples)
    n_pix, kw = width * width, {}
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
    face_rates = {}
    if route.radiance is pk.path_radiance:
        tests = prof.face_test_count(tables, stats, pw * pw * pspp, n_paths)
        bvh = bool(tables.flags & pk.HAS_BVH)
        # the box tests the card's wide walk ran, a second
        boxes = n_paths * sum(stats.get(k, 0) for k in (
            "walk_wide_boxes", "shadow_walk_wide_boxes")) / (pw * pw * pspp)
        face_rates[name] = (tests / (kernel_ms / 1e3),
                            "l2" if bvh else "shared",
                            boxes / (kernel_ms / 1e3))
        log(f"{name} face tests: {tests / n_paths:.2f} a path, "
            f"{face_rates[name][0] / 1e9:.3f} G/s")
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
             "bound_by": bound_by, "library_ms": None}] + entries, face_rates


# ptxas's report of each path kernel instantiation, by (flags, nc)
PTXAS = {}


def log_launch(name, route, n_lanes):
    """The main run's launch of the path kernel or the volumetric kernel:
    its grid, which must be the SMs times the blocks resident on each
    (persistent blocks, every family), its shared memory and ptxas's
    registers and spills."""
    info = route.radiance.last_launch[route.key]
    ptxas = PTXAS.get(route.ptxas_key or route.key, "no report")
    log(f"{name} launch of {route.label}: persistent, grid {info['grid']} "
        f"for {n_lanes} lanes, {info['blocks_per_sm']} blocks of "
        f"{route.block} resident an SM x {info['sms']} SMs, {info['smem']} B "
        f"dynamic shared a block; ptxas: {ptxas}")
    if info["grid"] != info["sms"] * info["blocks_per_sm"]:
        raise SystemExit(f"{name}: the launch's grid {info['grid']} is "
                         f"not the card's resident blocks ({info})")


def run_path(mi, pk, scenes, path, flags, mean_band, **route):
    """One path of the path kernel (a ``PATHS`` row, its builder from the
    ``scenes`` module) at its main shape -> its entries of the kernels line
    and its face-test rate (``drive``). ``route`` overrides ``Route``
    fields (parity shape, replaces, first hits)."""
    name = path.name
    mi.set_variant(path.variant)
    nc = pk.MODE_NC[mi.variant_config().color_mode]

    def tables(scene):
        if (scene.tables.flags & pk.TEMPLATE_FLAGS, scene.tables.nc) \
                != (flags, nc):
            raise SystemExit(f"{name}: scene tables carry flags "
                             f"{scene.tables.flags}, nc {scene.tables.nc}")
        return scene.tables

    fields = dict(replaces="mitsuba2_tpu/ops/megakernel.py:365")
    fields.update(route)
    return drive(mi, pk, name, path.make(scenes), path.width, path.spp,
                 path.max_depth, mean_band, Route(
        pk.kernel_name(flags, nc), (flags, nc), pk.path_radiance,
        pk.path_radiance_reference, pk.reset_launch_counts, tables,
        lambda *a: bound(pk, *a), "mitsuba2_tpu_torch/csrc/path_kernel.cu",
        block=pk.BLOCK, **fields))


def check_forced_on_cornell(mi, pk, cornell_box_dict):
    """The BVH tier and the lobes flag, each forced on the Cornell box,
    against its flag-free shared-memory tier: the same lanes at 64^2 x 16
    spp, and all three timed at the main shape (the lobes flag's cost
    with no divergence by kind)."""
    mi.set_variant("scalar_rgb")
    times = {}
    for width, spp in ((PARITY_WIDTH, PARITY_SPP), (WIDTH, SPP)):
        scene = mi.load_dict(cornell_box_dict(width, width, spp, MAX_DEPTH))
        cam = pk.camera_row(scene.sensors[0], scene.device)
        args = (cam, SEED, 0, spp, width, width, MAX_DEPTH,
                scene.integrator.rr_depth)
        tiers = {"shared": scene.tables,
                 "bvh": pk.with_bvh_tier(scene.tables),
                 "lobes": scene.tables._replace(
                     flags=scene.tables.flags | pk.HAS_LOBES)}
        if width == PARITY_WIDTH:
            out = {k: pk.path_radiance(t, *args) for k, t in tiers.items()}
            for k in ("bvh", "lobes"):
                compare(develop(out[k], width, spp),
                        develop(out["shared"], width, spp),
                        f"cornell, {k} forced against the flag-free kernel")
            continue
        for k, t in tiers.items():
            times[k] = timed(lambda: pk.path_radiance(t, *args))[1]
    log(f"cornell {WIDTH}^2 x {SPP} spp kernel: flag-free "
        f"{times['shared']:.3f} ms, BVH tier forced {times['bvh']:.3f} ms "
        f"({times['bvh'] / times['shared']:.3f}x), lobes flag forced "
        f"{times['lobes']:.3f} ms ({times['lobes'] / times['shared']:.3f}x)")


def every_kth(ray, count):
    """``count`` rays spread over a ray batch (every k-th), as the
    (o, d, mint, maxt) arguments of the queries."""
    k = max(1, ray.o.shape[0] // count)
    return tuple(x[::k][:count].contiguous() for x in ray)


def isect_parity(name, got, want):
    """The intersection kernel's closest-hit or any-hit outputs against its
    plain twin's, which must be bit-identical (the same unfused face test;
    the share and tolerances are logged beside) -> the largest abs error
    (of t over the rays whose prims agree, or of the 0/1 hits)."""
    if name == "isect_any":
        same = got == want
        share = float(same.float().mean())
        err = float((got.float() - want.float()).abs().max())
        ok = bool(same.all())
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
        # the kernel's face test is its twin's, unfused: bit for bit
        bits = bool(torch.equal(prim, rprim)) and all(
            torch.equal(x.view(torch.int32), y.view(torch.int32))
            for x, y in ((t, rt), (uv, ruv)))
        ok = (share >= ISECT_PRIM_SHARE and t_err <= ISECT_ATOL
              and uv_err <= ISECT_ATOL and misses_agree and bits)
        detail = (f"hits {float((rprim >= 0).float().mean()):.4f}, t rel "
                  f"err {t_err:.3e}, uv err {uv_err:.3e}, bit-identical "
                  f"{bits}")
    log(f"    parity: equal on {share:.6f} of {len(same)} rays, {detail}")
    if not ok:
        raise SystemExit(f"{name}: kernel and plain twin disagree")
    return err


def sweep_parity(name, got, want):
    """The sweep kernel's (t, uv, prim, hits) against its plain version's
    -> the largest abs error of t over the rays whose prims agree. The
    kernel runs the path kernel's fused face test, the plain version K2's
    unfused one, and on N(0,1) Woop rows (thin random faces, whose u and v
    are differences of large products) the two forms part by float
    rounding on a few rays: a ray agrees when its prim is equal and its t
    (relative to max(1, |t|)) and uv are within ISECT_ATOL, or both miss;
    ISECT_PRIM_SHARE of the rays must agree, and as many hit counts."""
    (t, uv, prim, hits), (rt, ruv, rprim, rhits) = got, want
    same = prim == rprim
    both = same & (rprim >= 0)
    t_err = torch.where(both, (t - rt).abs() / rt.abs().clamp(min=1.0), 0.0)
    uv_err = torch.where(both, (uv - ruv).abs().amax(1), 0.0)
    agree = (both & (t_err <= ISECT_ATOL) & (uv_err <= ISECT_ATOL)) \
        | (same & (rprim < 0) & torch.isinf(t))
    share = float(agree.float().mean())
    hits_share = float((hits == rhits).float().mean())
    log(f"    parity: prims equal on {float(same.float().mean()):.6f} of "
        f"{len(same)} rays, agree on {share:.6f} ({int((~agree).sum())} "
        f"rays not); hits {float((rprim >= 0).float().mean()):.4f}, t rel "
        f"err {float(t_err.max()):.3e}, uv err {float(uv_err.max()):.3e}; "
        f"hit counts equal on {hits_share:.6f}, mean "
        f"{float(rhits.float().mean()):.3f}")
    if share < ISECT_PRIM_SHARE or hits_share < ISECT_PRIM_SHARE:
        raise SystemExit(f"{name}: kernel and plain version disagree")
    return float(torch.where(both, (t - rt).abs(), 0.0).max())


def box_parity(name, got, want):
    """The box sweep's (near, hits) against its plain version's: the same
    arithmetic, so bit for bit -> the largest abs error of near (0)."""
    (near, hits), (rnear, rhits) = got, want
    same = torch.equal(near.view(torch.int32), rnear.view(torch.int32)) \
        and torch.equal(hits, rhits)
    log(f"    parity: bit-identical {same}; hits a ray "
        f"{float(rhits.float().mean()):.3f}, rays with a hit box "
        f"{float(torch.isfinite(rnear).float().mean()):.4f}")
    if not same:
        raise SystemExit(f"{name}: kernel and plain version disagree")
    both = torch.isfinite(rnear)
    return float((near[both] - rnear[both]).abs().max()) if bool(
        both.any()) else 0.0


def run_isect(mi, pk, ik, isx, scenes, big):
    """The scene's ray queries on biggeo (``big``, its ``PATHS`` row)
    through the intersection kernel: ``Scene.ray_intersect_preliminary``
    on the 2,097,152 camera rays of its 256^2 x 32 spp image and on as
    many rays toward the light,
    ``Scene.ray_test`` on the light rays; each entry point against its
    plain twin on 65,536 rays of both sets, timed on 2,097,152 -> the two
    entries of the kernels line."""
    from mitsuba2_tpu_torch.core.ray import Ray
    t_phase = time.perf_counter()
    mi.set_variant("scalar_rgb")
    scene = mi.load_dict(big.make(scenes)(big.width, big.width, big.spp,
                                          big.max_depth))
    tables = scene.tables
    cam_ray = Ray.make(*pk.camera_rays(
        pk.camera_row(scene.sensors[0], scene.device), big.width, big.width,
        big.spp, SEED))
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
    trees = pk.walk_trees(tables)
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
        # the bound counts the binary walk's tests and reads over the same
        # leaves; the wide walk the kernel runs is logged beside it (both
        # walked on the host)
        sample = [x.cpu() for x in every_kth(main, ISECT_COUNT_RAYS)]
        for label, walk in (
                ("binary walk (the bound's)", isx.traverse_pairs(
                    trees.pairs, trees.woop, trees.prim, *sample,
                    any_hit=name == "isect_any", k2=True)),
                ("wide walk (the kernel's)", isx.traverse(
                    trees.nodes, trees.woop, trees.prim, *sample,
                    any_hit=name == "isect_any", k2=True))):
            # the nodes and face rows the sample's walks read, once: a
            # lower bound on what all the rays' walks read
            log(f"  {name} {label} per ray: "
                f"{float(walk['nodes'].float().mean()):.2f} nodes, "
                f"{float(walk['boxes'].float().mean()):.2f} box tests, "
                f"{float(walk['faces'].float().mean()):.2f} face tests; the "
                f"sample's walks read {int(walk['node_reads'].sum())} of "
                f"{len(walk['node_reads'])} nodes and "
                f"{int(walk['face_reads'][:, 0].sum())} of "
                f"{len(walk['face_reads'])} faces, "
                f"{isx.bytes_read(walk) / 1e6:.3f} MB")
            if label.startswith("binary"):
                boxes = float(walk["boxes"].float().mean())
                faces = float(walk["faces"].float().mean())
                read = isx.bytes_read(walk)
        bound_ms, bound_by = roofline(
            prof.walk_flop_count(n, boxes, faces), read, n,
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
    kernel's hg instantiation -> its entries of the kernels line and no
    face-test rate (``drive``)."""
    mi.set_variant("scalar_rgb")
    flags = vk.HAS_HG

    def tables(scene):
        t = vk.build_vol_tables(scene)
        if t.flags != flags:
            raise SystemExit(f"volpath: scene tables carry flags {t.flags}")
        return t

    return drive(mi, pk, "volpath", volpath_slab_dict, WIDTH, VOL_SPP,
                 VOL_MAX_DEPTH, (0.3, 5.0), Route(
                     vk.kernel_name(flags), flags, vk.volpath_radiance,
                     vk.volpath_radiance_reference, vk.reset_launch_counts,
                     tables, vol_bound,
                     "mitsuba2_tpu_torch/csrc/volpath_kernel.cu",
                     "mitsuba2_tpu/ops/volmegakernel.py:186",
                     ptxas_key=("volpath", flags), block=vk.BLOCK))


def check_mono_materials(mi, pk, scenes, path):
    """The materials scene's kernel under ``scalar_mono`` (``path``, its
    ``PATHS`` row, at the parity shape) against its plain version, and one
    render through the user's entry points there -> its entry of the
    kernels line (times and bound at that shape)."""
    mi.set_variant(path.variant)
    flags, pw, pspp = pk.HAS_SPHERES | pk.HAS_LOBES, path.width, path.spp
    scene = mi.load_dict(path.make(scenes)(pw, pw, pspp, path.max_depth))
    if scene.tables.flags & pk.TEMPLATE_FLAGS != flags:
        raise SystemExit(f"mono materials: tables carry {scene.tables.flags}")
    cam = pk.camera_row(scene.sensors[0], scene.device)
    args = (scene.tables, cam, SEED, 0, pspp, pw, pw, path.max_depth,
            scene.integrator.rr_depth)
    got, kernel_ms = timed(lambda: pk.path_radiance(*args))
    if not torch.equal(got, pk.path_radiance(*args)):
        raise SystemExit("mono materials: two launches differ")
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


def run_ceiling(mi, pk, sk, cornell_box_dict, cornell_materials_dict,
                face_rates):
    """The measurement path: the face-test and box-test ceilings through
    ``tools/shape_ceiling.py``'s entry point (the sweep kernel's four
    instantiations at the tool's default shapes), each instantiation's
    last timed outputs against its plain version on the same inputs, the
    paths' face-test and box-test rates (``face_rates``, from ``drive``)
    against the ceilings, and the Cornell box's per-depth utilization
    report -> the four entries of the kernels line."""
    from mitsuba2_tpu_torch.tools import shape_ceiling as sc
    t_phase = time.perf_counter()
    sk.reset_launch_counts()
    res = sc.run(log=log)
    torch.cuda.synchronize()
    launches = dict(sk.sweep.launches_by_kernel)
    for r in res.values():
        if launches.get(r["name"], 0) < 1:
            raise SystemExit(f"the ceiling missed {r['name']}: {launches}")
    entries = []
    for r in res.values():
        got = r["outputs"]
        want, plain_ms = timed(r["reference"], repeats=1, warm_up=False)
        what = f"{r['faces']} faces" if "faces" in r else f"{r['boxes']} boxes"
        log(f"  {r['name']} against its plain version on the same inputs, "
            f"{what} x {r['rays']} rays x {r['iters']} iterations (plain "
            f"version {plain_ms:.3f} ms):")
        err = (sweep_parity if "faces" in r else box_parity)(r["name"], got,
                                                            want)
        entries.append({
            "name": r["name"], "route": "cuda",
            "source": "mitsuba2_tpu_torch/csrc/sweep_kernel.cu",
            "replaces": r["replaces"],
            "launches": launches[r["name"]], "max_abs_err": err,
            "ms": r["ms"], "plain_ms": plain_ms, "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    ceilings = {"shared": res["shared"]["tests_per_s"],
                "l2": res["global"]["tests_per_s"]}
    box_l2 = res["box_global"]["tests_per_s"]
    for name, (rate, tier, box_rate) in face_rates.items():
        log(f"{name}: {rate / 1e9:.3f} G face tests/s, "
            f"{100 * rate / ceilings[tier]:.2f}% of the {tier} ceiling "
            f"({ceilings[tier] / 1e9:.2f} G/s)" + (
                f"; the wide walk's {box_rate / 1e9:.3f} G box tests/s, "
                f"{100 * box_rate / box_l2:.2f}% of the L2 box ceiling "
                f"({box_l2 / 1e9:.2f} G/s)" if box_rate else ""))
    mi.set_variant("scalar_rgb")
    for name, make_dict in (("cornell", cornell_box_dict),
                            ("cornell_materials", cornell_materials_dict)):
        scene = mi.load_dict(make_dict(WIDTH, WIDTH, SPP, MAX_DEPTH))
        report, rows = prof.path_kernel_utilization_report(
            scene, SPP, MAX_DEPTH, REPEATS, ceilings=ceilings,
            parity=(PARITY_WIDTH, PARITY_SPP))
        log(f"{name}: {report}")
        if len(rows) != MAX_DEPTH or not all(
                0 < r["kernel_ms"] and 0 < r["pct_face"] < float("inf")
                for r in rows):
            raise SystemExit(f"{name}: the utilization report is "
                             f"implausible")
        # the lane slots a one-thread-per-lane launch would leave idle,
        # counted by the plain version in that launch's lane order
        w, spp = OCC_SHAPE
        scene = mi.load_dict(make_dict(w, w, spp, MAX_DEPTH))
        occ = prof.lane_occupancy(
            scene.tables, pk.camera_row(scene.sensors[0], scene.device), w,
            w, spp, MAX_DEPTH, scene.integrator.rr_depth)
        log(f"{name} lane occupancy at {w}^2 x {spp} spp, seed 0:\n"
            + "\n".join(prof.lane_occupancy_lines(occ)))
    log(f"ceiling phase: {time.perf_counter() - t_phase:.1f} s")
    return entries


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
    from mitsuba2_tpu_torch.ops import sweep_kernel as sk
    from mitsuba2_tpu_torch.ops import volpath_kernel as vk
    from mitsuba2_tpu_torch.python.test import scenes
    from mitsuba2_tpu_torch.python.test.scenes import (
        cornell_box_dict, cornell_materials_dict, volpath_slab_dict)

    nvcc = build.find_nvcc()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}"
        f"; nvcc: {nvcc or 'not found'}")

    # ---- build: two libraries per color mode, the splat, the volumetric
    # and the intersection kernel's and the host BVH builder, in parallel ----
    t0 = time.perf_counter()
    jobs = (pk.libraries() + sp.libraries() + vk.libraries()
            + ik.libraries() + sk.libraries() + [("bvh", {})])
    build.build_all(jobs)
    log(f"build: {len(jobs)} libraries -- path_kernel, 3 color modes x 2 "
        f"libraries x 32 instantiations (192), splat_kernel, "
        f"volpath_kernel, 16 instantiations, intersect_kernel, "
        f"sweep_kernel and csrc/bvh.cpp -- in "
        f"{time.perf_counter() - t0:.2f} s")
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
            report = build.ptxas_report(build_log(
                "path_kernel", pk.library_defines(nc, lobes)))
            PTXAS.update(report)
            log_ptxas(f"path_kernel, PK_NC={nc}, PK_LOBES={int(lobes)}",
                      report, {(f, nc) for f in on_paths},
                      lambda inst: pk.kernel_name(*inst))
    for fn, report in sorted(splat_ptxas(build_log("splat_kernel"))
                             .items()):
        if fn.startswith("splat_bands") or fn.endswith(", 2>"):
            log(f"  ptxas {fn}: {report}")
    report = build.ptxas_report(build_log("volpath_kernel"),
                                "volpath_kernel")
    PTXAS.update({("volpath",) + k: v for k, v in report.items()})
    log_ptxas("volpath_kernel", report, {(vk.HAS_HG,)},
              lambda inst: vk.kernel_name(*inst))
    entry = None
    for line in build_log("intersect_kernel").splitlines():
        m = re.search(r"isect_kernelILb([01])E", line)
        entry = ("isect_any" if m.group(1) == "1" else "isect_closest") \
            if m else entry
        if entry and "Used" in line:
            log(f"  ptxas {entry}: {line.split(':', 1)[1].strip()}")
    entry = None
    for line in build_log("sweep_kernel").splitlines():
        m = re.search(r"(sweep|box)_kernelILb([01])E", line)
        entry = sk.kernel_name(m.group(2) == "1", m.group(1) == "box") \
            if m else entry
        if entry and "Used" in line:
            log(f"  ptxas {entry}: {line.split(':', 1)[1].strip()}")

    # each path's template flags, image mean band and Route overrides
    big = dict(parity=(BIG_PARITY_WIDTH, BIG_PARITY_SPP),
               plain_stride=BIG_PLAIN_STRIDE)
    checks = {
        "cornell": (0, (0.05, 1.0), {}),
        "matpreview": (full, (0.2, 5.0), {}),
        "cornell_spectral": (0, (0.05, 1.0), {}),
        "matpreview_spectral": (full, (0.2, 5.0), {}),
        "cornell_mono": (0, (0.05, 1.0), {}),
        # the big meshes: the BVH tier, parity and the walk counts at
        # 32^2 x 4 spp, the plain version on every 31st pixel
        "biggeo": (pk.HAS_BVH, (0.03, 0.5), big),
        "hero": ((full & ~pk.HAS_SPHERES) | pk.HAS_BVH, (0.2, 5.0), big),
        # the materials scene: the lobes flag's instantiation and the splat
        "cornell_materials": (materials, (0.03, 1.0), dict(
            first_hits=True, mean_rtol=CAUSTIC_MEAN_RTOL)),
        "cornell_materials_spectral": (materials, (0.03, 1.0), dict(
            first_hits=True, mean_rtol=CAUSTIC_MEAN_RTOL)),
    }
    # the kernels line, and the path kernel's face-test rates by path
    kernels, face_rates = [], {}
    for path in PATHS:
        if path.name == "cornell_materials_mono":
            # at the parity shape, against the plain version
            kernels.append(check_mono_materials(mi, pk, scenes, path))
            continue
        flags, band, route = checks[path.name]
        entries, rates = run_path(mi, pk, scenes, path, flags, band, **route)
        kernels.extend(entries)
        face_rates.update(rates)
    kernels += run_volpath(mi, pk, vk, volpath_slab_dict)[0]
    kernels += run_isect(mi, pk, ik, isx, scenes,
                         next(p for p in PATHS if p.name == "biggeo"))
    check_forced_on_cornell(mi, pk, cornell_box_dict)
    kernels += run_ceiling(mi, pk, sk, cornell_box_dict,
                           cornell_materials_dict, face_rates)

    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
