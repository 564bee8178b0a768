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
the same leaves, and the wide walk's counts are logged beside. The
wavefront phase then drives the general wavefront (``PathIntegrator.
sample``, whose ray queries are K2's), which renders every scene the path
kernel's gate refuses: matpreview with a Beckmann hero at 256x256, 64 spp,
max_depth 6 (timed, with K2's launches and share, the spans of its layers,
the host's waits for the card counted by torch's sync debug mode, and
peak memory), K2 held bit for bit against its plain twin on 65,536 rays
sampled from every one of its launches in that render (its two entries of
the kernels line, ``isect_closest[wavefront]`` and
``isect_any[wavefront]``, count the render's launches and time K2 on one
bounce's rays), the card against the CPU at 32x32x4 spp with projected
normal sampling and at 128x128x4 spp with visible normals
(tools/wavefront_spread.py); the Cornell box forced onto it
(``_disable_kernel``) within 2% of the kernel's means; the materials box,
the mono Cornell box and spectral matpreview. The volpath wavefront phase
drives ``VolumetricPathIntegrator.sample``, which renders every volpath
scene K3's gate refuses: volpath_gaussian (the volpath slab under the
film's default gaussian filter) at 256x256, 16 spp, max_depth 16 (timed,
the trip counts of its loops, K2's launches and share, the spans of its
layers, the host's waits against the design's count, peak memory), K2
held bit for bit against its plain twin on 65,536 rays sampled from every
closest-hit launch of that render (``isect_closest[volpath_wavefront]``
in the kernels line), the card against the CPU on one pass's lanes at
32x32x4 spp (the slab, spectral volpathmis, a homogeneous slab in mono:
equal trip counts, then the parity bar), the box-film slab forced onto
the wavefront against K3 (within 12% of its mean) and vacuum volpath on
the Cornell box (K2's any hit) against the path kernel. The surface
wavefront phase renders the scenes users write, which both kernels' gates
refuse, through ``load_dict`` and ``scene.integrator.render``:
cornell_surfaces (twosided walls, a bump-mapped floor, a normal-mapped
back wall, a rough glass box, a conductor-and-diffuse blend, a thin pane,
a masked card and a conductor panel; each of those eight BSDFs the first
hit of at least 1% of the camera rays) and cornell_lights (spot, point,
projector, directional and constant emitters, blackbody, curve and
regular spectra) at 256x256, 64 spp, max_depth 6 (timed, spans by layer
with the BSDF wrappers and the delta and constant emitters apart, host
syncs against the design's count, peak memory, K2 bit for bit on 65,536
rays sampled from every launch of a render and timed on its busiest
launch: the entries
``isect_closest[cornell_surfaces]`` and so on of the kernels line), both
card against CPU at 32x32x4 spp in rgb and spectral (the glass box stands
on the floor, and the lanes that part where the card and the CPU break
the tie of its base with the floor are traced, named and set apart), and
fog_spot (a spot
and a point light in a homogeneous fog with a masked card) under volpath
and volpathmis, card against CPU on one pass's lanes; then the Cornell
box and the volpath slab with their area lights written as uniform
spectra, which stay on the path kernel and K3 and render bit for bit as
the same lights written as colors. The scene-file and instancing phase
(after the sensor and integrator phase) loads the Cornell box from an XML
file (``load_file``) onto the path kernel, its tables within the writer's
rounding of the dict scene's; biggeo's mesh from a PLY file, its image bit
for bit the OBJ scene's, both loads timed; 8 instances of a 4,096-face
group (materialized) on the BVH tier, held against the plain version on
every 31st pixel; 8 instances of biggeo's 262,144-face group (shared: one
packed group, a transform row an instance) on the path wavefront, timed
with its host syncs, spans and peak memory (and at 2 instances), K2's
instance entries bit for bit against their plain version on rays of four
of the render's launches (``isect_closest_inst[instanced_shared]`` and
``isect_any_inst[instanced_shared]`` in the kernels line), the small
shared scene card against CPU, shared against materialized image means;
``python -m mitsuba2_tpu_torch`` on the XML file, its EXR the in-process
render's; and a Blender quad from numpy buffers. The polarized and
measured phase renders at 256x256, 64 spp, max_depth 6 on the wavefronts
(timed, with host syncs, spans with the Mueller rotations and the
polarized BSDF calls apart, peak memory): the Cornell box in
``scalar_rgb_polarized`` and ``scalar_spectral_polarized`` (gate:
"polarized variant"), bit for bit the unpolarized box forced onto the
path wavefront; cornell_stokes (a polarizer pane under the light, a
retarder and a circular polarizer before the boxes, a pplastic tall box)
under ``stokes`` in rgb and ``scalar_spectral_polarized``, its S0 and
S1-S3 means logged and each of S1-S3 non-zero somewhere; cornell_measured
(a ``measured`` and a ``measured_polarized`` box, synthesized tensor
files) under ``path`` in rgb and spectral and under ``stokes``; K2 bit for
bit against its twin on rays of every launch of cornell_stokes and
cornell_measured (``isect_closest[cornell_stokes]`` and so on in the
kernels line); five of those card against CPU at 32x32x4 spp; and the
plain box under ``stokes``, S1-S3 zero and S0 the path wavefront's image
within four standard errors of the mean difference. The differentiable
rendering phase (``run_autodiff``) updates the Cornell box's red wall
and light and the volpath slab's sigma_t grid through
``params.update()`` and holds each kernel render (K1a, K3) bit for bit
against a fresh load's; runs a taped ``render_loss`` of the red wall's
albedo at 256x256, 16 spp, depth 6 on the path wavefront (engine and
gate, render and backward times, peak memory, at 64 spp too, K2's share;
its image the forced wavefront's bit for bit), the card's gradient
against the CPU's at 32x32x4 spp, ``render_loss_rb`` at 16 and 64 spp
(ms a step, peak memory flat in spp, the gradient the tape's within 0.35
of the scale), eight Adam steps through rb that recover the wall's
albedo, and K2 bit for bit against its twin on the rays of a taped
render (``isect_closest[autodiff]``, ``isect_any[autodiff]``). The
multichip phase (``run_multichip``) renders through
``parallel/mesh.py`` over every card present, or two shards on one card:
the Cornell box at 256x256, 64 spp, depth 6 sample-sharded (within 2e-5
of the single-device render) and banded (bit for bit), the materials box
banded (the lobes family and the splat, within 2e-5), the volpath slab
sample-sharded on K3; a ``[cuda:0, cpu]`` mesh (the CPU shard on the
plain versions) against the card alone at 64x64x16 spp, and the forced
wavefront there at 32x32x4; and the band launches of K1 and the splat
against their plain versions (``path_kernel[cornell_bands]``,
``path_kernel[materials_bands]`` and ``splat_kernel[materials_bands]``
in the kernels line). Last comes
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
import math
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
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
    # the entry's name in the kernels line, if it is not ``label``
    entry_name: str = None


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
          route, load=None):
    """Parity, and render and timing at the main shape (width^2 x spp,
    max_depth) of one path -> (its entries of
    the kernels line: the path's kernel, and the splat's where the film
    filter is not the box; for the path kernel {name: (face tests a second
    of its main run, the ceiling that bounds them, 'shared' or 'l2', the
    wide walk's box tests a second)}, else {}). ``make_dict`` gives what
    ``load`` (``mi.load_dict`` unless given) loads."""
    from mitsuba2_tpu_torch.models.rfilters import BoxFilter
    from mitsuba2_tpu_torch.ops import splat as sp
    t_path = time.perf_counter()
    load = load or mi.load_dict

    # ---- parity: kernel against its plain version on the same tables ----
    pw, pspp = route.parity
    scene = load(make_dict(pw, pw, pspp, max_depth))
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
    parity_plain_ms = 1e3 * (time.perf_counter() - t_plain)
    log(f"{name} parity plain version, with its counts: "
        f"{parity_plain_ms / 1e3:.1f} s")
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
    scene = load(make_dict(width, width, spp, max_depth))
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
    return [{"name": route.entry_name or route.label, "route": "cuda",
             "source": route.source,
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
    """``count`` rays spread over a ray batch (a Ray or its (o, d, mint,
    maxt) tuple; every k-th), as the (o, d, mint, maxt) arguments of the
    queries."""
    k = max(1, ray[0].shape[0] // count)
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


def k2_entry(isx, name, fn, ref, tables, woop, trees, main, out_bytes,
             launches, max_abs_err):
    """K2's entry ``name`` of the kernels line: the kernel timed on the ray
    set ``main`` (o, d, mint, maxt), its plain twin on ISECT_PARITY_RAYS
    of them, and the bound from the binary walk's tests and reads over a
    sample of them (walked on the host; the wide walk the kernel runs is
    logged beside)."""
    n = main[0].shape[0]
    sub = every_kth(main, ISECT_PARITY_RAYS)
    kernel_ms = timed(lambda: fn(tables, *main))[1]
    plain_ms = timed(lambda: ref(woop, *sub), repeats=1, warm_up=False)[1]
    sample = [x.cpu() for x in every_kth(main, ISECT_COUNT_RAYS)]
    for label, walk in (
            ("binary walk (the bound's)", isx.traverse_pairs(
                trees.pairs, trees.woop, trees.prim, *sample,
                any_hit=name.startswith("isect_any"), k2=True)),
            ("wide walk (the kernel's)", isx.traverse(
                trees.nodes, trees.woop, trees.prim, *sample,
                any_hit=name.startswith("isect_any"), k2=True))):
        # the nodes and face rows the sample's walks read, once: a lower
        # bound on what all the rays' walks read
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
        f"{plain_ms:.3f} ms on {len(sub[0])} rays")
    return {
        "name": name, "route": "cuda",
        "source": "mitsuba2_tpu_torch/csrc/intersect_kernel.cu",
        "replaces": "mitsuba2_tpu/ops/intersect_pallas.py:81",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}


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
        entries.append(k2_entry(isx, name, fn, ref, tables, woop, trees,
                                tuple(main), out_bytes, launches[name],
                                max(errs)))
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


# the wavefront phase: the slice's path (matpreview with a Beckmann hero,
# which the path kernel's gate refuses, tools/wavefront_spread.py) at the
# main shape; K2 held bit for bit against its plain twin on a sample of
# the rays of every one of its launches in a render at that shape; the
# card against the CPU with projected normal sampling at 32^2 x 4 spp (the
# parity bar) and with visible normals at 128^2 x 4 spp (the solve's
# one-ulp spread, tools/wavefront_spread.py ``spread``); the forced
# Cornell box at the main shape within this share of the kernel's means;
# the materials box (128^2 x 16) and mono Cornell (64^2 x 16) within this
# share of the kernels'
WF_CPU_WIDTH, WF_CPU_SPP = 32, 4
WF_SPREAD_WIDTH, WF_SPREAD_SPP = 128, 4
WF_CORNELL_RTOL, WF_SMALL_RTOL = 0.02, 0.03
# a lane that took another branch on the card departs from the CPU's by
# more than this; at most this many may (the count of smoke 2 on the
# projected run, each logged with the call where card and CPU part)
WF_DIVERGED, WF_MAX_DIVERGENT_LANES = 1e-3, 2
# rays kept of each K2 launch of the wavefront's render for the parity
WF_K2_SAMPLE = 4096


class _Spans:
    """CUDA-event spans of the wavefront's layers in one render, by wrapping
    functions for the render's duration: K2's launches by entry name
    (``ik._launch``) and each of ``targets``, (object, attribute, label).
    With ``nest`` a call made inside another wrapped call is labelled
    "<label> in <outer label>", so that the top-level labels partition
    the render."""

    def __init__(self, ik, targets, nest=False):
        self.events = {}
        self.stack = []
        self.nest = nest
        self.patches = [(ik, "_launch", self._wrap(ik._launch,
                                                   lambda a: a[0]))]
        for obj, name, label in targets:
            self.patches.append((obj, name, self._wrap(
                getattr(obj, name), lambda a, n=label: n)))

    def _wrap(self, fn, label):
        def timed_call(*args, **kw):
            name = label(args)
            if self.nest and self.stack:
                name = f"{name} in {self.stack[0]}"
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            self.stack.append(name)
            start.record()
            try:
                out = fn(*args, **kw)
            finally:
                stop.record()
                self.stack.pop()
            self.events.setdefault(name, []).append((start, stop))
            return out
        return timed_call

    def __enter__(self):
        self.saved = [(obj, name, getattr(obj, name))
                      for obj, name, _ in self.patches]
        for obj, name, fn in self.patches:
            setattr(obj, name, fn)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.saved:
            setattr(obj, name, fn)

    def ms(self):
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in self.events.items()}


def wavefront_lanes(scene, seed, spp):
    sensor = scene.sensors[0]
    return scene.integrator.wavefront_lanes(scene, sensor, sensor.sampler,
                                            seed, 0, spp)


def counted_render(integ, scene, spp=SPP):
    """One render with its host waits counted twice: on the card by
    torch's sync debug mode (a warning at each synchronizing call, its
    site the innermost frame of this checkout's code that is not the
    counting's own; a wait with no such frame, as the mode's own switch,
    is logged and not counted), and by the calls core/profiler.py
    ``HostTransfers`` sees -> (image, the card's count in the package's
    code, {site: count} of all the card's, HostTransfers)."""
    import traceback
    root = os.path.dirname(os.path.abspath(__file__))
    own = (os.path.abspath(__file__), os.path.abspath(prof.__file__))
    sites = {}

    def on_warning(message, category, filename, lineno, file=None,
                   line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        while len(stack) > 1 and stack[-1].filename == warnings.__file__:
            stack.pop()
        ours = [f for f in stack if f.filename.startswith(root)
                and f.filename not in own]
        site = (f"{os.path.relpath(ours[-1].filename, root)}:"
                f"{ours[-1].lineno}" if ours else "not the package's") \
            + f" ({stack[-1].name} in {os.path.basename(stack[-1].filename)})"
        sites[site] = sites.get(site, 0) + 1

    with prof.HostTransfers() as host, warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            img = integ.render(scene, seed=SEED, spp=spp)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return img, sum(n for k, n in sites.items()
                    if not k.startswith("not the package's")), sites, host


def record_k2(ik, render, per_launch=WF_K2_SAMPLE, busiest=False):
    """Runs render() with K2's launches recorded: ``per_launch`` rays
    (every k-th) of each launch, and all the rays of each entry's second
    launch (a bounce's), or with ``busiest`` of its launch with the most
    active rays -> ({entry: [(o, d, mint, maxt) of each launch]},
    {entry: (o, d, mint, maxt)})."""
    samples = {"isect_closest": [], "isect_any": []}
    full, most = {}, {}
    launch = ik._launch

    def recording(entry, tables, o, d, mint, maxt, **out):
        rays = (o, d, mint, maxt)
        samples.setdefault(entry, [])
        if busiest:
            active = int((maxt > mint).sum())
            keep = active > most.get(entry, -1)
            most[entry] = max(active, most.get(entry, -1))
        else:
            keep = len(samples[entry]) == 1
        if keep:
            full[entry] = tuple(x.clone() for x in rays)
        samples[entry].append(tuple(
            x.clone() for x in every_kth(rays, per_launch)))
        return launch(entry, tables, o, d, mint, maxt, **out)

    ik._launch = recording
    try:
        render()
    finally:
        ik._launch = launch
    torch.cuda.synchronize()
    return samples, full


def hold_card_against_cpu(label, runs, ties=False):
    """The card's image against the CPU's at the parity bar on every pixel
    no divergent lane reaches (the CPU tests' rule,
    tests/test_torch_wavefront.py), at most WF_MAX_DIVERGENT_LANES
    divergent lanes, each logged with the call where its card and CPU
    traces part. With ``ties``, a lane whose traces first part at a tie of
    two coplanar faces hit at one point (tools/wavefront_spread.py
    ``tie_parting``: a glass box standing on the floor) is logged as such
    and set apart from that count, up to MAX_TIE_SHARE of the lanes.
    ``runs`` maps the device to (scene, image, lanes)."""
    from mitsuba2_tpu_torch.tools import wavefront_spread as ws
    (sc_g, card, lanes_card), (sc_r, cpu, lanes_cpu) = runs["cuda"], \
        runs["cpu"]
    g = card.double().cpu().numpy()
    r = cpu.double().cpu().numpy()
    lc = lanes_card[1].double().cpu().numpy()
    lr = lanes_cpu[1].double().cpu().numpy()
    err_l = (np.abs(lc - lr) / np.maximum(np.abs(lr), 1e-3)).max(-1)
    div = np.flatnonzero(err_l > WF_DIVERGED)
    keep = np.ones(r.shape[:2], bool)
    for x, y in np.floor(lanes_cpu[0][div].cpu().numpy()).astype(int):
        keep[y, x] = False
    err = ws.pixel_errors(g, r)
    share = float((err[keep] <= PIX_RTOL).mean())
    mean_rel = abs(g[keep].mean() - r[keep].mean()) / abs(r[keep].mean())
    log(f"{label}: {len(div)} of {len(err_l)} lanes diverged (> "
        f"{WF_DIVERGED:g}); on the {int(keep.sum())} pixels they do not "
        f"reach: share within {PIX_RTOL:g} {share:.6f}, mean rel diff "
        f"{mean_rel:.3e}; all pixels: share "
        f"{float((err <= PIX_RTOL).mean()):.6f}, max {err.max():.3e}")
    tied = []
    if len(div):
        spp = lanes_card[1].shape[0] // (r.shape[0] * r.shape[1])
        traces = [ws.lane_trace(sc, SEED, spp, div) for sc in (sc_g, sc_r)]
        for k in div:
            tie = ws.tie_parting(sc_r, traces[0][k], traces[1][k]) \
                if ties else None
            if tie is not None:
                tied.append(k)
            log(f"  lane {k} (departs by {err_l[k]:.3e}), card against "
                f"CPU, first parting at "
                f"{ws.first_parting(traces[0][k], traces[1][k])}"
                + (f"; a tie of coplanar faces, first other prim at {tie}"
                   if tie is not None else ""))
    if ties:
        log(f"  {len(tied)} of the diverged lanes part at a tie of coplanar "
            f"faces (at most {ws.MAX_TIE_SHARE:g} of {len(err_l)} lanes), "
            f"{len(div) - len(tied)} otherwise (at most "
            f"{WF_MAX_DIVERGENT_LANES})")
    if len(div) - len(tied) > WF_MAX_DIVERGENT_LANES \
            or len(tied) > ws.MAX_TIE_SHARE * len(err_l) \
            or share < PIX_SHARE or mean_rel > MEAN_RTOL:
        raise SystemExit(f"{label}: the card and the CPU disagree")
    return float(np.abs(g - r).max())


def run_wavefront(mi, ik, isx, pk, scenes):
    """The general wavefront on the card: the slice's path at the main
    shape (timed, its layers' spans, K2's launches and share, host syncs,
    peak memory, image band), K2 against its plain twin on that render's
    rays, the card against the CPU, the Cornell box forced onto the
    wavefront against the path kernel, the materials box, spectral and
    mono -> K2's two entries of the kernels line for the wavefront's
    launches."""
    from mitsuba2_tpu_torch.render.scene import Scene
    from mitsuba2_tpu_torch.tools import wavefront_spread as ws
    t_phase = time.perf_counter()
    mi.set_variant("scalar_rgb")
    n = WIDTH * WIDTH * SPP

    # ---- the slice's path at the main shape ----
    scene = mi.load_dict(ws.matpreview_beckmann(scenes, WIDTH, SPP,
                                                MAX_DEPTH))
    integ = scene.integrator
    ik.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    img = integ.render(scene, seed=SEED, spp=SPP)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {"isect_closest": ik.isect_closest.launches,
                "isect_any": ik.isect_any.launches}
    # the host's waits in a render after the first (which builds the
    # wavefront's tables and copies them to the card)
    _, syncs, sync_sites, host = counted_render(integ, scene)
    if integ.last_engine != "wavefront" \
            or integ.engine_reason != "unsupported BSDF RoughConductor":
        raise SystemExit(f"matpreview_beckmann: engine {integ.last_engine} "
                         f"({integ.engine_reason})")
    if min(launches.values()) < 1:
        raise SystemExit(f"the wavefront missed K2: {launches}")
    mean = float(img.mean())
    if not (bool(torch.isfinite(img).all()) and 0.2 < mean < 5.0):
        raise SystemExit(f"matpreview_beckmann: implausible image, mean "
                         f"{mean}")
    passes = n // integ.MAX_WAVEFRONT
    _, times = prof.cuda_times(
        lambda: integ.render(scene, seed=SEED, spp=SPP), runs=3)
    ms = statistics.median(times)
    with _Spans(ik, [(Scene, n, n) for n in (
            "sample_emitter_direction", "bsdf_partition", "bsdf_eval_pdf",
            "bsdf_sample")]) as spans:
        _, (total,) = prof.cuda_times(
            lambda: integ.render(scene, seed=SEED, spp=SPP), runs=1,
            warm_up=False)
    parts = spans.ms()
    k2 = parts.get("isect_closest", 0.0) + parts.get("isect_any", 0.0)
    log(f"wavefront matpreview_beckmann {WIDTH}^2 x {SPP} spp, depth "
        f"{MAX_DEPTH}: engine {integ.last_engine} (gate: "
        f"{integ.engine_reason}); {passes} passes of "
        f"{integ.MAX_WAVEFRONT} lanes; render {ms:.1f} ms (median of 3 "
        f"after a warm-up: {', '.join(f'{t:.1f}' for t in times)}), "
        f"{n / ms / 1e3:.3f} Mpaths/s; image mean {mean:.6f}")
    log(f"  K2 launches in one render: {launches}; peak memory "
        f"{peak / 2**20:.1f} MiB")
    log(f"  host syncs in a second render: {syncs} in the package's code "
        f"on the card (torch's sync debug mode; {syncs / passes:.1f} a "
        f"pass), {host.total} counted by core/profiler.py HostTransfers; "
        f"the card's by site: "
        + ", ".join(f"{k} {v}" for k, v in sorted(sync_sites.items())))
    for line in host.lines():
        log(f"    {line}")
    rest = total - parts.get("isect_closest", 0.0) \
        - parts.get("sample_emitter_direction", 0.0) \
        - sum(parts.get(k, 0.0) for k in ("bsdf_partition",
                                          "bsdf_eval_pdf", "bsdf_sample"))
    log(f"  spans of one instrumented render ({total:.1f} ms, CUDA events "
        f"around each call): K2 closest {parts.get('isect_closest', 0):.1f} "
        f"ms, K2 any {parts.get('isect_any', 0):.1f} ms (inside emitter "
        f"sampling), emitter sampling "
        f"{parts.get('sample_emitter_direction', 0):.1f} ms, "
        f"BSDF partition {parts.get('bsdf_partition', 0):.1f} ms, BSDF "
        f"eval+pdf {parts.get('bsdf_eval_pdf', 0):.1f} ms, BSDF sample "
        f"{parts.get('bsdf_sample', 0):.1f} ms, the rest {rest:.1f} ms; K2 "
        f"share {100 * k2 / total:.2f}%")

    # ---- K2 on the wavefront's rays, against its plain twin ----
    samples, full = record_k2(
        ik, lambda: integ.render(scene, seed=SEED, spp=SPP))
    tables = scene.tables
    woop = pk.face_woop(tables)
    trees = pk.walk_trees(tables)
    entries = []
    for name, fn, ref, out_bytes in (
            ("isect_closest", ik.isect_closest, isx.closest_hit_reference,
             16),
            ("isect_any", ik.isect_any, isx.any_hit_reference, 1)):
        every = tuple(torch.cat(xs) for xs in zip(*samples[name]))
        sub = every_kth(every, ISECT_PARITY_RAYS)
        got = fn(tables, *sub)
        torch.cuda.synchronize()
        active = float((sub[3] > sub[2]).float().mean())
        log(f"  {name} on the wavefront's rays ({len(samples[name])} "
            f"launches of one render, {WF_K2_SAMPLE} rays of each; "
            f"{len(sub[0])} of those, {active:.4f} of them active):")
        err = isect_parity(name, got, ref(woop, *sub))
        entries.append(k2_entry(isx, f"{name}[wavefront]", fn, ref, tables,
                                woop, trees, full[name], out_bytes,
                                launches[name], err))
    log(f"  main path: {time.perf_counter() - t_phase:.1f} s")
    t_step = time.perf_counter()

    # ---- the card against the CPU ----
    w, spp = WF_CPU_WIDTH, WF_CPU_SPP
    runs = {}
    for dev in ("cuda", "cpu"):
        mi.set_device(dev)
        try:
            sc = mi.load_dict(ws.matpreview_beckmann(
                scenes, w, spp, MAX_DEPTH, sample_visible=False))
            runs[dev] = (sc, sc.integrator.render(sc, seed=SEED, spp=spp),
                         wavefront_lanes(sc, SEED, spp))
        finally:
            mi.set_device("cuda")
    hold_card_against_cpu(
        f"wavefront matpreview beckmann (sample_visible=False) {w}^2 x "
        f"{spp}, card against CPU", runs)
    w, spp = WF_SPREAD_WIDTH, WF_SPREAD_SPP
    card, _ = ws.render(mi, "cuda", w, spp, SEED)
    cpu, _ = ws.render(mi, "cpu", w, spp, SEED)
    moved, _ = ws.render(mi, "cpu", w, spp, SEED, move_up=True)
    s = ws.spread(card, cpu, moved)
    log(f"wavefront matpreview_beckmann {w}^2 x {spp}, card against CPU: "
        f"{ws.describe(s)}; mean rel diff "
        f"{abs(card.mean() - cpu.mean()) / cpu.mean():.3e}")
    if not s["ok"]:
        raise SystemExit("matpreview_beckmann: the card and the CPU "
                         "disagree")
    log(f"  card against CPU: {time.perf_counter() - t_step:.1f} s")
    t_step = time.perf_counter()

    # ---- Cornell forced onto the wavefront against the kernel ----
    sc = mi.load_dict(scenes.cornell_box_dict(WIDTH, WIDTH, SPP, MAX_DEPTH))
    kimg, kms = timed(lambda: sc.integrator.render(sc, seed=SEED, spp=SPP),
                      repeats=3)
    assert sc.integrator.last_engine == "kernel"
    sc.integrator._disable_kernel = True
    wimg, wms = timed(lambda: sc.integrator.render(sc, seed=SEED, spp=SPP),
                      repeats=3)
    assert sc.integrator.last_engine == "wavefront"
    rel = [abs(float(wimg[..., c].mean()) / float(kimg[..., c].mean()) - 1)
           for c in range(3)]
    rel_all = abs(float(wimg.mean()) / float(kimg.mean()) - 1)
    log(f"cornell {WIDTH}^2 x {SPP} spp: kernel {kms:.1f} ms, wavefront "
        f"{wms:.1f} ms ({wms / kms:.1f}x); means {float(kimg.mean()):.6f} "
        f"and {float(wimg.mean()):.6f} (rel {rel_all:.2e}), by channel "
        f"{', '.join(f'{r:.2e}' for r in rel)}")
    if max(rel + [rel_all]) > WF_CORNELL_RTOL:
        raise SystemExit("cornell: the wavefront's mean leaves the "
                         "kernel's")

    log(f"  forced Cornell: {time.perf_counter() - t_step:.1f} s")

    # ---- the materials box, spectral and mono ----
    def forced_against_kernel(label, variant, make, width, spp):
        mi.set_variant(variant)
        sc = mi.load_dict(make(width, width, spp, MAX_DEPTH))
        ki = sc.integrator.render(sc, seed=SEED, spp=spp)
        sc.integrator._disable_kernel = True
        t0 = time.perf_counter()
        wi = sc.integrator.render(sc, seed=SEED, spp=spp)
        torch.cuda.synchronize()
        rel = abs(float(wi.mean()) / float(ki.mean()) - 1)
        log(f"{label} {width}^2 x {spp} spp forced onto the wavefront: "
            f"{time.perf_counter() - t0:.3f} s, mean {float(wi.mean()):.6f}"
            f" against the kernel's {float(ki.mean()):.6f} (rel {rel:.2e})")
        if not bool(torch.isfinite(wi).all()) or rel > WF_SMALL_RTOL:
            raise SystemExit(f"{label}: the wavefront's mean leaves the "
                             f"kernel's")

    forced_against_kernel("cornell_materials (gaussian film)", "scalar_rgb",
                          scenes.cornell_materials_dict, 128, 16)
    forced_against_kernel("cornell mono", "scalar_mono",
                          scenes.cornell_box_dict, 64, 16)
    mi.set_variant("scalar_spectral")
    sc = mi.load_dict(ws.matpreview_beckmann(scenes, 128, 16, MAX_DEPTH))
    simg = sc.integrator.render(sc, seed=SEED, spp=16)
    smean = float(simg.mean())
    log(f"matpreview_beckmann spectral 128^2 x 16 spp: engine "
        f"{sc.integrator.last_engine}, mean {smean:.6f}")
    if sc.integrator.last_engine != "wavefront" or not (0.2 < smean < 5.0) \
            or not bool(torch.isfinite(simg).all()):
        raise SystemExit("matpreview_beckmann spectral: implausible")
    mi.set_variant("scalar_rgb")
    log(f"wavefront phase: {time.perf_counter() - t_phase:.1f} s")
    return entries


# the volpath wavefront phase: the slice's path, volpath_gaussian (the
# bench slab with the default gaussian film, which K3's gate refuses) at
# the volpath shape, 4 passes of 2^18 lanes; K2 held bit for bit against
# its plain twin on rays sampled from every closest-hit launch of a render
# (this many of each); the card against the CPU at 32^2 x 4 on the lanes
# (the film's index_put_ accumulates in no fixed order); the bench slab's
# K3 against the same scene forced onto the wavefront within the
# reference's own kernel-against-wavefront tolerance
# (tests/test_volmegakernel.py:163-180); vacuum volpath on Cornell at
# 64^2 x 16 against the path kernel within WF_SMALL_RTOL
VW_K2_SAMPLE = 64
VW_CPU_WIDTH, VW_CPU_SPP = 32, 4
VW_FORCED_RTOL = 0.12
# a render slower than this is timed once after the warm-up
VW_ONE_RUN_S = 20.0


def slab_gaussian(scenes, width, spp, **kw):
    """The bench slab under the film's default filter, the gaussian."""
    d = scenes.volpath_slab_dict(width, width, spp, VOL_MAX_DEPTH, **kw)
    del d["sensor"]["film"]["rfilter"]
    return d


def homogeneous_slab(scenes, width, spp):
    """The bench slab filled with a chromatic homogeneous medium."""
    d = scenes.volpath_slab_dict(width, width, spp, VOL_MAX_DEPTH)
    d["slab"]["interior"] = {
        "type": "homogeneous",
        "sigma_t": {"type": "rgb", "value": [0.5, 0.9, 1.4]},
        "albedo": {"type": "rgb", "value": [0.9, 0.7, 0.5]},
        "phase": {"type": "hg", "g": -0.4}}
    return d


class _PassTrips:
    """Collects the integrator's ``last_trips`` after each pass."""

    def __init__(self, integ):
        self.integ, self.passes = integ, []

    def __enter__(self):
        sample = type(self.integ).sample

        def counted(*args, **kw):
            out = sample(self.integ, *args, **kw)
            self.passes.append(list(self.integ.last_trips))
            return out
        self.integ.sample = counted
        return self

    def __exit__(self, *exc):
        del self.integ.sample

    def designed_syncs(self):
        """The host's waits the design allows: each loop's test at every
        turn and at its end (none where it stopped at its cap), and the
        BSDF partition's read at every turn of the main loop."""
        integ = self.integ
        total = 0
        for trips in self.passes:
            caps = [integ.nee_loop_cap] * (len(trips) - 1) + [integ.max_iters]
            total += sum(t + (t < c) for t, c in zip(trips, caps))
            total += trips[-1]
        return total

    def describe(self):
        out = []
        for k, trips in enumerate(self.passes):
            walks = trips[:-1]
            out.append(f"pass {k}: main loop {trips[-1]} turns, "
                       f"{len(walks)} walks of {sum(walks)} turns (max "
                       f"{max(walks, default=0)}, mean "
                       f"{np.mean(walks) if walks else 0:.2f})")
        return "; ".join(out)


def hold_lanes_card_against_cpu(mi, label, variant, make, spp):
    """One pass's lanes of ``make()`` on the card against the CPU's: equal
    trip counts, then at most WF_MAX_DIVERGENT_LANES lanes beyond
    WF_DIVERGED (each logged with the call where its card and CPU traces
    part), the rest at the CPU tests' bar."""
    from mitsuba2_tpu_torch.tools import wavefront_spread as ws
    mi.set_variant(variant)
    runs = {}
    t0 = time.perf_counter()
    for dev in ("cuda", "cpu"):
        mi.set_device(dev)
        try:
            sc = mi.load_dict(make())
            _, rgb = wavefront_lanes(sc, SEED, spp)
            runs[dev] = (sc, rgb.double().cpu().numpy(),
                         list(sc.integrator.last_trips))
        finally:
            mi.set_device("cuda")
    (sc_g, g, trips_g), (sc_r, r, trips_r) = runs["cuda"], runs["cpu"]
    err = (np.abs(g - r) / np.maximum(np.abs(r), 1e-3)).max(-1)
    div = np.flatnonzero(err > WF_DIVERGED)
    keep = np.ones(len(err), bool)
    keep[div] = False
    share = float((err[keep] <= PIX_RTOL).mean())
    mean_rel = abs(g[keep].mean() - r[keep].mean()) / abs(r[keep].mean())
    log(f"{label}: trip counts equal {trips_g == trips_r} ({len(trips_g)} "
        f"loops, main {trips_g[-1]} turns on the card, {trips_r[-1]} on "
        f"the CPU); {len(div)} of {len(err)} lanes diverged (> "
        f"{WF_DIVERGED:g}); the others: share within {PIX_RTOL:g} "
        f"{share:.6f}, mean rel diff {mean_rel:.3e}, max {err[keep].max():.3e}"
        f" ({time.perf_counter() - t0:.1f} s)")
    if len(div):
        traces = [ws.lane_trace(sc, SEED, spp, div) for sc in (sc_g, sc_r)]
        for k in div:
            log(f"  lane {k} (departs by {err[k]:.3e}), card against CPU, "
                f"first parting at "
                f"{ws.first_parting(traces[0][k], traces[1][k])}")
    mi.set_variant("scalar_rgb")
    if trips_g != trips_r or len(div) > WF_MAX_DIVERGENT_LANES \
            or share < PIX_SHARE or mean_rel > MEAN_RTOL:
        raise SystemExit(f"{label}: the card and the CPU disagree")


def run_volpath_wavefront(mi, ik, isx, pk, scenes):
    """The volpath wavefront on the card: volpath_gaussian at the volpath
    shape (timed, trip counts, K2's launches and share, host syncs, peak
    memory, spans, image band), K2 against its plain twin on that render's
    rays, the card against the CPU, K3 against the wavefront forced, and
    vacuum volpath -> K2's kernels-line entry for the volpath wavefront's
    launches."""
    from mitsuba2_tpu_torch.models.integrators import \
        VolumetricPathIntegrator
    from mitsuba2_tpu_torch.render.film import ImageBlock
    from mitsuba2_tpu_torch.render.scene import Scene
    t_phase = time.perf_counter()
    mi.set_variant("scalar_rgb")
    spp = VOL_SPP
    n = WIDTH * WIDTH * spp

    # ---- the slice's path: volpath_gaussian ----
    scene = mi.load_dict(slab_gaussian(scenes, WIDTH, spp))
    integ = scene.integrator
    ik.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _PassTrips(integ) as trips:
        img = integ.render(scene, seed=SEED, spp=spp)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {"isect_closest": ik.isect_closest.launches,
                "isect_any": ik.isect_any.launches}
    if integ.last_engine != "wavefront" \
            or integ.engine_reason != "rfilter GaussianFilter":
        raise SystemExit(f"volpath_gaussian: engine {integ.last_engine} "
                         f"({integ.engine_reason})")
    if launches["isect_closest"] < 1:
        raise SystemExit(f"the volpath wavefront missed K2: {launches}")
    mean = float(img.mean())
    if not (bool(torch.isfinite(img).all()) and 0.5 < mean < 3.0):
        raise SystemExit(f"volpath_gaussian: implausible image, mean {mean}")
    passes = n // integ.MAX_WAVEFRONT
    log(f"volpath wavefront volpath_gaussian {WIDTH}^2 x {spp} spp, depth "
        f"{VOL_MAX_DEPTH}: engine {integ.last_engine} (gate: "
        f"{integ.engine_reason}); {passes} passes of {integ.MAX_WAVEFRONT} "
        f"lanes; first render {first_s:.2f} s; image mean {mean:.6f}")
    log(f"  trip counts: {trips.describe()}")
    log(f"  K2 launches in one render: {launches}; peak memory "
        f"{peak / 2**20:.1f} MiB ({peak / (n // passes):.0f} B a lane)")
    if first_s > VW_ONE_RUN_S:
        _, times = prof.cuda_times(
            lambda: integ.render(scene, seed=SEED, spp=spp), runs=1,
            warm_up=False)
        how = f"one run after the warm-up (the first took {first_s:.1f} s)"
    else:
        _, times = prof.cuda_times(
            lambda: integ.render(scene, seed=SEED, spp=spp), runs=3,
            warm_up=False)
        how = "median of 3 after a warm-up"
    ms = statistics.median(times)
    log(f"  render {ms:.1f} ms ({how}: "
        f"{', '.join(f'{t:.1f}' for t in times)}), {n / ms / 1e3:.4f} "
        f"Mpaths/s")
    with _PassTrips(integ) as trips:
        _, syncs, sync_sites, host = counted_render(integ, scene, spp)
    designed = trips.designed_syncs()
    log(f"  host syncs in a second render: {syncs} in the package's code "
        f"on the card (torch's sync debug mode), {host.total} counted by "
        f"core/profiler.py HostTransfers; the design's count {designed} "
        f"(each loop test, each partition read); the card's by site: "
        + ", ".join(f"{k} {v}" for k, v in sorted(sync_sites.items())))
    for line in host.lines():
        log(f"    {line}")
    # checked at the phase's end, after the measurements below
    syncs_ok = syncs == designed and host.total == designed
    targets = [(Scene, "medium_sample_interaction", "medium sampling"),
               (VolumetricPathIntegrator, "_sample_emitter_attenuated",
                "NEE walks"),
               (Scene, "medium_phase_eval", "phase"),
               (Scene, "medium_phase_sample", "phase"),
               (ImageBlock, "put", "film put")] + [
        (Scene, name, "BSDF") for name in (
            "bsdf_partition", "bsdf_eval", "bsdf_pdf", "bsdf_sample")]
    with _Spans(ik, targets, nest=True) as spans:
        _, (total,) = prof.cuda_times(
            lambda: integ.render(scene, seed=SEED, spp=spp), runs=1,
            warm_up=False)
    parts = spans.ms()
    top = {k: v for k, v in parts.items() if " in " not in k}
    k2 = sum(v for k, v in parts.items() if k.startswith("isect_"))
    log(f"  spans of one instrumented render ({total:.1f} ms, CUDA events "
        f"around each call; a call inside another is named 'in' it): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(parts.items()))
        + f"; the rest {total - sum(top.values()):.1f} ms; K2 share "
        f"{100 * k2 / total:.2f}%")

    # ---- K2 on the volpath wavefront's rays, against its plain twin ----
    samples, full = record_k2(
        ik, lambda: integ.render(scene, seed=SEED, spp=spp),
        per_launch=VW_K2_SAMPLE, busiest=True)
    tables = scene.tables
    woop = pk.face_woop(tables)
    trees = pk.walk_trees(tables)
    every = tuple(torch.cat(xs) for xs in zip(*samples["isect_closest"]))
    sub = every_kth(every, ISECT_PARITY_RAYS)
    got = ik.isect_closest(tables, *sub)
    torch.cuda.synchronize()
    active = float((sub[3] > sub[2]).float().mean())
    log(f"  isect_closest on the volpath wavefront's rays "
        f"({len(samples['isect_closest'])} launches of one render, "
        f"{VW_K2_SAMPLE} rays of each; {len(sub[0])} of those, "
        f"{active:.4f} of them active; timed on the busiest launch, "
        f"{int((full['isect_closest'][3] > full['isect_closest'][2]).sum())}"
        f" of {len(full['isect_closest'][0])} rays active):")
    err = isect_parity("isect_closest", got,
                       isx.closest_hit_reference(woop, *sub))
    entry = k2_entry(isx, "isect_closest[volpath_wavefront]",
                     ik.isect_closest, isx.closest_hit_reference, tables,
                     woop, trees, full["isect_closest"], 16,
                     launches["isect_closest"], err)
    log(f"  main path: {time.perf_counter() - t_phase:.1f} s")
    t_step = time.perf_counter()

    # ---- the card against the CPU, on the lanes ----
    w, s = VW_CPU_WIDTH, VW_CPU_SPP
    hold_lanes_card_against_cpu(
        mi, f"volpath_gaussian {w}^2 x {s}", "scalar_rgb",
        lambda: slab_gaussian(scenes, w, s), s)

    def spectral_mis():
        d = scenes.volpath_slab_dict(w, w, s, VOL_MAX_DEPTH)
        d["integrator"]["type"] = "volpathmis"
        return d

    hold_lanes_card_against_cpu(mi, f"volpathmis spectral {w}^2 x {s}",
                                "scalar_spectral", spectral_mis, s)
    hold_lanes_card_against_cpu(mi, f"homogeneous slab mono {w}^2 x {s}",
                                "scalar_mono",
                                lambda: homogeneous_slab(scenes, w, s), s)
    log(f"  card against CPU: {time.perf_counter() - t_step:.1f} s")
    t_step = time.perf_counter()

    # ---- K3 against the wavefront forced ----
    mi.set_variant("scalar_rgb")
    sc = mi.load_dict(scenes.volpath_slab_dict(WIDTH, WIDTH, spp,
                                               VOL_MAX_DEPTH))
    kimg, kms = timed(lambda: sc.integrator.render(sc, seed=SEED, spp=spp),
                      repeats=3)
    if sc.integrator.last_engine != "kernel":
        raise SystemExit("volpath slab: K3 did not render it")
    sc.integrator._disable_kernel = True
    wimg, wms = timed(lambda: sc.integrator.render(sc, seed=SEED, spp=spp),
                      repeats=1)
    if sc.integrator.last_engine != "wavefront":
        raise SystemExit("volpath slab: the forced render missed the "
                         "wavefront")
    rel = abs(float(wimg.mean()) / float(kimg.mean()) - 1)
    log(f"volpath slab (box film) {WIDTH}^2 x {spp} spp: K3 {kms:.2f} ms, "
        f"the wavefront forced {wms:.1f} ms (one run after a warm-up; "
        f"{wms / kms:.0f}x); means {float(kimg.mean()):.6f} and "
        f"{float(wimg.mean()):.6f} (rel {rel:.2e}, allowed "
        f"{VW_FORCED_RTOL:g})")
    if rel > VW_FORCED_RTOL or not bool(torch.isfinite(wimg).all()):
        raise SystemExit("volpath slab: the wavefront's mean leaves K3's")

    # ---- vacuum volpath against the path kernel ----
    d = scenes.cornell_box_dict(64, 64, 16, MAX_DEPTH)
    sc = mi.load_dict(d)
    pimg = sc.integrator.render(sc, seed=SEED, spp=16)
    d["integrator"] = {"type": "volpath", "max_depth": MAX_DEPTH}
    sc = mi.load_dict(d)
    before = ik.isect_any.launches
    vimg = sc.integrator.render(sc, seed=SEED, spp=16)
    torch.cuda.synchronize()
    any_launches = ik.isect_any.launches - before
    rel = abs(float(vimg.mean()) / float(pimg.mean()) - 1)
    log(f"vacuum volpath cornell 64^2 x 16: engine "
        f"{sc.integrator.last_engine} ({sc.integrator.engine_reason}), K2 "
        f"any launches {any_launches}; mean {float(vimg.mean()):.6f} "
        f"against the path kernel's {float(pimg.mean()):.6f} (rel "
        f"{rel:.2e}, allowed {WF_SMALL_RTOL:g})")
    if sc.integrator.last_engine != "wavefront" or any_launches < 1 \
            or rel > WF_SMALL_RTOL:
        raise SystemExit("vacuum volpath: wrong engine, no K2 any hit, or "
                         "its mean leaves the path kernel's")
    log(f"volpath wavefront phase: {time.perf_counter() - t_phase:.1f} s")
    if not syncs_ok:
        raise SystemExit("volpath_gaussian: host waits beside the design's")
    return [entry]


# the surface plugins' phase: cornell_surfaces and cornell_lights at the
# main shape, each scene's first camera hits, the engine's reason, and
# fog_spot (delta emitters and a masked card in fog) held card against CPU
SURFACE_SCENES = (
    ("cornell_surfaces", "cornell_surfaces_dict", "unsupported BSDF BumpMap",
     (0.05, 1.0)),
    ("cornell_lights", "cornell_lights_dict",
     "unsupported BSDF SmoothDiffuse", (0.05, 2.0)))
# the eight BSDFs of cornell_surfaces, each the first hit of at least
# MIN_FIRST_HIT_SHARE of its camera rays
SURFACE_KINDS = ("TwoSided", "BumpMap", "NormalMap", "RoughDielectric",
                 "BlendBSDF", "ThinDielectric", "MaskBSDF", "SmoothConductor")


class _PassPartitions:
    """Counts the BSDF partitions of each pass of the path wavefront (or,
    without ``loop``, of an integrator whose pass has no bounce loop),
    from which the host's designed waits follow. A pass is a call of the
    integrator's ``sample_aovs``, the drive's entry (``wavefront_lanes``),
    which reaches ``sample`` where the integrator has no AOVs of its
    own."""

    def __init__(self, integ, loop=True):
        self.integ, self.passes, self.loop = integ, [], loop

    def __enter__(self):
        from mitsuba2_tpu_torch.render.scene import Scene
        sample = type(self.integ).sample_aovs
        partition = Scene.bsdf_partition
        counts = self.passes

        def counted_partition(scene, *args, **kw):
            counts[-1] += 1
            return partition(scene, *args, **kw)

        def counted(*args, **kw):
            counts.append(0)
            return sample(self.integ, *args, **kw)
        self.saved = partition
        Scene.bsdf_partition = counted_partition
        self.integ.sample_aovs = counted
        return self

    def __exit__(self, *exc):
        from mitsuba2_tpu_torch.render.scene import Scene
        Scene.bsdf_partition = self.saved
        del self.integ.sample_aovs

    def designed_syncs(self):
        """Each bounce's loop test and partition read, and the loop test
        that ends a pass whose lanes all died before max_depth; without a
        loop, the partition reads alone."""
        if not self.loop:
            return sum(self.passes)
        last = self.integ.max_depth - 1
        return sum(2 * p + (p < last) for p in self.passes)


def check_surface_first_hits(mi, scene):
    """The BSDF of each camera ray's first hit through the pixel centers
    -> {BSDF class: share}; fails unless each of SURFACE_KINDS has at
    least MIN_FIRST_HIT_SHARE."""
    sensor = scene.sensors[0]
    w, h = sensor.film.crop_size
    dev = scene.device
    ys, xs = torch.meshgrid((torch.arange(h, device=dev) + 0.5) / h,
                            (torch.arange(w, device=dev) + 0.5) / w,
                            indexing="ij")
    ray, _, _ = sensor.sample_ray(0.0, torch.zeros(w * h, device=dev),
                                  torch.stack([xs.reshape(-1),
                                               ys.reshape(-1)], -1), None)
    si = scene.ray_intersect(ray)
    names = [type(b).__name__ for b in scene.wavefront_tables().bsdfs]
    counts = {}
    for i, c in zip(*np.unique(si.bsdf_idx.cpu().numpy(),
                               return_counts=True)):
        k = names[i] if i >= 0 else "none"
        counts[k] = counts.get(k, 0) + int(c)
    shares = {k: v / (w * h) for k, v in counts.items()}
    log("  first hits of the camera rays: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(shares.items())))
    low = [k for k in SURFACE_KINDS if shares.get(k, 0.0)
           < MIN_FIRST_HIT_SHARE]
    if low:
        raise SystemExit(f"cornell_surfaces: {low} are the first hit of "
                         f"less than {MIN_FIRST_HIT_SHARE} of camera rays")
    return shares


def wavefront_k2_entries(ik, isx, pk, label, scene, render, launches):
    """K2 on the rays of one wavefront render of ``scene`` (``render()``):
    each entry against its plain twin, bit for bit, on ISECT_PARITY_RAYS
    rays sampled from every launch, and timed on its busiest launch ->
    the two entries of the kernels line, named "<entry>[label]", with
    ``launches``, the entries' launches in the main run (a render of
    few launches gives each more rays, so that every entry has
    ISECT_PARITY_RAYS)."""
    per_launch = max(WF_K2_SAMPLE,
                     -(-ISECT_PARITY_RAYS // min(launches.values())))
    samples, full = record_k2(ik, render, per_launch=per_launch,
                              busiest=True)
    tables = scene.tables
    woop = pk.face_woop(tables)
    trees = pk.walk_trees(tables)
    entries = []
    for name, fn, ref, out_bytes in (
            ("isect_closest", ik.isect_closest, isx.closest_hit_reference,
             16),
            ("isect_any", ik.isect_any, isx.any_hit_reference, 1)):
        every = tuple(torch.cat(xs) for xs in zip(*samples[name]))
        sub = every_kth(every, ISECT_PARITY_RAYS)
        got = fn(tables, *sub)
        torch.cuda.synchronize()
        active = float((sub[3] > sub[2]).float().mean())
        busy = full[name]
        log(f"  {name} on {label}'s rays ({len(samples[name])} launches "
            f"of one render, {per_launch} rays of each; "
            f"{len(sub[0])} of those, {active:.4f} of them active; "
            f"timed on the busiest launch, "
            f"{int((busy[3] > busy[2]).sum())} of {len(busy[0])} rays "
            f"active):")
        err = isect_parity(name, got, ref(woop, *sub))
        entries.append(k2_entry(
            isx, f"{name}[{label}]", fn, ref, tables, woop, trees,
            full[name], out_bytes, launches[name], err))
    return entries


def run_surface_wavefronts(mi, ik, isx, pk, scenes):
    """The surface plugins on the wavefronts: cornell_surfaces (the eight
    BSDFs) and cornell_lights (the five emitters, the curve spectra) at
    the main shape through the path wavefront (timed, spans by layer with
    the BSDF wrappers and the delta and constant emitters split out, host
    syncs against the design's count, peak memory, K2 bit for bit on
    rays sampled from every launch of a render and timed on its busiest
    launch), both scenes card against
    CPU at 32^2 x 4 in rgb and spectral, and fog_spot under volpath and
    volpathmis card against CPU on one pass's lanes, and the Cornell box
    and the volpath slab with their lights written as uniform spectra on
    the kernels -> K2's four entries of the kernels line for the two
    scenes' launches."""
    from mitsuba2_tpu_torch.models import bsdfs as bm, emitters as em
    from mitsuba2_tpu_torch.render.scene import Scene
    t_phase = time.perf_counter()
    n = WIDTH * WIDTH * SPP
    entries = []
    wrappers = [(cls, name, "BSDF wrappers")
                for cls in (bm.TwoSided, bm.MaskBSDF, bm.BlendBSDF,
                            bm.NormalMap, bm.BumpMap)
                for name in ("sample", "eval", "pdf")]
    lights = [(cls, name, "delta and constant emitters")
              for cls in (em.PointEmitter, em.SpotEmitter,
                          em.DirectionalEmitter, em.ConstantEmitter,
                          em.ProjectorEmitter)
              for name in ("sample_direction", "eval", "pdf_direction")]
    layers = [(Scene, "sample_emitter_direction", "emitter sampling"),
              (Scene, "bsdf_partition", "BSDF partition"),
              (Scene, "bsdf_eval_pdf", "BSDF eval+pdf"),
              (Scene, "bsdf_sample", "BSDF sample")]
    for label, make, reason, band in SURFACE_SCENES:
        t_scene = time.perf_counter()
        mi.set_variant("scalar_rgb")
        scene = mi.load_dict(getattr(scenes, make)(WIDTH, WIDTH, SPP,
                                                   MAX_DEPTH))
        integ = scene.integrator
        ik.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img = integ.render(scene, seed=SEED, spp=SPP)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {"isect_closest": ik.isect_closest.launches,
                    "isect_any": ik.isect_any.launches}
        if integ.last_engine != "wavefront" or integ.engine_reason != reason:
            raise SystemExit(f"{label}: engine {integ.last_engine} "
                             f"({integ.engine_reason})")
        if min(launches.values()) < 1:
            raise SystemExit(f"{label}: the wavefront missed K2: {launches}")
        mean = float(img.mean())
        if not (bool(torch.isfinite(img).all()) and band[0] < mean < band[1]):
            raise SystemExit(f"{label}: implausible image, mean {mean}")
        passes = n // integ.MAX_WAVEFRONT
        log(f"surface wavefront {label} {WIDTH}^2 x {SPP} spp, depth "
            f"{MAX_DEPTH}: engine {integ.last_engine} (gate: "
            f"{integ.engine_reason}); {passes} passes of "
            f"{integ.MAX_WAVEFRONT} lanes; first render {first_s:.2f} s; "
            f"image mean {mean:.6f}")
        if label == "cornell_surfaces":
            check_surface_first_hits(mi, scene)
        runs = 1 if first_s > VW_ONE_RUN_S else 3
        _, times = prof.cuda_times(
            lambda: integ.render(scene, seed=SEED, spp=SPP), runs=runs,
            warm_up=False)
        ms = statistics.median(times)
        how = ("median of 3 after a warm-up" if runs == 3 else
               f"one run after the warm-up (the first took {first_s:.1f} s)")
        log(f"  render {ms:.1f} ms ({how}: "
            f"{', '.join(f'{t:.1f}' for t in times)}), "
            f"{n / ms / 1e3:.4f} Mpaths/s; K2 launches in one render: "
            f"{launches}; peak memory {peak / 2**20:.1f} MiB "
            f"({peak / (n // passes):.0f} B a lane)")
        with _PassPartitions(integ) as parts_count:
            _, syncs, sync_sites, host = counted_render(integ, scene)
        designed = parts_count.designed_syncs()
        log(f"  host syncs in a second render: {syncs} in the package's "
            f"code on the card (torch's sync debug mode), {host.total} "
            f"counted by core/profiler.py HostTransfers; the design's count "
            f"{designed} ({parts_count.passes} partitions a pass: each "
            f"bounce's loop test and partition read); the card's by site: "
            + ", ".join(f"{k} {v}" for k, v in sorted(sync_sites.items())))
        for line in host.lines():
            log(f"    {line}")
        if syncs != designed or host.total != designed:
            raise SystemExit(f"{label}: host waits beside the design's")
        with _Spans(ik, layers + wrappers + lights, nest=True) as spans:
            _, (total,) = prof.cuda_times(
                lambda: integ.render(scene, seed=SEED, spp=SPP), runs=1,
                warm_up=False)
        parts = spans.ms()
        top = {k: v for k, v in parts.items() if " in " not in k}
        k2 = sum(v for k, v in parts.items() if k.startswith("isect_"))
        log(f"  spans of one instrumented render ({total:.1f} ms, CUDA "
            f"events around each call; a call inside another is named "
            f"'in' it): " + ", ".join(
                f"{k} {v:.1f} ms" for k, v in sorted(parts.items()))
            + f"; the rest {total - sum(top.values()):.1f} ms; K2 share "
            f"{100 * k2 / total:.2f}%")

        entries += wavefront_k2_entries(
            ik, isx, pk, label, scene,
            lambda: integ.render(scene, seed=SEED, spp=SPP), launches)
        log(f"  {label} at the main shape: "
            f"{time.perf_counter() - t_scene:.1f} s")

    # ---- the card against the CPU ----
    t_step = time.perf_counter()
    w, spp = WF_CPU_WIDTH, WF_CPU_SPP
    for label, make, _, _ in SURFACE_SCENES:
        for variant in ("scalar_rgb", "scalar_spectral"):
            mi.set_variant(variant)
            runs = {}
            for dev in ("cuda", "cpu"):
                mi.set_device(dev)
                try:
                    sc = mi.load_dict(getattr(scenes, make)(w, w, spp,
                                                            MAX_DEPTH))
                    runs[dev] = (sc, sc.integrator.render(sc, seed=SEED,
                                                          spp=spp),
                                 wavefront_lanes(sc, SEED, spp))
                finally:
                    mi.set_device("cuda")
            hold_card_against_cpu(f"{label} {variant} {w}^2 x {spp}, card "
                                  f"against CPU", runs,
                                  ties=label == "cornell_surfaces")
    for integrator in ("volpath", "volpathmis"):
        hold_lanes_card_against_cpu(
            mi, f"fog_spot {integrator} {w}^2 x {spp}", "scalar_rgb",
            lambda: scenes.fog_spot_dict(w, w, spp, MAX_DEPTH,
                                         integrator=integrator), spp)
    mi.set_variant("scalar_rgb")
    log(f"  card against CPU: {time.perf_counter() - t_step:.1f} s")

    # ---- an area light written as a uniform spectrum stays on the
    # kernels, and renders as the same light written as a color ----
    for label, make, spp, depth, value in (
            ("cornell", scenes.cornell_box_dict, SPP, MAX_DEPTH, 15.0),
            ("volpath slab", scenes.volpath_slab_dict, VOL_SPP,
             VOL_MAX_DEPTH, 4.0)):
        imgs = []
        for radiance in ({"type": "rgb", "value": [value] * 3},
                         {"type": "spectrum", "value": value}):
            d = make(WIDTH, WIDTH, spp, depth)
            d["light"]["emitter"]["radiance"] = radiance
            sc = mi.load_dict(d)
            imgs.append(sc.integrator.render(sc, seed=SEED, spp=spp))
            if sc.integrator.last_engine != "kernel":
                raise SystemExit(f"{label} with a {radiance['type']} light: "
                                 f"engine {sc.integrator.last_engine} "
                                 f"({sc.integrator.engine_reason})")
        same = torch.equal(imgs[0], imgs[1])
        log(f"{label} {WIDTH}^2 x {spp}, its light a uniform spectrum of "
            f"{value:g}: engine kernel, the image bit for bit the rgb "
            f"light's: {same} (mean {float(imgs[1].mean()):.6f})")
        if not same:
            raise SystemExit(f"{label}: the uniform spectrum light renders "
                             f"apart from its color")
    log(f"surface wavefront phase: {time.perf_counter() - t_phase:.1f} s")
    return entries


# the sensors', samplers' and integrators' phase (every scene the Cornell
# box at the main shape): (label, fixture, the kernels' gate's reason, the
# image mean's band, whether the pass loops over bounces)
SENSOR_SCENES = (
    ("cornell_thinlens", "cornell_thinlens_dict", "sensor ThinLensCamera",
     (0.05, 1.0), True),
    ("cornell_direct", "cornell_direct_dict", "non-path integrator subclass",
     (0.02, 1.0), False))
AOV_SPP = 16
# the meters' readings in constant environments of 0.8 and 1
# (tests/test_rfilter_sensor_battery.py:118-152)
METER_READINGS = (("radiancemeter", 0.8, 0.02),
                  ("irradiancemeter", math.pi, 0.15))


def time_wavefront(ik, label, scene, reason, band, loop,
                   entries=("isect_closest", "isect_any"), layers=()):
    """One wavefront render of ``scene`` at the main shape, K2's launch
    counts zeroed before it and read after, checked (engine, the gate's
    ``reason``, each of K2's ``entries`` reached, finite image within
    ``band``), then timed (median of 3 after it), its host syncs against
    the design's count and its spans by layer (``layers``, (object,
    attribute, label), beside the common ones) -> (K2's launches by
    entry, render ms, peak bytes, the first render's image)."""
    from mitsuba2_tpu_torch.render.scene import Scene
    integ = scene.integrator
    n = WIDTH * WIDTH * SPP
    ik.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img = integ.render(scene, seed=SEED, spp=SPP)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ik.ENTRIES
                if fn.__name__ in entries}
    peak = torch.cuda.max_memory_allocated()
    if integ.last_engine != "wavefront" or integ.engine_reason != reason:
        raise SystemExit(f"{label}: engine {integ.last_engine} "
                         f"({integ.engine_reason})")
    if min(launches.values()) < 1:
        raise SystemExit(f"{label}: the wavefront missed K2: {launches}")
    mean = float(img.mean())
    if not (bool(torch.isfinite(img).all()) and band[0] < mean < band[1]):
        raise SystemExit(f"{label}: implausible image, mean {mean}")
    passes = max(1, n // integ.MAX_WAVEFRONT)
    _, times = prof.cuda_times(
        lambda: integ.render(scene, seed=SEED, spp=SPP), runs=3,
        warm_up=False)
    ms = statistics.median(times)
    log(f"{label} {WIDTH}^2 x {SPP} spp, depth {MAX_DEPTH}: engine "
        f"{integ.last_engine} (gate: {integ.engine_reason}); {passes} passes "
        f"of {integ.MAX_WAVEFRONT} lanes; first render {first_s:.2f} s; "
        f"image mean {mean:.6f}; render {ms:.1f} ms (median of 3 after "
        f"it: {', '.join(f'{t:.1f}' for t in times)}), "
        f"{n / ms / 1e3:.4f} Mpaths/s; K2 launches in one render: "
        f"{launches}; peak memory {peak / 2**20:.1f} MiB "
        f"({peak / (n // passes):.0f} B a lane)")
    with _PassPartitions(integ, loop) as parts_count:
        _, syncs, sync_sites, host = counted_render(integ, scene)
    designed = parts_count.designed_syncs()
    log(f"  host syncs in a second render: {syncs} in the package's code "
        f"on the card, {host.total} counted by HostTransfers; the "
        f"design's count {designed} ({parts_count.passes} partitions a "
        f"pass); by site: " + ", ".join(
            f"{k} {v}" for k, v in sorted(sync_sites.items())))
    if syncs != designed or host.total != designed:
        raise SystemExit(f"{label}: host waits beside the design's")
    layers = [(Scene, "sample_emitter_direction", "emitter sampling"),
              (Scene, "bsdf_partition", "BSDF partition"),
              (Scene, "bsdf_eval_pdf", "BSDF eval+pdf"),
              (Scene, "bsdf_sample", "BSDF sample"),
              (scene.sensors[0], "sample_ray", "camera rays")] + list(layers)
    with _Spans(ik, layers, nest=True) as spans:
        _, (total,) = prof.cuda_times(
            lambda: integ.render(scene, seed=SEED, spp=SPP), runs=1,
            warm_up=False)
    parts = spans.ms()
    top = {k: v for k, v in parts.items() if " in " not in k}
    k2 = sum(v for k, v in parts.items() if k.startswith("isect_"))
    log(f"  spans of one instrumented render ({total:.1f} ms): " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in sorted(parts.items()))
        + f"; the rest {total - sum(top.values()):.1f} ms; K2 share "
        f"{100 * k2 / total:.2f}%")
    return launches, ms, peak, img


def check_aov_and_moment(mi, scenes):
    """cornell_aov (AOV_SPP) has 3 + 12 channels, its depth channel a
    depth render's bit for bit; cornell_moment's second moments are at
    least the squared means, pixel by pixel."""
    d = scenes.cornell_aov_dict(WIDTH, WIDTH, AOV_SPP, MAX_DEPTH)
    scene = mi.load_dict(d)
    integ = scene.integrator
    img = integ.render(scene, seed=SEED, spp=AOV_SPP)
    t0 = time.perf_counter()
    img = integ.render(scene, seed=SEED, spp=AOV_SPP)
    torch.cuda.synchronize()
    aov_s = time.perf_counter() - t0
    d["integrator"] = {"type": "depth"}
    sc = mi.load_dict(d)
    depth = sc.integrator.render(sc, seed=SEED, spp=AOV_SPP)
    same = torch.equal(img[..., 3], depth[..., 0])
    log(f"cornell_aov {WIDTH}^2 x {AOV_SPP}: engine {integ.last_engine}; "
        f"{img.shape[-1]} channels ({', '.join(integ.aov_names())} after "
        f"rgb); render {1e3 * aov_s:.1f} ms; depth channel bit for bit the "
        f"depth render's: {same}; color channels the nested path's: "
        f"{torch.equal(img[..., :3], img[..., 12:])}")
    if img.shape != (WIDTH, WIDTH, 15) or not same \
            or not bool(torch.isfinite(img).all()) \
            or integ.last_engine != "wavefront":
        raise SystemExit("cornell_aov: wrong channels")
    scene = mi.load_dict(scenes.cornell_moment_dict(WIDTH, WIDTH, SPP,
                                                    MAX_DEPTH))
    t0 = time.perf_counter()
    img = scene.integrator.render(scene, seed=SEED, spp=SPP).double()
    torch.cuda.synchronize()
    mean, m2 = img[..., :3], img[..., 3:]
    slack = float((m2 - mean * mean * (1 - 1e-5)).min())
    log(f"cornell_moment {WIDTH}^2 x {SPP} (orthogonal, p = "
        f"{scene.sensors[0].sampler.p}): {time.perf_counter() - t0:.2f} s; "
        f"min of m2 - mean^2 (1 - 1e-5) {slack:.3e}, mean m2 "
        f"{float(m2.mean()):.6f}, mean^2 {float((mean * mean).mean()):.6f}")
    if slack < -1e-7 or img.shape[-1] != 6:
        raise SystemExit("cornell_moment: a second moment below the square "
                         "of its mean")


def check_meters(mi):
    """The radiancemeter and the irradiancemeter in constant environments
    on the card: METER_READINGS."""
    T = mi.Transform
    film = {"type": "hdrfilm", "width": 1, "height": 1,
            "rfilter": {"type": "box"}}
    for kind, want, tol in METER_READINGS:
        env = {"type": "constant",
               "radiance": {"type": "rgb",
                            "value": 0.8 if kind == "radiancemeter"
                            else 1.0}}
        sampler = {"type": "independent", "sample_count": 256}
        d = {"type": "scene", "env": env,
             "integrator": {"type": "path", "max_depth": 2}}
        if kind == "radiancemeter":
            d["sensor"] = {"type": kind, "film": film, "sampler": sampler,
                           "to_world": T.look_at([0, 0, 1], [0, 0, 0],
                                                 [0, 1, 0])}
        else:
            d["sphere"] = {"type": "sphere", "radius": 0.2, "sensor": {
                "type": kind, "film": film, "sampler": sampler}}
        scene = mi.load_dict(d)
        got = float(scene.integrator.render(scene, seed=SEED, spp=256)
                    .mean())
        log(f"{kind} on the card: {got:.6f} (want {want:.4f} +- {tol}; "
            f"engine {scene.integrator.last_engine}, gate: "
            f"{scene.integrator.engine_reason})")
        if abs(got - want) > tol:
            raise SystemExit(f"{kind}: reads {got}")


def run_sensor_integrator_wavefronts(mi, ik, isx, pk, scenes):
    """The sensors, samplers and integrators without a kernel: cornell_thinlens
    (a thin lens, ldsampler, path) and cornell_direct (direct, stratified)
    at the main shape through the wavefront (``time_wavefront``; K2 bit
    for bit against its twin on rays of every launch, timed on the
    busiest), cornell_aov's channels against a depth render,
    cornell_moment's second moments, the mesh-attribute box, thinlens,
    direct and the mesh-attribute box card against CPU at 32^2 x 4, a
    stratified Cornell box on the path kernel bit for bit the independent
    one's, the Cornell box in scalar_rgb_double bit for bit the forced
    scalar_rgb wavefront's, and the meters' readings -> K2's four entries
    of the kernels line."""
    t_phase = time.perf_counter()
    mi.set_variant("scalar_rgb")
    entries = []
    for label, make, reason, band, loop in SENSOR_SCENES:
        t_scene = time.perf_counter()
        scene = mi.load_dict(getattr(scenes, make)(WIDTH, WIDTH, SPP,
                                                   MAX_DEPTH))
        launches = time_wavefront(ik, label, scene, reason, band, loop)[0]
        entries += wavefront_k2_entries(
            ik, isx, pk, label, scene,
            lambda: scene.integrator.render(scene, seed=SEED, spp=SPP),
            launches)
        log(f"  {label}: {time.perf_counter() - t_scene:.1f} s")
    check_aov_and_moment(mi, scenes)

    # ---- the mesh-attribute box ----
    scene = mi.load_dict(scenes.cornell_mesh_attribute_dict(
        WIDTH, WIDTH, SPP, MAX_DEPTH))
    t0 = time.perf_counter()
    img = scene.integrator.render(scene, seed=SEED, spp=SPP)
    torch.cuda.synchronize()
    log(f"cornell_mesh_attribute {WIDTH}^2 x {SPP}: engine "
        f"{scene.integrator.last_engine} (gate: "
        f"{scene.integrator.engine_reason}); first render "
        f"{time.perf_counter() - t0:.2f} s; image mean "
        f"{float(img.mean()):.6f}")
    if scene.integrator.last_engine != "wavefront" \
            or not bool(torch.isfinite(img).all()):
        raise SystemExit("cornell_mesh_attribute: not rendered")

    # ---- the card against the CPU ----
    t_step = time.perf_counter()
    w, spp = WF_CPU_WIDTH, WF_CPU_SPP
    for make in ("cornell_thinlens_dict", "cornell_direct_dict",
                 "cornell_mesh_attribute_dict"):
        runs = {}
        for dev in ("cuda", "cpu"):
            mi.set_device(dev)
            try:
                sc = mi.load_dict(getattr(scenes, make)(w, w, spp,
                                                        MAX_DEPTH))
                runs[dev] = (sc, sc.integrator.render(sc, seed=SEED,
                                                      spp=spp),
                             wavefront_lanes(sc, SEED, spp))
            finally:
                mi.set_device("cuda")
        hold_card_against_cpu(f"{make[:-5]} {w}^2 x {spp}, card against "
                              f"CPU", runs, ties=True)
    log(f"  card against CPU: {time.perf_counter() - t_step:.1f} s")

    # ---- a structured sampler stays on the path kernel; _double renders
    # on the wavefront as the float32 variant ----
    imgs = {}
    for sampler in ("independent", "stratified"):
        d = scenes.cornell_box_dict(WIDTH, WIDTH, SPP, MAX_DEPTH)
        d["sensor"]["sampler"]["type"] = sampler
        sc = mi.load_dict(d)
        pk.reset_launch_counts()
        imgs[sampler] = sc.integrator.render(sc, seed=SEED, spp=SPP)
        torch.cuda.synchronize()
        if sc.integrator.last_engine != "kernel" \
                or pk.path_radiance.launches < 1:
            raise SystemExit(f"cornell with {sampler}: engine "
                             f"{sc.integrator.last_engine} "
                             f"({sc.integrator.engine_reason})")
    same = torch.equal(imgs["independent"], imgs["stratified"])
    log(f"cornell {WIDTH}^2 x {SPP} with stratified: engine kernel "
        f"(path_kernel launches {pk.path_radiance.launches}), the image bit "
        f"for bit the independent sampler's: {same}")
    if not same:
        raise SystemExit("stratified Cornell: the kernel's image moved")
    for variant, force in (("scalar_rgb_double", False),
                           ("scalar_rgb", True)):
        mi.set_variant(variant)
        sc = mi.load_dict(scenes.cornell_box_dict(WIDTH, WIDTH, SPP,
                                                  MAX_DEPTH))
        sc.integrator._disable_kernel = force
        t0 = time.perf_counter()
        imgs[variant] = sc.integrator.render(sc, seed=SEED, spp=SPP)
        torch.cuda.synchronize()
        log(f"cornell {variant} {WIDTH}^2 x {SPP}: engine "
            f"{sc.integrator.last_engine} (gate: "
            f"{sc.integrator.engine_reason}), "
            f"{time.perf_counter() - t0:.2f} s, dtype "
            f"{imgs[variant].dtype}")
        if variant.endswith("double") and (
                sc.integrator.last_engine != "wavefront"
                or sc.integrator.engine_reason != "double-precision variant"):
            raise SystemExit("cornell double: not on the wavefront")
    mi.set_variant("scalar_rgb")
    same = torch.equal(imgs["scalar_rgb_double"], imgs["scalar_rgb"])
    log(f"  scalar_rgb_double bit for bit the forced scalar_rgb wavefront's: "
        f"{same}")
    if not same:
        raise SystemExit("cornell double: apart from the float32 render")
    check_meters(mi)
    log(f"sensor and integrator wavefront phase: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return entries


# ---- the scene-file and instancing phase -----------------------------------
# the groups of the instancing scenes: 8 instances of biggeo's 262,144-face
# sphere (shared by policy) and of a 4,096-face one (materialized)
INST_COUNT = 8
INST_BIG, INST_SMALL = (512, 257), (64, 33)
SHARED_REASON = "shared-geometry instances (wavefront path only)"
# the instance entries' bound: a ray's move into a group's frame, 18
# products and 15 sums
INST_TRANSFORM_FLOPS = 33
# the instance entries' parity sample: rays from four launches of a render
INST_PARITY_RAYS, INST_LAUNCHES = 8192, 4
# the rays of the busiest launch whose walks the bound counts on the host
INST_COUNT_RAYS = 2048
# the JAX test's bar of shared against materialized image means
SHARED_MEAN_RTOL = 0.02


def blender_quad_dict(shapes):
    """A two-triangle quad in Blender's memory layout (the buffers of
    tests/test_blender.py, smooth, with uvs and a color layer) -> (its
    ``blender`` shape dict, the buffers to keep alive while it loads)."""
    verts = np.zeros(4, shapes._M_VERT)
    verts["co"] = [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]]
    verts["no"] = [[0, 0, 32767]] * 4
    loops = np.zeros(6, shapes._ML_LOOP)
    loops["v"] = [0, 1, 2, 0, 2, 3]
    tris = np.zeros(2, shapes._ML_LOOPTRI)
    tris["tri"] = [[0, 1, 2], [3, 4, 5]]
    tris["poly"] = [0, 1]
    polys = np.zeros(2, shapes._M_POLY)
    polys["loopstart"] = [0, 3]
    polys["totloop"] = [3, 3]
    polys["flag"] = 1
    uvs = np.zeros(6, shapes._ML_LOOPUV)
    uvs["uv"] = [[0, 1], [1, 1], [1, 0], [0, 1], [1, 0], [0, 0]]
    cols = np.zeros(6, shapes._ML_LOOPCOL)
    for k in "rgb":
        cols[k] = [255, 0, 0, 255, 0, 128]
    keep = (verts, loops, tris, polys, uvs, cols)
    return {"type": "blender", "name": "quad", "mat_nr": 0, "vert_count": 4,
            "loop_count": 6, "loop_tri_count": 2,
            "loops": loops.ctypes.data, "loop_tris": tris.ctypes.data,
            "polys": polys.ctypes.data, "verts": verts.ctypes.data,
            "uvs": uvs.ctypes.data, "vertex_Col": cols.ctypes.data,
            "bsdf": {"type": "diffuse"}}, keep


def scene_path_route(pk, name, flags, **fields):
    """The path kernel's Route of a scene of this phase (rgb; the entry
    ``path_kernel[name]`` in the kernels line)."""
    def tables(scene):
        if (scene.tables.flags & pk.TEMPLATE_FLAGS, scene.tables.nc) \
                != (flags, 3):
            raise SystemExit(f"{name}: scene tables carry flags "
                             f"{scene.tables.flags}, nc {scene.tables.nc}")
        return scene.tables

    return Route(pk.kernel_name(flags, 3), (flags, 3), pk.path_radiance,
                 pk.path_radiance_reference, pk.reset_launch_counts, tables,
                 lambda *a: bound(pk, *a),
                 "mitsuba2_tpu_torch/csrc/path_kernel.cu",
                 "mitsuba2_tpu/ops/megakernel.py:365", block=pk.BLOCK,
                 entry_name=f"path_kernel[{name}]", **fields)


def inst_walk_bound(isx, inst, sample, any_hit):
    """-> (ms, 'operations' or 'bytes') of the instance entry on the rays
    ``sample`` (o, d, mint, maxt on the host), per ray scaled to ``n``
    rays by the caller: the binary walks' box and face tests over every
    instance, each walk's maxt the best t so far (for any hit, the rays
    not yet occluded), the moves into a group's frame the kernel makes
    (every instance for closest hit; for any hit, up to the first that
    occludes), and the distinct nodes and face rows each group's walks
    read -> (boxes a ray, faces a ray, moves a ray, bytes read)."""
    from mitsuba2_tpu_torch.ops import bvh as bvh_ops
    o, d, mint, maxt = sample
    tb = maxt.clone()
    found = torch.zeros(len(o), dtype=torch.bool)
    boxes = faces = moves = 0.0
    start = inst.group_face.tolist() + [inst.woop.shape[0]]
    pairs = [torch.as_tensor(bvh_ops.pack_pairs(t)[0]) for t in inst.trees]
    woop, prim = inst.woop.cpu(), inst.prim.cpu()
    reads = {}
    for row in inst.rows.cpu():
        g = int(row[21])
        o_l, d_l = isx.to_group(row, o, d)
        live = ~found if any_hit else torch.ones_like(found)
        moves += float(live.sum())
        walk = isx.traverse_pairs(
            pairs[g], woop[start[g]:start[g + 1]],
            prim[start[g]:start[g + 1]], o_l[live], d_l[live], mint[live],
            tb[live], any_hit=any_hit, k2=True)
        boxes += float(walk["boxes"].sum())
        faces += float(walk["faces"].sum())
        if any_hit:
            idx = live.nonzero()[:, 0]
            found[idx[walk["hit"]]] = True
        else:
            t = tb.clone()
            t[live] = walk["t"]
            tb = torch.minimum(tb, t)
        nr, fr = reads.get(g, (None, None))
        reads[g] = (walk["node_reads"] if nr is None
                    else nr | walk["node_reads"],
                    walk["face_reads"] if fr is None
                    else fr | walk["face_reads"])
    read = sum(isx.bytes_read({"node_bytes": isx.PAIR_BYTES,
                               "node_reads": nr, "face_reads": fr})
               for nr, fr in reads.values())
    return (boxes / len(o), faces / len(o), moves / len(o),
            read + inst.rows.numel() * 4)


def inst_k2_entries(ik, isx, scene, render, launches):
    """K2's instance entries on the rays of one render of ``scene``:
    bit for bit against their plain version on INST_PARITY_RAYS rays
    sampled from INST_LAUNCHES launches of each, timed on the busiest
    launch, the bound from the binary walks over every instance -> the two
    entries of the kernels line."""
    samples, full = record_k2(ik, render, per_launch=INST_PARITY_RAYS,
                              busiest=True)
    inst = scene.inst_tables
    woops = ik.group_woops(inst)
    entries = []
    for name, fn, ref, out_bytes in (
            ("isect_closest_inst", ik.isect_closest_inst,
             lambda *a: isx.closest_hit_instanced_reference(
                 woops, inst.rows, inst.g_max, *a), 16),
            ("isect_any_inst", ik.isect_any_inst,
             lambda *a: isx.any_hit_instanced_reference(
                 woops, inst.rows, *a), 1)):
        runs = samples[name]
        at = [k * (len(runs) - 1) // max(INST_LAUNCHES - 1, 1)
              for k in range(INST_LAUNCHES)]
        pick = [runs[k] for k in at]
        every = tuple(torch.cat(xs) for xs in zip(*pick))
        sub = every_kth(every, INST_PARITY_RAYS)
        got = fn(inst, *sub)
        torch.cuda.synchronize()
        want, plain_ms = timed(lambda: ref(*sub), repeats=1, warm_up=False)
        busy = full[name]
        n = len(busy[0])
        log(f"  {name} on instanced_shared's rays ({len(runs)} launches "
            f"of one render; {len(sub[0])} rays from launches "
            f"{at}, "
            f"{float((sub[3] > sub[2]).float().mean()):.4f} active):")
        err = isect_parity(name.replace("_inst", ""), got, want)
        kernel_ms = timed(lambda: fn(inst, *busy))[1]
        sample = [x.cpu() for x in every_kth(busy, INST_COUNT_RAYS)]
        t0 = time.perf_counter()
        boxes, faces, moves, read = inst_walk_bound(
            isx, inst, sample, name.startswith("isect_any"))
        flops = prof.walk_flop_count(n, boxes, faces) \
            + n * moves * INST_TRANSFORM_FLOPS
        log(f"  {name} binary walks (the bound's) per ray, summed over "
            f"{inst.n_instances} instances: {boxes:.2f} box tests, "
            f"{faces:.2f} face tests, {moves:.2f} moves into a group's "
            f"frame; the sample's walks read "
            f"{read / 1e6:.3f} MB ({time.perf_counter() - t0:.1f} s on "
            f"the host)")
        bound_ms, bound_by = roofline(flops, int(read), n,
                                      out_bytes=out_bytes, in_bytes=32,
                                      what="ray")
        log(f"{name}[instanced_shared]: kernel {kernel_ms:.4f} ms on the "
            f"busiest launch, {int((busy[3] > busy[2]).sum())} of {n} rays "
            f"active, {n / kernel_ms / 1e3:.3f} Mrays/s; bound "
            f"{bound_ms:.4f} ms ({bound_by}), "
            f"{100 * bound_ms / kernel_ms:.2f}% of bound; plain version "
            f"{plain_ms:.3f} ms on {len(sub[0])} rays")
        entries.append({
            "name": f"{name}[instanced_shared]", "route": "cuda",
            "source": "mitsuba2_tpu_torch/csrc/intersect_kernel.cu",
            "replaces": "mitsuba2_tpu/ops/intersect_pallas.py:81",
            "launches": launches[name], "max_abs_err": err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
    return entries


def run_scene_files(mi, ik, isx, pk, scenes, biggeo):
    """Scene files and instancing: the Cornell box through ``load_file``
    (an XML file written by ``dict_to_xml``) on the path kernel, its
    tables within the writer's rounding of the dict scene's; biggeo's
    mesh as a PLY file, its image bit for bit the OBJ's, load times beside
    each other; 8 instances of a 4,096-face group (materialized by policy)
    on the path kernel's BVH tier; 8 instances of biggeo's 262,144-face
    group (shared by policy) on the path wavefront with K2's instance
    entries (timed, host syncs, spans, peak memory beside 2 instances,
    the entries bit for bit against their plain version), the small shared
    scene card against CPU, shared against materialized means; the command
    line on the XML file; a Blender quad -> the kernels line's entries.
    ``biggeo`` is biggeo's entry of the kernels line, this run's."""
    from mitsuba2_tpu_torch.models import shapes as shapes_mod
    from mitsuba2_tpu_torch.utils.io_image import read_image
    t_phase = time.perf_counter()
    mi.set_variant("scalar_rgb")
    kernels = []

    # ---- cornell_xml: load_file onto the path kernel (K1a) ----
    xml = scenes.cornell_xml_path(WIDTH, WIDTH, SPP, MAX_DEPTH)
    sx = mi.load_file(xml)
    sd = mi.load_dict(scenes.cornell_box_dict(WIDTH, WIDTH, SPP, MAX_DEPTH))
    errs = {}
    for k in ("v0", "e1", "e2"):
        errs[k] = float(np.abs(getattr(sx, k) - getattr(sd, k)).max())
    fa, fb = sx.tables.fattr, sd.tables.fattr
    errs["fattr"] = float(((fa - fb).abs() / fb.abs().clamp(min=1.0))
                          .max())
    log(f"cornell_xml: {sx.tables.n_faces} faces from {xml}; against the "
        f"dict scene (the writer's %.6g): " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()))
    if max(errs.values()) > 1e-6 or not np.array_equal(sx.face_shape,
                                                       sd.face_shape):
        raise SystemExit("cornell_xml: tables beyond 1e-6 of the dict's")
    del sx, sd
    entries, _ = drive(mi, pk, "cornell_xml", scenes.cornell_xml_path,
                       WIDTH, SPP, MAX_DEPTH, (0.05, 1.0),
                       scene_path_route(pk, "cornell_xml", 0),
                       load=mi.load_file)
    kernels += entries

    # ---- biggeo_ply: the 262,144-face sphere from a PLY file (K1f) ----
    big = next(p for p in PATHS if p.name == "biggeo")
    nu, nv = INST_BIG
    t0 = time.perf_counter()
    ply = scenes.bumpy_sphere_ply_path(nu, nv)
    log(f"biggeo_ply: {ply} written in {time.perf_counter() - t0:.1f} s")

    def biggeo_ply(w, h, spp, depth):
        d = scenes.bumpy_sphere_dict(w, h, spp, depth, nu, nv)
        d["hero"]["type"] = "ply"
        d["hero"]["filename"] = ply
        return d

    loads = {}
    for label, make in (("obj", scenes.bumpy_sphere_dict),
                        ("ply", biggeo_ply)):
        d = make(big.width, big.width, big.spp, big.max_depth) \
            if label == "ply" else make(big.width, big.width, big.spp,
                                        big.max_depth, nu, nv)
        t0 = time.perf_counter()
        sc = mi.load_dict(d)
        torch.cuda.synchronize()
        loads[label] = (sc, time.perf_counter() - t0)
        if (sc.tables.flags & pk.TEMPLATE_FLAGS, sc.tables.nc) \
                != (pk.HAS_BVH, 3):
            raise SystemExit(f"biggeo_ply: the {label} scene's tables "
                             f"carry flags {sc.tables.flags}")
    # the PLY scene's render is the main path's; the OBJ's is its reference
    sc = loads["ply"][0]
    pk.reset_launch_counts()
    img = sc.integrator.render(sc, seed=0, spp=big.spp)
    torch.cuda.synchronize()
    launches = pk.path_radiance.launches_by_kernel[(pk.HAS_BVH, 3)]
    engine = sc.integrator.last_engine
    sc = loads["obj"][0]
    same = torch.equal(img, sc.integrator.render(sc, seed=0, spp=big.spp))
    log(f"biggeo_ply: load {loads['ply'][1]:.2f} s against the OBJ's "
        f"{loads['obj'][1]:.2f} s ({loads['ply'][0].tables.n_faces} faces, "
        f"file, tables, both traversal trees); engine {engine}, "
        f"{launches} launch(es) of {pk.kernel_name(pk.HAS_BVH, 3)}; image "
        f"bit for bit the OBJ's: {same}")
    if not same or engine != "kernel" or launches < 1:
        raise SystemExit("biggeo_ply: not the OBJ's image on the kernel")
    # one launch on each scene's tables: the same lanes, so biggeo's entry
    # (its plain version, error and bound, this run) is the PLY's reference
    rad, ms = {}, {}
    for label, (sc, _) in loads.items():
        cam = pk.camera_row(sc.sensors[0], sc.device)
        args = (sc.tables, cam, 0, 0, big.spp, big.width, big.width,
                big.max_depth, sc.integrator.rr_depth)
        rad[label], ms[label] = timed(lambda: pk.path_radiance(*args))
    same = torch.equal(rad["ply"], rad["obj"])
    log(f"path_kernel[biggeo_ply]: kernel {ms['ply']:.3f} ms (the OBJ "
        f"tables' {ms['obj']:.3f} ms); its "
        f"{rad['ply'].shape[1]} lanes bit for bit the OBJ tables' "
        f"launch's: {same}; plain version, error and bound biggeo's "
        f"({biggeo['plain_ms']:.3f} ms, {biggeo['max_abs_err']:.3e}, "
        f"{biggeo['bound_ms']:.4f} ms {biggeo['bound_by']})")
    if not same:
        raise SystemExit("biggeo_ply: the kernel's lanes are not the OBJ's")
    kernels.append(dict(biggeo, name="path_kernel[biggeo_ply]",
                        launches=launches, ms=ms["ply"]))
    # the 262,144-face tables stay out of the instanced scenes' peaks
    del loads, img, rad, args, cam, sc

    # ---- instanced_materialized: 8 x 4,096 faces, by policy (K1f) ----
    nu, nv = INST_SMALL

    def materialized(w, h, spp, depth):
        return scenes.instanced_spheres_dict(INST_COUNT, None, nu, nv, w, h,
                                             spp, depth)

    sc = mi.load_dict(materialized(8, 8, 1, 1))
    log(f"instanced_materialized: {INST_COUNT} instances of a "
        f"{2 * nu * (nv - 1)}-face group, by policy: n_instances "
        f"{sc.n_instances}, {sc.tables.n_faces} faces")
    if sc.n_instances:
        raise SystemExit("instanced_materialized: not materialized")
    entries, _ = drive(mi, pk, "instanced_materialized", materialized,
                       WIDTH, SPP, MAX_DEPTH, (0.02, 1.0), scene_path_route(
                           pk, "instanced_materialized", pk.HAS_BVH,
                           parity=(BIG_PARITY_WIDTH, BIG_PARITY_SPP),
                           plain_stride=BIG_PLAIN_STRIDE))
    kernels += entries
    # the same instances shared, on the wavefront: the JAX test's bar of
    # the image means
    means = {}
    for mat in (None, False):
        sc = mi.load_dict(scenes.instanced_spheres_dict(
            INST_COUNT, mat, nu, nv, WIDTH, WIDTH, SPP, MAX_DEPTH))
        means[mat] = float(sc.integrator.render(sc, seed=SEED,
                                                spp=SPP).mean())
        log(f"  instanced {'shared' if mat is False else 'materialized'}: "
            f"engine {sc.integrator.last_engine}, image mean "
            f"{means[mat]:.6f}")
    rel = abs(means[False] - means[None]) / means[None]
    log(f"  shared against materialized image means: {rel:.3e} (bar "
        f"{SHARED_MEAN_RTOL:g})")
    if rel > SHARED_MEAN_RTOL:
        raise SystemExit("instanced: shared and materialized disagree")

    # ---- instanced_shared: 8 x 262,144 faces, by policy (K2 instances) ----
    nu, nv = INST_BIG
    t0 = time.perf_counter()
    scene = mi.load_dict(scenes.instanced_spheres_dict(
        INST_COUNT, None, nu, nv, WIDTH, WIDTH, SPP, MAX_DEPTH))
    torch.cuda.synchronize()
    inst = scene.inst_tables
    inst_bytes = sum(x.numel() * x.element_size() for x in (
        inst.nodes, inst.woop, inst.prim, inst.rows))
    wf_bytes = sum(x.numel() * x.element_size() for x in (
        scene.wavefront_tables().inst_attr,
        scene.wavefront_tables().inst_ints))
    log(f"instanced_shared: load {time.perf_counter() - t0:.2f} s; "
        f"n_instances {scene.n_instances}, {scene.tables.n_faces} faces in "
        f"the face tables, one group of {inst.n_faces[0]} faces: its tree "
        f"and Woop rows {inst_bytes / 2**20:.1f} MiB, its wavefront rows "
        f"{wf_bytes / 2**20:.1f} MiB, {inst.n_instances} instance rows "
        f"of 24 floats; stack bound {inst.depth}")
    if scene.n_instances != INST_COUNT:
        raise SystemExit("instanced_shared: not shared")
    launches, ms, peak, _ = time_wavefront(
        ik, "instanced_shared", scene, SHARED_REASON, (0.02, 1.0), True,
        entries=("isect_closest", "isect_any", "isect_closest_inst",
                 "isect_any_inst"))
    kernels += inst_k2_entries(
        ik, isx, scene,
        lambda: scene.integrator.render(scene, seed=SEED, spp=SPP),
        launches)
    del scene
    torch.cuda.empty_cache()
    two = mi.load_dict(scenes.instanced_spheres_dict(
        2, None, nu, nv, WIDTH, WIDTH, SPP, MAX_DEPTH))
    torch.cuda.reset_peak_memory_stats()
    two.integrator.render(two, seed=SEED, spp=SPP)
    torch.cuda.synchronize()
    peak2 = torch.cuda.max_memory_allocated()
    log(f"  peak memory: {peak / 2**20:.1f} MiB at {INST_COUNT} instances, "
        f"{peak2 / 2**20:.1f} MiB at 2 (the group's tables once)")
    del two

    # ---- the small shared scene, card against CPU ----
    runs = {}
    w, spp = WF_CPU_WIDTH, WF_CPU_SPP
    for dev in ("cuda", "cpu"):
        mi.set_device(dev)
        try:
            sc = mi.load_dict(scenes.instanced_spheres_dict(
                3, False, 40, 20, w, w, spp, MAX_DEPTH))
            runs[dev] = (sc, sc.integrator.render(sc, seed=SEED, spp=spp),
                         wavefront_lanes(sc, SEED, spp))
        finally:
            mi.set_device("cuda")
    hold_card_against_cpu(f"instanced_spheres (3 shared) {w}^2 x {spp}, "
                          f"card against CPU", runs)

    # ---- the command line on the XML file, on the card ----
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        exr = os.path.join(tmp, "cornell_xml.exr")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "mitsuba2_tpu_torch", xml, "-o", exr,
             "-s", str(SPP), "--seed", "0"], capture_output=True, text=True,
            timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
        cli_s = time.perf_counter() - t0
        if out.returncode != 0:
            raise SystemExit(f"the command line failed: {out.stderr}")
        got = read_image(exr)
    sc = mi.load_file(xml)
    want = sc.integrator.render(sc, seed=0, spp=SPP).cpu().numpy()
    same = np.array_equal(got, want.astype(np.float16).astype(np.float32))
    log(f"python -m mitsuba2_tpu_torch {os.path.basename(xml)} -o "
        f"<tmp>.exr -s {SPP} --seed 0: exit 0 in {cli_s:.1f} s; "
        + "; ".join(line.split(": ", 1)[-1] for line in
                    out.stderr.splitlines() if "Rendered" in line)
        + f"; its EXR the in-process "
        f"render's (half floats) bit for bit: {same}")
    if not same:
        raise SystemExit("the command line's image is not the render's")

    # ---- a Blender quad onto the card ----
    quad, keep = blender_quad_dict(shapes_mod)
    sc = mi.load_dict({
        "type": "scene", "integrator": {"type": "path", "max_depth": 2},
        "light": {"type": "constant"}, "quad": quad,
        "sensor": {"type": "perspective",
                   "to_world": mi.Transform.look_at([0.5, 0.5, 3],
                                                    [0.5, 0.5, 0],
                                                    [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 64, "height": 64,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": 8}}})
    img = sc.integrator.render(sc, seed=0)
    del keep
    log(f"blender quad: {sc.tables.n_faces} faces on {sc.tables.device}, "
        f"{len(sc.shapes[0].attributes)} vertex-color layer; engine "
        f"{sc.integrator.last_engine}, image {tuple(img.shape)} on "
        f"{img.device}, mean {float(img.mean()):.6f}")
    if img.device.type != "cuda" or not bool(torch.isfinite(img).all()) \
            or float(img.max()) <= 0:
        raise SystemExit("blender quad: not rendered on the card")
    log(f"scene-file and instancing phase: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return kernels


# ---- the polarized and measured phase ---------------------------------------
STOKES_REASON = "non-path integrator subclass"
MEASURED_REASON = "unsupported BSDF MeasuredBSDF"
# (label, fixture, variant, the kernels' gate's reason, the image mean's
# band, the integrator put in place of the fixture's or None); a stokes
# image's mean counts its nine S1-S3 channels beside S0's three
POL_SCENES = (
    ("cornell_polarized", "cornell_box_dict", "scalar_rgb_polarized",
     "polarized variant", (0.05, 1.0), None),
    ("cornell_polarized_spectral", "cornell_box_dict",
     "scalar_spectral_polarized", "polarized variant", (0.05, 1.0), None),
    ("cornell_stokes", "cornell_stokes_dict", "scalar_rgb", STOKES_REASON,
     (0.01, 1.0), None),
    ("cornell_stokes_spectral", "cornell_stokes_dict",
     "scalar_spectral_polarized", STOKES_REASON, (0.01, 1.0), None),
    ("cornell_measured", "cornell_measured_dict", "scalar_rgb",
     MEASURED_REASON, (0.05, 1.0), None),
    ("cornell_measured_spectral", "cornell_measured_dict",
     "scalar_spectral", MEASURED_REASON, (0.05, 1.0), None),
    ("cornell_measured_stokes", "cornell_measured_dict",
     "scalar_spectral_polarized", STOKES_REASON, (0.01, 1.0), "stokes"))
# the scenes whose K2 traffic the kernels line times, and the scenes held
# card against CPU at WF_CPU_WIDTH^2 x WF_CPU_SPP
POL_K2 = ("cornell_stokes", "cornell_measured")
POL_CARD_CPU = ("cornell_polarized", "cornell_stokes",
                "cornell_stokes_spectral", "cornell_measured",
                "cornell_measured_spectral")
# the plain box under stokes against the path wavefront: the mean pixel
# difference within this many standard errors (tools/wavefront_spread.py
# ``spread``'s rule)
POL_MAX_Z = 4.0


def pol_scene(mi, scenes, fixture, integrator, width, spp):
    d = getattr(scenes, fixture)(width, width, spp, MAX_DEPTH)
    if integrator is not None:
        d["integrator"] = {"type": integrator, "max_depth": MAX_DEPTH}
    return mi.load_dict(d)


def stokes_means(img):
    """The means of S0 and of S1, S2 and S3 (three channels each) of a
    stokes image, and the largest |S_k| of each."""
    comps = [img[..., 3 * k:3 * k + 3] for k in range(4)]
    return ([float(c.mean()) for c in comps],
            [float(c.abs().max()) for c in comps])


def run_polarized_measured(mi, ik, isx, pk, scenes):
    """Polarized rendering and the measured BSDFs on the wavefronts at
    the main shape (``time_wavefront``: engine, the kernels' reason,
    render time, host syncs, spans with the Mueller rotations and the
    polarized BSDF calls apart): the Cornell box in ``scalar_rgb_polarized``
    and ``scalar_spectral_polarized`` on the path wavefront, bit for bit
    the unpolarized box forced onto it; cornell_stokes (a polarizer, a
    retarder, a circular polarizer, a pplastic box) under ``stokes`` in
    rgb and ``scalar_spectral_polarized``, its S0 and S1-S3 means logged,
    each of S1-S3 non-zero; cornell_measured (a ``measured`` and a
    ``measured_polarized`` box) under ``path`` in rgb and spectral and
    under ``stokes`` in ``scalar_spectral_polarized``; K2 bit for bit
    against its twin on rays of every launch of cornell_stokes and
    cornell_measured, timed on the busiest; five of those card against
    CPU at 32^2 x 4; the plain box under ``stokes``: S1-S3 zero, S0 the
    path wavefront's image within POL_MAX_Z standard errors -> K2's four
    entries of the kernels line."""
    from mitsuba2_tpu_torch.render import mueller
    from mitsuba2_tpu_torch.render.scene import Scene
    t_phase = time.perf_counter()
    layers = [(Scene, "bsdf_eval_pol", "BSDF eval_pol"),
              (Scene, "bsdf_sample_pol", "BSDF sample_pol"),
              (Scene, "bsdf_pdf", "BSDF pdf"),
              (mueller, "to_world_mueller", "Mueller rotation")]
    entries = []
    try:
        for label, fixture, variant, reason, band, integrator in POL_SCENES:
            t_scene = time.perf_counter()
            mi.set_variant(variant)
            scene = pol_scene(mi, scenes, fixture, integrator, WIDTH, SPP)
            log(f"{label} ({variant}):")
            launches, _, _, img = time_wavefront(
                ik, label, scene, reason, band, True, layers=layers)
            if img.shape[-1] == 12:
                means, peaks = stokes_means(img)
                log(f"  S0 mean {means[0]:.6f}; S1, S2, S3 means "
                    f"{means[1]:.6e}, {means[2]:.6e}, {means[3]:.6e}; "
                    f"largest |S1|, |S2|, |S3| {peaks[1]:.4f}, "
                    f"{peaks[2]:.4f}, {peaks[3]:.4f}")
                if fixture == "cornell_stokes_dict" and min(peaks[1:]) < 1e-3:
                    raise SystemExit(f"{label}: a Stokes component is zero "
                                     f"everywhere: {peaks}")
            if fixture == "cornell_box_dict":
                # the unpolarized variant's box forced onto the wavefront
                mi.set_variant(variant.replace("_polarized", ""))
                plain = pol_scene(mi, scenes, fixture, None, WIDTH, SPP)
                plain.integrator._disable_kernel = True
                ref = plain.integrator.render(plain, seed=SEED, spp=SPP)
                same = torch.equal(img, ref)
                log(f"  bit for bit the {variant[:-10]} box forced onto "
                    f"the wavefront: {same}")
                if not same:
                    raise SystemExit(f"{label}: apart from the unpolarized "
                                     f"wavefront's image")
            if label in POL_K2:
                entries += wavefront_k2_entries(
                    ik, isx, pk, label, scene,
                    lambda: scene.integrator.render(scene, seed=SEED,
                                                    spp=SPP), launches)
            del scene
            torch.cuda.empty_cache()
            log(f"  {label}: {time.perf_counter() - t_scene:.1f} s")

        # ---- the card against the CPU ----
        t_step = time.perf_counter()
        w, spp = WF_CPU_WIDTH, WF_CPU_SPP
        for label, fixture, variant, _, _, integrator in POL_SCENES:
            if label not in POL_CARD_CPU:
                continue
            mi.set_variant(variant)
            runs = {}
            for dev in ("cuda", "cpu"):
                mi.set_device(dev)
                try:
                    sc = pol_scene(mi, scenes, fixture, integrator, w, spp)
                    runs[dev] = (sc, sc.integrator.render(sc, seed=SEED,
                                                          spp=spp),
                                 wavefront_lanes(sc, SEED, spp))
                finally:
                    mi.set_device("cuda")
            hold_card_against_cpu(f"{label} {w}^2 x {spp}, card against "
                                  f"CPU", runs, ties=True)
        log(f"  card against CPU: {time.perf_counter() - t_step:.1f} s")

        # ---- the plain box under stokes: unpolarized, the path's image --
        mi.set_variant("scalar_rgb")
        d = scenes.cornell_box_dict(WIDTH, WIDTH, SPP, MAX_DEPTH)
        path = mi.load_dict(d)
        path.integrator._disable_kernel = True
        ref = path.integrator.render(path, seed=SEED, spp=SPP).double()
        d["integrator"] = {"type": "stokes", "max_depth": MAX_DEPTH}
        plain = mi.load_dict(d)
        t0 = time.perf_counter()
        img = plain.integrator.render(plain, seed=SEED, spp=SPP).double()
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        means, peaks = stokes_means(img)
        diff = (img[..., :3] - ref).reshape(-1)
        z = abs(float(diff.mean())) / max(
            float(diff.std()) / math.sqrt(diff.numel()), 1e-30)
        log(f"plain cornell under stokes {WIDTH}^2 x {SPP}: "
            f"{render_s:.2f} s; S0 mean {means[0]:.6f} against the path "
            f"wavefront's {float(ref.mean()):.6f}, mean difference {z:.2f} "
            f"standard errors (at most {POL_MAX_Z:g}); largest |S1|, |S2|, "
            f"|S3| {peaks[1]:g}, {peaks[2]:g}, {peaks[3]:g} (must be 0)")
        if z > POL_MAX_Z or max(peaks[1:]) != 0.0:
            raise SystemExit("plain cornell under stokes: not the path "
                             "wavefront's unpolarized image")
    finally:
        mi.set_variant("scalar_rgb")
    log(f"polarized and measured phase: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return entries


# the differentiable-rendering phase: the Cornell box at the main width and
# depth, the taped render at AD_TAPED_SPP, rb at each of AD_RB_SPP, the
# red wall's albedo (and the light's radiance where named)
AD_LEFT = "left.bsdf.reflectance.value"
AD_LIGHT = "light.emitter.radiance.value"
AD_TAPED_SPP, AD_RB_SPP, AD_REPACK_SPP = 16, (16, 64), 16
# rb against the tape: the JAX test's bar for two independent estimators
# (tests/test_rb.py:54-57); rb's peak memory at 64 spp within this factor
# of its peak at 16 (one pass of lanes at a time)
AD_RB_TOL, AD_RB_FLAT = 0.35, 1.25
# the card's gradient against the CPU's at 32^2 x 4, relative to its
# largest component (the two sum in different orders)
AD_CARD_CPU_TOL = 1e-3
# the recovery: Adam steps through rb from a grey wall, and the share of
# the starting mean error that must remain at most (tests/test_rb.py:83-84)
AD_STEPS, AD_LR, AD_START, AD_RECOVER = 8, 0.05, 0.5, 0.6


def ad_l2(target):
    return lambda im: ((im - target) ** 2).mean()


def ad_repack(mi, label, make, edit, root, key, value, spp, max_depth):
    """A kernel render, ``params.update()`` of ``key`` (in the map of
    ``root(scene)``) to ``value``, a second kernel render, and the kernel
    render of the scene loaded with ``edit(dict, value)``: the second must
    be the fresh load's bit for bit, and not the first's."""
    def kernel_render(scene):
        img = scene.integrator.render(scene, seed=SEED, spp=spp)
        torch.cuda.synchronize()
        if scene.integrator.last_engine != "kernel":
            raise SystemExit(f"{label}: engine {scene.integrator.last_engine}"
                             f" ({scene.integrator.engine_reason})")
        return img

    scene = mi.load_dict(make())
    before = kernel_render(scene)
    params = mi.traverse(root(scene))
    params[key] = torch.as_tensor(np.asarray(value, np.float32))
    t0 = time.perf_counter()
    params.update()
    after = kernel_render(scene)
    update_s = time.perf_counter() - t0
    fresh = kernel_render(mi.load_dict(edit(make(), value)))
    same, moved = torch.equal(after, fresh), not torch.equal(before, after)
    log(f"  repack, {label}: params.update() of {key} and the kernel "
        f"render {update_s:.3f} s; image moved: {moved}; bit for bit a "
        f"fresh load's: {same}; means {float(before.mean()):.6f} -> "
        f"{float(after.mean()):.6f}")
    if not (same and moved):
        raise SystemExit(f"{label}: a kernel render after params.update() "
                         f"is not a fresh load's")


def run_autodiff(mi, ik, isx, pk, scenes):
    """Differentiable rendering of the Cornell box at WIDTH^2, depth
    MAX_DEPTH (python/autodiff.py, models/rb.py): the kernels' tables
    re-packed after ``params.update()`` (K1a, and K3 on the volpath slab),
    bit for bit a fresh load's; the taped ``render_loss`` of the red
    wall's albedo against a target render at AD_TAPED_SPP (engine and
    gate, render and backward times, peak memory, K2's launches and share;
    its image the forced wavefront's); the card's gradient against the
    CPU's at 32^2 x 4; ``render_loss_rb`` at each of AD_RB_SPP (ms a step,
    peak memory flat in spp, its gradient the tape's within AD_RB_TOL of
    the scale); AD_STEPS Adam steps through rb recovering the wall's
    albedo; and K2 bit for bit against its twin on the rays of a taped
    render -> K2's two entries of the kernels line,
    ``isect_closest[autodiff]`` and ``isect_any[autodiff]``."""
    from mitsuba2_tpu_torch.python.autodiff import (Adam, render_loss,
                                                    render_loss_rb)
    t_phase = time.perf_counter()
    mi.set_variant("scalar_rgb")
    w, depth = WIDTH, MAX_DEPTH

    def cornell(spp, albedo=None):
        d = scenes.cornell_box_dict(w, w, spp, depth)
        if albedo is not None:
            d["left"]["bsdf"]["reflectance"]["value"] = list(albedo)
        return d

    # ---- the kernels' tables after params.update() ----
    def edit_light(d, v):
        d["light"]["emitter"]["radiance"]["value"] = list(v)
        return d

    grid = np.random.default_rng(0).uniform(0.2, 2.0, (16, 16, 16)) \
        .astype(np.float32) * 1.5
    ad_repack(mi, "K1a, the red wall's albedo",
              lambda: cornell(AD_REPACK_SPP),
              lambda d, v: cornell(AD_REPACK_SPP, v), lambda s: s, AD_LEFT,
              [0.2, 0.5, 0.7], AD_REPACK_SPP, depth)
    ad_repack(mi, "K1a, the light's radiance",
              lambda: cornell(AD_REPACK_SPP), edit_light, lambda s: s,
              AD_LIGHT, [9.0, 14.0, 20.0], AD_REPACK_SPP, depth)
    ad_repack(mi, "K3, the slab's sigma_t grid",
              lambda: scenes.volpath_slab_dict(w, w, VOL_SPP, VOL_MAX_DEPTH),
              lambda d, v: scenes.volpath_slab_dict(
                  w, w, VOL_SPP, VOL_MAX_DEPTH, grid=np.asarray(v)[..., 0]),
              lambda s: s.media[0], "sigma_t.data", grid[..., None],
              VOL_SPP, VOL_MAX_DEPTH)

    # ---- the target: the true red wall on the path kernel ----
    true_red = scenes.cornell_box_dict(1, 1, 1, 1)["left"]["bsdf"][
        "reflectance"]["value"]
    ref_scene = mi.load_dict(cornell(AD_RB_SPP[-1]))
    target = ref_scene.integrator.render(ref_scene, seed=SEED + 1)
    del ref_scene
    start = [AD_START] * 3
    scene = mi.load_dict(cornell(AD_TAPED_SPP, start))
    params = mi.traverse(scene).keep([AD_LEFT])
    loss_fn = ad_l2(target)

    # ---- the taped render: the main run, K2's launches counted ----
    torch.cuda.empty_cache()
    ik.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, g_tape, img = render_loss(scene, params, loss_fn,
                                    spp=AD_TAPED_SPP, seed=SEED)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    taped_peak = torch.cuda.max_memory_allocated()
    launches = {fn.__name__: fn.launches for fn in ik.ENTRIES
                if fn.__name__ in ("isect_closest", "isect_any")}
    integ = scene.integrator
    log(f"autodiff, cornell {w}^2 x {AD_TAPED_SPP} spp, depth {depth}, "
        f"taped render_loss of {AD_LEFT}: engine {integ.last_engine} "
        f"(gate: {integ.engine_reason}); loss {float(loss):.6e}; gradient "
        f"{g_tape[AD_LEFT].tolist()}; step {step_s:.2f} s; peak memory "
        f"{taped_peak / 2**20:.1f} MiB "
        f"({taped_peak / (w * w * AD_TAPED_SPP):.0f} B a lane); K2 "
        f"launches {launches}")
    if integ.last_engine != "wavefront" or integ.engine_reason != \
            "differentiable render (wavefront only)":
        raise SystemExit("autodiff: the taped render left the wavefront")
    if min(launches.values()) < 1:
        raise SystemExit(f"autodiff: the taped render missed K2: {launches}")
    if not bool(torch.isfinite(g_tape[AD_LEFT]).all()) \
            or float(g_tape[AD_LEFT].abs().max()) == 0.0:
        raise SystemExit(f"autodiff: taped gradient {g_tape[AD_LEFT]}")
    # the render and the backward pass apart, K2's share of the render
    from mitsuba2_tpu_torch.python.autodiff import render
    values = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    with _Spans(ik, [], nest=True) as spans:
        (img2,), (render_ms,) = prof.cuda_times(
            lambda: (render(scene, spp=AD_TAPED_SPP, seed=SEED,
                            params=params, values=values),), runs=1,
            warm_up=False)
    k2_ms = sum(v for k, v in spans.ms().items() if k.startswith("isect_"))
    _, (backward_ms,) = prof.cuda_times(
        lambda: torch.autograd.grad(loss_fn(img2), [values[AD_LEFT]]),
        runs=1, warm_up=False)
    log(f"  taped render {render_ms:.1f} ms (K2 {k2_ms:.1f} ms, share "
        f"{100 * k2_ms / render_ms:.2f}%), backward pass "
        f"{backward_ms:.1f} ms")
    del img2, values
    # the tape's growth with spp: the graph of every pass is kept until
    # the backward pass
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    render_loss(scene, params, loss_fn, spp=AD_RB_SPP[-1], seed=SEED)
    torch.cuda.synchronize()
    taped_peak_hi = torch.cuda.max_memory_allocated()
    log(f"  taped render_loss at {AD_RB_SPP[-1]} spp: peak memory "
        f"{taped_peak_hi / 2**20:.1f} MiB, {taped_peak_hi / taped_peak:.2f}x"
        f" the {AD_TAPED_SPP}-spp peak")
    # its image against the forward wavefront's at the same seed
    integ._disable_kernel = True
    fwd = integ.render(scene, seed=SEED, spp=AD_TAPED_SPP)
    integ._disable_kernel = False
    log(f"  taped image bit for bit the forced wavefront's: "
        f"{torch.equal(img, fwd)}")
    compare(img, fwd, "  taped image against the forced wavefront's")

    # ---- the card against the CPU at 32^2 x 4 ----
    cw, cspp = WF_CPU_WIDTH, WF_CPU_SPP
    grads = {}
    for dev in ("cuda", "cpu"):
        mi.set_device(dev)
        try:
            sc = mi.load_dict(scenes.cornell_box_dict(cw, cw, cspp, depth))
            p = mi.traverse(sc).keep([AD_LEFT, AD_LIGHT])
            grads[dev] = render_loss(sc, p, ad_l2(0.1), spp=cspp,
                                     seed=SEED)[1]
        finally:
            mi.set_device("cuda")
    for k in (AD_LEFT, AD_LIGHT):
        ref = grads["cpu"][k].double()
        err = float((grads["cuda"][k].double().cpu() - ref).abs().max())
        scale = float(ref.abs().max())
        log(f"  {k} at {cw}^2 x {cspp}: card {grads['cuda'][k].tolist()}, "
            f"CPU {grads['cpu'][k].tolist()}; max diff {err:.3e} = "
            f"{err / scale:.3e} of the scale (at most {AD_CARD_CPU_TOL:g})")
        if not err <= AD_CARD_CPU_TOL * scale:
            raise SystemExit(f"autodiff: card and CPU gradients of {k} "
                             f"disagree")

    # ---- rb: ms a step and peak memory, flat in spp ----
    peaks = {}
    g_tape_np = g_tape[AD_LEFT].double().cpu()
    for spp in AD_RB_SPP:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        render_loss_rb(scene, params, loss_fn, spp=spp, seed=SEED)
        torch.cuda.synchronize()
        peaks[spp] = torch.cuda.max_memory_allocated()
        (_, g_rb, _), (ms,) = prof.cuda_times(
            lambda: render_loss_rb(scene, params, loss_fn, spp=spp,
                                   seed=SEED), runs=1, warm_up=False)
        g = g_rb[AD_LEFT].double().cpu()
        scale = float(g_tape_np.abs().max())
        err = float((g - g_tape_np).abs().max())
        log(f"  rb {w}^2 x {spp} spp: {ms:.1f} ms a step; peak memory "
            f"{peaks[spp] / 2**20:.1f} MiB; gradient {g.tolist()}, the "
            f"tape's within {err / scale:.3f} of the scale (at most "
            f"{AD_RB_TOL:g})")
        if not (bool(torch.isfinite(g).all()) and err <= AD_RB_TOL * scale):
            raise SystemExit("autodiff: rb and the tape disagree")
    lo, hi = peaks[AD_RB_SPP[0]], peaks[AD_RB_SPP[-1]]
    log(f"  rb peak memory {AD_RB_SPP[-1]} against {AD_RB_SPP[0]} spp: "
        f"{hi / lo:.3f}x (at most {AD_RB_FLAT:g}); the tape's "
        f"{taped_peak / lo:.2f}x rb's at {AD_TAPED_SPP} spp and "
        f"{taped_peak_hi / hi:.2f}x at {AD_RB_SPP[-1]}")
    if hi > AD_RB_FLAT * lo:
        raise SystemExit("autodiff: rb's memory grows with spp")

    # ---- the recovery: Adam through rb ----
    true = torch.tensor(true_red, dtype=torch.float32)
    err0 = float((params[AD_LEFT].cpu() - true).abs().mean())
    opt = Adam(params, lr=AD_LR)
    losses, times = [], []
    for it in range(AD_STEPS):
        t0 = time.perf_counter()
        loss, g_rb, _ = render_loss_rb(scene, params, loss_fn,
                                       spp=AD_RB_SPP[0], seed=SEED + it)
        opt.step(g_rb)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    err1 = float((params[AD_LEFT].cpu() - true).abs().mean())
    log(f"  recovery, {AD_STEPS} Adam steps (lr {AD_LR:g}) through rb at "
        f"{AD_RB_SPP[0]} spp from {start} toward {list(true_red)}: losses "
        f"{', '.join(f'{x:.4e}' for x in losses)}; albedo "
        f"{params[AD_LEFT].tolist()}; mean error {err0:.4f} -> {err1:.4f} "
        f"({err1 / err0:.3f} of the start, at most {AD_RECOVER:g}); "
        f"{statistics.median(times):.1f} ms a step (median)")
    if not err1 < AD_RECOVER * err0:
        raise SystemExit("autodiff: the recovery did not converge")

    # ---- K2 on the rays of a taped render ----
    entries = wavefront_k2_entries(
        ik, isx, pk, "autodiff", scene,
        lambda: render_loss(scene, params, loss_fn, spp=AD_TAPED_SPP,
                            seed=SEED), launches)
    del scene
    torch.cuda.empty_cache()
    log(f"autodiff phase: {time.perf_counter() - t_phase:.1f} s")
    return entries


# the multichip phase: a sample-sharded render's bar against the
# single-device render (tests/test_parallel.py, the JAX package's), the
# [cuda:0, cpu] mesh's shape, and the forced wavefront's there (32^2 x 4)
SHARD_ATOL = 2e-5
MIXED_WIDTH, MIXED_SPP = 64, 16
# card against CPU on the forced wavefront: a lane the two devices part
# (PERF.md §2) moves the image mean by up to about 1e-4 of it
MIXED_WF_MEAN_RTOL = 1e-3


def held_to_single(label, img, single, exact=False):
    """A sharded render against the single-device render: within
    SHARD_ATOL, or bit for bit with ``exact``."""
    err = float((img - single).abs().max()) if img.shape == single.shape \
        else math.inf
    same = img.shape == single.shape and torch.equal(img, single)
    log(f"{label}: max abs diff {err:.3e} against the single-device "
        f"render, bit-identical: {same}")
    if not bool(torch.isfinite(img).all()) or err > SHARD_ATOL \
            or exact and not same:
        raise SystemExit(f"{label}: differs from the single-device render")


def band_kernel_entry(pk, name, scene, launches, mean_rtol):
    """The path kernel's band launch (``row0``, ``n_rows``) against its
    plain version: at the parity shape the middle half of the rows, lane
    for lane, and bit for bit those rows of a whole-film launch; at the
    main shape the middle half timed beside the plain version, both
    image means within ``mean_rtol`` -> (its entry of the kernels line,
    the main band's lanes, its rows)."""
    tables, rr = scene.tables, scene.integrator.rr_depth
    cam = pk.camera_row(scene.sensors[0], scene.device)
    pw, pspp = PARITY_WIDTH, PARITY_SPP
    r0, nr = pw // 4, pw // 2
    p_args = (tables, cam, SEED, 0, pspp, pw, pw, MAX_DEPTH, rr)
    got = pk.path_radiance(*p_args, row0=r0, n_rows=nr)
    full = pk.path_radiance(*p_args)
    same = torch.equal(got, full[:, r0 * pw * pspp:(r0 + nr) * pw * pspp])
    log(f"{name}: band launch bit for bit those rows of the film's: {same}")
    if not same:
        raise SystemExit(f"{name}: a band's lanes differ from the film's")
    stats, n_stats = {}, pw * nr * pspp
    want = pk.path_radiance_reference(*p_args, stats=stats, row0=r0,
                                      n_rows=nr)
    max_abs_err = compare(develop(got, pw, pspp, nr),
                          develop(want, pw, pspp, nr), f"{name} parity",
                          mean_rtol)
    r0, nr = WIDTH // 4, WIDTH // 2
    args = (tables, cam, 0, 0, SPP, WIDTH, WIDTH, MAX_DEPTH, rr)
    k_rad, kernel_ms = timed(lambda: pk.path_radiance(*args, row0=r0,
                                                      n_rows=nr))
    p_rad, plain_ms = timed(lambda: pk.path_radiance_reference(
        *args, row0=r0, n_rows=nr), repeats=1, warm_up=False)
    max_abs_err = max(max_abs_err, compare(
        develop(k_rad, WIDTH, SPP, nr), develop(p_rad, WIDTH, SPP, nr),
        f"{name} main band", mean_rtol))
    n_paths = WIDTH * nr * SPP
    bound_ms, bound_by = bound(pk, tables, stats, n_stats, n_paths)
    log(f"{name}: band of {nr} rows, {n_paths} paths: kernel "
        f"{kernel_ms:.3f} ms, {100 * bound_ms / kernel_ms:.2f}% of bound; "
        f"plain version {plain_ms:.3f} ms")
    return {"name": name, "route": "cuda",
            "source": "mitsuba2_tpu_torch/csrc/path_kernel.cu",
            "replaces": "mitsuba2_tpu/ops/megakernel.py:365",
            "launches": launches, "max_abs_err": max_abs_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}, k_rad, (r0, nr)


def splat_band_entry(name, rad, rows, rfilter, launches):
    """The splat kernel on a band's lanes (``row0``, ``n_rows``) against
    its plain version: every block pixel within 1e-5 relative or 1e-6
    absolute -> its entry of the kernels line."""
    from mitsuba2_tpu_torch.ops import splat as sp
    r0, nr = rows
    kw = dict(row0=r0, n_rows=nr)
    block, splat_ms = timed(lambda: sp.splat(rad, 0, 0, SPP, WIDTH, WIDTH,
                                             rfilter, **kw))
    want, plain_ms = timed(lambda: sp.splat_reference(
        rad, 0, 0, SPP, WIDTH, WIDTH, rfilter, **kw), repeats=1,
        warm_up=False)
    err = (block - want).abs()
    ok = (err <= 1e-5 * want.abs()) | (err <= 1e-6)
    log(f"{name}: block {tuple(block.shape)}, block pixels within 1e-5 or "
        f"1e-6 {float(ok.float().mean()):.6f}")
    if not bool(ok.all()):
        raise SystemExit(f"{name}: splat kernel and plain version disagree")
    k = 2 * ((block.shape[1] - WIDTH) // 2) + 1
    bound_ms, bound_by = splat_bound(rad.shape[1], k,
                                     block.shape[0] * block.shape[1])
    log(f"{name}: kernel {splat_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}); plain version {plain_ms:.3f} ms")
    return {"name": name, "route": "cuda",
            "source": "mitsuba2_tpu_torch/csrc/splat_kernel.cu",
            "replaces": "mitsuba2_tpu/ops/megakernel.py:3041",
            "launches": launches, "max_abs_err": float(err.max()),
            "ms": splat_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def run_multichip(mi, pk, vk, scenes):
    """Multi-device rendering (parallel/mesh.py) over every card present,
    or two shards on the one card: the Cornell box (256^2 x 64, K1a)
    sample-sharded and banded, the materials box banded (K1's lobes family
    and the splat, its gaussian border overlap-added), the volpath slab
    sample-sharded (K3), each against the single-device render; a [cuda:0,
    cpu] mesh at 64^2 x 16 (placement and the cross-device reduce: the
    CPU shard on the plain versions) against the card alone, and the
    forced wavefront there at 32^2 x 4; the band launches of K1 and the
    splat against their plain versions -> the entries of the kernels
    line."""
    from mitsuba2_tpu_torch.ops import splat as sp
    from mitsuba2_tpu_torch.parallel.mesh import (
        default_mesh, render_multichip, render_multichip_pixel_sharded)
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    mesh = default_mesh() if n_cards > 1 else default_mesh(["cuda:0"] * 2)
    log(f"multichip: {mesh}")
    mi.set_variant("scalar_rgb")
    entries = []

    def sharded(label, scene, spp, mesh, band=False):
        """One render of the mesh, then its median time of 3."""
        fn = render_multichip_pixel_sharded if band else render_multichip
        img = fn(scene, seed=0, spp=spp, mesh=mesh)
        torch.cuda.synchronize()
        engine = scene.integrator.last_engine
        _, ms = timed(lambda: fn(scene, seed=0, spp=spp, mesh=mesh),
                      repeats=3)
        log(f"{label}: {engine}, {ms:.3f} ms median of 3")
        return img

    def single(label, scene, spp):
        img, ms = timed(lambda: scene.integrator.render(scene, seed=0,
                                                        spp=spp), repeats=3)
        if scene.integrator.last_engine != "kernel":
            raise SystemExit(f"{label} left the kernel: "
                             f"{scene.integrator.engine_reason}")
        log(f"{label} single device: {ms:.3f} ms median of 3")
        return img

    # ---- the Cornell box: samples, then bands ----
    scene = mi.load_dict(scenes.cornell_box_dict(WIDTH, WIDTH, SPP,
                                                 MAX_DEPTH))
    one = single("cornell", scene, SPP)
    held_to_single("cornell sample-sharded", sharded(
        "cornell sample-sharded", scene, SPP, mesh), one)
    pk.reset_launch_counts()
    img = render_multichip_pixel_sharded(scene, seed=0, spp=SPP, mesh=mesh)
    torch.cuda.synchronize()
    launches = pk.path_radiance.launches_by_kernel[(0, 3)]
    if launches < 1:
        raise SystemExit("cornell bands launched no path kernel")
    held_to_single("cornell banded", img, one, exact=True)
    sharded("cornell banded", scene, SPP, mesh, band=True)
    entry, _, _ = band_kernel_entry(pk, "path_kernel[cornell_bands]", scene,
                                    launches, MEAN_RTOL)
    entries.append(entry)

    # ---- the materials box banded: the lobes family and the splat ----
    flags = pk.HAS_SPHERES | pk.HAS_LOBES
    scene = mi.load_dict(scenes.cornell_materials_dict(WIDTH, WIDTH, SPP,
                                                       MAX_DEPTH))
    one = single("cornell_materials", scene, SPP)
    pk.reset_launch_counts()
    sp.reset_launch_counts()
    img = render_multichip_pixel_sharded(scene, seed=0, spp=SPP, mesh=mesh)
    torch.cuda.synchronize()
    launches = pk.path_radiance.launches_by_kernel[(flags, 3)]
    splats = sp.splat.launches
    if launches < 1 or splats < 1:
        raise SystemExit("materials bands launched no path kernel or splat")
    held_to_single("cornell_materials banded", img, one)
    sharded("cornell_materials banded", scene, SPP, mesh, band=True)
    entry, rad, rows = band_kernel_entry(
        pk, "path_kernel[materials_bands]", scene, launches,
        CAUSTIC_MEAN_RTOL)
    entries.append(entry)
    entries.append(splat_band_entry("splat_kernel[materials_bands]", rad,
                                    rows, scene.sensors[0].film.rfilter,
                                    splats))

    # ---- the volpath slab sample-sharded on K3 ----
    scene = mi.load_dict(scenes.volpath_slab_dict(WIDTH, WIDTH, VOL_SPP,
                                                  VOL_MAX_DEPTH))
    one = single("volpath", scene, VOL_SPP)
    vk.reset_launch_counts()
    img = sharded("volpath sample-sharded", scene, VOL_SPP, mesh)
    if vk.volpath_radiance.launches < 1:
        raise SystemExit("volpath shards launched no volumetric kernel")
    held_to_single("volpath sample-sharded", img, one)

    # ---- a [cuda:0, cpu] mesh: placement and the cross-device reduce ----
    mixed = default_mesh(["cuda:0", "cpu"])
    scene = mi.load_dict(scenes.cornell_box_dict(MIXED_WIDTH, MIXED_WIDTH,
                                                 MIXED_SPP, MAX_DEPTH))
    one = single("cornell 64^2 x 16", scene, MIXED_SPP)
    for band in (False, True):
        label = f"cornell on {mixed}, {'banded' if band else 'sampled'}"
        img = sharded(label, scene, MIXED_SPP, mixed, band)
        if img.device != mixed.devices[0]:
            raise SystemExit(f"{label}: the image is on {img.device}")
        compare(img, one, f"{label}, against the card alone")
    scene = mi.load_dict(scenes.cornell_box_dict(32, 32, 4, MAX_DEPTH))
    scene.integrator._disable_kernel = True
    one = scene.integrator.render(scene, seed=0, spp=4)
    img = sharded(f"cornell forced onto the wavefront on {mixed}", scene, 4,
                  mixed)
    if scene.integrator.last_engine != "wavefront":
        raise SystemExit("the forced Cornell box left the wavefront")
    compare(img, one, "forced wavefront on the mixed mesh, against the card "
            "alone", MIXED_WF_MEAN_RTOL)
    log(f"multichip phase: {time.perf_counter() - t_phase:.1f} s")
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
        m = re.search(r"isect_(inst_)?kernelILb([01])E", line)
        entry = ("isect_any" if m.group(2) == "1" else "isect_closest") \
            + ("_inst" if m.group(1) else "") if m else entry
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
    kernels += run_wavefront(mi, ik, isx, pk, scenes)
    kernels += run_volpath_wavefront(mi, ik, isx, pk, scenes)
    kernels += run_surface_wavefronts(mi, ik, isx, pk, scenes)
    kernels += run_sensor_integrator_wavefronts(mi, ik, isx, pk, scenes)
    kernels += run_scene_files(mi, ik, isx, pk, scenes, next(
        e for e in kernels if e["name"] == pk.kernel_name(pk.HAS_BVH, 3)))
    kernels += run_polarized_measured(mi, ik, isx, pk, scenes)
    kernels += run_autodiff(mi, ik, isx, pk, scenes)
    kernels += run_multichip(mi, pk, vk, scenes)
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
