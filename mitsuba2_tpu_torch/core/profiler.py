"""Profiling hooks, the card's ceilings and the kernels' work tallies.

Counterpart of ``mitsuba2_tpu/core/profiler.py`` (parity role:
include/mitsuba/core/profiler.h):

- ``PHASES``, ``profiler_phase``/``ScopedPhase``: the reference's phase
  names, annotated as ``torch.profiler.record_function`` ranges and, on a
  CUDA device, NVTX ranges.
- ``trace(log_dir)``: ``torch.profiler`` over the CPU and the CUDA device
  (what this build of PyTorch supports), exported as a Chrome trace into
  ``log_dir``; ``device_op_summary(log_dir)`` reads the newest one: device
  time by kernel and the device's busy share of the span from its first to
  its last kernel.
- ``cuda_times``/``kernel_ms``: CUDA-event timing.
- The card's ceilings: its published float32 and memory rates, and the
  face-test rates ``tools/shape_ceiling.py`` measured on it.
- The work tallies of the hand-written kernels (FLOPs counted from the
  plain versions' per-path counts) and ``roofline``, the least time the
  card could take for them; ``path_kernel_utilization_report``, the path
  kernel's per-depth utilization against those ceilings (the counterpart
  of ``megakernel_mfu_report``).
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import statistics
import tempfile
import time
from typing import NamedTuple

import torch

# the 24 phases of the reference (profiler.h:18-43), kept for parity
PHASES = [
    "InitScene", "LoadGeometry", "LoadTexture", "InitKDTree", "Render",
    "SamplingIntegratorSample", "SampleEmitterRay", "SampleEmitterDirection",
    "RayTest", "RayIntersect", "CreateSurfaceInteraction", "ImageBlockPut",
    "BSDFEvaluate", "BSDFSample", "PhaseFunctionEvaluate",
    "PhaseFunctionSample", "MediumEvaluate", "MediumSample",
    "EndpointEvaluate", "EndpointSampleRay", "EndpointSampleDirection",
    "EndpointSamplePosition", "TextureSample", "TextureEvaluate",
]

# the trace events that ran on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
NO_DEVICE_OPS = ("no device ops in trace: this run recorded host activity "
                 "only; run on a CUDA device for per-kernel device timings")


def default_log_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "mitsuba2_tpu_torch_profile")


@contextlib.contextmanager
def profiler_phase(name: str):
    """RAII phase annotation (ScopedPhase, profiler.h:90)."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


ScopedPhase = profiler_phase


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the block; on exit its Chrome trace is written into
    ``log_dir`` (made if missing) as ``<ns>.trace.json``."""
    from torch.profiler import ProfilerActivity, profile, \
        supported_activities
    log_dir = log_dir or default_log_dir()
    os.makedirs(log_dir, exist_ok=True)
    acts = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
            if a in supported_activities()]
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{time.time_ns()}.trace.json"))


def latest_trace(log_dir: str | None = None) -> str | None:
    files = sorted(glob.glob(os.path.join(log_dir or default_log_dir(),
                                          "*.trace.json")))
    return files[-1] if files else None


def device_op_times(path: str):
    """-> ({kernel name: device us}, busy us, span us) of a Chrome trace,
    or None if it holds no device events. Busy is the sum of the device
    events' durations, span the time from the first one's start to the
    last one's end."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_name, t0, t1 = {}, float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        t0, t1 = min(t0, e["ts"]), max(t1, e["ts"] + e["dur"])
    if not by_name:
        return None
    return by_name, sum(by_name.values()), t1 - t0


def device_op_summary(log_dir: str | None = None, top: int = 20) -> str:
    """Device time by kernel from the latest trace in ``log_dir``: the
    busy share of the span, then the ``top`` kernels."""
    path = latest_trace(log_dir)
    if path is None:
        return "no trace captured"
    times = device_op_times(path)
    if times is None:
        return NO_DEVICE_OPS
    by_name, busy, span = times
    lines = [f"device busy {busy / 1e3:.3f} ms of a {span / 1e3:.3f} ms "
             f"span ({100 * busy / max(span, 1e-9):.2f}%)"]
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"  {us / 1e3:9.3f} ms {100 * us / busy:6.2f}%  "
                     f"{name[:90]}")
    return "\n".join(lines)


def cuda_times(fn, runs=5, warm_up=True):
    """-> (the last call's result, milliseconds of each of ``runs`` calls
    of fn() on the card, each between two CUDA events), after one warm-up
    call unless told otherwise."""
    out = fn() if warm_up else None
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return out, times


def kernel_ms(fn, runs=5):
    """CUDA-event median of ``runs`` calls of fn() after a warm-up."""
    return statistics.median(cuda_times(fn, runs)[1])


# ---------------------------------------------------------------------------
# the card's ceilings
# ---------------------------------------------------------------------------

# the card's published peaks (H100 SXM data sheet, dense, at its full power
# limit of 700 W; every measurement in PERF.md ran on an NVIDIA H100 80GB
# HBM3 at 700.00 W): fp32 outside the tensor cores, and HBM bandwidth
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# face tests a second the whole card sustains, the path kernel's test on
# every pair (tools/shape_ceiling.py at its default shapes through
# chip_smoke.py, csrc/sweep_kernel.cu; NVIDIA H100 80GB HBM3, 700.00 W,
# 132 SMs): with the Woop rows in shared memory (2,048 faces, the path
# kernel's flag-free tier; 3.9023 G a second per SM) and read from L2
# (262,144 faces, 12.6 MB, as the BVH tier reads them; 2.2085 G per SM)
PEAK_FACE_SHARED = 515.10e9
PEAK_FACE_L2 = 291.52e9

# ---------------------------------------------------------------------------
# work tallies
# ---------------------------------------------------------------------------

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
# the face sweep (csrc/sweep_kernel.cu), per ray and face: the Woop t
# (FACE_FLOPS), then for the U and V rows [o,1] . w (three multiplies,
# three adds) and [d,0] . w (three multiplies, two adds), u and v (a
# multiply-add each) and 1 - u - v
UV_FLOPS = 2 * (6 + 5) + 2 * 2 + 2
SWEEP_PAIR_FLOPS = FACE_FLOPS + UV_FLOPS
# the TPU tool's unit, its logical product: 2 x 3C x 4 x 2R a chunk
# (benchmarks/mxu_shape_ceiling.py:74), 48 a pair, the products by the ray
# columns' 1 and 0 included; printed by tools/shape_ceiling.py, not work
# the card must do, so no bound counts it
PRODUCT_PAIR_FLOPS = 48
# bytes the sweep moves: a face's three Woop rows, a ray's o and d in and
# its t, uv, prim and hit count out
SWEEP_FACE_BYTES, SWEEP_RAY_IN_BYTES, SWEEP_RAY_OUT_BYTES = 48, 24, 20


def read_tables(tables):
    """The tables an instantiation reads: a path kernel's shared-memory
    tier reads no traversal tree, its BVH tier not the face-order Woop
    rows."""
    from ..ops.path_kernel import HAS_BVH
    if not hasattr(tables, "bvh_nodes"):
        return tables.tensors()
    skip = ({"woop"} if tables.flags & HAS_BVH
            else {"bvh_nodes", "bvh_woop", "bvh_prim"})
    return [v for k, v in tables._asdict().items()
            if isinstance(v, torch.Tensor) and k not in skip]


def path_kernel_flop_count(tables, stats, n_stats, n_paths):
    """-> the fp32 FLOPs of n_paths paths of the path kernel, from the
    per-lane work counted by the plain version (``stats`` over ``n_stats``
    lanes of the same scene)."""
    from ..ops.path_kernel import HAS_BVH, MODE_NC
    per = {k: v / n_stats for k, v in stats.items()}
    nc = tables.nc
    spectral = nc == MODE_NC["spectral"]
    shade = SHADE_FLOPS + SHADE_FLOPS_PER_CHANNEL * nc
    env = ENV_ESCAPE_FLOPS, ENV_NEE_FLOPS
    path = PATH_FLOPS
    if spectral:
        path += SPECTRAL_PATH_FLOPS_PER_CHANNEL * nc
        shade += SPECTRAL_SHADE_FLOPS_PER_CHANNEL * nc
        env = tuple(e + SPECTRAL_ENV_FLOPS_PER_CHANNEL * nc for e in env)
    if tables.flags & HAS_BVH:
        faces = ((per["walk_boxes"] + per.get("shadow_walk_boxes", 0.0))
                 * BOX_FLOPS
                 + (per["walk_faces"] + per.get("shadow_walk_faces", 0.0))
                 * FACE_FLOPS)
    else:
        faces = (per.get("rays", 0.0) * tables.n_faces
                 + per.get("shadow_faces", 0.0)) * FACE_FLOPS
    return n_paths * (
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


def face_test_count(tables, stats, n_stats, n_paths):
    """-> the face tests of n_paths paths of the path kernel, counted as
    ``path_kernel_flop_count`` counts them: every face per traced ray and
    the shadow rays' tests in the shared-memory tier, the walks' face
    tests in the BVH tier."""
    from ..ops.path_kernel import HAS_BVH
    per = {k: v / n_stats for k, v in stats.items()}
    if tables.flags & HAS_BVH:
        return n_paths * (per["walk_faces"]
                          + per.get("shadow_walk_faces", 0.0))
    return n_paths * (per.get("rays", 0.0) * tables.n_faces
                      + per.get("shadow_faces", 0.0))


def volpath_flop_count(tables, stats, n_stats, n_paths):
    """-> the fp32 FLOPs of n_paths volpath paths, from the per-lane work
    counted by the plain version (``stats`` over ``n_stats`` lanes of the
    same scene)."""
    per = {k: v / n_stats for k, v in stats.items()}
    return n_paths * (
        PATH_FLOPS
        + per["rounds"] * (VOL_ROUND_FLOPS + tables.n_faces * FACE_FLOPS)
        + (per["delta_steps"] + per["ratio_steps"]) * VOL_STEP_FLOPS
        + (per["delta_fetches"] + per["ratio_fetches"]) * VOL_FETCH_FLOPS
        + per["nee"] * VOL_NEE_FLOPS
        + per.get("shadow_faces", 0.0) * FACE_FLOPS
        + per["phase"] * VOL_PHASE_FLOPS
        + per["surface"] * VOL_SURFACE_FLOPS)


def splat_flop_count(n_lanes, k, n_block):
    """-> the splat's FLOPs: n_lanes lanes of a K x K filter into a block
    of n_block pixels."""
    return n_lanes * (2 * k * SPLAT_FILTER_FLOPS + 4 * k + 8 * k * k) \
        + n_block * 4 * k * k


def walk_flop_count(n_rays, boxes, faces):
    """-> the FLOPs of n_rays BVH walks of ``boxes`` box and ``faces`` face
    tests a ray."""
    return n_rays * (boxes * BOX_FLOPS + faces * FACE_FLOPS)


def sweep_flop_count(n_faces, n_rays, iters):
    """-> the face sweep's FLOPs: the face test of every ray and face pair
    of every iteration."""
    return SWEEP_PAIR_FLOPS * n_faces * n_rays * iters


class Bound(NamedTuple):
    """The least time the card could take for a piece of work."""
    ms: float           # the larger of ops_ms and bytes_ms
    by: str             # 'operations' or 'bytes'
    nbytes: float
    ops_ms: float       # flops over PEAK_FP32
    bytes_ms: float     # nbytes over PEAK_BYTES


def roofline(flops, tables, n_items, out_bytes=12, in_bytes=0) -> Bound:
    """The larger of ``flops`` over the fp32 peak and the bytes (the
    tables read once: ``read_tables`` of a table set, or a byte count;
    ``in_bytes`` read and ``out_bytes`` written per item) over the HBM
    rate."""
    table_bytes = tables if isinstance(tables, int) else sum(
        t.numel() * t.element_size() for t in read_tables(tables))
    nbytes = (in_bytes + out_bytes) * n_items + table_bytes
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return Bound(max(t_ops, t_bytes) * 1e3, by, nbytes, t_ops * 1e3,
                 t_bytes * 1e3)


# ---------------------------------------------------------------------------
# the path kernel's per-depth utilization
# ---------------------------------------------------------------------------

# the seed of the plain version's work counts (chip_smoke.py's parity seed)
PARITY_SEED = 7


def isotonic_fit(values):
    """The closest non-decreasing sequence to ``values`` in least squares
    (pool-adjacent-violators): kernel time cannot fall as max_depth grows,
    so per-depth differences of the fit are >= 0 where raw medians can
    invert under noise."""
    blocks = [[float(v), 1] for v in values]     # (mean, count)
    i = 0
    while i < len(blocks) - 1:
        if blocks[i][0] > blocks[i + 1][0]:
            (m0, c0), (m1, c1) = blocks[i], blocks[i + 1]
            blocks[i:i + 2] = [[(m0 * c0 + m1 * c1) / (c0 + c1), c0 + c1]]
            i = max(i - 1, 0)
        else:
            i += 1
    return [m for m, c in blocks for _ in range(c)]


def utilization_row(depth, ms, bounce_ms, noise_ms, flops, nbytes,
                    face_tests, face_peak):
    """One row of the report: the work of max_depth ``depth`` (cumulative
    over its bounces) over its kernel time ``ms``, as rates and as shares
    of the fp32 peak, the HBM rate and the face-test ceiling."""
    s = ms / 1e3
    return {"depth": depth, "kernel_ms": ms, "bounce_ms": bounce_ms,
            "noise_ms": noise_ms,
            "gflops": flops / s / 1e9, "pct_fp32": 100 * flops / s / PEAK_FP32,
            "gbs": nbytes / s / 1e9, "pct_hbm": 100 * nbytes / s / PEAK_BYTES,
            "gtests": face_tests / s / 1e9,
            "pct_face": 100 * face_tests / s / face_peak}


def path_kernel_utilization_report(scene, spp=64, max_depth=6, runs=5,
                                   ceilings=None, parity=(64, 16)):
    """The path kernel on ``scene`` (its first sensor's film size, ``spp``
    samples a pixel) at max_depth 1 .. ``max_depth``, each a CUDA-event
    median of ``runs`` after a warm-up, against the card's ceilings:
    FLOPs, bytes and face tests of each depth from the plain version's
    counts at ``parity`` (width, spp) run at that depth; face tests
    against the shared or the L2 face-test ceiling by the tables' tier
    (``ceilings``: {'shared': tests/s, 'l2': tests/s}, by default
    PEAK_FACE_SHARED and PEAK_FACE_L2). -> (report_str, rows)."""
    from ..ops import path_kernel as pk
    sensor = scene.sensors[0]
    w, h = sensor.film.crop_size
    tables = scene.tables
    cam = pk.camera_row(sensor, scene.device)
    rr = scene.integrator.rr_depth
    n = w * h * spp
    pw, pspp = parity
    ph = max(1, round(pw * h / w))
    ceilings = ceilings or {"shared": PEAK_FACE_SHARED, "l2": PEAK_FACE_L2}
    tier = "l2" if tables.flags & pk.HAS_BVH else "shared"
    face_peak = ceilings[tier]
    medians, noise, work = [], [], []
    for d in range(1, max_depth + 1):
        _, times = cuda_times(lambda: pk.path_radiance(
            tables, cam, 0, 0, spp, w, h, d, rr), runs)
        q = statistics.quantiles(times, n=4) if len(times) > 1 else [0, 0, 0]
        medians.append(statistics.median(times))
        noise.append(q[2] - q[0])
        stats = {}
        pk.path_radiance_reference(tables, cam, PARITY_SEED, 0, pspp, pw,
                                   ph, d, rr, stats=stats)
        n_stats = pw * ph * pspp
        flops = path_kernel_flop_count(tables, stats, n_stats, n)
        work.append((flops, roofline(flops, tables, n).nbytes,
                     face_test_count(tables, stats, n_stats, n)))
    fit = isotonic_fit(medians)
    rows, prev = [], 0.0
    for j, d in enumerate(range(1, max_depth + 1)):
        rows.append(utilization_row(d, medians[j], fit[j] - prev, noise[j],
                                    *work[j], face_peak))
        prev = fit[j]
    lines = [
        f"path kernel utilization ({tables.n_faces} faces, {tier} tier, "
        f"{n / 1e6:.2f}M lanes, {w}x{h}@{spp}spp; ceilings: fp32 "
        f"{PEAK_FP32 / 1e12:.0f} TFLOP/s, HBM {PEAK_BYTES / 1e12:.2f} TB/s, "
        f"face tests {face_peak / 1e9:.1f} G/s from {tier})",
        f"columns are cumulative: the work of max_depth d over its kernel "
        f"time; FLOPs, bytes and face tests from the plain version's counts "
        f"at {pw}x{ph}@{pspp}spp; bounce_ms from the isotonic fit",
        "depth kernel_ms bounce_ms noise_ms  GFLOP/s %fp32   GB/s  %HBM "
        "Gface/s  %face"]
    for r in rows:
        lines.append(
            f"{r['depth']:5d} {r['kernel_ms']:9.3f} {r['bounce_ms']:9.3f} "
            f"{r['noise_ms']:8.3f} {r['gflops']:8.1f} {r['pct_fp32']:5.2f} "
            f"{r['gbs']:6.1f} {r['pct_hbm']:5.2f} {r['gtests']:7.2f} "
            f"{r['pct_face']:6.2f}")
    return "\n".join(lines), rows
