"""The path kernel's time on each of its paths, chip_smoke.py's, the
volumetric kernel's (K3) and the ray queries' (K2).

    python mitsuba2_tpu_torch/tools/time_paths.py [--repeats 5] [--rounds 1]
        [--paths biggeo,hero,volpath,splat] [--isect] [--save DIR]
        [--compare DIR]

Loads each path scene of ``PATHS`` (the table chip_smoke.py drives) at
its main shape (the Cornell box in rgb, spectral and mono mode, matpreview
in rgb and spectral, 256x256 at 64 spp, depth 6; biggeo and hero at 32
spp, depth 5; the materials box in rgb and spectral at 64 spp, depth 6,
and in mono at 64x64 at 16 spp) and prints the CUDA-event median of
``--repeats`` launches of ``ops/path_kernel.py path_radiance`` after a
warm-up, ``--rounds`` times over the scenes, then one JSON line {"card":
..., "ms": {path: [median of each round]}, "ptxas": {path: registers and
spills}}. ``--paths`` keeps the named paths only (and builds only their
libraries). ``--isect`` adds the intersection kernel on biggeo at
chip_smoke.py's shapes: ``isect_closest`` on the 2,097,152 camera rays of
its 256x256x32 spp image, and ``isect_closest`` and ``isect_any`` on as
many rays from their hits toward the light (``light_rays``), as
"isect_closest[camera]", "isect_closest[light]" and "isect_any[light]".
The volumetric kernel's paths (``VOL_PATHS``, all kept by the name
"volpath"): the bench slab ("volpath", bench.py's volpath config at
256x256, 16 spp, depth 16) and the dense slab ("volpath_dense", sigma_t
16 times the bench's, where walks run out of their budgets) are timed;
one small scene per instantiation ("volpath_f0" to "volpath_f15", as
tests/test_torch_volpath.py ``cuda_scenes`` builds them) only enters
``--save`` and ``--compare``.
The film splat's passes (``SPLAT_PASSES``, all kept by the name "splat"):
the materials box's 256x256x64 spp pass under its gaussian film (its lanes
from one launch of the path kernel, seed 0, as chip_smoke.py splats them)
and 256x256x64 spp of random lanes (a seeded ``torch.Generator``) under a
lanczos (K = 7), a tent (K = 3) and a wide gaussian (stddev 1.125, K = 9)
film. Each is timed per call, as the others are, back to back (CUDA events
around ``SPLAT_BATCH`` calls, over the count, so that the host's launch
overhead hides behind the card) and by its host part alone
(``host_ms``), beside the yardstick of its tap product alone: one
``torch.bmm`` of the pass's filter values, (pixels, K, spp) @ (pixels,
spp, 4K), precomputed ("bmm[<pass>]"). In ``--compare`` a splat's block
is held against the other checkout's within the splat's bar
(``splat_within_bar``), not bit for bit: two designs sum in another
order. It imports the package
``mitsuba2_tpu_torch`` from the Python path, so that run as a file with
``PYTHONPATH`` set to another checkout it times that checkout's kernel on
this file's ``PATHS`` (for a comparison of two commits within one run on
one card). ``--save DIR`` writes each path's output of one launch (seed 0)
to ``DIR/<path>.pt``; ``--compare DIR`` holds each path's output against
the one saved there (by another checkout) and prints whether it is
bit-identical, the share of lanes that differ and the largest relative
difference, and exits non-zero if any path differs; both launch each path
a second time, which must give the same output bit for bit. Builds the path
kernel's libraries first. Exits non-zero without a CUDA device.
"""

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch


class PathScene(NamedTuple):
    """One path of the path kernel at its main shape (chip_smoke.py drives
    each, this tool times each)."""
    name: str
    variant: str
    builder: str        # its scene dict builder in python/test/scenes.py
    width: int          # width = height
    spp: int
    max_depth: int
    mesh: tuple = ()    # the builder's mesh resolution, after the shape

    def make(self, scenes):
        """-> (width, height, spp, max_depth) -> the scene dict, from the
        given ``python/test/scenes.py`` module."""
        build = getattr(scenes, self.builder)
        return lambda w, h, spp, depth: build(w, h, spp, depth, *self.mesh)


# bench.py's shapes (256x256 at 64 spp, depth 6; the big meshes at 32 spp,
# depth 5, biggeo at 512x257), the materials box in mono at the parity shape
PATHS = (
    PathScene("cornell", "scalar_rgb", "cornell_box_dict", 256, 64, 6),
    PathScene("matpreview", "scalar_rgb", "matpreview_dict", 256, 64, 6),
    PathScene("cornell_spectral", "scalar_spectral", "cornell_box_dict", 256,
              64, 6),
    PathScene("matpreview_spectral", "scalar_spectral", "matpreview_dict",
              256, 64, 6),
    PathScene("cornell_mono", "scalar_mono", "cornell_box_dict", 256, 64, 6),
    PathScene("biggeo", "scalar_rgb", "bumpy_sphere_dict", 256, 32, 5,
              (512, 257)),
    PathScene("hero", "scalar_rgb", "hero_serialized_dict", 256, 32, 5),
    PathScene("cornell_materials", "scalar_rgb", "cornell_materials_dict",
              256, 64, 6),
    PathScene("cornell_materials_spectral", "scalar_spectral",
              "cornell_materials_dict", 256, 64, 6),
    PathScene("cornell_materials_mono", "scalar_mono",
              "cornell_materials_dict", 64, 16, 6),
)


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


class VolScene(NamedTuple):
    """One scene of the volumetric kernel (``vol_dict`` builds it)."""
    name: str
    width: int          # width = height
    spp: int
    max_depth: int
    scale: float = 1.0  # of sigma_t
    flags: int = -1     # the instantiation scene's flags, -1: the slab
    timed: bool = True


VOL_PATHS = (
    VolScene("volpath", 256, 16, 16),
    VolScene("volpath_dense", 256, 16, 16, scale=16.0),
) + tuple(VolScene(f"volpath_f{f}", 16, 8, 8, flags=f, timed=False)
          for f in range(16))


def vol_dict(p, scenes, T, vk):
    """The scene dict of a ``VOL_PATHS`` row: the bench slab with sigma_t
    times ``scale``, or for an instantiation the slab with g 0.3 (HG) or 0,
    a GGX aluminium floor and a glass pane as the flags say, rr_depth 2,
    under volpath or volpathmis (tests/test_torch_volpath.py
    ``cuda_scenes``)."""
    if p.flags < 0:
        d = scenes.volpath_slab_dict(p.width, p.width, p.spp, p.max_depth)
        d["slab"]["interior"]["scale"] = p.scale
        return d
    extra = {}
    if p.flags & vk.HAS_GGX:
        extra["metal"] = {"type": "rectangle",
                          "to_world": (T.translate([0, -2.5, 0])
                                       @ T.rotate([1, 0, 0], -90)
                                       @ T.scale(3.0)),
                          "bsdf": {"type": "roughconductor", "alpha": 0.4,
                                   "distribution": "ggx", "material": "Al"}}
    if p.flags & vk.HAS_DIEL:
        extra["glass"] = {"type": "rectangle",
                          "to_world": T.translate([0, 0, 1.6]) @ T.scale(1.4),
                          "bsdf": {"type": "dielectric"}}
    d = scenes.volpath_slab_dict(p.width, p.width, p.spp, p.max_depth,
                                 g=0.3 if p.flags & vk.HAS_HG else 0.0,
                                 **extra)
    d["integrator"]["rr_depth"] = 2
    if p.flags & vk.MIS:
        d["integrator"]["type"] = "volpathmis"
    return d


def vol_calls(mi, scenes):
    """The volumetric kernel's calls -> [(name, call, timed)]."""
    from mitsuba2_tpu_torch.ops import path_kernel as pk
    from mitsuba2_tpu_torch.ops import volpath_kernel as vk
    mi.set_variant("scalar_rgb")
    out = []
    for p in VOL_PATHS:
        scene = mi.load_dict(vol_dict(p, scenes, mi.Transform, vk))
        integ = scene.integrator
        call = (vk.build_vol_tables(scene),
                pk.camera_row(scene.sensors[0], scene.device), 0, 0, p.spp,
                p.width, p.width, p.max_depth, integ.rr_depth)
        out.append((p.name, lambda call=call, mis=integ.USE_MIS:
                    vk.volpath_radiance(*call, mis=mis), p.timed))
    return out


class SplatPass(NamedTuple):
    """One pass of the film splat: its lanes and its film filter."""
    name: str
    rfilter: dict       # the filter's dict; {} for the scene's own
    width: int          # width = height
    spp: int
    seed: int = -1      # of random lanes; -1: the materials box's pass


SPLAT_PASSES = (
    SplatPass("splat_gaussian", {}, 256, 64),
    SplatPass("splat_lanczos", {"type": "lanczos"}, 256, 64, seed=3),
    SplatPass("splat_tent", {"type": "tent"}, 256, 64, seed=4),
    SplatPass("splat_gaussian_k9", {"type": "gaussian", "stddev": 1.125}, 256,
              64, seed=5),
)
# calls of a back-to-back timing
SPLAT_BATCH = 20


def splat_calls(mi, scenes):
    """The film splat's passes -> [(name, call, (rad, spp, width, rfilter))]
    (the path kernel's lobes library built)."""
    from mitsuba2_tpu_torch.ops import path_kernel as pk
    from mitsuba2_tpu_torch.ops import splat as sp
    mi.set_variant("scalar_rgb")
    out = []
    for p in SPLAT_PASSES:
        if p.seed < 0:
            scene = mi.load_dict(scenes.cornell_materials_dict(
                p.width, p.width, p.spp, 6))
            rad = pk.path_radiance(
                scene.tables, pk.camera_row(scene.sensors[0], scene.device),
                0, 0, p.spp, p.width, p.width, 6, scene.integrator.rr_depth)
            rf = scene.sensors[0].film.rfilter
        else:
            g = torch.Generator(device="cuda").manual_seed(p.seed)
            rad = torch.rand(3, p.width * p.width * p.spp, generator=g,
                             device="cuda")
            rf = mi.load_dict(p.rfilter)
        arg = (rad, p.spp, p.width, rf)
        out.append((p.name, lambda arg=arg: sp.splat(
            arg[0], 0, 0, arg[1], arg[2], arg[2], arg[3]), arg))
    return out


def tap_operands(rad, spp, width, rfilter):
    """-> (fy (P, K, spp), u (P, spp, 4K)) of a pass of P = width^2 pixels:
    each sample's filter values along y, and its [r, g, b, 1] times its
    filter values along x, so that ``torch.bmm(fy, u)`` is every pixel's
    K x K x 4 tap sums (the yardstick of the tap product alone)."""
    from mitsuba2_tpu_torch.ops import path_kernel as pk
    from mitsuba2_tpu_torch.render.film import border
    n, P = rad.shape[1], width * width
    key, _ = pk.lane_keys(0, 0, spp, torch.arange(n, device=rad.device))
    jx, jy = pk._rng2(key, 0)
    b = border(rfilter)
    offs = [(o + 0.5) for o in range(-b, b + 1)]
    fy = torch.stack([rfilter.eval(o - jy) for o in offs])      # (K, n)
    fx = torch.stack([rfilter.eval(o - jx) for o in offs])
    vals4 = torch.cat([rad, torch.ones((1, n), device=rad.device)])
    u = fx[:, None] * vals4[None]                                # (K, 4, n)
    return (fy.reshape(len(offs), P, spp).permute(1, 0, 2).contiguous(),
            u.reshape(len(offs), 4, P, spp).permute(2, 3, 0, 1)
            .reshape(P, spp, 4 * len(offs)).contiguous())


def batched_ms(call, batch=SPLAT_BATCH, runs=5):
    """-> median over ``runs`` of the CUDA-event time of ``batch`` calls
    back to back, over ``batch`` (after a warm-up)."""
    call()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(batch):
            call()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / batch)
    return statistics.median(times)


def host_ms(call, runs=5):
    """-> median milliseconds of the host's part of a call (from its start
    to its return, the card idle before it), after a warm-up."""
    call()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


# the film filters whose weights change sign: their blocks are held against
# the block's largest value (tests/test_torch_splat.py)
SIGNED_FILTERS = ("MitchellFilter", "CatmullRomFilter", "LanczosFilter")


def splat_within_bar(got, want, signed):
    """-> the share of block pixel values within the splat's bar (PERF.md
    section 2): 1e-5 relative or 1e-6 absolute, for a signed filter 1e-6 of
    the block's largest value."""
    err = (got - want).abs()
    atol = 1e-6 * (float(want.abs().max()) if signed else 1.0)
    return float(((err <= 1e-5 * want.abs()) | (err <= atol)).float()
                 .mean())


def splat_ptxas(build_log):
    """-> {kernel: 'N registers; ... spill ...'} of the splat library's
    kernels from its ``.log`` (template arguments as <b, filter>)."""
    out, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"(splat_[a-z]+)((?:ILi\d+E(?:Li\d+E)*E)?)E", line)
        if m and "entry function" in line:
            args = re.findall(r"Li(\d+)E", m.group(2))
            name = m.group(1) + (f"<{', '.join(args)}>" if args else "")
        if name is None:
            continue
        if "spill" in line or "stack frame" in line:
            out[name] = line.strip()
        elif "Used" in line and "registers" in line:
            out[name] = f"{line.split('Used', 1)[1].strip()}; " \
                f"{out.get(name, '')}"
    return out


# the ray queries' rays: biggeo's camera rays and their seed
ISECT_PATH, ISECT_SEED = "biggeo", 7


def isect_calls(mi, scenes):
    """The intersection kernel's timed calls on biggeo (``--isect``) ->
    [(name, call)]."""
    from mitsuba2_tpu_torch.core.ray import Ray
    from mitsuba2_tpu_torch.ops import intersect_kernel as ik
    from mitsuba2_tpu_torch.ops import path_kernel as pk
    p = next(p for p in PATHS if p.name == ISECT_PATH)
    mi.set_variant(p.variant)
    scene = mi.load_dict(p.make(scenes)(p.width, p.width, p.spp,
                                        p.max_depth))
    cam = Ray.make(*pk.camera_rays(
        pk.camera_row(scene.sensors[0], scene.device), p.width, p.width,
        p.spp, ISECT_SEED))
    hits = scene.ray_intersect_preliminary(cam)
    light = light_rays(scene, Ray, hits, cam, cam.o.shape[0], ISECT_SEED)
    t = scene.tables
    return [("isect_closest[camera]", lambda: ik.isect_closest(t, *cam)),
            ("isect_closest[light]", lambda: ik.isect_closest(t, *light)),
            ("isect_any[light]", lambda: ik.isect_any(t, *light))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--paths", default="",
                    help="comma-separated PATHS names, volpath for "
                    "VOL_PATHS, splat for SPLAT_PASSES (default: all)")
    ap.add_argument("--isect", action="store_true")
    ap.add_argument("--save", default="",
                    help="directory to write each path's output to")
    ap.add_argument("--compare", default="",
                    help="directory of outputs to hold each path against")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_paths: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    import mitsuba2_tpu_torch as mi
    from mitsuba2_tpu_torch.core.profiler import cuda_times
    from mitsuba2_tpu_torch.ops import build, path_kernel as pk
    from mitsuba2_tpu_torch.python.test import scenes
    print(f"{card}; {mi.__file__}", flush=True)
    keep = set(filter(None, args.paths.split(",")))
    loaded, insts = [], {}
    for p in PATHS:
        if keep and p.name not in keep:
            continue
        mi.set_variant(p.variant)
        scene = mi.load_dict(p.make(scenes)(p.width, p.width, p.spp,
                                            p.max_depth))
        tables = scene.tables
        call = (tables, pk.camera_row(scene.sensors[0], scene.device),
                0, 0, p.spp, p.width, p.width, p.max_depth,
                scene.integrator.rr_depth)
        loaded.append((p.name, lambda call=call: pk.path_radiance(*call)))
        insts[p.name] = (tables.flags & pk.TEMPLATE_FLAGS, tables.nc)
    paths = dict(loaded)
    jobs = [("path_kernel", pk.library_defines(nc, bool(f & pk.HAS_LOBES)))
            for f, nc in set(insts.values())]
    if args.isect:
        from mitsuba2_tpu_torch.ops import intersect_kernel as ik
        jobs += ik.libraries()
    vol = not keep or "volpath" in keep
    if vol:
        from mitsuba2_tpu_torch.ops import volpath_kernel as vk
        jobs += vk.libraries()
    splat = not keep or "splat" in keep
    if splat:
        from mitsuba2_tpu_torch.ops import splat as sp
        jobs += sp.libraries()
        lobes = ("path_kernel", pk.library_defines(3, True))
        jobs += [] if lobes in jobs else [lobes]
    build.build_all(jobs)
    ptxas = {}
    for name, (f, nc) in insts.items():
        log = build.library_path("path_kernel", pk.library_defines(
            nc, bool(f & pk.HAS_LOBES))).with_suffix(".log")
        ptxas[name] = build.ptxas_report(log.read_text()).get((f, nc)) \
            if log.exists() else None
        print(f"{name}: {pk.kernel_name(f, nc)}: {ptxas[name]}", flush=True)
    if vol:
        calls = vol_calls(mi, scenes)
        paths.update((name, call) for name, call, _ in calls)
        loaded += [(name, call) for name, call, timed in calls if timed]
        log = build.library_path("volpath_kernel").with_suffix(".log")
        report = build.ptxas_report(log.read_text(), "volpath_kernel") \
            if log.exists() else {}
        ptxas["volpath"] = report.get((vk.HAS_HG,))
        print(f"volpath: {vk.kernel_name(vk.HAS_HG)}: {ptxas['volpath']}",
              flush=True)
    if args.isect:
        loaded += isect_calls(mi, scenes)
    batched, bars = {}, {}
    if splat:
        log = build.library_path("splat_kernel").with_suffix(".log")
        ptxas["splat"] = splat_ptxas(log.read_text()) if log.exists() \
            else None
        print(f"splat_kernel: {ptxas['splat']}", flush=True)
        for name, call, arg in splat_calls(mi, scenes):
            paths[name] = call
            loaded.append((name, call))
            bars[name] = type(arg[3]).__name__ in SIGNED_FILTERS
            fy, u = tap_operands(*arg)
            loaded.append((f"bmm[{name}]", lambda fy=fy, u=u:
                           torch.bmm(fy, u)))
            batched[name] = call
    same = compare_outputs(paths, args.save, args.compare, bars)
    ms = {name: [] for name, _ in loaded}
    ms_batched = {name: [] for name in batched}
    ms_host = {name: [] for name in batched}
    for r in range(args.rounds):
        for name, call in loaded:
            t = statistics.median(cuda_times(call, args.repeats)[1])
            ms[name].append(t)
            print(f"round {r}: {name} {t:.4f} ms", flush=True)
            if name in batched:
                t = batched_ms(call, runs=args.repeats)
                ms_batched[name].append(t)
                print(f"round {r}: {name} back to back {t:.4f} ms a call",
                      flush=True)
                t = host_ms(call, runs=args.repeats)
                ms_host[name].append(t)
                print(f"round {r}: {name} host {t:.4f} ms a call",
                      flush=True)
    print(json.dumps({"card": card, "ms": ms, "ms_batched": ms_batched,
                      "ms_host": ms_host, "ptxas": ptxas}))
    return 0 if same else 1


def compare_outputs(paths, save, against, bars=None):
    """Each path's output of one launch written to ``save`` and held
    against the one in ``against`` -> whether every path held is
    bit-identical, or for a name in ``bars`` ({splat pass: whether its
    filter is signed}) within the splat's bar."""
    ok, bars = True, bars or {}
    if not (save or against):
        return ok
    for name, call in paths.items():
        out = call()
        # lanes reach threads in no fixed order: a relaunch must agree
        again = torch.equal(out, call())
        ok = ok and again
        print(f"{name}: two launches bit-identical: {again}", flush=True)
        if save:
            Path(save).mkdir(parents=True, exist_ok=True)
            torch.save(out.cpu(), Path(save) / f"{name}.pt")
        if against:
            want = torch.load(Path(against) / f"{name}.pt").to(out.device)
            differ = (out != want).any(0)
            rel = float(((out - want).abs() / want.abs().clamp(min=1e-3))
                        .max())
            same = not bool(differ.any())
            if name in bars:
                share = splat_within_bar(out, want, bars[name])
                ok = ok and share == 1.0
                print(f"{name}: block values within the splat's bar of "
                      f"{against}: {share:.6f}; bit-identical: {same}",
                      flush=True)
            else:
                ok = ok and same
            print(f"{name}: bit-identical to {against}: {same}; lanes "
                  f"that differ {float(differ.float().mean()):.6f}, "
                  f"largest relative difference {rel:.3e}", flush=True)
    return ok


if __name__ == "__main__":
    sys.exit(main())
