"""The path kernel's time on each of its paths, chip_smoke.py's, the
volumetric kernel's (K3) and the ray queries' (K2).

    python mitsuba2_tpu_torch/tools/time_paths.py [--repeats 5] [--rounds 1]
        [--paths biggeo,hero] [--isect] [--save DIR] [--compare DIR]

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
It imports the package
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
import statistics
import subprocess
import sys
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
                    help="comma-separated PATHS names, or volpath for "
                    "VOL_PATHS (default: all)")
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
    same = compare_outputs(paths, args.save, args.compare)
    ms = {name: [] for name, _ in loaded}
    for r in range(args.rounds):
        for name, call in loaded:
            t = statistics.median(cuda_times(call, args.repeats)[1])
            ms[name].append(t)
            print(f"round {r}: {name} {t:.4f} ms", flush=True)
    print(json.dumps({"card": card, "ms": ms, "ptxas": ptxas}))
    return 0 if same else 1


def compare_outputs(paths, save, against):
    """Each path's output of one launch written to ``save`` and held
    against the one in ``against`` -> whether every path held is
    bit-identical."""
    ok = True
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
            ok = ok and same
            print(f"{name}: bit-identical to {against}: {same}; lanes "
                  f"that differ {float(differ.float().mean()):.6f}, "
                  f"largest relative difference {rel:.3e}", flush=True)
    return ok


if __name__ == "__main__":
    sys.exit(main())
