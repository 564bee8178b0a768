"""The path kernel's time on each of its paths, chip_smoke.py's.

    python mitsuba2_tpu_torch/tools/time_paths.py [--repeats 5] [--rounds 1]

Loads each path scene of ``PATHS`` (the table chip_smoke.py drives) at
its main shape (the Cornell box in rgb, spectral and mono mode, matpreview
in rgb and spectral, 256x256 at 64 spp, depth 6; biggeo and hero at 32
spp, depth 5; the materials box in rgb and spectral at 64 spp, depth 6,
and in mono at 64x64 at 16 spp) and prints the CUDA-event median of
``--repeats`` launches of ``ops/path_kernel.py path_radiance`` after a
warm-up, ``--rounds`` times over the scenes, then one JSON line {"card":
..., "ms": {path: [median of each round]}}. It imports the package
``mitsuba2_tpu_torch`` from the Python path, so that run as a file with
``PYTHONPATH`` set to another checkout it times that checkout's kernel on
this file's ``PATHS`` (for a comparison of two commits within one run on
one card). Builds the path kernel's libraries first. Exits non-zero
without a CUDA device.
"""

import argparse
import json
import statistics
import subprocess
import sys
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1)
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
    build.build_all(pk.libraries())
    loaded = []
    for p in PATHS:
        mi.set_variant(p.variant)
        scene = mi.load_dict(p.make(scenes)(p.width, p.width, p.spp,
                                            p.max_depth))
        call = (scene.tables, pk.camera_row(scene.sensors[0], scene.device),
                0, 0, p.spp, p.width, p.width, p.max_depth,
                scene.integrator.rr_depth)
        loaded.append((p.name, call))
    ms = {name: [] for name, _ in loaded}
    for r in range(args.rounds):
        for name, call in loaded:
            t = statistics.median(cuda_times(
                lambda: pk.path_radiance(*call), args.repeats)[1])
            ms[name].append(t)
            print(f"round {r}: {name} {t:.4f} ms", flush=True)
    print(json.dumps({"card": card, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
