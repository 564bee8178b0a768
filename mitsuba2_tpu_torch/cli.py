"""Command-line renderer (parity: src/mitsuba/mitsuba.cpp:33-294 and
``mitsuba2_tpu.cli``).

Usage:
    python -m mitsuba2_tpu_torch [options] <scene.xml|scene.json>

Flags as the reference's: -m variant, -o output, -D key=value parameter
substitution, -s spp override, --seed, --sensor, -t threads (accepted and
advisory), -a search paths, -v verbose, --timeout seconds, --multichip
(samples sharded over every device: parallel/mesh.py ``render_multichip``
over ``default_mesh()``, every CUDA device, or with --cpu the CPU alone).
The render runs on the card unless --cpu asks for the CPU. SIGHUP writes
the passes finished so far (``develop_partial``); the first SIGINT cancels
the render after its current pass (``cancel``), a second one interrupts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="mitsuba2_tpu_torch",
        description="Mitsuba-class renderer on PyTorch and CUDA")
    p.add_argument("scene", help="scene file (.xml or .json dict)")
    p.add_argument("-m", "--mode", default="scalar_rgb",
                   help="variant, e.g. scalar_rgb / scalar_spectral")
    p.add_argument("-o", "--output", default=None,
                   help="output image (exr/pfm/png); default: the scene's "
                        "name with .exr")
    p.add_argument("-D", "--define", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="scene parameter substitution ($key in XML)")
    p.add_argument("-s", "--spp", type=int, default=None,
                   help="override samples per pixel")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sensor", type=int, default=0, help="sensor index")
    p.add_argument("-t", "--threads", type=int, default=None,
                   help="accepted for compatibility (the card's parallelism "
                        "is the kernels')")
    p.add_argument("-a", "--append-path", action="append", default=[],
                   help="add a file resolver search path")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("--multichip", action="store_true",
                   help="shard samples over every device (every CUDA "
                        "device; with --cpu the CPU alone)")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (the plain versions of the "
                        "kernels)")
    p.add_argument("--timeout", type=float, default=-1.0,
                   help="stop rendering after this many seconds and "
                   "develop the passes finished so far")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import signal

    import mitsuba2_tpu_torch as mi
    from mitsuba2_tpu_torch.core.fresolver import file_resolver
    from mitsuba2_tpu_torch.core.logger import Debug, Info, Log, set_log_level
    from mitsuba2_tpu_torch.utils.io_image import write_image

    if args.verbose:
        set_log_level(Debug)
    if args.cpu:
        mi.set_device("cpu")
    for path in args.append_path:
        file_resolver().append(path)

    mi.set_variant(args.mode)
    params = {}
    for d in args.define:
        k, _, v = d.partition("=")
        params[k] = v

    Log(Info, "Loading scene %s (variant %s, device %s)", args.scene,
        args.mode, mi.device())
    t0 = time.time()
    if args.scene.endswith(".json"):
        with open(args.scene) as f:
            scene = mi.load_dict(json.load(f))
    else:
        scene = mi.load_file(args.scene, params=params)
    Log(Info, "Scene loaded in %.2fs: %d shapes, %d emitters, %d faces",
        time.time() - t0, len(scene.shapes), len(scene.emitters),
        scene.tables.n_faces)

    if scene.integrator is None:
        scene.integrator = mi.load_dict({"type": "path"})
    sensor = scene.sensors[args.sensor]
    spp = args.spp or sensor.sampler.sample_count
    integrator = scene.integrator
    if args.timeout > 0:
        integrator.timeout = args.timeout

    out = args.output
    if out is None:
        out = os.path.splitext(args.scene)[0] + ".exr"

    # SIGHUP develops the passes finished so far; a second SIGINT (after
    # the cooperative cancel) interrupts (mitsuba.cpp:95-121)
    def _on_hup(signum, frame):
        partial = integrator.develop_partial()
        if partial is not None:
            write_image(out, partial)
            Log(Info, "Wrote partial image %s (SIGHUP)", out)

    def _on_int(signum, frame):
        if integrator._cancel:
            raise KeyboardInterrupt
        Log(Info, "Cancelling render (finishing the current pass) ...")
        integrator.cancel()

    if hasattr(signal, "SIGHUP"):
        try:
            signal.signal(signal.SIGHUP, _on_hup)
        except ValueError:
            pass      # not the main thread (e.g. under a test runner)
    try:
        signal.signal(signal.SIGINT, _on_int)
    except ValueError:
        pass

    Log(Info, "Rendering %dx%d @ %d spp with %s ...",
        sensor.film.crop_size[0], sensor.film.crop_size[1], spp,
        type(integrator).__name__)
    t0 = time.time()
    if args.multichip:
        from mitsuba2_tpu_torch.parallel.mesh import (default_mesh,
                                                      render_multichip)
        mesh = default_mesh()
        Log(Info, "Sharding samples over %d device(s): %s", mesh.size,
            ", ".join(str(d) for d in mesh.devices))
        img = render_multichip(scene, sensor=args.sensor, seed=args.seed,
                               spp=spp, mesh=mesh)
    else:
        img = integrator.render(scene, sensor=args.sensor, seed=args.seed,
                                spp=spp)
    img = img.cpu().numpy()
    dt = time.time() - t0
    n_paths = sensor.film.crop_size[0] * sensor.film.crop_size[1] * spp
    Log(Info, "Rendered in %.2fs (%.2f Mpaths/s) on the %s engine", dt,
        n_paths / dt / 1e6, getattr(integrator, "last_engine", "wavefront"))
    write_image(out, img)
    Log(Info, "Wrote %s", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
