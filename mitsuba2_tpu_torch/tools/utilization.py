"""The path kernel's per-depth utilization on the card.

    python -m mitsuba2_tpu_torch.tools.utilization [--scene cornell] \
        [--width 256] [--spp 64] [--max-depth 6]

Counterpart of benchmarks/tpu_mfu.py. Loads the Cornell box or the
matpreview scene (``scalar_rgb``, width x width) and prints
``core/profiler.py path_kernel_utilization_report``: the path kernel at
max_depth 1 .. --max-depth, CUDA-event medians of 5, with the FLOPs, bytes
and face tests of each depth (from the plain version's counts at 64x64x16
spp) as rates and as shares of the card's fp32 peak, its HBM rate and the
face-test ceiling of the scene's tier (``PEAK_FACE_SHARED`` or
``PEAK_FACE_L2``, measured by tools/shape_ceiling.py). Prints the card's
name and power limit first. Exits non-zero without a CUDA device.
"""

import argparse
import subprocess
import sys

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="cornell",
                    choices=["cornell", "matpreview"])
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--max-depth", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("utilization: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    import mitsuba2_tpu_torch as mi
    from ..core.profiler import path_kernel_utilization_report
    from ..ops import build, path_kernel as pk
    from ..python.test.scenes import cornell_box_dict, matpreview_dict
    mi.set_variant("scalar_rgb")
    build.build_all(pk.libraries()[:1])
    make = cornell_box_dict if args.scene == "cornell" else matpreview_dict
    scene = mi.load_dict(make(args.width, args.width, args.spp,
                              args.max_depth))
    report, _ = path_kernel_utilization_report(scene, args.spp,
                                               args.max_depth)
    print(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
