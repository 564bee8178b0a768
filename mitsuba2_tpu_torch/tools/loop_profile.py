"""The path kernel's loop, by phase, on the card.

    python -m mitsuba2_tpu_torch.tools.loop_profile [--scenes cornell,...]

Builds csrc/path_kernel.cu's libraries of each path's color mode
(without and with the lobes flag) a second time with ``-DPK_PROFILE=1``,
under which each warp sums its clock cycles by phase of the loop (refill,
which in the lobes loop includes the wait at its first barrier for the
block's slowest warp; closest hit; regroup; shading; and the shadow ray's
sweep or walk where the shading still runs it, the BVH and the rgb and
spectral lobes families: the warp's longest such sweep, taken out of the
shading's cycles) and counts its iterations, and runs that build once on
each path of ``tools/time_paths.py PATHS`` at its main shape
(``--scenes`` picks some). In the shared-memory families without the
lobes flag and in the mono lobes ones the shadow ray is traced in the
closest-hit sweep of the next iteration and counts as closest hit (their
shadow phase reads 0). The profiled output must equal the committed
kernel's bit for bit. Prints the card's name and power limit, then per
path the profiled build's registers and spills (ptxas) and each phase's
share of the cycles, and one JSON line {path: {phase: share}}. Exits
non-zero without a CUDA device.
"""

import argparse
import ctypes
import json
import subprocess
import sys

import torch

# the phases, in the order of their counters
PHASES = ("refill", "closest_hit", "regroup", "shade", "shadow")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenes", default="",
                    help="comma-separated path names (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("loop_profile: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    import mitsuba2_tpu_torch as mi
    from ..ops import build, path_kernel as pk
    from ..python.test import scenes as S
    from .time_paths import PATHS

    loaded = []
    for p in PATHS:
        if args.scenes and p.name not in args.scenes.split(","):
            continue
        mi.set_variant(p.variant)
        loaded.append((p, mi.load_dict(p.make(S)(p.width, p.width, p.spp,
                                                 p.max_depth))))

    def defines(tables):
        d = pk.library_defines(tables.nc, bool(tables.flags & pk.HAS_LOBES))
        return d, {**d, "PK_PROFILE": 1}

    # each library once: paths share them
    libs = {tuple(sorted(d.items())): d for p, s in loaded
            for d in defines(s.tables)}
    build.build_all([("path_kernel", d) for d in libs.values()])

    def launch(d, tables, call):
        cam, spp, w, depth, rr = call
        out = torch.empty((3, w * w * spp), device="cuda")
        # the lane counter, then (profiled) 64-bit counters: the phases'
        # cycles, then the warp iterations
        counter = torch.zeros(2 + 2 * (len(PHASES) + 1), dtype=torch.int32,
                              device="cuda")
        info = (ctypes.c_int * len(pk.LAUNCH_INFO))()
        err = pk._path_render(d)(ctypes.byref(pk._path_args(
            tables, cam, 0, 0, spp, w, w, depth, rr, out, counter)),
            torch.cuda.current_stream().cuda_stream, info)
        if err != 0:
            raise RuntimeError(f"path_kernel launch failed: {err}")
        torch.cuda.synchronize()
        return out, counter

    res = {}
    for p, scene in loaded:
        t = scene.tables
        call = (pk.camera_row(scene.sensors[0], scene.device), p.spp,
                p.width, p.max_depth, scene.integrator.rr_depth)
        plain, prof = defines(t)
        ref, _ = launch(plain, t, call)
        out, counter = launch(prof, t, call)
        if not torch.equal(out, ref):
            raise SystemExit(f"{p.name}: the profiled output differs from "
                             f"the committed kernel's")
        c = counter[2:].cpu().numpy().view("uint64")
        n_ph = len(PHASES)
        total = max(int(c[:n_ph].sum()), 1)
        res[p.name] = {ph: float(c[k]) / total
                       for k, ph in enumerate(PHASES)}
        report = build.ptxas_report(build.library_path(
            "path_kernel", prof).with_suffix(".log").read_text())
        print(f"{p.name}: {report.get((t.flags & pk.TEMPLATE_FLAGS, t.nc))}"
              f"; cycles " + ", ".join(
                  f"{ph} {v:.3f}" for ph, v in res[p.name].items())
              + f"; {int(c[n_ph])} warp iterations, "
              f"{total / max(int(c[n_ph]), 1):.0f} cycles each", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
