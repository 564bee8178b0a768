"""Where the volumetric kernel's time goes on the card.

    python -m mitsuba2_tpu_torch.tools.prof_volpath

For bench.py's volpath slab (``volpath_slab_dict``: 256x256, 16 spp) on
one CUDA device:

- depth: the kernel at max_depth 1, 2, 4, 8 and 16, beside the work per
  path the plain version counts at 64x64x16 spp of the same scene (rounds,
  delta- and ratio-tracking steps) and what warps of 32 lanes run in
  lockstep (the share of lane slots doing work, per round and per
  tracking step): how time follows path length and divergence;
- grid: the kernel at max_depth 16 with sigma_t grids of 16^3, 64^3 and
  128^3 voxels drawn from the same distribution: the cost of cached grid
  reads as the grid outgrows L1;
- density: the kernel at max_depth 16 with the medium's ``scale`` at 1, 4
  and 16 (the slab 4 and 16 times as thick): how often the reference's
  tracking budgets truncate a walk, and what dense media cost;
- profile: ``torch.profiler`` over 10 back-to-back renders of the bench
  config: device time by kernel and the device's busy share of the span
  from its first to its last kernel.

Kernel times are CUDA-event medians of 5 after a warm-up. Prints the
card's name and power limit first. Exits non-zero without a CUDA device.
"""

import subprocess
import sys
import tempfile

import numpy as np
import torch

from ..core.profiler import device_op_summary, kernel_ms, trace

WIDTH, SPP = 256, 16
STATS_WIDTH, STATS_SPP, SEED = 64, 16, 7


def measure(mi, pk, vk, slab, max_depth, grid=None, scale=1.0):
    """-> (kernel ms at the bench shape, per-path work counts) of the slab
    at ``max_depth`` with sigma_t ``grid`` times ``scale``."""
    d = slab(WIDTH, WIDTH, SPP, max_depth, grid=grid)
    d["slab"]["interior"]["scale"] = scale
    scene = mi.load_dict(d)
    tables = vk.build_vol_tables(scene)
    cam = pk.camera_row(scene.sensors[0], scene.device)
    rr = scene.integrator.rr_depth
    ms = kernel_ms(lambda: vk.volpath_radiance(
        tables, cam, 0, 0, SPP, WIDTH, WIDTH, max_depth, rr))
    stats = {}
    vk.volpath_radiance_reference(tables, cam, SEED, 0, STATS_SPP,
                                  STATS_WIDTH, STATS_WIDTH, max_depth, rr,
                                  stats=stats)
    n = STATS_WIDTH * STATS_WIDTH * STATS_SPP
    per = {k: v / n for k, v in stats.items()}
    return ms, per


def describe(per):
    steps = per["delta_steps"] + per["ratio_steps"]
    return (f"rounds {per['rounds']:.3f}, tracking steps {steps:.3f} "
            f"(delta {per['delta_steps']:.3f}, ratio "
            f"{per['ratio_steps']:.3f}), grid fetches "
            f"{per['delta_fetches'] + per['ratio_fetches']:.3f}; lockstep "
            f"share of lane slots: rounds "
            f"{per['rounds'] / per['warp_rounds']:.4f}, steps "
            f"{steps / max(per['warp_steps'], 1e-12):.4f}; stalled walks "
            f"{per['stalled']:.6f}, ratio walks cut {per['ratio_cut']:.6f}, "
            f"paths cut {per['cut_paths']:.6f}")


def profile(mi, slab):
    scene = mi.load_dict(slab(WIDTH, WIDTH, SPP, 16))
    integ = scene.integrator
    for _ in range(3):
        integ.render(scene, seed=0, spp=SPP)
    torch.cuda.synchronize()
    log_dir = tempfile.mkdtemp(prefix="prof_volpath_")
    with trace(log_dir):
        for i in range(10):
            integ.render(scene, seed=i, spp=SPP)
    print("profile, 10 renders: " + device_op_summary(log_dir, top=6))


def main():
    if not torch.cuda.is_available():
        print("prof_volpath: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    import mitsuba2_tpu_torch as mi
    from mitsuba2_tpu_torch.ops import build, path_kernel as pk
    from mitsuba2_tpu_torch.ops import volpath_kernel as vk
    from mitsuba2_tpu_torch.python.test.scenes import volpath_slab_dict
    mi.set_variant("scalar_rgb")
    build.build_all(vk.libraries())

    for max_depth in (1, 2, 4, 8, 16):
        ms, per = measure(mi, pk, vk, volpath_slab_dict, max_depth)
        print(f"depth {max_depth}: kernel {ms:.3f} ms; per path "
              f"{describe(per)}")
    for res in (16, 64, 128):
        grid = np.random.default_rng(0).uniform(
            0.2, 2.0, (res, res, res)).astype(np.float32)
        ms, per = measure(mi, pk, vk, volpath_slab_dict, 16, grid)
        print(f"grid {res}^3 ({grid.nbytes / 1e6:.3f} MB): kernel {ms:.3f} "
              f"ms; per path {describe(per)}")
    for scale in (1.0, 4.0, 16.0):
        ms, per = measure(mi, pk, vk, volpath_slab_dict, 16, scale=scale)
        print(f"scale {scale:g}: kernel {ms:.3f} ms; per path "
              f"{describe(per)}")
    profile(mi, volpath_slab_dict)
    return 0


if __name__ == "__main__":
    sys.exit(main())
