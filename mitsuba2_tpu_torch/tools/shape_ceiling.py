"""The card's face-test ceilings: what a Woop face test costs on it.

    python -m mitsuba2_tpu_torch.tools.shape_ceiling [--chunks 16] \
        [--iters 64] [--tiles 64]

Counterpart of benchmarks/mxu_shape_ceiling.py, which measures the rate
the TPU sustains on the path kernel's Woop-sweep product. Here
csrc/sweep_kernel.cu sweeps every ray against every face (the product
carried to the closest hit, ops/sweep_kernel.py) in its two
instantiations:

- shared: the TPU tool's shape, chunks x 128 faces (2,048 by default,
  96 KB of Woop rows staged in shared memory) against tiles x 2,048 rays
  (131,072), iters times (64);
- global: 262,144 faces (biggeo's sphere, 12.6 MB of Woop rows, read
  through the read-only path from L2) against 32 x 2,048 rays (65,536),
  --global-iters times (1).

Woop rows and rays are N(0,1) draws from a seeded numpy generator. For each
it prints a CUDA-event median of ten runs after a warm-up as face tests per
second per SM, as the logical product's FLOP/s counted as the TPU tool
counts it (2 x 3C x 4 x 2R a chunk, 48 a pair) and as a share of the 67
TFLOP/s fp32 peak; and the library call beside it: ``torch.matmul`` of the
same (3 x 2,048, 4) @ (4, 2 x 2,048) product, one tile of 2,048 rays and
2,048 faces a call, with TF32 off. The library computes the product only,
not the closest hit. Prints the card's name and power limit first. Exits
non-zero without a CUDA device.
"""

import argparse
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..core import profiler as prof
from ..ops import sweep_kernel as sk

C, R = 128, 2048
# the global instantiation's table (biggeo's sphere) and ray tiles
GLOBAL_FACES, GLOBAL_TILES = 262_144, 32
RUNS, SEED = 10, 0
# faces of one library call: the shared instantiation's default table
LIBRARY_FACES = 16 * C


def inputs(n_faces, n_rays, device, seed=SEED):
    """-> (woop (F, 12), o (n, 3), d (n, 3)), float32 N(0,1) draws."""
    rng = np.random.default_rng(seed)
    woop = rng.standard_normal((n_faces, 12), dtype=np.float32)
    rays = rng.standard_normal((2, n_rays, 3), dtype=np.float32)
    return tuple(torch.as_tensor(x, device=device)
                 for x in (woop, rays[0], rays[1]))


def library_ms(woop, o, d, iters, runs):
    """-> (median ms, calls): ``torch.matmul`` of the sweep's product,
    one (3 x LIBRARY_FACES, 4) @ (4, 2R) call per face chunk, ray tile
    and iteration, into one output buffer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = sk.woop_product_rows(woop).T.contiguous()          # (3F, 4)
    chunks = rows.split(3 * LIBRARY_FACES)
    tiles = [sk.ray_columns(o[s:s + R], d[s:s + R]).contiguous()
             for s in range(0, o.shape[0], R)]
    out = torch.empty((3 * LIBRARY_FACES, 2 * R), device=woop.device)

    def run():
        for _ in range(iters):
            for w in chunks:
                for odh in tiles:
                    torch.matmul(w, odh, out=out[:w.shape[0], :odh.shape[1]])

    return prof.kernel_ms(run, runs), iters * len(chunks) * len(tiles)


def measure(shared, n_faces, n_rays, iters, runs=RUNS, log=print):
    """One instantiation at one shape -> dict of its numbers (times in ms,
    rates per second), printed as it goes, with its ``inputs`` (woop, o,
    d) and the last timed call's ``outputs``."""
    woop, o, d = inputs(n_faces, n_rays, "cuda")
    out, times = prof.cuda_times(
        lambda: sk.sweep(woop, o, d, iters, shared), runs)
    ms = statistics.median(times)
    pairs = n_faces * n_rays * iters
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    product = prof.PRODUCT_PAIR_FLOPS * pairs / (ms / 1e3)
    lib_ms, calls = library_ms(woop, o, d, iters, runs)
    bound = prof.roofline(prof.sweep_flop_count(n_faces, n_rays, iters),
                          prof.SWEEP_FACE_BYTES * n_faces, n_rays,
                          out_bytes=prof.SWEEP_RAY_OUT_BYTES,
                          in_bytes=prof.SWEEP_RAY_IN_BYTES)
    name = sk.kernel_name(shared)
    r = {"name": name, "faces": n_faces, "rays": n_rays, "iters": iters,
         "ms": ms, "tests_per_s": pairs / (ms / 1e3), "library_ms": lib_ms,
         "bound_ms": bound.ms, "bound_by": bound.by,
         "inputs": (woop, o, d), "outputs": out}
    log(f"{name}: {n_faces} faces x {n_rays} rays x {iters} iterations: "
        f"{ms:.3f} ms median of {runs}; {r['tests_per_s'] / sms / 1e9:.4f} "
        f"G face tests/s per SM ({r['tests_per_s'] / 1e9:.2f} G/s on {sms} "
        f"SMs); logical product {product / 1e12:.3f} TFLOP/s, "
        f"{100 * product / prof.PEAK_FP32:.2f}% of the "
        f"{prof.PEAK_FP32 / 1e12:.0f} TFLOP/s fp32 peak; bound "
        f"{bound.ms:.4f} ms ({bound.by}), {100 * bound.ms / ms:.2f}% of "
        f"bound")
    log(f"  library: torch.matmul ({3 * LIBRARY_FACES}, 4) @ (4, {2 * R}), "
        f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}: {calls} calls "
        f"in {lib_ms:.3f} ms median of {runs} ({lib_ms / calls * 1e3:.2f} "
        f"us a call); logical product "
        f"{prof.PRODUCT_PAIR_FLOPS * pairs / (lib_ms / 1e3) / 1e12:.3f} "
        f"TFLOP/s; output written at "
        f"{calls * 3 * LIBRARY_FACES * 2 * R * 4 / (lib_ms / 1e3) / 1e12:.3f}"
        f" TB/s")
    return r


def run(chunks=16, iters=64, tiles=64, global_iters=1, runs=RUNS,
        log=print):
    """Both instantiations at their shapes -> {'shared': numbers,
    'global': numbers} (``measure``)."""
    return {"shared": measure(True, chunks * C, tiles * R, iters, runs, log),
            "global": measure(False, GLOBAL_FACES, GLOBAL_TILES * R,
                              global_iters, runs, log)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, default=16,
                    help="face chunks of 128 in the shared table")
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--tiles", type=int, default=64,
                    help="ray tiles of 2048 for the shared table")
    ap.add_argument("--global-iters", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("shape_ceiling: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    from ..ops import build
    build.build_all(sk.libraries())
    run(args.chunks, args.iters, args.tiles, args.global_iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
