"""The card's face-test and box-test ceilings: what a Woop face test and a
slab test of the BVH walk cost on it.

    python -m mitsuba2_tpu_torch.tools.shape_ceiling [--chunks 16] \
        [--iters 64] [--tiles 64] [--boxes] [--readings 1] [--save DIR] \
        [--compare DIR]
    PYTHONPATH=<checkout> python mitsuba2_tpu_torch/tools/shape_ceiling.py

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

Beside them, the box-test ceilings: csrc/sweep_kernel.cu's box
instantiations test every ray against every child box of a table of the
BVH walk's 4-wide nodes, each 128-byte line read and tested as the walk
does (csrc/bvh.cuh ``test_line``):

- box shared: 1,024 lines (4,096 boxes, 128 KB in shared memory) against
  64 x 2,048 rays, 16 iterations;
- box global: 24,576 lines (98,304 boxes, 3 MB read from L2) against
  32 x 2,048 rays, 1 iteration.

They price a node visit of the walk in box tests per second; no PyTorch
call computes a slab test, so they have no library call.

Woop rows and rays are N(0,1) draws from a seeded numpy generator. For
each face instantiation it prints a CUDA-event median of ten runs after a
warm-up as face tests per second per SM, as the logical product's FLOP/s
counted as the TPU tool counts it (2 x 3C x 4 x 2R a chunk, 48 a pair)
and as a share of the 67 TFLOP/s fp32 peak; and the library call beside
it: ``torch.matmul`` of the same (3 x 2,048, 4) @ (4, 2 x 2,048)
product, one tile of 2,048 rays and 2,048 faces a call, with TF32 off.
The library computes the product only, not the closest hit. With each
instantiation it prints its registers and spills (ptxas -v, from the
build's log) and, where the package has ``launch_info`` for it, its
threads a block, faces or lines ahead, rays a thread and resident blocks
an SM.

``--save DIR`` writes each instantiation's outputs (t, uv, prim, hits of
the faces; near, hits of the boxes) to ``DIR/<case>.pt``: the last timed
call's at the default shapes ("shared", "global", "box_shared",
"box_global") and one call's at tests/test_torch_sweep.py's ragged shapes
("shared_ragged": 2,048 faces x 4,099 rays x 5 iterations,
"global_ragged": 20,011 faces x 1,027 rays x 2, "box_shared_ragged":
1,023 lines x 4,099 rays x 3, "box_global_ragged": 8,191 lines x 1,027
rays x 1), each ragged case launched twice, which must agree bit for bit;
``--compare DIR`` holds each case against the one saved there (by another
checkout) bit for bit and exits non-zero on any difference. ``--boxes``
times and saves the box instantiations alone; ``--readings N`` times each
instantiation N times in turn (the last reading's outputs are saved). The
tool imports the package ``mitsuba2_tpu_torch`` from the Python path: run
as a file with ``PYTHONPATH`` set to another checkout, it times and saves
that checkout's kernels (two commits in one call on one card). Prints the
card's name and power limit and the package's path first. Exits non-zero
without a CUDA device.
"""

import argparse
import inspect
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from mitsuba2_tpu_torch.core import profiler as prof
from mitsuba2_tpu_torch.ops import build, sweep_kernel as sk

C, R = 128, 2048
# the global instantiation's table (biggeo's sphere) and ray tiles
GLOBAL_FACES, GLOBAL_TILES = 262_144, 32
RUNS, SEED = 10, 0
# faces of one library call: the shared instantiation's default table
LIBRARY_FACES = 16 * C
# the box ceilings: lines of the shared and the global table, ray tiles of
# each, iterations of the shared one
BOX_SHARED_LINES, BOX_GLOBAL_LINES = 1024, 24_576
BOX_SHARED_TILES, BOX_GLOBAL_TILES, BOX_SHARED_ITERS = 64, 32, 16
# tests/test_torch_sweep.py's ragged shapes: (shared, boxes, faces or
# lines, rays, iterations) of each instantiation, the line counts ragged
# against the box loop's unroll and lines ahead, the ray counts against a
# block and its rays a thread
RAGGED = {"shared_ragged": (True, False, 2048, 4099, 5),
          "global_ragged": (False, False, 20011, 1027, 2),
          "box_shared_ragged": (True, True, 1023, 4099, 3),
          "box_global_ragged": (False, True, 8191, 1027, 1)}


def inputs(n_faces, n_rays, device, seed=SEED):
    """-> (woop (F, 12), o (n, 3), d (n, 3)), float32 N(0,1) draws."""
    rng = np.random.default_rng(seed)
    woop = rng.standard_normal((n_faces, 12), dtype=np.float32)
    rays = rng.standard_normal((2, n_rays, 3), dtype=np.float32)
    return tuple(torch.as_tensor(x, device=device)
                 for x in (woop, rays[0], rays[1]))


def sweep_ptxas(build_log):
    """-> {kernel name: 'N registers; ... spill ...'} of the face and box
    instantiations, from the compiler's -Xptxas=-v output of the sweep
    library (its ``.log``)."""
    out, inst = {}, None
    for line in build_log.splitlines():
        m = re.search(r"(sweep|box)_kernelILb([01])E", line)
        if m:
            inst = sk.kernel_name(m.group(2) == "1", m.group(1) == "box")
        if inst is None:
            continue
        if "spill" in line:
            out[inst] = out.get(inst, "") + line.strip()
        elif "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out[inst] = f"{regs} registers; {out.get(inst, '')}"
    return out


def box_inputs(n_lines, n_rays, device, seed=SEED):
    """-> (lines (L, 32), o (n, 3), d (n, 3)): boxes of N(0,1) centres and
    |N(0, 0.3)| half-extents in the walk's line layout (refs 0, counts 1),
    rays of ``inputs``."""
    from mitsuba2_tpu_torch.ops.bvh import WIDTH
    rng = np.random.default_rng(seed + 1)
    centre = rng.standard_normal((n_lines, 3, WIDTH), dtype=np.float32)
    half = np.abs(rng.standard_normal((n_lines, 3, WIDTH),
                                      dtype=np.float32)) * 0.3
    lines = np.zeros((n_lines, 8 * WIDTH), np.float32)
    lines[:, :3 * WIDTH] = (centre - half).reshape(n_lines, -1)
    lines[:, 3 * WIDTH:6 * WIDTH] = (centre + half).reshape(n_lines, -1)
    lines.view(np.int32)[:, 7 * WIDTH:] = 1
    _, o, d = inputs(0, n_rays, device, seed)
    return torch.as_tensor(lines, device=device), o, d


def build_info(shared, boxes, n):
    """'ptxas ...; launch ...' of one instantiation over ``n`` faces or
    lines: its registers and spills from the build's log, and its
    ``launch_info`` where the package has one for it."""
    name = sk.kernel_name(shared, boxes)
    log_path = build.library_path("sweep_kernel").with_suffix(".log")
    ptxas = sweep_ptxas(log_path.read_text()).get(name) \
        if log_path.exists() else None
    # a checkout from before launch_info ran a thread a ray, one from
    # before its boxes argument a block of 256 threads a ray each
    if not hasattr(sk, "launch_info"):
        info = "no launch_info in this checkout"
    elif "boxes" in inspect.signature(sk.launch_info).parameters:
        info = sk.launch_info(shared, n, boxes=boxes)
    elif not boxes:
        info = sk.launch_info(shared, n)
    else:
        info = "no launch_info for it in this checkout"
    return f"{name}: ptxas {ptxas}; launch {info}"


def measure_boxes(shared, n_lines, n_rays, iters, runs=RUNS, log=print):
    """One box instantiation at one shape -> dict of its numbers, as
    ``measure``'s."""
    from mitsuba2_tpu_torch.ops.bvh import WIDTH
    lines, o, d = box_inputs(n_lines, n_rays, "cuda")
    out, times = prof.cuda_times(
        lambda: sk.box_sweep(lines, o, d, iters, shared), runs)
    ms = statistics.median(times)
    tests = WIDTH * n_lines * n_rays * iters
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bound = prof.roofline(prof.BOX_FLOPS * tests,
                          lines.numel() * lines.element_size(), n_rays,
                          out_bytes=prof.BOX_RAY_OUT_BYTES,
                          in_bytes=prof.SWEEP_RAY_IN_BYTES)
    name = sk.kernel_name(shared, boxes=True)
    log(build_info(shared, True, n_lines))
    # the TPU walk whose box tests it prices (the TPU repo has no box
    # probe)
    r = {"name": name, "boxes": WIDTH * n_lines, "rays": n_rays,
         "replaces": "mitsuba2_tpu/ops/megakernel.py:570",
         "iters": iters, "ms": ms, "tests_per_s": tests / (ms / 1e3),
         "library_ms": None, "bound_ms": bound.ms, "bound_by": bound.by,
         "outputs": out,
         "reference": lambda: sk.box_sweep_reference(lines, o, d, iters)}
    log(f"{name}: {WIDTH * n_lines} boxes ({n_lines} lines, "
        f"{lines.numel() * 4 / 1e6:.3f} MB) x {n_rays} rays x {iters} "
        f"iterations: {ms:.3f} ms median of {runs}; "
        f"{r['tests_per_s'] / sms / 1e9:.4f} G box tests/s per SM "
        f"({r['tests_per_s'] / 1e9:.2f} G/s on {sms} SMs); bound "
        f"{bound.ms:.4f} ms ({bound.by}), {100 * bound.ms / ms:.2f}% of "
        f"bound; boxes hit a ray and iteration "
        f"{float(out[1].float().mean()) / iters:.2f}")
    return r


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
    log(build_info(shared, False, n_faces))
    r = {"name": name, "faces": n_faces, "rays": n_rays, "iters": iters,
         "replaces": "benchmarks/mxu_shape_ceiling.py:44",
         "ms": ms, "tests_per_s": pairs / (ms / 1e3), "library_ms": lib_ms,
         "bound_ms": bound.ms, "bound_by": bound.by, "outputs": out,
         "reference": lambda: sk.sweep_reference(woop, o, d, iters)}
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
        log=print, faces=True):
    """The four instantiations at their shapes (without ``faces`` the box
    ones alone) -> {'shared': numbers, 'global': numbers, 'box_shared':
    ..., 'box_global': ...} (``measure``, ``measure_boxes``)."""
    res = {"shared": measure(True, chunks * C, tiles * R, iters, runs, log),
           "global": measure(False, GLOBAL_FACES, GLOBAL_TILES * R,
                             global_iters, runs, log)} if faces else {}
    res["box_shared"] = measure_boxes(True, BOX_SHARED_LINES,
                                      BOX_SHARED_TILES * R, BOX_SHARED_ITERS,
                                      runs, log)
    res["box_global"] = measure_boxes(False, BOX_GLOBAL_LINES,
                                      BOX_GLOBAL_TILES * R, 1, runs, log)
    return res


def ragged_outputs(log=print, faces=True):
    """{case: outputs} of the instantiations at ``RAGGED``'s shapes (without
    ``faces`` the box ones alone), each launched twice; raises if the two
    launches differ."""
    out = {}
    for case, (shared, boxes, n, n_rays, iters) in RAGGED.items():
        if not (boxes or faces):
            continue
        if boxes:
            table, o, d = box_inputs(n, n_rays, "cuda", seed=10)
            fn, what = sk.box_sweep, "lines"
        else:
            table, o, d = inputs(n, n_rays, "cuda", seed=10)
            fn, what = sk.sweep, "faces"
        got = fn(table, o, d, iters, shared)
        again = fn(table, o, d, iters, shared)
        same = all(torch.equal(bits(a), bits(b)) for a, b in zip(got, again))
        log(f"{case}: {n} {what} x {n_rays} rays x {iters} iterations; "
            f"two launches bit-identical: {same}")
        if not same:
            raise SystemExit(f"{case}: two launches differ")
        out[case] = got
    return out


def bits(x):
    """A float32 or int32 tensor as its int32 bits (NaN and -0 compare as
    bits)."""
    return x.contiguous().view(torch.int32)


def save_or_compare(outputs, save="", against="", log=print):
    """Each case's outputs (t, uv, prim, hits of the faces; near, hits of
    the boxes) written to ``save`` and held bit for bit against
    ``against``'s -> whether all agree."""
    ok = True
    for case, got in outputs.items():
        got = [x.cpu() for x in got]
        if save:
            Path(save).mkdir(parents=True, exist_ok=True)
            torch.save(got, Path(save) / f"{case}.pt")
        if against:
            want = torch.load(Path(against) / f"{case}.pt")
            same = [torch.equal(bits(a), bits(b))
                    for a, b in zip(got, want)]
            differ = sum((bits(a) != bits(b)).reshape(len(a), -1).any(1)
                         for a, b in zip(got, want)) > 0
            what = "near, hits" if len(got) == 2 else "t, uv, prim, hits"
            log(f"{case}: {what} bit-identical to {against}: {same}; rays "
                f"that differ {int(differ.sum())} of {len(differ)}")
            ok = ok and all(same)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, default=16,
                    help="face chunks of 128 in the shared table")
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--tiles", type=int, default=64,
                    help="ray tiles of 2048 for the shared table")
    ap.add_argument("--global-iters", type=int, default=1)
    ap.add_argument("--boxes", action="store_true",
                    help="the box ceilings alone")
    ap.add_argument("--readings", type=int, default=1,
                    help="times each instantiation is timed, in turn")
    ap.add_argument("--save", default="",
                    help="directory to write the outputs to")
    ap.add_argument("--compare", default="",
                    help="directory of outputs to hold these against")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("shape_ceiling: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0] + f"; {sk.__file__}",
        flush=True)
    build.build_all(sk.libraries())
    for _ in range(args.readings):
        res = run(args.chunks, args.iters, args.tiles, args.global_iters,
                  faces=not args.boxes)
    if not (args.save or args.compare):
        return 0
    outputs = {case: r["outputs"] for case, r in res.items()}
    outputs.update(ragged_outputs(faces=not args.boxes))
    return 0 if save_or_compare(outputs, args.save, args.compare) else 1


if __name__ == "__main__":
    sys.exit(main())
