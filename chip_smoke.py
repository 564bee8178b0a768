"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout and
prints each kernel instantiation's registers and spills. Then, for each
path -- the Cornell box (the main path) and the matpreview scene (a rough
gold sphere under an HDR sky above a checker floor), both at 256x256, 64
spp, max_depth 6 -- it checks the path kernel against its plain PyTorch
version on the card at 64x64x16 spp, renders the path through
``load_dict`` and ``scene.integrator.render``, checks that the render went
through the path's kernel instantiation and that the image is sane, and
times render, kernel and plain version at the path's shape. Prints one
JSON line of kernel results, the card's name and power limit, and as its
last line ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero, and so does a machine without CUDA: nothing runs on the CPU
instead.
"""

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

WIDTH, SPP, MAX_DEPTH = 256, 64, 6
PARITY_WIDTH, PARITY_SPP, SEED = 64, 16, 7
# the tolerance of the CPU tests (tests/test_torch_path_kernel.py)
PIX_RTOL, PIX_SHARE, MEAN_RTOL = 1e-4, 0.99, 1e-5
REPEATS = 5


def log(*args):
    print(*args, flush=True)


def timed(fn, repeats=REPEATS):
    """-> (last result, median milliseconds) of fn() on the card, timed
    with CUDA events after one warm-up call."""
    out = fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return out, statistics.median(times)


def develop(rad, w, spp):
    return rad.reshape(3, w * w, spp).mean(dim=2).T.reshape(w, w, 3)


def compare(got, want, label):
    """Per-pixel agreement of two (w, w, 3) images -> max abs error."""
    g = got.double().cpu().numpy()
    r = want.double().cpu().numpy()
    err = (np.abs(g - r) / np.maximum(np.abs(r), 1e-3)).max(-1)
    share = float((err <= PIX_RTOL).mean())
    mean_rel = abs(g.mean() - r.mean()) / abs(r.mean())
    log(f"{label}: max pixel rel diff {err.max():.3e}, p99 "
        f"{np.quantile(err, 0.99):.3e}, share within {PIX_RTOL:g} "
        f"{share:.6f}, mean rel diff {mean_rel:.3e}")
    if share < PIX_SHARE or mean_rel > MEAN_RTOL:
        raise SystemExit(f"{label}: kernel and plain version disagree")
    return float(np.abs(g - r).max())


def ptxas_report(build_log):
    """-> {instantiation flags: 'N registers, ... spill ...'} from the
    compiler's -Xptxas=-v output."""
    out, flags = {}, None
    for line in build_log.splitlines():
        m = re.search(r"path_kernelILi(\d+)E", line)
        if m:
            flags = int(m.group(1))
        if flags is None:
            continue
        if "spill" in line or "stack frame" in line:
            out[flags] = line.strip()
        elif "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out[flags] = f"{regs} registers; {out.get(flags, '')}"
    return out


def run_path(mi, pk, name, make_dict, flags, mean_band):
    """Parity, main-path render and timing of one path -> its entry of
    the kernels line."""
    label = f"path_kernel[{pk.flag_names(flags)}]"

    # ---- parity: kernel against its plain version on the same tables ----
    scene = mi.load_dict(make_dict(PARITY_WIDTH, PARITY_WIDTH, PARITY_SPP,
                                   MAX_DEPTH))
    if scene.tables.flags & pk.TEMPLATE_FLAGS != flags:
        raise SystemExit(f"{name}: scene tables carry flags "
                         f"{scene.tables.flags}, not {flags}")
    cam = pk.camera_row(scene.sensors[0], scene.device)
    args = (scene.tables, cam, SEED, 0, PARITY_SPP, PARITY_WIDTH,
            PARITY_WIDTH, MAX_DEPTH, scene.integrator.rr_depth)
    got = pk.path_radiance(*args)
    torch.cuda.synchronize()
    want = pk.path_radiance_reference(*args)
    lane_rel = ((got - want).abs() / want.abs().clamp(min=1e-3)).amax(0)
    beyond = float((lane_rel > PIX_RTOL).float().mean())
    log(f"{name} parity {PARITY_WIDTH}^2 x {PARITY_SPP} spp, depth "
        f"{MAX_DEPTH}: lanes not bit-identical "
        f"{float((got != want).any(0).float().mean()):.4f}, lanes beyond "
        f"{PIX_RTOL:g} relative {beyond:.6f}")
    max_abs_err = compare(develop(got, PARITY_WIDTH, PARITY_SPP),
                          develop(want, PARITY_WIDTH, PARITY_SPP),
                          f"{name} parity")

    # ---- the path itself, through the user's entry points ----
    scene = mi.load_dict(make_dict(WIDTH, WIDTH, SPP, MAX_DEPTH))
    integrator = scene.integrator
    pk.reset_launch_counts()
    img = integrator.render(scene, seed=0, spp=SPP)
    torch.cuda.synchronize()
    launches = pk.path_radiance.launches_by_flags[flags]
    if integrator.last_engine != "kernel":
        raise SystemExit(f"{name} left the kernel: {integrator.engine_reason}")
    if launches < 1:
        raise SystemExit(f"{name} launched no {label}")
    mean = float(img.mean())
    if img.shape != (WIDTH, WIDTH, 3) or img.device.type != "cuda" \
            or not bool(torch.isfinite(img).all()) \
            or not mean_band[0] < mean < mean_band[1]:
        raise SystemExit(f"{name} image is wrong: {tuple(img.shape)} "
                         f"{img.device} mean {mean}")
    log(f"{name}: {WIDTH}^2 x {SPP} spp, depth {MAX_DEPTH}: {launches} "
        f"launch(es) of {label}, image mean {mean:.6f}")

    n_paths = WIDTH * WIDTH * SPP
    _, render_ms = timed(lambda: integrator.render(scene, seed=0, spp=SPP))
    cam = pk.camera_row(scene.sensors[0], scene.device)
    args = (scene.tables, cam, 0, 0, SPP, WIDTH, WIDTH, MAX_DEPTH,
            integrator.rr_depth)
    k_rad, kernel_ms = timed(lambda: pk.path_radiance(*args))
    p_rad, plain_ms = timed(lambda: pk.path_radiance_reference(*args))
    log(f"{name} render (kernel, end to end): {render_ms:.3f} ms median of "
        f"{REPEATS}, {n_paths / render_ms / 1e3:.3f} Mpaths/s")
    log(f"{name} kernel: {kernel_ms:.3f} ms, {n_paths / kernel_ms / 1e3:.3f} "
        f"Mpaths/s; plain version: {plain_ms:.3f} ms, "
        f"{n_paths / plain_ms / 1e3:.3f} Mpaths/s")
    compare(develop(k_rad, WIDTH, SPP), develop(p_rad, WIDTH, SPP),
            f"{name} main-path shape")
    return {"name": label, "route": "cuda",
            "source": "mitsuba2_tpu_torch/csrc/path_kernel.cu",
            "replaces": "mitsuba2_tpu/ops/megakernel.py:365",
            "launches": launches, "max_abs_err": max_abs_err,
            "ms": kernel_ms, "plain_ms": plain_ms}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing is run on the CPU "
              "instead", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    import mitsuba2_tpu_torch as mi
    from mitsuba2_tpu_torch.ops import build, path_kernel as pk
    from mitsuba2_tpu_torch.python.test.scenes import (cornell_box_dict,
                                                       matpreview_dict)

    nvcc = build.find_nvcc()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}"
        f"; nvcc: {nvcc or 'not found'}")

    # ---- build ----
    t0 = time.perf_counter()
    build.load("path_kernel")
    log(f"build: path_kernel in {time.perf_counter() - t0:.2f} s")
    report = ptxas_report(build.build_logs.get("path_kernel", ""))
    for flags in sorted(report):
        log(f"  ptxas path_kernel[{pk.flag_names(flags)}]: {report[flags]}")

    mi.set_variant("scalar_rgb")
    mi.set_device("cuda")

    full = pk.HAS_SPHERES | pk.HAS_ENV | pk.HAS_GGX | pk.HAS_CHECKER
    kernels = [run_path(mi, pk, "cornell", cornell_box_dict, 0, (0.05, 1.0)),
               run_path(mi, pk, "matpreview", matpreview_dict, full,
                        (0.2, 5.0))]

    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
