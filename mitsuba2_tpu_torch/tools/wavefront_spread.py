"""The card's general wavefront against the CPU's on the slice's path, and
the scatter of the Beckmann visible-normal solve that bounds how well the
two agree per pixel.

``matpreview_beckmann`` is bench.py's matpreview with the hero's
``distribution`` set to ``beckmann`` (the reference's default, which the
path kernel refuses), so it renders through ``PathIntegrator.sample``.
Its visible-normal solve (render/microfacet.py ``_sample_slopes``, the
reference's 12 bracketed Newton steps) does not converge in its steps: an
ulp of its input moves a lane's normal by up to ~1e-2. The card's exp,
log and division round some lanes' inputs an ulp apart from the CPU's, so
per pixel the card agrees with the CPU about as well as the CPU agrees
with itself when the solve's input moves one ulp up. ``spread`` counts
the pixels beyond the parity bar (1e-4 relative) for both, and holds the
card's count to the moved CPU's plus three standard deviations of the
difference of two such counts, 3 sqrt(D_card + D_moved), and the mean
pixel difference to within 4 standard errors (the solve scatters lanes;
it must not bias them). ``lane_trace`` records one lane's closest hits,
bounce by bounce, to find where two runs of a lane part, and
``tie_parting`` says whether they first part at a tie of two coplanar
faces hit at one point (a glass box standing on a floor), which two
intersection tests, or one on rays an ulp apart, may break apart.

    python -m mitsuba2_tpu_torch.tools.wavefront_spread [--width 128]
        [--spp 4] [--seeds 0 1 2 3]

renders each seed on the card and twice on the CPU and prints one line a
seed with the counts, the allowed excess and the verdict.

    python mitsuba2_tpu_torch/tools/wavefront_spread.py --time
        [--width 256] [--spp 64]

times the render on the card instead (CUDA events, median of 3 after a
warm-up) and counts its host waits with torch's sync debug mode. It
imports ``mitsuba2_tpu_torch`` from the Python path, so that run as a file
with ``PYTHONPATH`` set to another checkout it times that checkout's
wavefront (two commits compared within one run on one card). Both modes
need a CUDA device.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

PIX_RTOL = 1e-4
MAX_DEPTH = 6
# the share of a run's lanes that may part at a tie of coplanar faces
# (``tie_parting``) where a check sets such lanes apart
MAX_TIE_SHARE = 0.01


def matpreview_beckmann(scenes, width, spp, max_depth=MAX_DEPTH, **hero):
    """bench.py's matpreview with the hero's distribution set to beckmann
    (and the hero's other ``hero`` parameters)."""
    d = scenes.matpreview_dict(width, width, spp, max_depth)
    d["hero"]["bsdf"].update(distribution="beckmann", **hero)
    return d


def pixel_errors(a, b):
    """Largest relative channel error of each pixel of (h, w, 3) images
    (tests/test_torch_path_kernel.py's)."""
    return (np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max(-1)


def render(mi, device, width, spp, seed, move_up=False, **hero):
    """matpreview_beckmann rendered on ``device`` -> (its image as float64
    numpy, the integrator's ``last_engine``); with ``move_up`` the solve's
    first input moved one ulp up."""
    from mitsuba2_tpu_torch.python.test import scenes
    from mitsuba2_tpu_torch.render import microfacet as mf
    solve = mf.MicrofacetDistribution._sample_slopes
    prev = mi.device()
    mi.set_device(device)
    try:
        if move_up:
            mf.MicrofacetDistribution._sample_slopes = \
                lambda self, c, u1, u2: solve(
                    self, c, torch.nextafter(u1, torch.full_like(u1, 2.0)),
                    u2)
        sc = mi.load_dict(matpreview_beckmann(scenes, width, spp, **hero))
        img = sc.integrator.render(sc, seed=seed, spp=spp)
        return img.double().cpu().numpy(), sc.integrator.last_engine
    finally:
        mf.MicrofacetDistribution._sample_slopes = solve
        mi.set_device(prev)


def spread(card, cpu, moved):
    """The card's image against the CPU's, beside the CPU's own image with
    the solve's input moved one ulp -> dict of the pixels beyond the bar
    (``d_card``, ``d_moved``), the allowed excess (``margin``), the mean
    pixel difference in standard errors (``z``) and ``ok``."""
    d_card = int((pixel_errors(card, cpu) > PIX_RTOL).sum())
    d_moved = int((pixel_errors(moved, cpu) > PIX_RTOL).sum())
    margin = 3.0 * math.sqrt(d_card + d_moved)
    diff = (card - cpu).ravel()
    z = abs(diff.mean()) / max(diff.std() / math.sqrt(diff.size), 1e-30)
    n = cpu.shape[0] * cpu.shape[1]
    return {"pixels": n, "d_card": d_card, "d_moved": d_moved,
            "margin": margin, "share_card": 1 - d_card / n,
            "share_moved": 1 - d_moved / n, "z": z,
            "ok": d_card <= d_moved + margin and z <= 4.0}


def describe(s):
    return (f"{s['d_card']} of {s['pixels']} pixels beyond {PIX_RTOL:g} "
            f"(share within {s['share_card']:.6f}); the CPU moved one ulp: "
            f"{s['d_moved']} ({s['share_moved']:.6f}); allowed "
            f"{s['d_moved']} + {s['margin']:.1f}; mean difference "
            f"{s['z']:.2f} standard errors; ok {s['ok']}")


def lane_trace(scene, seed, spp, lanes):
    """Each of ``lanes``' closest hits in one pass of ``scene``'s
    wavefront, call by call -> {lane: [(o, d, t, prim), ...]} as numpy."""
    from mitsuba2_tpu_torch.render.scene import Scene
    out = {int(k): [] for k in lanes}
    idx = torch.as_tensor(sorted(out), device=scene.device)
    query = Scene.ray_intersect_preliminary

    def recording(self, ray, active=None):
        pi = query(self, ray, active)
        rows = [x[idx].double().cpu().numpy() for x in (
            ray.o, ray.d, pi.t, pi.prim_idx)]
        for j, k in enumerate(sorted(out)):
            out[k].append(tuple(r[j] for r in rows))
        return pi

    Scene.ray_intersect_preliminary = recording
    try:
        sensor = scene.sensors[0]
        scene.integrator.wavefront_lanes(scene, sensor, sensor.sampler, seed,
                                         0, spp)
    finally:
        Scene.ray_intersect_preliminary = query
    return out


def first_parting(a, b):
    """Where two traces of one lane part: the first call whose ray or hit
    differs -> a line (differences of o, d and t, and the prims)."""
    for k, (x, y) in enumerate(zip(a, b)):
        do, dd = np.abs(x[0] - y[0]).max(), np.abs(x[1] - y[1]).max()
        same_t = x[2] == y[2] or (np.isinf(x[2]) and np.isinf(y[2]))
        if do or dd or not same_t or x[3] != y[3]:
            return (f"call {k}: |o| diff {do:.2e}, |d| diff {dd:.2e}, t "
                    f"{x[2]:.7f} against {y[2]:.7f}, prim {int(x[3])} against "
                    f"{int(y[3])}")
    return "no call differs"


def coplanar(scene, a, b, tol=1e-5):
    """Whether the faces ``a`` and ``b`` of ``scene`` (prim ids) are two
    faces of one plane."""
    n_faces = len(scene.face_shape)
    if a == b or not (0 <= a < n_faces and 0 <= b < n_faces):
        return False
    na, nb = (scene.ng[k].astype(np.float64) for k in (a, b))
    gap = scene.v0[b].astype(np.float64) - scene.v0[a]
    return abs(abs(na @ nb) - 1.0) < tol and abs(na @ gap) < tol


def tie_parting(scene, a, b, tol=1e-4):
    """Where two traces of one lane first hit other prims, when that is a
    tie: two coplanar faces of ``scene`` hit at one point (within ``tol``
    of the scene's scale), which two intersection tests, or one test on
    rays an ulp apart, may break apart -> a line, else None."""
    for k, (x, y) in enumerate(zip(a, b)):
        if int(x[3]) == int(y[3]):
            continue
        if not coplanar(scene, int(x[3]), int(y[3])):
            return None
        px, py = x[0] + x[2] * x[1], y[0] + y[2] * y[1]
        gap = np.abs(px - py).max()
        if not gap <= tol * (1.0 + np.abs(py).max()):
            return None
        return (f"call {k}: coplanar faces {int(x[3])} and {int(y[3])} hit "
                f"{gap:.1e} apart, t {x[2]:.7f} against {y[2]:.7f}")
    return None


def time_render(mi, width, spp, seed=7, runs=3):
    """matpreview_beckmann at width^2 x spp on the card -> (CUDA-event ms
    of each of ``runs`` renders after a warm-up, the host's waits for the
    card in one more render under torch's sync debug mode)."""
    import warnings
    from mitsuba2_tpu_torch.python.test import scenes
    sc = mi.load_dict(matpreview_beckmann(scenes, width, spp))

    def go():
        return sc.integrator.render(sc, seed=seed, spp=spp)

    go()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        go()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            go()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert sc.integrator.last_engine == "wavefront"
    return times, sum("synchroniz" in str(w.message) for w in caught)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("wavefront_spread needs a CUDA device")
    import mitsuba2_tpu_torch as mi
    mi.set_variant("scalar_rgb")
    if args.time:
        w, spp = args.width or 256, args.spp or 64
        times, syncs = time_render(mi, w, spp)
        ms = sorted(times)[len(times) // 2]
        print(f"{mi.__file__}: matpreview_beckmann {w}^2 x {spp}: render "
              f"{ms:.1f} ms (median of {', '.join(f'{t:.1f}' for t in times)}"
              f"), {w * w * spp / ms / 1e3:.3f} Mpaths/s; host syncs "
              f"{syncs}", flush=True)
        return
    args.width, args.spp = args.width or 128, args.spp or 4
    for seed in args.seeds:
        t0 = time.perf_counter()
        card, _ = render(mi, "cuda", args.width, args.spp, seed)
        cpu, _ = render(mi, "cpu", args.width, args.spp, seed)
        moved, _ = render(mi, "cpu", args.width, args.spp, seed, True)
        print(f"seed {seed}, {args.width}^2 x {args.spp}: "
              f"{describe(spread(card, cpu, moved))} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
