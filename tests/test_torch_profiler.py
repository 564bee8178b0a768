"""The port's profiler (mitsuba2_tpu_torch/core/profiler.py): its phases
against the JAX package's, the trace and its device summary, the isotonic
fit and the utilization rows, and the work tallies that moved there from
chip_smoke.py, held to the numbers the old formulas give on stats written
here by hand (every expected value below is that formula's arithmetic).
"""

import json
from types import SimpleNamespace

import pytest
import torch

from mitsuba2_tpu_torch.core import profiler as prof
from mitsuba2_tpu_torch.ops import path_kernel as pk


def test_phases_match_jax():
    from mitsuba2_tpu.core.profiler import PHASES
    assert prof.PHASES == PHASES and len(prof.PHASES) == 24


def test_phase_appears_in_exported_trace(tmp_path):
    with prof.trace(str(tmp_path)):
        with prof.ScopedPhase("RayIntersect"):
            x = torch.ones(64) * 2
    assert float(x.sum()) == 128.0
    path = prof.latest_trace(str(tmp_path))
    assert path is not None and path.startswith(str(tmp_path))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "RayIntersect" in names


def test_summary_without_device_events(tmp_path):
    assert prof.device_op_summary(str(tmp_path)) == "no trace captured"
    with prof.trace(str(tmp_path)):
        with prof.profiler_phase("Render"):
            torch.arange(10).sum()
    assert prof.device_op_summary(str(tmp_path)) == prof.NO_DEVICE_OPS


def test_summary_of_device_events(tmp_path):
    """Device time by kernel and the busy share of the span, from a Chrome
    trace written by hand: two kernels and a copy in a 100 us span."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "path_kernel", "ts": 1000.0,
         "dur": 40.0},
        {"ph": "X", "cat": "kernel", "name": "path_kernel", "ts": 1050.0,
         "dur": 30.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1090.0,
         "dur": 10.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sum", "ts": 900.0,
         "dur": 500.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5000.0}]
    with open(tmp_path / "1.trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    by_name, busy, span = prof.device_op_times(str(tmp_path / "1.trace.json"))
    assert by_name == {"path_kernel": 70.0, "Memcpy DtoH": 10.0}
    assert (busy, span) == (80.0, 100.0)
    lines = prof.device_op_summary(str(tmp_path), top=1).splitlines()
    assert lines[0] == "device busy 0.080 ms of a 0.100 ms span (80.00%)"
    assert len(lines) == 2 and "path_kernel" in lines[1] \
        and "87.50%" in lines[1]


@pytest.mark.parametrize("values, fit", [
    ([1.0, 2.0, 3.0], [1.0, 2.0, 3.0]),
    ([1.0, 3.0, 2.0, 4.0], [1.0, 2.5, 2.5, 4.0]),
    ([3.0, 2.0, 1.0], [2.0, 2.0, 2.0]),
    ([1.0, 4.0, 2.0, 3.0, 5.0], [1.0, 3.0, 3.0, 3.0, 5.0]),
])
def test_isotonic_fit(values, fit):
    assert prof.isotonic_fit(values) == pytest.approx(fit, rel=1e-12)


def test_utilization_row():
    """6.7e10 FLOPs, 6.7e9 bytes and 1e9 face tests in 2 ms against a
    1e12 tests/s ceiling: half the fp32 peak, twice the HBM rate, half
    the ceiling."""
    row = prof.utilization_row(3, 2.0, 0.5, 0.1, 6.7e10, 6.7e9, 1e9, 1e12)
    assert row["depth"] == 3 and row["bounce_ms"] == 0.5
    assert row["gflops"] == pytest.approx(33500.0, rel=1e-12)
    assert row["pct_fp32"] == pytest.approx(50.0, rel=1e-12)
    assert row["gbs"] == pytest.approx(3350.0, rel=1e-12)
    assert row["pct_hbm"] == pytest.approx(100.0, rel=1e-12)
    assert row["gtests"] == pytest.approx(500.0, rel=1e-12)
    assert row["pct_face"] == pytest.approx(50.0, rel=1e-12)


def _tables(nc, flags, n_faces, n_spheres):
    return SimpleNamespace(nc=nc, flags=flags, n_faces=n_faces,
                           n_spheres=n_spheres)


# (tables, stats, n_stats, n_paths, FLOPs a path, face tests a path)
PATH_CASES = {
    # Cornell, rgb: per path 3 rays, 10 shadow face tests, 2 shaded
    # bounces, 1 escape: 40 + (3 x 36 + 10) x 12 + 2 x (200 + 40 x 3)
    # + 80
    "shared_rgb": (_tables(3, 0, 36, 0),
                   {"rays": 12, "shadow_faces": 40, "shaded": 8,
                    "escaped": 4}, 4, 1000, 2176.0, 118.0),
    # matpreview, spectral: path 40 + 60 x 4, faces (2 x 14 + 3) x 12,
    # spheres 2 x 20 + 20, shade 2 x (200 + 160 + 100), ggx 190 + 200,
    # escape 80 + 48, env NEE 2 x (100 + 48)
    "shared_spectral": (_tables(4, pk.HAS_SPHERES | pk.HAS_ENV | pk.HAS_GGX,
                                14, 1),
                        {"rays": 4, "shadow_faces": 6, "shadow_spheres": 2,
                         "shaded": 4, "ggx": 2, "escaped": 2, "env_nee": 4},
                        2, 10, 2446.0, 31.0),
    # BVH tier with the lobes: walks (30 + 10) x 12 + (5 + 3) x 12, quads
    # 6 x 60, shade 2 x 320, dielectric 45 + 9, plastic 150 + 30, rough
    # plastic 0.5 x (190 + 12), bitmap 50
    "bvh_lobes": (_tables(3, pk.HAS_BVH | pk.HAS_SPHERES | pk.HAS_LOBES,
                          1000, 0),
                  {"rays": 2, "walk_boxes": 30, "shadow_walk_boxes": 10,
                   "walk_faces": 5, "shadow_walk_faces": 3, "quad_tests": 4,
                   "shadow_quads": 2, "shaded": 2, "dielectric": 1,
                   "plastic": 1, "roughplastic": 0.5, "bitmap": 1},
                  1, 3, 2001.0, 8.0),
}


@pytest.mark.parametrize("case", sorted(PATH_CASES))
def test_path_kernel_tallies(case):
    tables, stats, n_stats, n_paths, flops, faces = PATH_CASES[case]
    assert prof.path_kernel_flop_count(tables, stats, n_stats, n_paths) \
        == pytest.approx(n_paths * flops, rel=1e-12)
    assert prof.face_test_count(tables, stats, n_stats, n_paths) \
        == pytest.approx(n_paths * faces, rel=1e-12)


def test_other_tallies_and_roofline():
    # volpath: 40 + 3 x (55 + 12 x 12) + 14 x 6 + 14 x 80 + 2 x 130
    # + 5 x 12 + 50 + 110 a path
    stats = {"rounds": 3, "delta_steps": 10, "ratio_steps": 4,
             "delta_fetches": 10, "ratio_fetches": 4, "nee": 2,
             "shadow_faces": 5, "phase": 1, "surface": 1}
    assert prof.volpath_flop_count(_tables(3, 0, 12, 0), stats, 1, 2) \
        == pytest.approx(2 * 2321.0, rel=1e-12)
    # splat, K = 5: 100 x (2 x 5 x 20 + 20 + 200) + 50 x 100
    assert prof.splat_flop_count(100, 5, 50) == 47000
    # the walk: 10 x (2.5 x 12 + 1.5 x 12)
    assert prof.walk_flop_count(10, 2.5, 1.5) == pytest.approx(480.0)
    # the sweep: the t test's 12, the U and V rows' 2 x 11, u and v 4,
    # 1 - u - v 2: 40 a pair
    assert prof.sweep_flop_count(2048, 10, 2) == 40 * 2048 * 20
    # 6.7e9 FLOPs against 100 items of 8 B in, 12 B out and 1,000 B of
    # tables: 0.1 ms of operations, 3,000 B -> 3000 / 3.35e9 ms
    b = prof.roofline(6.7e9, 1000, 100, out_bytes=12, in_bytes=8)
    assert b.by == "operations" and b.nbytes == 3000
    assert b.ms == pytest.approx(0.1, rel=1e-12) == b.ops_ms
    assert b.bytes_ms == pytest.approx(3000 / 3.35e9, rel=1e-12)
    b = prof.roofline(1.0, 3_350_000, 0)
    assert b.by == "bytes" and b.ms == pytest.approx(1e-3, rel=1e-12)


@pytest.mark.cuda
def test_cuda_trace_and_utilization_report(tmp_path):
    """On the card: the sweep kernel, launched through ctypes, shows in
    the trace's device summary, and the utilization report of a small
    Cornell box has one plausible row a depth."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mitsuba2_tpu_torch as mt
    from mitsuba2_tpu_torch.ops import sweep_kernel as sk
    from mitsuba2_tpu_torch.python.test.scenes import cornell_box_dict
    woop = torch.randn((512, 12), device="cuda")
    o, d = torch.randn((2, 4096, 3), device="cuda")
    sk.sweep(woop, o, d, 2)
    with prof.trace(str(tmp_path)):
        with prof.profiler_phase("Render"):
            sk.sweep(woop, o, d, 2)
    summary = prof.device_op_summary(str(tmp_path))
    assert "sweep_kernel" in summary and "device busy" in summary
    mt.set_variant("scalar_rgb")
    prev = mt.device()
    try:
        mt.set_device("cuda")
        scene = mt.load_dict(cornell_box_dict(32, 32, 4, 3))
    finally:
        mt.set_device(prev)
    report, rows = prof.path_kernel_utilization_report(
        scene, 4, 3, runs=3, ceilings={"shared": 1e11, "l2": 1e11},
        parity=(16, 4))
    assert [r["depth"] for r in rows] == [1, 2, 3]
    assert all(r["kernel_ms"] > 0 and r["gflops"] > 0 and r["pct_face"] > 0
               and r["bounce_ms"] >= 0 for r in rows)
    assert "path kernel utilization" in report
