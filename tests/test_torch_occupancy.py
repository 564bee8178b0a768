"""``core/profiler.py lane_occupancy``: the plain version's per-depth count
of the lane slots a one-thread-per-lane launch keeps busy, and of the
shading kinds its warps hold, against a direct numpy count of the same
masks, against the plain version's own ray count, and on the materials box
(several kinds a warp once paths have scattered). Counts only: no kernel
runs, and nothing of the JAX package."""

import numpy as np
import pytest

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core import profiler as prof
from mitsuba2_tpu_torch.ops import path_kernel as pk
from mitsuba2_tpu_torch.python.test.scenes import (cornell_box_dict,
                                                   cornell_materials_dict)
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()

MAX_DEPTH, RR_DEPTH, SEED = 5, 2, 0


def scene_args(make_dict, width, spp):
    mt.set_variant("scalar_rgb")
    scene = mt.load_dict(make_dict(width, width, spp, MAX_DEPTH))
    return (scene.tables, pk.camera_row(scene.sensors[0], scene.device),
            width, width, spp, MAX_DEPTH, RR_DEPTH)


def numpy_count(live, kind):
    """(live lanes, busy warps, mean distinct arms a shading warp) of one
    depth's masks, warp by warp in plain Python."""
    n_live, busy, arms = 0, 0, []
    for w in range(0, len(live), prof.WARP):
        lv = live[w:w + prof.WARP]
        n_live += int(lv.sum())
        busy += bool(lv.any())
        if kind is not None:
            k = kind[w:w + prof.WARP]
            k = np.where(k == pk.KIND_ROUGHPLASTIC, pk.KIND_PLASTIC, k)
            if (k >= 0).any():
                arms.append(len(set(k[k >= 0].tolist())))
    return n_live, busy, (np.mean(arms) if arms else None)


@pytest.mark.parametrize("make_dict, width, spp", [
    (cornell_box_dict, 8, 8),
    (cornell_materials_dict, 12, 3),     # 432 lanes: a ragged last warp
])
def test_counts_match_numpy(make_dict, width, spp):
    args = scene_args(make_dict, width, spp)
    rows = prof.lane_occupancy(*args, seed=SEED)
    masks = []
    pk.path_radiance_reference(args[0], args[1], SEED, 0, spp, width, width,
                               MAX_DEPTH, RR_DEPTH,
                               stats={"lane_masks": masks})
    n = width * width * spp
    assert [r["depth"] for r in rows] == list(range(MAX_DEPTH))
    for r, m in zip(rows, masks):
        kind = m["kind"].numpy() if "kind" in m else None
        live, busy, arms = numpy_count(m["live"].numpy(), kind)
        assert (r["live"], r["busy_warps"]) == (live, busy)
        assert r["live_share"] == pytest.approx(live / n, rel=1e-12)
        assert r["slot_share"] == pytest.approx(live / (32 * busy),
                                                rel=1e-12)
        if arms is None:
            assert r["kinds_per_warp"] in (None, 0.0)
        else:
            assert r["kinds_per_warp"] == pytest.approx(arms, rel=1e-12)
    # the last bounce shades nothing
    assert rows[-1]["kinds_per_warp"] is None


def test_live_counts_sum_to_rays():
    args = scene_args(cornell_box_dict, 8, 16)
    rows = prof.lane_occupancy(*args, seed=SEED)
    stats = {}
    pk.path_radiance_reference(args[0], args[1], SEED, 0, 16, 8, 8,
                               MAX_DEPTH, RR_DEPTH, stats=stats)
    assert sum(r["live"] for r in rows) == stats["rays"]
    # every lane traces its camera ray; paths only end after that
    assert rows[0]["live_share"] == 1.0 and rows[0]["slot_share"] == 1.0
    assert all(a["live"] >= b["live"] for a, b in zip(rows, rows[1:]))
    assert rows[-1]["slot_share"] < 1.0


def test_materials_warps_mix_kinds():
    """At 32 spp a warp is one pixel's samples: their camera rays mostly
    hit one kind, and once they scatter a warp shades several."""
    rows = prof.lane_occupancy(*scene_args(cornell_materials_dict, 12, 32),
                               seed=SEED)
    kinds = [r["kinds_per_warp"] for r in rows[:-1]]
    assert kinds[0] < 1.5 and min(kinds[1:]) > 2.0, kinds
    lines = prof.lane_occupancy_lines(rows)
    assert len(lines) == MAX_DEPTH + 1 and lines[-1].rstrip().endswith("-")
