"""Disks and cylinders in the scene's ray queries (render/scene.py
``ray_intersect_preliminary``, ``ray_test``) against the JAX ``Scene``'s
on the same rays: the quad pass runs after the faces and the spheres, a
quad hit has prim id F + S + its index, its shape's index and uv 0.

Tolerance: both packages run the same float32 quadric solve (the JAX one
through XLA, the port's through torch), so a ray grazing a rim could in
principle flip; the bar is equal prim ids on at least 99.9% of rays, and
t within 1e-5 (relative to max(1, t)) on as many of their hits, all
within 1e-4. A ray nearly tangent to a cylinder solves an ill-conditioned
quadratic, and the packages' to_object products round differently (XLA's
dot, torch's matmul). Measured: every prim id equal; t within 3.1e-7 on
faces and disks, within 1.8e-5 on cylinders (one ray above 1e-5)."""

import numpy as np
import pytest
import torch

import mitsuba2_tpu as mj
import mitsuba2_tpu_torch as mt
from mitsuba2_tpu.core.transform import Transform as TJ
from mitsuba2_tpu_torch.core.transform import Transform as TT
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()

ID_SHARE = 0.999


def scene_dict(T):
    """A floor, a sphere, three disks (one elliptic, one flipped) and two
    cylinders (one through a to_world)."""
    return {
        "type": "scene",
        "floor": {"type": "rectangle", "to_world": T.translate([0, 0, -1])
                  @ T.scale(3)},
        "ball": {"type": "sphere", "center": [1.2, 0.5, 0.2],
                 "radius": 0.4},
        "disk": {"type": "disk", "to_world": T.translate([0, 0, 0.5])},
        "ellipse": {"type": "disk", "flip_normals": True,
                    "to_world": T.translate([-1.0, 1.0, 0.0])
                    @ T.rotate([1, 0, 0], 60) @ T.scale([0.7, 0.3, 1])},
        "small": {"type": "disk", "to_world": T.translate([0.5, -1.2, -0.2])
                  @ T.rotate([0, 1, 0], -30) @ T.scale(0.4)},
        "rod": {"type": "cylinder", "radius": 0.2, "p0": [-1.5, -1, -0.5],
                "p1": [1.5, -0.5, 0.3]},
        "pipe": {"type": "cylinder", "radius": 0.5, "flip_normals": True,
                 "to_world": T.translate([0.8, 1.2, -0.8])
                 @ T.rotate([1, 0, 0], 20)},
    }


def rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(1.5, 3.0, n)
    target = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    target[:, 2] = rng.uniform(-1.2, 0.8, n)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.where(rng.random(n) < 0.2, rng.uniform(0.5, 3.0, n),
                    np.inf).astype(np.float32)
    active = rng.random(n) > 0.05
    return o, d, mint, maxt, active


@pytest.fixture(scope="module")
def scenes():
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    return mj.load_dict(scene_dict(TJ)), mt.load_dict(scene_dict(TT))


def test_scene_packs_disks_and_cylinders(scenes):
    sj, st = scenes
    assert st.tables.n_quads == sj.n_quads == 5
    assert st.tables.n_spheres == sj.n_spheres == 1
    assert st.tables.n_faces == 2
    np.testing.assert_array_equal(st.quad_table[:, 24],
                                  np.asarray(sj.quad_table)[:, 24])


def test_queries_match_jax_scene(scenes):
    import jax.numpy as jnp
    from mitsuba2_tpu.core.ray import Ray as RayJ
    from mitsuba2_tpu_torch.core.ray import Ray
    sj, st = scenes
    o, d, mint, maxt, active = rays(20000, 7)
    rj = RayJ.make(jnp.asarray(o), jnp.asarray(d), mint=jnp.asarray(mint),
                   maxt=jnp.asarray(maxt))
    pj = sj.ray_intersect_preliminary(rj, jnp.asarray(active))
    hj = np.asarray(sj.ray_test(rj, jnp.asarray(active)))
    rt = Ray.make(o, d, mint=mint, maxt=maxt)
    pt = st.ray_intersect_preliminary(rt, torch.as_tensor(active))
    ht = st.ray_test(rt, torch.as_tensor(active)).numpy()
    prim_j, prim_t = np.asarray(pj.prim_idx), pt.prim_idx.numpy()
    same = prim_t == prim_j
    assert same.mean() >= ID_SHARE
    base = st.tables.n_faces + st.tables.n_spheres
    quad = same & (prim_j >= base)
    # every quad is hit, and quads take a good share of the rays
    assert set(prim_j[quad] - base) == set(range(5))
    assert quad.mean() > 0.2
    hit = same & (prim_j >= 0)
    tj = np.asarray(pj.t)[hit]
    err = np.abs(pt.t.numpy()[hit] - tj) / np.maximum(np.abs(tj), 1.0)
    assert (err <= 1e-5).mean() >= ID_SHARE and err.max() <= 1e-4, \
        err.max()
    assert (pt.shape_idx.numpy() == np.asarray(pj.shape_idx))[same].all()
    assert (pt.prim_uv.numpy()[quad] == 0).all()
    assert (prim_t[~active] == -1).all() and not ht[~active].any()
    assert (ht == hj).mean() >= ID_SHARE
    assert (ht == np.isfinite(pt.t.numpy())).all()
