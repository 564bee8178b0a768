"""The BVH module: the port's copy of the binned-SAH builder against the JAX
package's (the same face order and the same nodes, bit for bit), the
scene's face order against the JAX scene's (exactly equal per-face
arrays), and the device walk (ops/intersect.py ``traverse``, the step for
step emulation of csrc/bvh.cuh) against a linear sweep over every face.

Tolerance of the walk: the walk and the sweep run the same float32 Woop
test, summed in another order, so a ray grazing an edge could in
principle flip; the bar is at least 99.9% equal face ids and t within
1e-6 relative on the rest. Measured: every ray equal.
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import bvh, intersect, path_kernel as pk
from mitsuba2_tpu_torch.python.test import scenes as scenes_t
from mitsuba2_tpu_torch.utils.io_obj import load_obj
from tests.test_torch_mesh_io import (jax_bumpy_dict, jax_hero_dict,
                                      reference_file)
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()


def random_triangles(n, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.normal(size=(n, 3)).astype(np.float32)
    e1 = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    e2 = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    return v0, e1, e2


def bumpy_triangles(nu=32, nv=20):
    v, f, _, _ = load_obj(scenes_t._bumpy_sphere_obj_path(nu, nv))
    p = v[f]
    return p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]


MESHES = {"random": lambda: random_triangles(3000, 1),
          "bumpy": bumpy_triangles,
          "flat": lambda: random_triangles(200, 2)[:1] + tuple(
              x * [1, 1, 0] for x in random_triangles(200, 2)[1:])}


@pytest.mark.parametrize("leaf_size", [64, bvh.TRAVERSAL_LEAF])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_native_builder_matches_jax(mesh, leaf_size):
    from mitsuba2_tpu.ops import bvh as bvh_j
    assert bvh_j.native_available()
    tris = MESHES[mesh]()
    ours = bvh.build_bvh(*tris, leaf_size=leaf_size)
    theirs = bvh_j.build_bvh(*tris, leaf_size=leaf_size)
    np.testing.assert_array_equal(ours.order, theirs.order)
    np.testing.assert_array_equal(ours.nodes.view(np.int32),
                                  theirs.nodes.view(np.int32))
    bvh.validate_bvh(ours, *tris)


def test_median_split_only_on_request():
    from mitsuba2_tpu.ops import bvh as bvh_j
    tris = random_triangles(500, 3)
    ours = bvh.build_bvh(*tris, leaf_size=16, force_numpy=True)
    theirs = bvh_j.build_bvh(*tris, leaf_size=16, force_numpy=True)
    np.testing.assert_array_equal(ours.order, theirs.order)
    np.testing.assert_array_equal(ours.nodes.view(np.int32),
                                  theirs.nodes.view(np.int32))
    native = bvh.build_bvh(*tris, leaf_size=16)
    assert not np.array_equal(native.order, ours.order)


def test_failed_native_build_raises(monkeypatch):
    from mitsuba2_tpu_torch.ops import build

    def broken(name, defines=None):
        raise RuntimeError("g++ failed (1)")

    monkeypatch.setattr(build, "load", broken)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        bvh.build_bvh(*random_triangles(10, 4))


def test_chunk_bounds_match_jax():
    from mitsuba2_tpu.ops import bvh as bvh_j
    tris = bumpy_triangles()
    for chunk in (64, 100):
        np.testing.assert_array_equal(bvh.chunk_bounds(*tris, chunk),
                                      bvh_j.chunk_bounds(*tris, chunk))


@pytest.mark.parametrize("n", [1, 3, 5000])
def test_pack_traversal_covers_every_face_once(n):
    tris = random_triangles(n, 5)
    tree = bvh.build_bvh(*tris, leaf_size=bvh.TRAVERSAL_LEAF)
    pairs, depth = bvh.pack_traversal(tree)
    ints = pairs.view(np.int32)
    assert pairs.shape[1] == bvh.PAIR_SLOTS and 1 <= depth <= \
        bvh.STACK_DEPTH
    seen = np.zeros(n, int)
    p = np.stack([tris[0], tris[0] + tris[1], tris[0] + tris[2]], 1)
    for side in (0, 8):
        ref, cnt = ints[:, side + 3], ints[:, side + 7]
        lo, hi = pairs[:, side:side + 3], pairs[:, side + 4:side + 7]
        for k in np.flatnonzero(cnt > 0):
            faces = tree.order[ref[k]:ref[k] + cnt[k]]
            seen[faces] += 1
            pts = p[faces].reshape(-1, 3)
            assert (pts >= lo[k]).all() and (pts <= hi[k]).all()
        inner = (cnt == 0) & (ref >= 0)
        assert (ref[inner] > np.flatnonzero(inner)).all()
        assert (ref[inner] < len(pairs)).all()
    assert (seen == 1).all()
    if n <= bvh.TRAVERSAL_LEAF:
        assert len(pairs) == 1 and ints[0, 8 + 3] == -1


def _jax_scene_and_port_scene(name):
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.python.test import scenes as scenes_j
    reference_file(scenes_j._sky_exr_path)
    makers = {
        "cornell": (scenes_j.cornell_box_dict(8, 8, 2, 3),
                    scenes_t.cornell_box_dict(8, 8, 2, 3)),
        "matpreview": (scenes_j.matpreview_dict(8, 8, 2, 3),
                       scenes_t.matpreview_dict(8, 8, 2, 3)),
        "biggeo": (jax_bumpy_dict(8, 8, 2, 3, 32, 20),
                   scenes_t.bumpy_sphere_dict(8, 8, 2, 3, 32, 20)),
        "hero": (jax_hero_dict(8, 8, 2, 3),
                 scenes_t.hero_serialized_dict(8, 8, 2, 3, 32, 20)),
    }
    dj, dt = makers[name]
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    return mj.load_dict(dj), mt.load_dict(dt)


@pytest.mark.parametrize("name,n_faces", [
    ("cornell", 36), ("matpreview", 14), ("biggeo", 1220), ("hero", 1218)])
def test_scene_face_order_is_the_reference_order(name, n_faces):
    sj, st = _jax_scene_and_port_scene(name)
    g = sj.geom
    assert len(st.v0) == n_faces
    for attr in ("v0", "e1", "e2", "ng", "face_shape"):
        np.testing.assert_array_equal(getattr(st, attr),
                                      np.asarray(getattr(g, attr)), attr)
    uvs = np.stack([np.asarray(g.uv0), np.asarray(g.uv1),
                    np.asarray(g.uv2)], 1)
    np.testing.assert_array_equal(st.uvs, uvs)
    np.testing.assert_array_equal(st.bvh.order, sj.bvh.order)
    # the traversal tree's face ids are the reference's
    assert sorted(st.tables.bvh_prim.tolist()) == list(range(n_faces))
    np.testing.assert_array_equal(
        st.tables.bvh_woop.numpy(),
        st.tables.woop.numpy()[st.tables.bvh_prim.numpy()])
    flags = st.tables.flags & pk.HAS_BVH
    assert flags == (pk.HAS_BVH if n_faces > pk.MAX_FACES_SHARED else 0)


def _rays(tris, n, seed):
    """Half the rays aimed at the mesh from outside, half anywhere."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)) * 3.0
    d = rng.normal(size=(n, 3))
    d[: n // 2] = -o[: n // 2] + rng.normal(size=(n // 2, 3)) * 0.4
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32),
            torch.tensor(d, dtype=torch.float32))


def _tree(tris):
    tree = bvh.build_bvh(*tris, leaf_size=bvh.TRAVERSAL_LEAF)
    nodes, _ = bvh.pack_traversal(tree)
    woop = pk.build_woop(*tris)
    return (torch.tensor(nodes), torch.tensor(woop[tree.order]),
            torch.tensor(tree.order), torch.tensor(woop))


@pytest.mark.parametrize("k2", [True, False])
def test_walk_matches_linear_sweep(k2):
    tris = bumpy_triangles(48, 30)
    nodes, twoop, prim, woop = _tree(tris)
    o, d = _rays(tris, 2048, 6)
    mint = torch.zeros(len(o))
    maxt = torch.full((len(o),), float("inf"))
    maxt[::3] = 3.0                       # some segments end early
    walk = intersect.traverse(nodes, twoop, prim, o, d, mint, maxt, k2=k2)
    if k2:
        t, uv, face = intersect.closest_hit_reference(woop, o, d, mint,
                                                      maxt)
    else:
        tf, uf, vf = pk._woop_t_uv(woop, list(o.T), list(d.T))
        ok = pk._face_ok(tf, uf, vf, maxt)
        t, face = pk._argmin_lowest(torch.where(ok, tf, pk._BIG))
        face = torch.where(t < pk._BIG * 0.5, face, -1)
        t = torch.where(face >= 0, t, float("inf"))
    same = walk["face"] == face
    assert same.float().mean() >= 0.999
    hit = same & (face >= 0)
    assert 0.2 < hit.float().mean() < 0.9
    torch.testing.assert_close(walk["t"][hit], t[hit], rtol=1e-6, atol=0)
    assert torch.isinf(walk["t"][same & (face < 0)]).all()
    any_walk = intersect.traverse(nodes, twoop, prim, o, d, mint, maxt,
                                  any_hit=True, k2=k2)
    any_sweep = intersect.any_hit_reference(woop, o, d, mint, maxt)
    assert (any_walk["hit"] == any_sweep).float().mean() >= 0.999
    # the walk tests a small part of the faces
    assert walk["faces"].float().mean() < 0.05 * len(woop)
    assert (any_walk["boxes"] <= walk["boxes"] + 2 * 64).all()
    # what it reads: the root, every hit face's rows, each row only of a
    # face whose Z row it read, and less than the whole tree
    for w in (walk, any_walk):
        reads = w["face_reads"]
        assert w["node_reads"][0] and 0 < int(reads[:, 0].sum()) <= int(
            w["faces"].sum())
        assert not (reads[:, 2] & ~reads[:, 1]).any()
        assert not (reads[:, 1] & ~reads[:, 0]).any()
        assert 0 < intersect.bytes_read(w) < (
            nodes.numel() + twoop.numel() + prim.numel()) * 4
    pos = torch.argsort(prim)[walk["face"][walk["face"] >= 0]]
    assert walk["face_reads"][pos].all()


def test_walk_ties_go_to_the_lowest_face_id():
    """Copies of one triangle at several face ids: every ray reports the
    lowest, however the tree orders them."""
    v0, e1, e2 = random_triangles(400, 7)
    for dup in (17, 230, 391):
        v0[dup], e1[dup], e2[dup] = v0[5], e1[5], e2[5]
    nodes, twoop, prim, woop = _tree((v0, e1, e2))
    c = v0[5] + (e1[5] + e2[5]) / 3.0
    n = np.cross(e1[5], e2[5])
    o = torch.tensor(c + 2.0 * n / np.linalg.norm(n) + np.random.default_rng(
        8).normal(size=(64, 3)) * 1e-3, dtype=torch.float32)
    d = torch.tensor(c, dtype=torch.float32) - o
    d = d / d.norm(dim=1, keepdim=True)
    mint = torch.zeros(64)
    maxt = torch.full((64,), float("inf"))
    walk = intersect.traverse(nodes, twoop, prim, o, d, mint, maxt, k2=True)
    _, _, face = intersect.closest_hit_reference(woop, o, d, mint, maxt)
    assert (face == 5).float().mean() > 0.9
    assert torch.equal(walk["face"].int(), face)
