"""Traversal trees that the SAH build alone does not fit to the BVH walk
(ops/bvh.py ``traversal_bvh``): faces with one centroid, which the builder
keeps in one leaf beyond the walk's leaf word, and clustered meshes whose
SAH trees are deeper than the walk's stack. The guarantees of the fully
median trees and the trees that fit, bit for bit the SAH build's, are in
tests/test_torch_deep_tree_bounds.py.

The render's bar is tests/test_torch_wavefront.py's: at least 99% of
pixels within 1e-4 relative and the image means within 1e-5 relative of
the JAX wavefront's render at equal seed, each lane held beside it.
"""

import importlib

import pytest

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import bvh, intersect, path_kernel as pk
from mitsuba2_tpu_torch.python.test import scenes as scenes_t
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_wavefront import render_pair

_on_cpu = cpu_device_fixture()

# the clustered meshes whose SAH trees exceed the stack: (faces, scale,
# seed) of scenes.log_uniform_mesh
DEEP_MESHES = [(16384, 1e4, 1), (16384, 1e6, 0), (262144, 1e4, 0),
               (262144, 1e4, 1)]


def sah_bound(v0, e1, e2, leaf_size=bvh.TRAVERSAL_LEAF):
    """The stack bound of the SAH tree alone, where its leaves fit."""
    return bvh.pack_traversal(bvh.build_bvh(v0, e1, e2, leaf_size))[1]


def test_coincident_faces_load_and_render_as_the_jax_package(tmp_path):
    """40 copies of one triangle from an OBJ file (one centroid: the SAH
    builder's leaf holds all 40, beyond the walk's leaf word of 32) load,
    their traversal tree split into leaves of at most TRAVERSAL_LEAF, and
    render under a constant emitter as the JAX package renders them."""
    path = tmp_path / "coincident.obj"
    path.write_text("v -1 -1 0\nv 1 -1 0\nv 0 1 0\n" + "f 1 2 3\n" * 40)

    def make(pkg):
        T = importlib.import_module(pkg.__name__ + ".core.transform") \
            .Transform
        return scenes_t.coincident_faces_dict(8, 8, 2, 3, T=T,
                                              filename=str(path))

    st, img = render_pair(make, "scalar_rgb", 8, 2, force=False)
    assert st.integrator.engine_reason == "unsupported emitter " \
        "ConstantEmitter"
    sah = bvh.build_bvh(st.v0, st.e1, st.e2, bvh.TRAVERSAL_LEAF)
    assert max(count for _, count, _, _ in sah.leaves()) == 40
    tree = st.traversal
    assert max(count for _, count, _, _ in tree.leaves()) \
        <= bvh.TRAVERSAL_LEAF and not tree.by_level
    bvh.validate_bvh(tree, st.v0, st.e1, st.e2)
    assert 0 < st.tables.bvh_depth <= bvh.STACK_DEPTH
    pk.check_tree(st.tables)
    assert 0.5 < float(img.mean()) < 1.0


@pytest.mark.parametrize("n,scale,seed", DEEP_MESHES)
def test_clustered_mesh_tree_fits_the_stack(n, scale, seed):
    """A clustered mesh (faces at log-uniform distances) whose SAH tree's
    stack bound exceeds STACK_DEPTH loads into a tree within it: a valid
    BVH of every face, the scene's tables accepted by the path kernel's
    checks, and a binary depth within the host's binary walk's stack."""
    scene = mt.load_dict(scenes_t.clustered_mesh_dict(
        4, 4, 1, 2, n=n, scale=scale, seed=seed))
    v0, e1, e2 = scene.v0, scene.e1, scene.e2
    assert len(v0) == n + 4          # and the floor and the light
    assert sah_bound(v0, e1, e2) > bvh.STACK_DEPTH
    tree = scene.traversal
    bvh.validate_bvh(tree, v0, e1, e2)
    assert tree.by_level
    tables = scene.tables
    assert tables.flags & pk.HAS_BVH
    assert 0 < tables.bvh_depth <= bvh.STACK_DEPTH
    assert tables.bvh_depth == bvh.pack_traversal(tree)[1]
    pk._check_tables(tables, pk.camera_row(scene.sensors[0], "cpu"))
    assert bvh.pack_pairs(tree)[1] <= intersect.PAIR_STACK + 1
