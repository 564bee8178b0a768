"""The bounds behind ops/bvh.py ``traversal_bvh``: the fully median trees
fit the walks' stacks for the face and instance counts that
``bvh.STACK_DEPTH``'s and ``intersect_kernel.TOP_STACK_DEPTH``'s notes
state, the trees that fit stay the SAH build's bit for bit, and the host's
binary walk raises instead of indexing past its stack. The deep trees
themselves are tests/test_torch_deep_trees.py's.
"""

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.ops import bvh, intersect
from mitsuba2_tpu_torch.ops import intersect_kernel as ik, path_kernel as pk
from mitsuba2_tpu_torch.python.test import scenes as scenes_t
from mitsuba2_tpu_torch.render.scene import _mesh_face_arrays
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()

# the fully median top tree fits TOP_STACK_DEPTH up to this many instances
# (ops/intersect_kernel.py's note on it)
MEDIAN_TOP_INSTANCES = 6 << 18


def median_tree(v0, e1, e2, leaf_size):
    """The fully median tree (``build_bvh(..., sah_depth=0)``), collapsed
    level by level as ``traversal_bvh`` collapses it."""
    tree = bvh.build_bvh(v0, e1, e2, leaf_size, sah_depth=0)
    tree.by_level = True
    return tree


def test_median_tree_fits_every_face_count():
    """The fully median tree of MAX_FACES_HBM faces at TRAVERSAL_LEAF has
    18 binary levels above its leaves and the stack bound 3 * floor((18 -
    1) / 2) = 24, as STACK_DEPTH's note says; smaller counts stay within
    that formula of their own depth."""
    rng = np.random.default_rng(3)
    for n in (5, 17, 1000, 4097, 65537, pk.MAX_FACES_HBM):
        v0 = rng.uniform(0, 100, (n, 3)).astype(np.float32)
        e = np.full((n, 3), 0.01, np.float32)
        tree = median_tree(v0, e, e, bvh.TRAVERSAL_LEAF)
        D = bvh._interior_depth(tree)
        assert D == int(np.ceil(np.log2(np.ceil(n / bvh.TRAVERSAL_LEAF))))
        bound = bvh.pack_traversal(tree)[1]
        assert bound <= 3 * ((D - 1) // 2)
        if n == pk.MAX_FACES_HBM:
            assert (D, bound) == (18, 24)


@pytest.mark.parametrize("extra", [0, 1])
def test_median_top_tree_fits_the_stated_instances(extra):
    """The fully median top tree (one box a leaf) of MEDIAN_TOP_INSTANCES
    boxes has the stack bound TOP_STACK_DEPTH; one box more needs one
    entry more, which the instance entries' check refuses."""
    n = MEDIAN_TOP_INSTANCES + extra
    lo = np.random.default_rng(4).uniform(0, 1000, (n, 3)).astype(
        np.float32)
    tree = median_tree(lo, np.full_like(lo, 0.5), np.zeros_like(lo), 1)
    assert bvh._interior_depth(tree) == 21
    assert bvh.pack_traversal(tree)[1] == ik.TOP_STACK_DEPTH + extra


def _same_tree(a, b):
    np.testing.assert_array_equal(a.order, b.order)
    np.testing.assert_array_equal(a.nodes.view(np.int32),
                                  b.nodes.view(np.int32))
    assert not a.by_level and not b.by_level


@pytest.mark.parametrize("name", ["cornell", "bumpy", "hero"])
def test_fitting_scene_tree_is_the_sah_build(name):
    """Where the SAH tree fits, the scene's traversal tree is that tree,
    bit for bit, and so are its tables."""
    make = {"cornell": lambda: scenes_t.cornell_box_dict(4, 4, 1, 2),
            "bumpy": lambda: scenes_t.bumpy_sphere_dict(4, 4, 1, 2, 64, 33),
            "hero": lambda: scenes_t.hero_serialized_dict(4, 4, 1, 2, 64,
                                                          33)}[name]
    scene = mt.load_dict(make())
    sah = bvh.build_bvh(scene.v0, scene.e1, scene.e2, bvh.TRAVERSAL_LEAF)
    _same_tree(scene.traversal, sah)
    nodes, depth = bvh.pack_traversal(sah)
    assert torch.equal(scene.tables.bvh_nodes.view(torch.int32),
                       torch.as_tensor(nodes).view(torch.int32))
    assert scene.tables.bvh_depth == depth


def test_fitting_instance_trees_are_the_sah_build():
    """The shared instances' group trees and top tree, where they fit, are
    the SAH build's bit for bit: a group's at TRAVERSAL_LEAF, the top
    tree's at one box a leaf with the builder's larger leaves split."""
    scene = mt.load_dict(scenes_t.instanced_spheres_dict(
        4, False, 24, 12, width=4, height=4, spp=1, max_depth=2))
    inst = scene.inst_tables
    for tree, meshes in zip(inst.trees, scene._inst_children):
        faces = [np.concatenate([_mesh_face_arrays(c)[k] for c in meshes])
                 .astype(np.float32) for k in range(3)]
        _same_tree(tree, bvh.build_bvh(*faces, bvh.TRAVERSAL_LEAF))
    lo, hi = ik.instance_boxes(inst.trees, inst.rows.numpy())
    sah = bvh.split_leaves(
        bvh.build_bvh(lo, hi - lo, np.zeros_like(lo), leaf_size=1), lo, hi)
    _same_tree(ik.top_bvh(lo, hi), sah)


def test_binary_walk_refuses_a_tree_beyond_its_stack():
    """The host's binary walk over pair nodes raises WalkStackError where
    a ray would push beyond its PAIR_STACK entries, instead of indexing
    past its stack: a chain of pair nodes, each with the next one and an
    empty pair node as its children, pushes one entry a level."""
    levels = intersect.PAIR_STACK + 2
    pairs = np.zeros((levels + 1, bvh.PAIR_SLOTS), np.float32)
    ints = pairs.view(np.int32)
    ints[levels, [3, 11]] = -1
    for k in range(levels):
        # both children's boxes around the ray's path (x from -1 to 11)
        for side in (0, 8):
            pairs[k, side:side + 3] = [-1.0, -1.0, -1.0]
            pairs[k, side + 4:side + 7] = [11.0, 1.0, 1.0]
        ints[k, 3] = k + 1 if k + 1 < levels else -1
        ints[k, 11] = levels
    o = torch.tensor([[-5.0, 0.0, 0.0]])
    d = torch.tensor([[1.0, 0.0, 0.0]])
    with pytest.raises(intersect.WalkStackError, match="binary"):
        intersect.traverse_pairs(torch.as_tensor(pairs), torch.zeros((1, 12)),
                                 torch.zeros(1, dtype=torch.int32), o, d,
                                 torch.zeros(1), torch.full((1,), 1e30))
