"""BVH over triangles: the host builder, the scene's face order and the
device traversal tree.

Counterpart of ``mitsuba2_tpu/ops/bvh.py``. The builder is the reference's
binned-SAH builder (csrc/bvh.cpp, a copy of mitsuba2_tpu/native/bvh.cpp),
compiled with the host C++ compiler through ops/build.py and loaded with
ctypes. It serves twice:

- the scene's face order: ``build_bvh(..., leaf_size=64)`` over the faces
  in shape order, whose ``order`` the scene applies to every per-face
  array, as the reference does (mitsuba2_tpu/render/scene.py:253-275), so
  face ids, prim ids and exact ties are the reference's;
- the traversal tree: a second build at ``TRAVERSAL_LEAF`` faces per leaf
  over the already permuted faces (``traversal_bvh``), collapsed by
  ``pack_traversal`` into the 4-wide nodes that csrc/bvh.cuh walks per ray
  (the path kernel's BVH tier and the scene's ray queries). Its leaves
  hold contiguous ranges of its own ``order``, whose entries are the
  reference's face ids.

A traversal tree must fit the walk: no leaf above ``2**LEAF_BITS`` faces
and a stack bound within its stack. ``traversal_bvh`` keeps the SAH tree
where it fits; where a leaf of faces with one centroid is too large it
splits that leaf, and where the tree is deeper than the stack it rebuilds
it with SAH only down to a depth and object medians below
(csrc/bvh.cpp ``bvh_build_capped``), collapsed level by level.

What bounds the walk on the card is its chain of dependent node reads
from L2, one per node visited, not its arithmetic: a 4-wide node (one
128-byte line, eight independent loads, four slab tests side by side)
about halves that chain against the binary tree's pair nodes, for about a
third more box tests. The leaves stay the binary tree's, so the face
order and the Woop rows in tree order do not change; ``pack_pairs`` keeps
the binary tree's pair nodes, which no kernel reads, for the walk whose
tests the kernels' bounds count (ops/intersect.py ``traverse_pairs``).

There is no other builder: another builder gives another face order, so
a failed native build raises instead of falling back.
"""

from __future__ import annotations

import ctypes

import numpy as np

# Node record (csrc/bvh.cpp struct Node): 12 32-bit slots.
_NODE_SLOTS = 12
_LO, _LEFT, _HI, _COUNT, _RIGHT = slice(0, 3), 3, slice(4, 7), 7, 8

# faces per leaf of the traversal tree (the SAH builder may keep up to 4x
# as many in a leaf when splitting costs more)
TRAVERSAL_LEAF = 4
# children of a wide node, and its float32 slots: one 128-byte line
WIDTH, WIDE_SLOTS = 4, 32
# the walk's word for a leaf child (csrc/bvh.cuh test_line): ~(first <<
# LEAF_BITS | count - 1), so a leaf holds at most 2^LEAF_BITS faces and
# begins below 2^(31 - LEAF_BITS)
LEAF_BITS = 5
# entries of the per-ray traversal stack (csrc/bvh.cuh STACK); a tree
# whose stack bound (``pack_traversal``) exceeds it is refused on the host
# (ops/path_kernel.py ``check_tree``). WIDTH, LEAF_BITS and STACK_DEPTH
# must equal csrc/bvh.cuh's constants: tests/test_torch_bvh.py reads them
# there and holds them equal.
# What fits, whatever the geometry: ``traversal_bvh`` falls back as far as
# the fully median tree, whose n faces at TRAVERSAL_LEAF a leaf make D =
# ceil(log2(ceil(n / 4))) binary levels above the leaves; collapsed level
# by level, a wide node pushes at most 3 and reaches 2 levels down, and
# one whose children are all leaves pushes none, so its bound is at most
# 3 * floor((D - 1) / 2): 24 at MAX_FACES_HBM = 1,048,576 faces (D = 18),
# 33 at the 2^26 faces a leaf's word addresses (LEAF_BITS, D = 24). 48
# holds it for every face count the layout addresses (it would up to
# 4 * 2^34 faces, D = 34) (tests/test_torch_deep_tree_bounds.py)
STACK_DEPTH = 48
# pair-node float32 slots: per child [lo xyz, ref] [hi xyz, count]
PAIR_SLOTS = 16
# outward padding of every child box, relative to its coordinates, so that
# float rounding in the slab test never culls a face the Woop test hits
BOX_PAD = 1e-5


class BVH:
    """Flattened BVH: ``nodes`` is (M, 12) float32 with int32 fields viewed
    in place; ``order`` is the face permutation (leaf-contiguous);
    ``by_level`` whether ``pack_traversal`` collapses it level by level
    (``traversal_bvh``'s capped trees) instead of by surface area."""

    def __init__(self, nodes: np.ndarray, order: np.ndarray,
                 by_level: bool = False):
        self.nodes = nodes
        self.order = order
        self.by_level = by_level

    @property
    def n_nodes(self):
        return len(self.nodes)

    def _ints(self):
        return self.nodes.view(np.int32)

    def bounds(self):
        """-> (lo, hi) (3,) float32 of the root's box, every face's."""
        return self.nodes[0, _LO].copy(), self.nodes[0, _HI].copy()

    def leaves(self):
        """Yield (first, count, lo, hi) per leaf, in node order."""
        ints = self._ints()
        for i in range(len(self.nodes)):
            cnt = int(ints[i, _COUNT])
            if cnt > 0:
                yield (int(ints[i, _LEFT]), cnt,
                       self.nodes[i, _LO].copy(), self.nodes[i, _HI].copy())


def _native(capped=False):
    """csrc/bvh.cpp's ``bvh_build``, or with ``capped`` its
    ``bvh_build_capped``, built on first use; a failed build raises."""
    from .build import load
    lib = load("bvh")
    fn = lib.bvh_build_capped if capped else lib.bvh_build
    fp = ctypes.POINTER(ctypes.c_float)
    fn.restype = ctypes.c_int
    fn.argtypes = [fp, fp, fp, ctypes.c_int, ctypes.c_int] + (
        [ctypes.c_int] if capped else []) + [
        ctypes.POINTER(ctypes.c_int32), fp, ctypes.c_int]
    return fn


def build_bvh(v0, e1, e2, leaf_size: int = 64, sah_depth=None) -> BVH:
    """BVH over triangles (v0 + u e1 + v e2) by the native binned-SAH
    builder; no faces give one empty leaf. With ``sah_depth`` the depth-
    capped build: SAH down to that binary depth, object medians below
    (csrc/bvh.cpp ``bvh_build_capped``)."""
    v0 = np.ascontiguousarray(v0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    n = len(v0)
    if n == 0:
        node = np.zeros((1, _NODE_SLOTS), np.float32)
        node.view(np.int32)[0, _RIGHT] = -1
        return BVH(node, np.zeros(0, np.int32))
    order = np.empty(n, np.int32)
    max_nodes = 4 * n + 4
    buf = np.empty((max_nodes, _NODE_SLOTS), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    capped = () if sah_depth is None else (int(sah_depth),)
    written = _native(bool(capped))(
        v0.ctypes.data_as(fp), e1.ctypes.data_as(fp), e2.ctypes.data_as(fp),
        n, leaf_size, *capped,
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        buf.ctypes.data_as(fp), max_nodes)
    if written < 0:
        raise RuntimeError(f"bvh_build needs more than {max_nodes} nodes")
    return BVH(buf[:written].copy(), order)


def split_leaves(bvh: BVH, lo, hi, leaf_size: int = 1, over=None) -> BVH:
    """``bvh`` with every leaf of more than ``over`` primitives (by default
    ``leaf_size``; the builder keeps up to four times its leaf size, or all
    of those with one centroid) split into a balanced subtree of leaves of
    at most ``leaf_size`` over the same range of ``order``, built in place
    of the leaf, its nodes appended; ``lo``, ``hi`` (n, 3) float32 are each
    primitive's box, by primitive index."""
    over = leaf_size if over is None else over
    out = list(bvh.nodes)

    def split(first, count):
        row = np.zeros(_NODE_SLOTS, np.float32)
        ints = row.view(np.int32)
        if count <= leaf_size:
            k = bvh.order[first:first + count]
            row[_LO], row[_HI] = lo[k].min(0), hi[k].max(0)
            ints[_LEFT], ints[_COUNT], ints[_RIGHT] = first, count, -1
            return row
        kids = (split(first, count // 2),
                split(first + count // 2, count - count // 2))
        out.extend(kids)
        row[_LO] = np.minimum(kids[0][_LO], kids[1][_LO])
        row[_HI] = np.maximum(kids[0][_HI], kids[1][_HI])
        ints[_LEFT], ints[_COUNT], ints[_RIGHT] = len(out) - 2, 0, len(out) - 1
        return row

    ints = bvh._ints()
    for i in np.flatnonzero(ints[:, _COUNT] > over):
        out[i] = split(int(ints[i, _LEFT]), int(ints[i, _COUNT]))
    return BVH(np.stack(out), bvh.order, bvh.by_level)


def traversal_bvh(v0, e1, e2, leaf_size: int = TRAVERSAL_LEAF,
                  stack: int = STACK_DEPTH, max_leaf: int = 1 << LEAF_BITS,
                  boxes=None) -> BVH:
    """The tree a walk reads over triangles (v0 + u e1 + v e2), within its
    leaf limit ``max_leaf`` and, where it can be, its stack of ``stack``
    entries (``pack_traversal``'s bound): the SAH tree at ``leaf_size``
    (``build_bvh``), bit for bit where it fits; else that tree with every
    leaf above ``max_leaf`` split into leaves of at most ``leaf_size``
    (``split_leaves``; the builder keeps all faces of one centroid in one
    leaf); and where that is still deeper than the stack, the depth-capped
    build (``build_bvh(..., sah_depth=k)``, its leaves split as well)
    collapsed level by level, at the largest k that a bisection over 0 to
    the SAH tree's depth finds to fit, or at k = 0 (object medians from the
    root), which fits every face count STACK_DEPTH's note names; a tree
    that still does not fit is returned, and the walk's checks refuse it.
    ``boxes`` (lo, hi) (n, 3) float32 are the primitives' boxes for the
    split leaves, by default the faces' own."""
    v0, e1, e2 = (np.ascontiguousarray(x, np.float32) for x in (v0, e1, e2))
    if boxes is None:
        p = np.stack([v0, v0 + e1, v0 + e2])
        boxes = (p.min(0), p.max(0))

    def fitted(tree, by_level=False):
        tree.by_level = by_level
        if len(tree.nodes) and tree._ints()[:, _COUNT].max() > max_leaf:
            tree = split_leaves(tree, *boxes, leaf_size=leaf_size,
                                over=max_leaf)
        return tree, pack_traversal(tree)[1]

    tree, depth = fitted(build_bvh(v0, e1, e2, leaf_size))
    if depth <= stack:
        return tree
    # bisect the cap: ``lo`` fits (k = 0 assumed until built), ``hi`` not
    lo, hi, best = 0, _interior_depth(tree) + 1, None
    while hi - lo > 1:
        k = (lo + hi) // 2
        cand, depth = fitted(build_bvh(v0, e1, e2, leaf_size, sah_depth=k),
                             by_level=True)
        if depth <= stack:
            lo, best = k, cand
        else:
            hi = k
    if best is None:
        best = fitted(build_bvh(v0, e1, e2, leaf_size, sah_depth=0),
                      by_level=True)[0]
    return best


def validate_bvh(bvh: BVH, v0, e1, e2) -> None:
    """Structural checks (used by tests): the order is a permutation,
    leaves cover every face exactly once, every node's AABB contains its
    faces, interior AABBs contain their children."""
    n = len(v0)
    assert sorted(bvh.order.tolist()) == list(range(n))
    ints = bvh._ints()
    p = np.stack([v0, v0 + e1, v0 + e2], 1)
    covered = np.zeros(n, bool)
    for first, count, lo, hi in bvh.leaves():
        faces = bvh.order[first:first + count]
        assert not covered[faces].any()
        covered[faces] = True
        pts = p[faces].reshape(-1, 3)
        assert (pts >= lo - 1e-4).all() and (pts <= hi + 1e-4).all()
    assert covered.all() or n == 0
    for i in range(bvh.n_nodes):
        if ints[i, _COUNT] == 0 and ints[i, _RIGHT] >= 0:
            for c in (ints[i, _LEFT], ints[i, _RIGHT]):
                assert (bvh.nodes[c, _LO] >= bvh.nodes[i, _LO] - 1e-4).all()
                assert (bvh.nodes[c, _HI] <= bvh.nodes[i, _HI] + 1e-4).all()


def _child_boxes(bvh: BVH):
    """-> (interior mask, lo, hi (M, 3) float32 padded outward by
    ``BOX_PAD`` relative to the box's coordinates) of every node."""
    ints = bvh._ints()
    interior = (ints[:, _COUNT] == 0) & (ints[:, _RIGHT] >= 0)
    lo = bvh.nodes[:, _LO].astype(np.float64)
    hi = bvh.nodes[:, _HI].astype(np.float64)
    pad = BOX_PAD * (1.0 + np.maximum(np.abs(lo), np.abs(hi)).max(1))
    return (interior, (lo - pad[:, None]).astype(np.float32),
            (hi + pad[:, None]).astype(np.float32))


def pack_pairs(bvh: BVH):
    """The binary tree as pair nodes -> (pairs (P, 16) float32, depth).

    No kernel reads this layout: it is the tree whose box and face tests
    the kernels' bounds count (ops/intersect.py ``traverse_pairs``), so
    that a bound does not grow with the wider walk's extra box tests. One
    pair node per interior node of ``bvh`` (a single-leaf tree gets one
    pair whose second child is empty), in node order, so pair 0 is the
    root. A pair holds both children, each as [lo xyz, ref] [hi xyz,
    count] with ref and count int32 bits: an interior child has count 0
    and ref its pair index, a leaf has count > 0 and ref its first
    position in ``bvh.order``, an empty child ref -1. ``depth`` is the
    number of pair nodes on the longest root-to-leaf chain."""
    ints = bvh._ints()
    count = ints[:, _COUNT]
    left, right = ints[:, _LEFT], ints[:, _RIGHT]
    interior, lo, hi = _child_boxes(bvh)
    pair_id = np.cumsum(interior) - 1

    def child(c):
        """[lo, ref] [hi, count] of nodes ``c`` -> (len(c), 8) float32."""
        rows = np.zeros((len(c), 8), np.float32)
        rows[:, 0:3] = lo[c]
        rows[:, 4:7] = hi[c]
        r = rows.view(np.int32)
        leaf = ~interior[c]
        r[:, 3] = np.where(leaf, left[c], pair_id[c])
        r[:, 7] = np.where(leaf, count[c], 0)
        return rows

    if not interior[0]:
        pairs = np.zeros((1, PAIR_SLOTS), np.float32)
        pairs[0, :8] = child(np.zeros(1, np.int64))[0]
        pairs.view(np.int32)[0, 8 + 3] = -1
        return pairs, 1
    nodes = np.flatnonzero(interior)
    pairs = np.concatenate([child(left[nodes]), child(right[nodes])], 1)
    return np.ascontiguousarray(pairs), _interior_depth(bvh)


def _interior_depth(bvh: BVH) -> int:
    """The interior nodes on the longest root-to-leaf chain of ``bvh``,
    one level of interior children at a time (0 for a single leaf)."""
    ints = bvh._ints()
    left, right = ints[:, _LEFT], ints[:, _RIGHT]
    interior = (ints[:, _COUNT] == 0) & (right >= 0)
    depth, level = 0, np.flatnonzero(interior[:1])
    while len(level):
        depth += 1
        kids = np.concatenate([left[level], right[level]])
        level = kids[interior[kids]]
    return depth


def pack_traversal(bvh: BVH):
    """The device layout of a traversal tree -> (nodes (P, 32) float32,
    depth): the binary tree collapsed into 4-wide nodes of one 128-byte
    line each.

    Each wide node takes a binary interior node's two children and, while
    it has fewer than ``WIDTH`` and one of them is interior, replaces the
    interior child of the largest surface area (for a ``by_level`` tree,
    of the least binary depth below the node, then the largest area) by
    its two children. Every
    interior child becomes a wide node of its own, level by level, so node
    0 is the root (a single-leaf tree gets one node with one child). The
    leaves are the binary tree's: ``order``, and with it the Woop rows and
    face ids in tree order, do not change.

    A line is structure of arrays over its four children: lo x, lo y, lo z,
    hi x, hi y, hi z (float32, padded outward by ``BOX_PAD`` relative to
    the box's coordinates), then the four refs and the four counts (int32
    bits): an interior child has count 0 and ref its node index, a leaf has
    count > 0 and ref its first position in ``bvh.order``, an empty slot
    ref -1 and the box lo +inf, hi -inf, which every ray misses.
    ``depth`` bounds the walk's stack: a node pushes at most its interior
    children but one, so the most pushes on any root-to-node chain."""
    ints = bvh._ints()
    count = ints[:, _COUNT]
    left, right = ints[:, _LEFT], ints[:, _RIGHT]
    interior, lo, hi = _child_boxes(bvh)
    ext = np.maximum(bvh.nodes[:, _HI] - bvh.nodes[:, _LO], 0.0).astype(
        np.float64)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] \
        + ext[:, 2] * ext[:, 0]
    if not interior[0]:
        slots = np.array([[0, -1, -1, -1]])
        levels, wide_of = [slots], np.zeros(1, np.int64)
    else:
        levels, wide_of = [], np.full(len(count), -1, np.int64)
        frontier, n_wide = np.zeros(1, np.int64), 0
        while len(frontier):
            m = len(frontier)
            wide_of[frontier] = np.arange(n_wide, n_wide + m)
            n_wide += m
            slots = np.full((m, WIDTH), -1, np.int64)
            slots[:, 0], slots[:, 1] = left[frontier], right[frontier]
            used = np.full(m, 2)
            rows = np.arange(m)
            # each slot's binary depth below the wide node
            below = np.ones((m, WIDTH), np.int64)
            for _ in range(WIDTH - 2):
                safe = np.maximum(slots, 0)
                split = (slots >= 0) & interior[safe]
                if bvh.by_level:
                    # (a slot lies fewer than WIDTH levels below)
                    least = np.where(split, below, WIDTH).min(1)
                    split &= below == least[:, None]
                k = np.where(split, area[safe], -1.0).argmax(1)
                r = rows[split[rows, k]]
                c = slots[r, k[r]]
                slots[r, k[r]] = left[c]
                slots[r, used[r]] = right[c]
                below[r, used[r]] = below[r, k[r]] = below[r, k[r]] + 1
                used[r] += 1
            levels.append(slots)
            kids = slots[slots >= 0]
            frontier = kids[interior[kids]]
    slots = np.concatenate(levels)
    n = len(slots)
    nodes = np.zeros((n, WIDE_SLOTS), np.float32)
    nodes[:, :3 * WIDTH] = np.inf
    nodes[:, 3 * WIDTH:6 * WIDTH] = -np.inf
    ref = nodes.view(np.int32)[:, 6 * WIDTH:7 * WIDTH]
    cnt = nodes.view(np.int32)[:, 7 * WIDTH:]
    ref[:] = -1
    valid = slots >= 0
    c = slots[valid]
    leaf = ~interior[c]
    if leaf.any() and (count[c[leaf]].max() > 1 << LEAF_BITS
                       or left[c[leaf]].max() >= 1 << (31 - LEAF_BITS)):
        raise ValueError(f"a leaf of more than {1 << LEAF_BITS} faces or "
                         f"beyond face {1 << (31 - LEAF_BITS)}")
    for axis in range(3):
        nodes[:, axis * WIDTH:(axis + 1) * WIDTH][valid] = lo[c, axis]
        nodes[:, (3 + axis) * WIDTH:(4 + axis) * WIDTH][valid] = hi[c, axis]
    ref[valid] = np.where(leaf, left[c], wide_of[c])
    cnt[valid] = np.where(leaf, count[c], 0)
    # the stack bound: pushes accumulated from the root, level by level
    # (a node's parent lies in the level before it)
    pushes = np.maximum((cnt == 0).sum(1) - (ref < 0).sum(1) - 1, 0)
    held = pushes.copy()
    parent = np.full(n, -1, np.int64)
    inner = valid & (cnt == 0) & (ref >= 0)
    parent[ref[inner]] = np.nonzero(inner)[0]
    ends = np.cumsum([len(x) for x in levels])
    for a, b in zip(ends[:-1], ends[1:]):
        held[a:b] += held[parent[a:b]]
    return nodes, int(held.max())
