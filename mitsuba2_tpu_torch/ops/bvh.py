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
  over the already permuted faces, packed by ``pack_traversal`` into the
  pair nodes that csrc/bvh.cuh walks per ray (the path kernel's BVH tier
  and the scene's ray queries). Its leaves hold contiguous ranges of its
  own ``order``, whose entries are the reference's face ids.

The median-split numpy builder is kept only behind ``force_numpy=True``:
another builder gives another face order, so a failed native build raises
instead of falling back.
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
# entries of the per-ray traversal stack (csrc/bvh.cuh BVH_STACK); a tree
# whose pair-node depth exceeds it is refused on the host
STACK_DEPTH = 64
# pair-node float32 slots: per child [lo xyz, ref] [hi xyz, count]
PAIR_SLOTS = 16
# outward padding of every child box, relative to its coordinates, so that
# float rounding in the slab test never culls a face the Woop test hits
BOX_PAD = 1e-5


class BVH:
    """Flattened BVH: ``nodes`` is (M, 12) float32 with int32 fields viewed
    in place; ``order`` is the face permutation (leaf-contiguous)."""

    def __init__(self, nodes: np.ndarray, order: np.ndarray):
        self.nodes = nodes
        self.order = order

    @property
    def n_nodes(self):
        return len(self.nodes)

    def _ints(self):
        return self.nodes.view(np.int32)

    def leaves(self):
        """Yield (first, count, lo, hi) per leaf, in node order."""
        ints = self._ints()
        for i in range(len(self.nodes)):
            cnt = int(ints[i, _COUNT])
            if cnt > 0:
                yield (int(ints[i, _LEFT]), cnt,
                       self.nodes[i, _LO].copy(), self.nodes[i, _HI].copy())


def _build_numpy(v0, e1, e2, leaf_size):
    """Median-split builder (no SAH), same node layout."""
    n = len(v0)
    p0, p1, p2 = v0, v0 + e1, v0 + e2
    lo_f = np.minimum(np.minimum(p0, p1), p2)
    hi_f = np.maximum(np.maximum(p0, p1), p2)
    cen = 0.5 * (lo_f + hi_f)
    order = np.arange(n, dtype=np.int32)
    nodes = []

    def rec(begin, end):
        idx = len(nodes)
        nodes.append(np.zeros(_NODE_SLOTS, np.float32))
        sel = order[begin:end]
        node = nodes[idx]
        node[_LO] = lo_f[sel].min(0)
        node[_HI] = hi_f[sel].max(0)
        ints = node.view(np.int32)
        cnt = end - begin
        if cnt <= leaf_size:
            ints[_LEFT], ints[_COUNT], ints[_RIGHT] = begin, cnt, -1
            return idx
        axis = int(np.argmax((cen[sel].max(0) - cen[sel].min(0))))
        key = np.argsort(cen[sel, axis], kind="stable")
        order[begin:end] = sel[key]
        mid = begin + cnt // 2
        left = rec(begin, mid)
        right = rec(mid, end)
        ints[_LEFT], ints[_COUNT], ints[_RIGHT] = left, 0, right
        return idx

    if n:
        rec(0, n)
    else:
        node = np.zeros(_NODE_SLOTS, np.float32)
        node.view(np.int32)[_RIGHT] = -1
        nodes.append(node)
    return BVH(np.stack(nodes), order)


def _native():
    """csrc/bvh.cpp's ``bvh_build``, built on first use; a failed build
    raises."""
    from .build import load
    fn = load("bvh").bvh_build
    fp = ctypes.POINTER(ctypes.c_float)
    fn.restype = ctypes.c_int
    fn.argtypes = [fp, fp, fp, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int32), fp, ctypes.c_int]
    return fn


def build_bvh(v0, e1, e2, leaf_size: int = 64,
              force_numpy: bool = False) -> BVH:
    """BVH over triangles (v0 + u e1 + v e2): the native binned-SAH
    builder, or the numpy median split when ``force_numpy`` asks for it."""
    v0 = np.ascontiguousarray(v0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    n = len(v0)
    if force_numpy or n == 0:
        return _build_numpy(v0, e1, e2, leaf_size)
    order = np.empty(n, np.int32)
    max_nodes = 4 * n + 4
    buf = np.empty((max_nodes, _NODE_SLOTS), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    written = _native()(
        v0.ctypes.data_as(fp), e1.ctypes.data_as(fp), e2.ctypes.data_as(fp),
        n, leaf_size, order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        buf.ctypes.data_as(fp), max_nodes)
    if written < 0:
        raise RuntimeError(f"bvh_build needs more than {max_nodes} nodes")
    return BVH(buf[:written].copy(), order)


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


def chunk_bounds(v0, e1, e2, chunk: int) -> np.ndarray:
    """Per-face-chunk AABBs (n_chunks, 6) = [lo, hi] over each contiguous
    ``chunk`` of (BVH-ordered) faces. Padding slots get inverted boxes so
    they never extend a chunk."""
    v0 = np.asarray(v0, np.float32)
    p = np.stack([v0, v0 + np.asarray(e1, np.float32),
                  v0 + np.asarray(e2, np.float32)], 1)       # (F,3,3)
    lo = p.min(1)
    hi = p.max(1)
    f = len(v0)
    pad = (-f) % chunk
    if pad:
        lo = np.concatenate([lo, np.full((pad, 3), np.inf, np.float32)])
        hi = np.concatenate([hi, np.full((pad, 3), -np.inf, np.float32)])
    n_chunks = len(lo) // chunk
    lo = lo.reshape(n_chunks, chunk, 3).min(1)
    hi = hi.reshape(n_chunks, chunk, 3).max(1)
    return np.concatenate([lo, hi], -1)


def pack_traversal(bvh: BVH):
    """The device layout of a traversal tree -> (pairs (P, 16) float32,
    depth).

    One pair node per interior node of ``bvh`` (a single-leaf tree gets
    one pair whose second child is empty), in node order, so pair 0 is the
    root. A pair holds both children, each as [lo xyz, ref] [hi xyz,
    count] with ref and count int32 bits: an interior child has count 0 and
    ref its pair index, a leaf has count > 0 and ref its first position in
    ``bvh.order``, an empty child ref -1. Child boxes are padded outward by
    ``BOX_PAD`` relative to their coordinates. ``depth`` is the number of
    pair nodes on the longest root-to-leaf chain, which bounds the
    traversal stack."""
    ints = bvh._ints()
    count = ints[:, _COUNT]
    left, right = ints[:, _LEFT], ints[:, _RIGHT]
    interior = (count == 0) & (right >= 0)
    lo = bvh.nodes[:, _LO].astype(np.float64)
    hi = bvh.nodes[:, _HI].astype(np.float64)
    pad = BOX_PAD * (1.0 + np.maximum(np.abs(lo), np.abs(hi)).max(1))
    lo = (lo - pad[:, None]).astype(np.float32)
    hi = (hi + pad[:, None]).astype(np.float32)
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
    # depth in pair nodes, one level of interior children at a time
    depth, level = 0, np.zeros(1, np.int64)
    while len(level):
        depth += 1
        kids = np.concatenate([left[level], right[level]])
        level = kids[interior[kids]]
    return np.ascontiguousarray(pairs), depth
