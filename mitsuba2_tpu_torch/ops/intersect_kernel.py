"""The scene's ray queries on the card: the wrapper of K2
(csrc/intersect_kernel.cu).

Counterpart of ``mitsuba2_tpu.ops.intersect_pallas.WoopIntersector``
(intersect_pallas.py:200-259), the scene-level handle of ``_isect_kernel``:
``isect_closest`` gives each ray's closest hit as ``t`` (inf on a miss),
``uv`` (0 on a miss) and ``prim`` (int32 reference face id, -1 on a miss),
``isect_any`` whether any face lies in its [mint, maxt]. Both read the
scene's path-kernel tables (``PathTables``: the traversal tree's pair
nodes, Woop rows and face ids), which the scene builds once.

``isect_closest_inst`` and ``isect_any_inst`` are the same queries
against a scene's shared-geometry instances (``InstanceTables``, built by
``instance_tables``: each group's own traversal tree, once, a transform
row an instance, and the top tree over the instances' world boxes that
the kernel walks first); a closest hit's prim is instance * g_max + the
group's face id.

For tables on a CUDA device each call launches the kernel, each ray walking
the tree's 4-wide nodes (csrc/bvh.cuh); for tables on the CPU it runs the
plain version, ops/intersect.py's linear sweep over the Woop rows in face
order. A build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import NamedTuple

import numpy as np
import torch

from . import bvh as bvh_ops
from . import intersect
from .path_kernel import build_woop, check_tree, face_woop


class _IsectArgs(ctypes.Structure):
    """csrc/intersect_kernel.cu's IsectArgs, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "nodes", "woop", "prim", "o", "d", "mint", "maxt", "t", "uv",
        "prim_out", "hit")] + [("n_rays", ctypes.c_int)])


class _InstArgs(ctypes.Structure):
    """csrc/intersect_kernel.cu's InstArgs, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "nodes", "woop", "prim", "group_node", "group_face", "rows", "top")]
        + [("n_instances", ctypes.c_int), ("g_max", ctypes.c_int)])


# entries of the top walk's stack (csrc/intersect_kernel.cu TOP_STACK): a
# top tree whose stack bound exceeds it is refused before a launch.
# ``top_bvh`` falls back as far as the fully median tree (ops/bvh.py
# ``traversal_bvh``), one box a leaf. 28 holds it for up to 1,572,864
# instances, wherever they lie (6 * 2^18: the wide nodes of the even
# levels 0-16 push 3 entries each, 27, and each node 18 levels down holds
# at most 6 boxes, so its wide node pushes at most one more), and one
# more instance needs 29 (tests/test_torch_deep_tree_bounds.py). Clustered
# placements, such as 4,096 instances at log-uniform distances, fit
# through the fallback (tests/test_torch_loop_emulated.py
# test_top_tree_stack_holds_a_large_forest)
TOP_STACK_DEPTH = 28
# outward pad of an instance's world box, relative to its coordinates (ten
# times the group walk's bvh.BOX_PAD), on top of the group box padded by
# BOX_PAD as the group walk tests it (``instance_boxes``)
INST_PAD = 1e-4


class InstanceTables(NamedTuple):
    """A scene's shared-geometry instances on one device: every group's
    traversal tree one after another (``nodes`` (P, 32) wide nodes,
    ``woop`` (F, 12) Woop rows and ``prim`` (F,) int32 the group's face
    ids, both in the tree's face order), each group's first node and first
    tree position (``group_node``, ``group_face`` (G,) int32), and a row
    an instance (``rows`` (I, 24) float32: to-group A (9, row-major), b
    (3), to-world B (9), group, shape, 0; mitsuba2_tpu/render/scene.py:
    400-409). ``top`` (T, 32) float32 is the top tree over the instances'
    world boxes (``top_tree``: ops/bvh.py pack_traversal's 4-wide nodes,
    one instance a leaf, a leaf's ref the instance's index). ``g_max`` is
    the largest group's face count, the stride of an instance's prim ids;
    ``depth`` the deepest group tree's stack bound and ``top_depth`` the
    top tree's; ``trees`` the groups' host trees (ops/bvh.py BVH) and
    ``n_faces`` their face counts."""
    nodes: torch.Tensor
    woop: torch.Tensor
    prim: torch.Tensor
    group_node: torch.Tensor
    group_face: torch.Tensor
    rows: torch.Tensor
    top: torch.Tensor
    g_max: int
    depth: int
    top_depth: int
    trees: tuple
    n_faces: tuple

    @property
    def device(self):
        return self.rows.device

    @property
    def n_instances(self):
        return self.rows.shape[0]


def instance_boxes(trees, rows):
    """Each instance's world box -> (lo, hi) (I, 3) float32: the root box
    of its group's tree (``trees[group]``), padded by bvh.BOX_PAD as the
    group walk pads its boxes, mapped to world through the inverse of the
    row's to-group map (A, b) in float64 (its eight corners), padded by
    INST_PAD relative to its coordinates and rounded outward.

    Why that holds every hit the plain version finds in the instance: the
    hit lies in the group's faces up to the Woop test's rounding, which
    the group walk's own BOX_PAD covers in the group frame; the world ray
    differs from the group ray by the move's rounding (a few units of
    2^-24 of |o| + t |d|, times A's condition number), and the world slab
    test rounds as the group's does. INST_PAD covers those while the ray's
    origin lies within some hundreds of times the box's size of it (by a
    condition number of A near 1): the same kind of bound as the group
    walk's BOX_PAD, ten times wider."""
    rows = np.asarray(rows, np.float64)
    g_lo, g_hi = (np.stack(x).astype(np.float64)
                  for x in zip(*(t.bounds() for t in trees)))
    pad = bvh_ops.BOX_PAD * (1.0 + np.maximum(np.abs(g_lo), np.abs(g_hi))
                             .max(1, keepdims=True))
    g = rows[:, 21].astype(np.int64)
    corner = np.array(list(itertools.product((0, 1), repeat=3)), bool)
    pts = np.where(corner[None], (g_hi + pad)[g][:, None],
                   (g_lo - pad)[g][:, None])
    A_inv = np.linalg.inv(rows[:, 0:9].reshape(-1, 3, 3))
    world = np.einsum("ijk,ilk->ilj", A_inv, pts - rows[:, None, 9:12])
    lo, hi = world.min(1), world.max(1)
    pad = INST_PAD * (1.0 + np.maximum(np.abs(lo), np.abs(hi))
                      .max(1, keepdims=True))
    lo, hi = lo - pad, hi + pad
    lo32, hi32 = lo.astype(np.float32), hi.astype(np.float32)
    lo32 = np.where(lo32 > lo, np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32 < hi, np.nextafter(hi32, np.float32(np.inf)), hi32)
    return lo32, hi32


def top_bvh(lo, hi):
    """The host tree over boxes lo, hi (I, 3) float32 (ops/bvh.py BVH): the
    reference's builder over each box as a degenerate face (v0 lo, e1 hi -
    lo, e2 0), one box a leaf, within TOP_STACK_DEPTH where it can be
    (ops/bvh.py ``traversal_bvh``)."""
    return bvh_ops.traversal_bvh(lo, hi - lo, np.zeros_like(lo), leaf_size=1,
                                 stack=TOP_STACK_DEPTH, max_leaf=1,
                                 boxes=(lo, hi))


def top_tree(lo, hi):
    """The top tree over boxes lo, hi (I, 3) float32 -> (nodes (T, 32)
    float32, stack bound): ``top_bvh`` packed by ops/bvh.py pack_traversal
    (each child box padded again by BOX_PAD), a leaf's ref then the box's
    index instead of its tree position."""
    tree = top_bvh(lo, hi)
    nodes, depth = bvh_ops.pack_traversal(tree)
    W = bvh_ops.WIDTH
    ints = nodes.view(np.int32)
    ref, cnt = ints[:, 6 * W:7 * W], ints[:, 7 * W:]
    ref[cnt > 0] = tree.order[ref[cnt > 0]]
    return nodes, depth


def instance_tables(groups, rows, device) -> InstanceTables:
    """``groups``: each group's faces in its own frame, (v0, e1, e2) (F_g,
    3) float32 in the group's face order; ``rows`` (I, 24) float32 ->
    InstanceTables on ``device``, a traversal tree built once a group and
    the top tree over the instances' world boxes."""
    nodes, woop, prim, trees = [], [], [], []
    group_node, group_face = [0], [0]
    depth = 0
    for v0, e1, e2 in groups:
        tree = bvh_ops.traversal_bvh(v0, e1, e2)
        n, dep = bvh_ops.pack_traversal(tree)
        nodes.append(n)
        woop.append(build_woop(v0, e1, e2)[tree.order])
        prim.append(np.asarray(tree.order, np.int32))
        trees.append(tree)
        group_node.append(group_node[-1] + len(n))
        group_face.append(group_face[-1] + len(v0))
        depth = max(depth, dep)
    top, top_depth = top_tree(*instance_boxes(trees, rows))

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return InstanceTables(
        dev(np.concatenate(nodes)), dev(np.concatenate(woop)),
        dev(np.concatenate(prim), torch.int32),
        dev(np.asarray(group_node[:-1], np.int32), torch.int32),
        dev(np.asarray(group_face[:-1], np.int32), torch.int32),
        dev(np.asarray(rows, np.float32)), dev(top),
        max(len(g[0]) for g in groups), depth, top_depth, tuple(trees),
        tuple(len(g[0]) for g in groups))


def group_woops(inst):
    """Each group's Woop rows in its face order (the plain version's), from
    the tree-order rows."""
    out = []
    start = inst.group_face.tolist() + [inst.woop.shape[0]]
    for g in range(len(inst.n_faces)):
        rows = inst.woop[start[g]:start[g + 1]]
        w = torch.empty_like(rows)
        w[inst.prim[start[g]:start[g + 1]].long()] = rows
        out.append(w)
    return out


def _check_inst(inst):
    if inst.depth > bvh_ops.STACK_DEPTH:
        raise ValueError(f"a group's stack bound {inst.depth} > the "
                         f"kernel's stack of {bvh_ops.STACK_DEPTH}")
    if inst.top_depth > TOP_STACK_DEPTH:
        raise ValueError(f"the top tree's stack bound {inst.top_depth} > "
                         f"the kernel's top stack of {TOP_STACK_DEPTH}")
    if inst.nodes.is_cuda and (inst.nodes.data_ptr() % 128
                               or inst.top.data_ptr() % 128):
        raise ValueError("the groups' and the top tree's nodes must be "
                         "128-byte aligned on the card")
    if inst.n_instances * inst.g_max >= 1 << 31:
        raise ValueError("the instances' prim ids overflow int32")


def _check(tables, o, d, mint, maxt):
    n = o.shape[0] if o.dim() == 2 else -1
    for name, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("mint", mint, (n,)), ("maxt", maxt, (n,))):
        if x.dtype != torch.float32 or not x.is_contiguous() \
                or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor, got {tuple(x.shape)} {x.dtype}")
        if x.device != tables.device:
            raise ValueError(f"{name} is on {x.device}, not {tables.device}")
    if tables.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no intersection kernel for device "
                         f"{tables.device}")
    if n >= 1 << 31:
        raise ValueError(f"{n} rays overflow the kernel's int32 ray ids")
    if not isinstance(tables, InstanceTables) \
            and tables.bvh_prim.shape[0] != tables.n_faces:
        raise ValueError("the tables carry no traversal tree of every face")
    return n


def _launch(entry, tables, o, d, mint, maxt, t=None, uv=None, prim=None,
            hit=None):
    """Launches ``entry`` on the rays; ``tables`` are PathTables, or for
    the instance entries (``*_inst``) InstanceTables."""
    inst = entry.endswith("_inst")
    if inst:
        _check_inst(tables)
        tree = (None, None, None)
        extra = (ctypes.byref(_InstArgs(*(x.data_ptr() for x in (
            tables.nodes, tables.woop, tables.prim, tables.group_node,
            tables.group_face, tables.rows, tables.top)),
            tables.n_instances, tables.g_max)),)
    else:
        check_tree(tables)
        tree = (tables.bvh_nodes, tables.bvh_woop, tables.bvh_prim)
        extra = ()
    args = _IsectArgs(*(0 if x is None else x.data_ptr() for x in (
        *tree, o, d, mint, maxt, t, uv, prim, hit)), o.shape[0])
    fn = _entry(entry)
    with torch.cuda.device(tables.device):
        err = fn(ctypes.byref(args), *extra,
                 torch.cuda.current_stream(tables.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def isect_closest(tables, o, d, mint, maxt):
    """Closest hit of rays o, d (n, 3), mint, maxt (n,) on the tables'
    device -> (t (n,), uv (n, 2), prim (n,) int32)."""
    n = _check(tables, o, d, mint, maxt)
    if tables.device.type == "cpu":
        return intersect.closest_hit_reference(face_woop(tables), o, d, mint,
                                              maxt)
    t = torch.full((n,), float("inf"), device=o.device)
    uv = torch.zeros((n, 2), device=o.device)
    prim = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    if n == 0 or tables.n_faces == 0:
        return t, uv, prim
    _launch("isect_closest", tables, o, d, mint, maxt, t=t, uv=uv,
            prim=prim)
    isect_closest.launches += 1
    return t, uv, prim


def isect_any(tables, o, d, mint, maxt):
    """Whether each ray o, d (n, 3) hits a face with t in [mint, maxt]
    (n,) -> (n,) bool on the tables' device."""
    n = _check(tables, o, d, mint, maxt)
    if tables.device.type == "cpu":
        return intersect.any_hit_reference(face_woop(tables), o, d, mint,
                                          maxt)
    hit = torch.zeros((n,), dtype=torch.bool, device=o.device)
    if n == 0 or tables.n_faces == 0:
        return hit
    _launch("isect_any", tables, o, d, mint, maxt, hit=hit)
    isect_any.launches += 1
    return hit


def isect_closest_inst(inst, o, d, mint, maxt):
    """Closest hit of rays o, d (n, 3), mint, maxt (n,) among the instances
    ``inst`` (InstanceTables) on their device -> (t (n,), uv (n, 2), prim
    (n,) int32: instance * g_max + the group's face id, -1 on a miss)."""
    n = _check(inst, o, d, mint, maxt)
    if inst.device.type == "cpu":
        return intersect.closest_hit_instanced_reference(
            group_woops(inst), inst.rows, inst.g_max, o, d, mint, maxt)
    t = torch.full((n,), float("inf"), device=o.device)
    uv = torch.zeros((n, 2), device=o.device)
    prim = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    if n == 0:
        return t, uv, prim
    _launch("isect_closest_inst", inst, o, d, mint, maxt, t=t, uv=uv,
            prim=prim)
    isect_closest_inst.launches += 1
    return t, uv, prim


def isect_any_inst(inst, o, d, mint, maxt):
    """Whether each ray o, d (n, 3) hits a face of any of the instances
    ``inst`` with t in [mint, maxt] -> (n,) bool on their device."""
    n = _check(inst, o, d, mint, maxt)
    if inst.device.type == "cpu":
        return intersect.any_hit_instanced_reference(
            group_woops(inst), inst.rows, o, d, mint, maxt)
    hit = torch.zeros((n,), dtype=torch.bool, device=o.device)
    if n == 0:
        return hit
    _launch("isect_any_inst", inst, o, d, mint, maxt, hit=hit)
    isect_any_inst.launches += 1
    return hit


ENTRIES = (isect_closest, isect_any, isect_closest_inst, isect_any_inst)


def reset_launch_counts():
    """Sets every entry point's count of kernel launches to 0."""
    for fn in ENTRIES:
        fn.launches = 0


reset_launch_counts()


def libraries():
    """(name, defines) of the kernel's library, for ``build.build_all``."""
    return [("intersect_kernel", {})]


def _entry(name):
    """csrc/intersect_kernel.cu's C entry point ``name``, built on first
    use."""
    from .build import load
    fn = getattr(load("intersect_kernel"), name)
    fn.argtypes = [ctypes.POINTER(_IsectArgs)] + (
        [ctypes.POINTER(_InstArgs)] if name.endswith("_inst") else []) \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
