"""The scene's ray queries on the card: the wrapper of K2
(csrc/intersect_kernel.cu).

Counterpart of ``mitsuba2_tpu.ops.intersect_pallas.WoopIntersector``
(intersect_pallas.py:200-259), the scene-level handle of ``_isect_kernel``:
``isect_closest`` gives each ray's closest hit as ``t`` (inf on a miss),
``uv`` (0 on a miss) and ``prim`` (int32 reference face id, -1 on a miss),
``isect_any`` whether any face lies in its [mint, maxt]. Both read the
scene's path-kernel tables (``PathTables``: the traversal tree's pair
nodes, Woop rows and face ids), which the scene builds once.

For tables on a CUDA device each call launches the kernel, each ray walking
the tree's 4-wide nodes (csrc/bvh.cuh); for tables on the CPU it runs the
plain version, ops/intersect.py's linear sweep over the Woop rows in face
order. A build or launch failure raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import intersect
from .path_kernel import check_tree, face_woop


class _IsectArgs(ctypes.Structure):
    """csrc/intersect_kernel.cu's IsectArgs, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "nodes", "woop", "prim", "o", "d", "mint", "maxt", "t", "uv",
        "prim_out", "hit")] + [("n_rays", ctypes.c_int)])


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
    if tables.bvh_prim.shape[0] != tables.n_faces:
        raise ValueError("the tables carry no traversal tree of every face")
    return n


def _launch(entry, tables, o, d, mint, maxt, t=None, uv=None, prim=None,
            hit=None):
    check_tree(tables)
    args = _IsectArgs(*(0 if x is None else x.data_ptr() for x in (
        tables.bvh_nodes, tables.bvh_woop, tables.bvh_prim, o, d, mint,
        maxt, t, uv, prim, hit)), o.shape[0])
    fn = _entry(entry)
    with torch.cuda.device(tables.device):
        err = fn(ctypes.byref(args),
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


# kernel launches of each entry point
isect_closest.launches = 0
isect_any.launches = 0


def reset_launch_counts():
    isect_closest.launches = 0
    isect_any.launches = 0


def libraries():
    """(name, defines) of the kernel's library, for ``build.build_all``."""
    return [("intersect_kernel", {})]


def _entry(name):
    """csrc/intersect_kernel.cu's C entry point ``name``, built on first
    use."""
    from .build import load
    fn = getattr(load("intersect_kernel"), name)
    fn.argtypes = [ctypes.POINTER(_IsectArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
