"""The face-test ceiling on the card: the wrapper of csrc/sweep_kernel.cu
and its plain versions.

Counterpart of the inline kernel of ``benchmarks/mxu_shape_ceiling.py``
(:44, ``pl.pallas_call`` :58): the TPU path kernel's Woop sweep on its own,
the product of a Woop table (4, 3C) with the rays' [o,1 | d,0] columns
(4, 2R). Here the sweep is carried to what the product feeds: ``sweep``
gives each ray's closest hit over every face of a Woop table ``woop``
(F, 12), rows [Wu | Wv | Wz], the lowest t, ties to the lowest face id.
The kernel runs the path kernel's face test (fused products, t = -Z / DZ,
1 - u - v >= 0), the form whose cost the ceiling measures; the plain
version runs K2's (ops/intersect.py ``woop_test``: unfused, t = -Z *
(1 / DZ) where |DZ| > 1e-12, u + v <= 1), so the two agree up to float
rounding, to K2's bar (chip_smoke.py ``isect_parity``). It repeats the
sweep ``iters`` times, iteration k over the segment [k * MINT_STEP, inf),
and returns the last iteration's hit, t (inf on a miss), uv (0 on a miss)
and prim (int32, -1 on a miss), and per ray the number of iterations that
hit (int32).

Two instantiations: ``shared=True`` stages the table in shared memory (at
most MAX_SHARED_FACES faces), ``shared=False`` reads it from device memory
through the read-only path (``launch_info`` gives each instantiation's
geometry: threads a block, rows loaded ahead, rays a thread). For
tensors on a CUDA device each call launches the kernel; for tensors on the
CPU it runs ``sweep_reference``. A build or launch failure raises.

``sweep_product_reference`` is the TPU kernel's product in float32, and
``sweep_reference`` the closest hit computed from that product.

The box-test ceiling beside it: ``box_sweep`` tests every ray against every
child box of a table of the BVH walk's 4-wide nodes ``lines`` (L, 32)
(ops/bvh.py ``pack_traversal``'s layout; refs >= 0), ``iters`` times,
iteration k against [k * MINT_STEP, inf), and returns per ray the nearest
entry t of the last iteration's hit boxes (inf where none) and its box
hits summed over the iterations (int32). ``box_shared=True`` stages the
lines in shared memory (at most MAX_SHARED_LINES), ``False`` reads them
through the read-only path. Its plain version ``box_sweep_reference`` runs
the slab test's arithmetic (ops/intersect.py ``_slab``), bit for bit the
kernel's.
"""

from __future__ import annotations

import collections
import ctypes

import torch

# iteration k sweeps [k * MINT_STEP, inf): a power of two, so that k *
# MINT_STEP is exact in float32 on both sides
MINT_STEP = 2.0 ** -10
# 227 KB of dynamic shared memory a block, 48 B a face
MAX_SHARED_FACES = 232448 // 48
# 227 KB of dynamic shared memory a block, 128 B a line
MAX_SHARED_LINES = 232448 // 128
# faces x rays per step of the plain version
_CHUNK_ELEMS = 1 << 23


class _SweepArgs(ctypes.Structure):
    """csrc/sweep_kernel.cu's SweepArgs, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "woop", "o", "d", "t", "uv", "prim", "hits")]
        + [(name, ctypes.c_int) for name in ("n_faces", "n_rays", "iters")]
        + [("mint_step", ctypes.c_float)])


class _BoxArgs(ctypes.Structure):
    """csrc/sweep_kernel.cu's BoxArgs, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "lines", "o", "d", "near", "hits")]
        + [(name, ctypes.c_int) for name in ("n_lines", "n_rays", "iters")]
        + [("mint_step", ctypes.c_float)])


def kernel_name(shared: bool, boxes: bool = False) -> str:
    return (f"sweep_kernel[{'boxes, ' if boxes else ''}"
            f"{'shared' if shared else 'global'}]")


def sweep_product_reference(W, odh):
    """The TPU kernel's Woop product in float32: W (4, 3F) and odh (4, 2R)
    -> (3F, 2R), each element the sum over the contraction axis of the four
    products, rounded one by one and added in order."""
    out = W[0][:, None] * odh[0][None, :]
    for k in range(1, W.shape[0]):
        out += W[k][:, None] * odh[k][None, :]
    return out


def woop_product_rows(woop):
    """Woop rows (F, 12) -> the TPU layout (4, 3F): the U rows of every
    face, then the V rows, then the Z rows (megakernel.py _sweep_chunk)."""
    F = woop.shape[0]
    return woop.reshape(F, 3, 4).transpose(0, 1).reshape(3 * F, 4).T


def ray_columns(o, d):
    """Rays (n, 3) -> the TPU layout [o,1 | d,0] (4, 2n)."""
    n = o.shape[0]
    ones = torch.ones((1, n), dtype=o.dtype, device=o.device)
    return torch.cat([torch.cat([o.T, ones]), torch.cat([d.T, 0 * ones])], 1)


def sweep_reference(woop, o, d, iters):
    """Plain PyTorch version of ``sweep``: the product of
    ``sweep_product_reference``, then t, u, v and the closest hit of each
    iteration -> (t (n,), uv (n, 2), prim (n,) int32, hits (n,) int32)."""
    F, n, dev = woop.shape[0], o.shape[0], o.device
    t_out = torch.full((n,), float("inf"), device=dev)
    uv = torch.zeros((n, 2), device=dev)
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    hits = torch.zeros((n,), dtype=torch.int32, device=dev)
    if F == 0 or iters < 1:
        return t_out, uv, prim, hits
    W = woop_product_rows(woop)
    ids = torch.arange(F, device=dev)[:, None]
    step = max(1, _CHUNK_ELEMS // F)
    for s in range(0, n, step):
        sl = slice(s, s + step)
        m = o[sl].shape[0]
        P = sweep_product_reference(W, ray_columns(o[sl], d[sl]))
        U, V, Z = P[:F, :m], P[F:2 * F, :m], P[2 * F:, :m]
        DU, DV, DZ = P[:F, m:], P[F:2 * F, m:], P[2 * F:, m:]
        dz_ok = DZ.abs() > 1e-12
        t = -Z * torch.where(dz_ok, 1.0 / torch.where(dz_ok, DZ, 1.0),
                             float("nan"))
        u = U + t * DU
        v = V + t * DV
        inside = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                  & (t < float("inf")))
        for k in range(iters):
            ok = inside & (t >= k * MINT_STEP)
            tk = torch.where(ok, t, float("inf"))
            tmin = tk.min(dim=0).values
            f = torch.where(ok & (tk <= tmin), ids, F).min(dim=0).values
            hit = f < F
            hits[sl] += hit.to(torch.int32)
        fc = f.clamp(max=F - 1)[None, :]
        t_out[sl] = torch.where(hit, tmin, float("inf"))
        uv[sl] = torch.where(hit[:, None], torch.stack(
            [u.gather(0, fc)[0], v.gather(0, fc)[0]], 1), 0.0)
        prim[sl] = torch.where(hit, f, -1).to(torch.int32)
    return t_out, uv, prim, hits


def box_sweep_reference(lines, o, d, iters):
    """Plain PyTorch version of ``box_sweep`` -> (near (n,), hits (n,)
    int32)."""
    from .bvh import WIDTH
    from .intersect import _slab
    L, n, dev = lines.shape[0], o.shape[0], o.device
    near = torch.full((n,), float("inf"), device=dev)
    hits = torch.zeros((n,), dtype=torch.int32, device=dev)
    if L == 0 or iters < 1:
        return near, hits
    lo = lines[:, :3 * WIDTH].reshape(L, 3, WIDTH).transpose(1, 2)
    hi = lines[:, 3 * WIDTH:6 * WIDTH].reshape(L, 3, WIDTH).transpose(1, 2)
    lo, hi = lo.reshape(1, -1, 3), hi.reshape(1, -1, 3)
    B = lo.shape[1]
    inv = 1.0 / torch.where(d.abs() > 1e-12, d, 1e-12)
    step = max(1, _CHUNK_ELEMS // (3 * B))
    for s in range(0, n, step):
        sl = slice(s, s + step)
        m = o[sl].shape[0]
        inf = torch.full((m,), float("inf"), device=dev)
        for k in range(iters):
            hit, tn = _slab(lo.expand(m, -1, -1), hi.expand(m, -1, -1),
                            o[sl], inv[sl], torch.full_like(inf,
                                                            k * MINT_STEP),
                            inf)
            hits[sl] += hit.sum(1).to(torch.int32)
        near[sl] = torch.where(hit, tn, float("inf")).min(1).values
    return near, hits


def box_sweep(lines, o, d, iters, shared=True):
    """Every ray o, d (n, 3) against every child box of ``lines`` (L, 32),
    ``iters`` times -> (near, hits), see the module."""
    n = o.shape[0] if o.dim() == 2 else -1
    L = lines.shape[0] if lines.dim() == 2 else -1
    for name, x, shape in (("lines", lines, (L, 32)), ("o", o, (n, 3)),
                           ("d", d, (n, 3))):
        if x.dtype != torch.float32 or not x.is_contiguous() \
                or tuple(x.shape) != shape or x.device != lines.device:
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {lines.device}")
    if shared and L > MAX_SHARED_LINES:
        raise ValueError(f"{L} lines > {MAX_SHARED_LINES}, the shared "
                         f"instantiation's table")
    if max(n, 4 * L * max(iters, 1)) >= 1 << 31 or iters < 0:
        raise ValueError(f"{n} rays, {L} lines, {iters} iterations: out of "
                         f"the kernel's int32 range")
    if lines.device.type == "cpu" or n == 0 or L == 0 or iters == 0:
        return box_sweep_reference(lines, o, d, iters)
    if lines.device.type != "cuda":
        raise ValueError(f"no box kernel for device {lines.device}")
    dev = lines.device
    near = torch.empty((n,), device=dev)
    hits = torch.empty((n,), dtype=torch.int32, device=dev)
    args = _BoxArgs(*(x.data_ptr() for x in (lines, o, d, near, hits)),
                    L, n, iters, MINT_STEP)
    fn = _entry("boxes_shared" if shared else "boxes_global", _BoxArgs)
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(args),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel_name(shared, True)} launch failed: "
                           f"CUDA error {err}")
    sweep.launches_by_kernel[kernel_name(shared, True)] += 1
    return near, hits


def _check(woop, o, d, iters, shared):
    n = o.shape[0] if o.dim() == 2 else -1
    F = woop.shape[0] if woop.dim() == 2 else -1
    for name, x, shape in (("woop", woop, (F, 12)), ("o", o, (n, 3)),
                           ("d", d, (n, 3))):
        if x.dtype != torch.float32 or not x.is_contiguous() \
                or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor, got {tuple(x.shape)} {x.dtype}")
        if x.device != woop.device:
            raise ValueError(f"{name} is on {x.device}, not {woop.device}")
    if woop.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no sweep kernel for device {woop.device}")
    if max(n, F) >= 1 << 31 or iters < 0:
        raise ValueError(f"{n} rays, {F} faces, {iters} iterations: out of "
                         f"the kernel's int32 range")
    if shared and F > MAX_SHARED_FACES:
        raise ValueError(f"{F} faces > {MAX_SHARED_FACES}, the shared "
                         f"instantiation's table")
    return n, F


def sweep(woop, o, d, iters, shared=True):
    """The closest hit of rays o, d (n, 3) over the faces of ``woop``
    (F, 12), ``iters`` times -> (t, uv, prim, hits), see the module."""
    n, F = _check(woop, o, d, iters, shared)
    # nothing to sweep: the plain version's empty answer, no launch
    if woop.device.type == "cpu" or n == 0 or F == 0 or iters == 0:
        return sweep_reference(woop, o, d, iters)
    dev = woop.device
    t = torch.empty((n,), device=dev)
    uv = torch.empty((n, 2), device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    hits = torch.empty((n,), dtype=torch.int32, device=dev)
    args = _SweepArgs(*(x.data_ptr() for x in (woop, o, d, t, uv, prim,
                                               hits)),
                      F, n, iters, MINT_STEP)
    fn = _entry("sweep_shared" if shared else "sweep_global")
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(args),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel_name(shared)} launch failed: CUDA "
                           f"error {err}")
    sweep.launches_by_kernel[kernel_name(shared)] += 1
    return t, uv, prim, hits


# kernel launches by instantiation (``kernel_name``), of ``sweep`` and
# ``box_sweep``
sweep.launches_by_kernel = collections.Counter()


def reset_launch_counts():
    sweep.launches_by_kernel.clear()


# what ``launch_info`` returns, in csrc/sweep_kernel.cu's order
LAUNCH_INFO = ("threads", "ahead", "rays_per_thread", "blocks_per_sm")


def launch_info(shared, n, boxes=False):
    """{LAUNCH_INFO name: value} of a face (``boxes``: box) instantiation
    over ``n`` faces (lines) on the current CUDA device: threads a block,
    how many faces (lines) ahead of its test a face's rows (a line's
    planes) are loaded, rays a thread and resident blocks an SM."""
    from .build import load
    fn = load("sweep_kernel").sweep_launch_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * len(LAUNCH_INFO))()
    err = fn(int(shared), int(boxes), n, info)
    if err != 0:
        raise RuntimeError(f"{kernel_name(shared, boxes)} launch info: CUDA "
                           f"error {err}")
    return dict(zip(LAUNCH_INFO, info))


def libraries():
    """(name, defines) of the kernel's library, for ``build.build_all``."""
    return [("sweep_kernel", {})]


def _entry(name, args=_SweepArgs):
    """csrc/sweep_kernel.cu's C entry point ``name`` taking ``args``, built
    on first use."""
    from .build import load
    fn = getattr(load("sweep_kernel"), name)
    fn.argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
