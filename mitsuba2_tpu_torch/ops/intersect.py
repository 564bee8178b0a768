"""Ray-triangle queries in plain PyTorch: the plain twin of K2 and a plain
walk of the device BVH traversal.

``closest_hit_reference`` and ``any_hit_reference`` are the plain version
of the K2 kernel (ops/intersect_kernel.py, csrc/intersect_kernel.cu): a
linear sweep of every ray against every face, in face chunks, with the Woop
test that ``_isect_kernel`` computes (mitsuba2_tpu/ops/intersect_pallas.py:
119-154): t = -Z / DZ for |DZ| > 1e-12, a hit where u >= 0, v >= 0,
u + v <= 1 and mint <= t <= maxt, the closest hit the lowest t, ties to
the lowest face id. The kernel gets the same answer from a BVH walk; the
sweep is independent of the tree, which is what makes it the kernel's
check.

``traverse`` walks the device tree (ops/bvh.py ``pack_traversal``) step for
step as csrc/bvh.cuh does, vectorised over rays: near child first, a stack
of pair nodes, the box test against [mint, best t], leaves in order, ties
to the lowest face id. It returns the hits, per ray the box tests and face
tests the walk runs, and which nodes and face rows it reads, which is what
the kernels' bounds count (``bytes_read``); the tests hold its hits against
the sweep's.
"""

from __future__ import annotations

import torch

from .bvh import STACK_DEPTH

_BIG = 3.0e38
# rays x faces per sweep step
_CHUNK_ELEMS = 1 << 24
# bytes the device walk reads of one pair node (four float4), and of a
# face position's Z row, face id, and U and V rows (csrc/bvh.cuh ``walk``)
NODE_BYTES, FACE_READ_BYTES = 64, (16, 4, 32)


def _woop_dots(W, o, d):
    """Per-face [p, 1] . W and [d, 0] . W of every ray: W (F, 4) rows of
    one Woop axis, o and d (n, 3) -> two (n, F)."""
    po = (o[:, 0:1] * W[:, 0] + o[:, 1:2] * W[:, 1] + o[:, 2:3] * W[:, 2]
          + W[:, 3])
    pd = d[:, 0:1] * W[:, 0] + d[:, 1:2] * W[:, 1] + d[:, 2:3] * W[:, 2]
    return po, pd


def woop_test(woop, o, d, mint, maxt):
    """K2's Woop test of rays (n, 3) against faces (F, 12) -> t, u, v and
    the hit mask, each (n, F)."""
    U, DU = _woop_dots(woop[:, 0:4], o, d)
    V, DV = _woop_dots(woop[:, 4:8], o, d)
    Z, DZ = _woop_dots(woop[:, 8:12], o, d)
    dz_ok = DZ.abs() > 1e-12
    inv_dz = torch.where(dz_ok, 1.0 / torch.where(DZ == 0, 1.0, DZ), 0.0)
    t = -Z * inv_dz
    u = U + t * DU
    v = V + t * DV
    ok = (dz_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= mint[:, None]) & (t <= maxt[:, None]))
    return t, u, v, ok


def _ray_blocks(n, n_faces):
    step = max(1, _CHUNK_ELEMS // max(n_faces, 1))
    return range(0, n, step), step


def closest_hit_reference(woop, o, d, mint, maxt):
    """Closest hit of rays (o, d (n, 3), mint, maxt (n,)) among faces with
    Woop rows ``woop`` (F, 12) -> (t (n,) inf on a miss, uv (n, 2) 0 on a
    miss, prim (n,) int32 -1 on a miss)."""
    n, F = o.shape[0], woop.shape[0]
    t_out = torch.full((n,), float("inf"), device=o.device)
    uv = torch.zeros((n, 2), device=o.device)
    prim = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    if F == 0:
        return t_out, uv, prim
    starts, step = _ray_blocks(n, F)
    ids = torch.arange(F, device=o.device)
    for s in starts:
        sl = slice(s, s + step)
        t, u, v, ok = woop_test(woop, o[sl], d[sl], mint[sl], maxt[sl])
        t = torch.where(ok, t, _BIG)
        tmin = t.min(dim=1).values
        k = torch.where(ok & (t <= tmin[:, None]), ids, F).min(dim=1).values
        hit = k < F
        kk = k.clamp(max=F - 1)[:, None]
        t_out[sl] = torch.where(hit, tmin, float("inf"))
        uv[sl] = torch.where(hit[:, None], torch.cat(
            [u.gather(1, kk), v.gather(1, kk)], 1), 0.0)
        prim[sl] = torch.where(hit, k, -1).to(torch.int32)
    return t_out, uv, prim


def any_hit_reference(woop, o, d, mint, maxt):
    """Whether each ray hits any face with t in [mint, maxt] -> (n,)
    bool."""
    n, F = o.shape[0], woop.shape[0]
    hit = torch.zeros((n,), dtype=torch.bool, device=o.device)
    if F == 0:
        return hit
    starts, step = _ray_blocks(n, F)
    for s in starts:
        sl = slice(s, s + step)
        hit[sl] = woop_test(woop, o[sl], d[sl], mint[sl], maxt[sl])[3].any(1)
    return hit


# ----------------------------------------------------------------------------
# the device traversal, step for step (csrc/bvh.cuh)
# ----------------------------------------------------------------------------

def _dots(w, o, d):
    """[o, 1] . w and [d, 0] . w of rays against one Woop axis row each
    (w (k, 4)), summed left to right as ``woop_test`` does."""
    po = o[:, 0] * w[:, 0] + o[:, 1] * w[:, 1] + o[:, 2] * w[:, 2] + w[:, 3]
    pd = d[:, 0] * w[:, 0] + d[:, 1] * w[:, 1] + d[:, 2] * w[:, 2]
    return po, pd


def _face_t(w, o, d, k2):
    """t of rays against one face each (w (k, 12)): the path kernel's
    -Z / DZ, or K2's guarded -Z * (1 / DZ) (NaN where |DZ| <= 1e-12)."""
    Z, DZ = _dots(w[:, 8:12], o, d)
    if k2:
        return torch.where(DZ.abs() > 1e-12, -Z * (1.0 / DZ),
                           float("nan"))
    return -Z / DZ


def _face_uv(w, t, o, d, k2):
    U, DU = _dots(w[:, 0:4], o, d)
    V, DV = _dots(w[:, 4:8], o, d)
    u = U + t * DU
    v = V + t * DV
    if k2:
        inside = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    else:
        inside = (u >= 0.0) & (v >= 0.0) & (1.0 - u - v >= 0.0)
    return u, v, inside


def _slab(lo, hi, o, inv, mint, cap):
    """Box test of rays against one child box each -> (hit, entry t)."""
    a = (lo - o) * inv
    b = (hi - o) * inv
    tn = torch.maximum(torch.minimum(a, b).max(1).values, mint)
    tf = torch.minimum(torch.maximum(a, b).min(1).values, cap)
    return tn <= tf, tn


def traverse(nodes, woop, prim, o, d, mint, maxt, any_hit=False, k2=False):
    """The device walk of rays (o, d (n, 3), mint, maxt (n,)) over a packed
    tree (``nodes`` (P, 16), ``woop`` (F, 12) and ``prim`` (F,) in the
    tree's face order) -> dict of per-ray tensors: ``t``, ``u``, ``v``,
    ``face`` (the reference face id, -1 on a miss) of the closest hit, or
    ``hit`` for ``any_hit``; ``boxes`` and ``faces``, the box tests and the
    face tests (t computed) the walk runs; ``node_reads`` (P,) and
    ``face_reads`` (F, 3), bool over all rays, the pair nodes the walk
    reads and, per face position, whether it reads the Z row (every face
    tested), the face id (t in range) and the U and V rows (not dropped by
    the tie rule), as csrc/bvh.cuh loads them. ``k2`` picks K2's face
    test, else the path kernel's (t = -Z / DZ, min-form inside test)."""
    n, dev = o.shape[0], o.device
    P = nodes.reshape(-1, 16)
    Pi = P.view(torch.int32)
    inv = 1.0 / torch.where(d.abs() > 1e-12, d, 1e-12)
    tb = maxt.clone()
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    u_best = torch.zeros(n, device=dev)
    v_best = torch.zeros(n, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    boxes = torch.zeros(n, dtype=torch.int64, device=dev)
    faces = torch.zeros(n, dtype=torch.int64, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    alive = torch.full((n,), P.shape[0] > 0, dtype=torch.bool, device=dev)
    node_reads = torch.zeros(P.shape[0], dtype=torch.bool, device=dev)
    face_reads = torch.zeros((woop.shape[0], 3), dtype=torch.bool,
                             device=dev)
    prim = prim.long()

    def leaf(rows, first, cnt):
        """Faces first .. first + cnt - 1 of rays ``rows``, in order."""
        for j in range(int(cnt.max()) if len(cnt) else 0):
            live = (j < cnt) & ~found[rows] if any_hit else j < cnt
            r = rows[live]
            pos = first[live] + j
            w = woop[pos]
            faces[r] += 1
            face_reads[pos, 0] = True
            tf = _face_t(w, o[r], d[r], k2)
            ok = (tf >= mint[r]) & (tf <= tb[r])
            face_reads[pos[ok], 1] = True
            ident = prim[pos]
            if not any_hit:
                # equal t: only a lower face id replaces the best
                ok &= ~((tf == tb[r]) & (ident >= torch.where(
                    best[r] < 0, 1 << 62, best[r])))
            face_reads[pos[ok], 2] = True
            uu, vv, inside = _face_uv(w, tf, o[r], d[r], k2)
            ok &= inside
            r = r[ok]
            if any_hit:
                found[r] = True
                continue
            tb[r] = tf[ok]
            best[r] = ident[ok]
            u_best[r] = uu[ok]
            v_best[r] = vv[ok]

    while bool(alive.any()):
        idx = alive.nonzero()[:, 0]
        node_reads[node[idx]] = True
        row, ri = P[node[idx]], Pi[node[idx]]
        ra, ca, rb, cb = ri[:, 3].long(), ri[:, 7], ri[:, 11].long(), ri[:, 15]
        oi, ii, mi = o[idx], inv[idx], mint[idx]
        ha, ta = _slab(row[:, 0:3], row[:, 4:7], oi, ii, mi, tb[idx])
        hb, tbb = _slab(row[:, 8:11], row[:, 12:15], oi, ii, mi, tb[idx])
        ha &= ra >= 0
        hb &= rb >= 0
        boxes[idx] += (ra >= 0).long() + (rb >= 0).long()
        # the nearer child first
        sw = ha & hb & (tbb < ta)
        ra, rb = torch.where(sw, rb, ra), torch.where(sw, ra, rb)
        ca, cb = torch.where(sw, cb, ca), torch.where(sw, ca, cb)
        ta, tbb = torch.where(sw, tbb, ta), torch.where(sw, ta, tbb)
        nxt = torch.where(ha & (ca == 0), ra, -1)
        la = ha & (ca > 0)
        leaf(idx[la], ra[la], ca[la])
        hb &= tbb <= tb[idx]
        if any_hit:
            hb &= ~found[idx]
        lb = hb & (cb > 0)
        leaf(idx[lb], rb[lb], cb[lb])
        ib = hb & (cb == 0)
        push = ib & (nxt >= 0)
        stack[idx[push], sp[idx[push]]] = rb[push]
        sp[idx[push]] += 1
        nxt = torch.where(ib & (nxt < 0), rb, nxt)
        pop = nxt < 0
        done = pop & (sp[idx] == 0)
        if any_hit:
            done |= found[idx]
        pop &= ~done
        sp[idx[pop]] -= 1
        nxt[pop] = stack[idx[pop], sp[idx[pop]]]
        node[idx] = nxt.clamp(min=0)
        alive[idx[done]] = False
    out = {"boxes": boxes, "faces": faces, "node_reads": node_reads,
           "face_reads": face_reads}
    if any_hit:
        out["hit"] = found
    else:
        hit = best >= 0
        out.update(t=torch.where(hit, tb, float("inf")),
                   u=torch.where(hit, u_best, 0.0),
                   v=torch.where(hit, v_best, 0.0), face=best)
    return out


def bytes_read(walk) -> int:
    """-> the bytes of the distinct pair nodes and face rows a ``traverse``
    walk read over all its rays: a lower bound on what the device walk
    moves for those rays (each read once)."""
    return (NODE_BYTES * int(walk["node_reads"].sum())
            + sum(b * int(walk["face_reads"][:, k].sum())
                  for k, b in enumerate(FACE_READ_BYTES)))
