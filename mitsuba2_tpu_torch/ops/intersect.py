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

``closest_hit_instanced_reference`` and ``any_hit_instanced_reference``
are the plain version of K2's instance entries: each ray moves into each
instance's group frame (``to_group``, the kernel's unfused sums in its
order) and sweeps that group's faces, instance after instance, the sweep's
maxt the best t so far; a later instance replaces the best only at a
strictly smaller t (mitsuba2_tpu/render/scene.py:613-634).

``traverse`` walks the device tree (ops/bvh.py ``pack_traversal``, 4-wide
nodes) step for step as csrc/bvh.cuh does, vectorised over rays: the hit
children sorted by entry t, leaves tested nearest first, the farther
interior children pushed with their entry t, a pop beyond the best t
dropped, boxes tested against [mint, best t], ties to the lowest face id.
It returns the hits, per ray the nodes, box tests and face tests the walk
runs, and which nodes and face rows it reads (``bytes_read``); the tests
hold its hits against the sweep's. ``traverse_pairs`` is the binary walk
over the same leaves (ops/bvh.py ``pack_pairs``), whose counts the kernels'
bounds keep, and whose hits the wide walk's equal bit for bit.

``traverse_instances`` walks K2's instance entries step for step: the top
tree over the instances' world boxes nearest first, each instance leaf a
move into its group's frame, whose walk finds the instance's own hit
(``instance_hits``) where that lies within the best t; it counts the moves
and gives the plain version's hits bit for bit. ``traverse_instance_pairs``
walks the top tree's binary pair nodes the same way, for the bounds.
"""

from __future__ import annotations

import torch

from .bvh import PAIR_SLOTS, STACK_DEPTH, WIDE_SLOTS, WIDTH

_BIG = 3.0e38
_FLT_MAX = torch.finfo(torch.float32).max
# rays x faces per sweep step
_CHUNK_ELEMS = 1 << 24
# bytes the device walk reads of one wide node (one 128-byte line), of one
# pair node of the binary tree the bounds count (four float4), and of a
# face position's Z row, face id, and U and V rows (csrc/bvh.cuh ``walk``)
NODE_BYTES, PAIR_BYTES, FACE_READ_BYTES = 128, 64, (16, 4, 32)
# entries of the binary walk's stack, which holds at most one entry for
# each pair node above the current one: room for a pair tree of 65 levels,
# which the trees of tests/test_torch_deep_trees.py's clustered meshes
# keep within (ops/bvh.py ``traversal_bvh`` caps a tree deeper than the
# wide walk's stack); a walk that would need more raises WalkStackError
PAIR_STACK = 64


class WalkStackError(RuntimeError):
    """A walk of ops/intersect.py would push beyond its stack."""


def _push_room(sp, size, what):
    """Raises WalkStackError unless every stack pointer ``sp`` about to
    push lies below ``size``."""
    if len(sp) and int(sp.max()) >= size:
        raise WalkStackError(f"the {what} walk needs more than its {size} "
                             f"stack entries: the tree is too deep")


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


def to_group(row, o, d):
    """Rays o, d (n, 3) in the frame of an instance's group: o A^T + b and
    d A^T, with A = row[0:9] row-major and b = row[9:12], each product and
    sum rounded on its own, left to right (csrc/intersect_kernel.cu
    ``to_group``) -> (o_l, d_l)."""
    A, b = row[0:9], row[9:12]

    def lin(x, k):
        return x[:, 0] * A[3 * k] + x[:, 1] * A[3 * k + 1] \
            + x[:, 2] * A[3 * k + 2]

    o_l = torch.stack([lin(o, k) + b[k] for k in range(3)], 1)
    d_l = torch.stack([lin(d, k) for k in range(3)], 1)
    return o_l, d_l


def closest_hit_instanced_reference(woops, rows, g_max, o, d, mint, maxt):
    """Closest hit of rays o, d (n, 3), mint, maxt (n,) among the faces of
    the instances ``rows`` (I, 24) [A | b | B | group | ...], each
    instance's group ``woops[group]`` (F_g, 12) Woop rows in the group's
    face order -> (t (n,) inf on a miss, uv (n, 2) 0 on a miss, prim (n,)
    int32: instance * g_max + the group's face id, -1 on a miss)."""
    n = o.shape[0]
    tb = maxt.clone()
    uv = torch.zeros((n, 2), device=o.device)
    prim = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    for i, row in enumerate(rows.cpu()):
        o_l, d_l = to_group(row.to(o.device), o, d)
        t, uv_i, f = closest_hit_reference(woops[int(row[21])], o_l, d_l,
                                           mint, tb)
        closer = (f >= 0) & ((prim < 0) | (t < tb))
        tb = torch.where(closer, t, tb)
        uv = torch.where(closer[:, None], uv_i, uv)
        prim = torch.where(closer, i * g_max + f, prim).to(torch.int32)
    return torch.where(prim >= 0, tb, float("inf")), uv, prim


def any_hit_instanced_reference(woops, rows, o, d, mint, maxt):
    """Whether each ray hits a face of any instance (``rows``, ``woops`` as
    ``closest_hit_instanced_reference``) with t in [mint, maxt] -> (n,)
    bool."""
    hit = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    for row in rows.cpu():
        o_l, d_l = to_group(row.to(o.device), o, d)
        hit |= any_hit_reference(woops[int(row[21])], o_l, d_l, mint, maxt)
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
    """Box test of rays against one child box each (or, with lo and hi
    (n, k, 3), against k boxes each) -> (hit, entry t)."""
    if lo.dim() == 3:
        o, inv = o[:, None], inv[:, None]
        mint, cap = mint[:, None], cap[:, None]
    a = (lo - o) * inv
    b = (hi - o) * inv
    tn = torch.maximum(torch.minimum(a, b).max(-1).values, mint)
    tf = torch.minimum(torch.maximum(a, b).min(-1).values, cap)
    return tn <= tf, tn


class _Walk:
    """The per-ray state of a walk and its leaf test (csrc/bvh.cuh
    ``walk``'s ``leaf``), shared by ``traverse`` and ``traverse_pairs``."""

    def __init__(self, woop, prim, o, d, mint, maxt, any_hit, k2, n_nodes,
                 rows_at_once=False):
        n, dev = o.shape[0], o.device
        self.woop, self.prim = woop, prim.long()
        self.o, self.d, self.mint = o, d, mint
        self.any_hit, self.k2 = any_hit, k2
        # the wide walk reads a face's three rows at once, its face id only
        # on a tie in t and for the final hit; the binary walk read the id
        # of a face in range and the U and V rows of one not lost to a tie
        self.rows_at_once = rows_at_once
        # the tree position of each face id
        self.pos_of = torch.argsort(self.prim)
        self.inv = 1.0 / torch.where(d.abs() > 1e-12, d, 1e-12)
        self.tb = maxt.clone()
        self.best = torch.full((n,), -1, dtype=torch.int64, device=dev)
        self.u = torch.zeros(n, device=dev)
        self.v = torch.zeros(n, device=dev)
        self.found = torch.zeros(n, dtype=torch.bool, device=dev)
        self.boxes = torch.zeros(n, dtype=torch.int64, device=dev)
        self.faces = torch.zeros(n, dtype=torch.int64, device=dev)
        self.nodes = torch.zeros(n, dtype=torch.int64, device=dev)
        self.node_reads = torch.zeros(n_nodes, dtype=torch.bool, device=dev)
        self.face_reads = torch.zeros((woop.shape[0], 3), dtype=torch.bool,
                                      device=dev)

    def leaf(self, rows, first, cnt):
        """Faces first .. first + cnt - 1 of rays ``rows``, in order."""
        for j in range(int(cnt.max()) if len(cnt) else 0):
            live = (j < cnt) & ~self.found[rows] if self.any_hit \
                else j < cnt
            r = rows[live]
            pos = first[live] + j
            w = self.woop[pos]
            self.faces[r] += 1
            self.face_reads[pos, 0] = True
            tf = _face_t(w, self.o[r], self.d[r], self.k2)
            ok = (tf >= self.mint[r]) & (tf <= self.tb[r])
            ident = self.prim[pos]
            uu, vv, inside = _face_uv(w, tf, self.o[r], self.d[r], self.k2)
            if self.rows_at_once:
                self.face_reads[pos, 2] = True
                ok &= inside
            else:
                self.face_reads[pos[ok], 1] = True
            if not self.any_hit:
                # equal t: only a lower face id replaces the best
                tie = ok & (tf == self.tb[r]) & (self.best[r] >= 0)
                if self.rows_at_once:
                    # both ids: the face's and the best's
                    self.face_reads[pos[tie], 1] = True
                    self.face_reads[self.pos_of[self.best[r][tie]], 1] = True
                ok &= ~(tie & (ident >= self.best[r]))
            if not self.rows_at_once:
                self.face_reads[pos[ok], 2] = True
                ok &= inside
            r = r[ok]
            if self.any_hit:
                self.found[r] = True
                continue
            self.tb[r] = tf[ok]
            self.best[r] = ident[ok]
            self.u[r] = uu[ok]
            self.v[r] = vv[ok]

    def result(self, node_bytes):
        if self.rows_at_once and not self.any_hit:
            # the hit's face id, read at the end
            self.face_reads[self.pos_of[self.best[self.best >= 0]], 1] = True
        out = {"boxes": self.boxes, "faces": self.faces,
               "nodes": self.nodes, "node_reads": self.node_reads,
               "face_reads": self.face_reads, "node_bytes": node_bytes}
        if self.any_hit:
            out["hit"] = self.found
        else:
            hit = self.best >= 0
            out.update(t=torch.where(hit, self.tb, float("inf")),
                       u=torch.where(hit, self.u, 0.0),
                       v=torch.where(hit, self.v, 0.0), face=self.best)
        return out


def _sort_kids(t, ref, cnt):
    """csrc/bvh.cuh ``sort_kids``: the children (m, 4) by entry t (+inf
    where missed), nearest first, by the same five exchanges."""
    t, ref, cnt = t.clone(), ref.clone(), cnt.clone()
    for i, j in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
        sw = t[:, j] < t[:, i]
        for x in (t, ref, cnt):
            xi, xj = x[:, i].clone(), x[:, j].clone()
            x[:, i] = torch.where(sw, xj, xi)
            x[:, j] = torch.where(sw, xi, xj)
    return t, ref, cnt


def traverse(nodes, woop, prim, o, d, mint, maxt, any_hit=False, k2=False):
    """The device walk (csrc/bvh.cuh) of rays (o, d (n, 3), mint, maxt
    (n,)) over a packed tree (``nodes`` (P, 32) wide nodes, ops/bvh.py
    ``pack_traversal``; ``woop`` (F, 12) and ``prim`` (F,) in the tree's
    face order) -> dict of per-ray tensors: ``t``, ``u``, ``v``, ``face``
    (the reference face id, -1 on a miss) of the closest hit, or ``hit``
    for ``any_hit``; ``nodes`` the nodes read, ``boxes`` the box tests (a
    node's non-empty children) and ``faces`` the face tests (t computed)
    the walk runs; ``node_reads`` (P,) and ``face_reads`` (F, 3), bool over
    all rays, the nodes the walk reads and, per face position, whether it
    reads the Z row (every face tested), the face id (t in range) and the
    U and V rows (not dropped by the tie rule), as csrc/bvh.cuh loads them;
    ``node_bytes`` NODE_BYTES. ``k2`` picks K2's face test, else the path
    kernel's (t = -Z / DZ, min-form inside test)."""
    P = nodes.reshape(-1, WIDE_SLOTS)
    # the best t within FLT_MAX, so that a missed child's +inf is never in
    # range
    maxt = torch.where(maxt > _FLT_MAX, _FLT_MAX, maxt)
    w = _Walk(woop, prim, o, d, mint, maxt, any_hit, k2, P.shape[0],
              rows_at_once=True)
    _wide_walk(P, w, o, mint, any_hit)
    return w.result(NODE_BYTES)


def _wide_walk(P, w, o, mint, any_hit, live=None):
    """csrc/bvh.cuh ``walk``'s loop over wide nodes ``P`` (P, 32), rays
    vectorised (those of ``live``, else all), the leaves given to
    ``w.leaf`` (a ``_Walk``, or the top walk's ``_InstanceWalk``)."""
    n, dev = o.shape[0], o.device
    Pi = P.view(torch.int32)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((n, STACK_DEPTH), device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    alive = torch.full((n,), P.shape[0] > 0, dtype=torch.bool, device=dev)
    if live is not None:
        alive &= live
    K = WIDTH
    while bool(alive.any()):
        idx = alive.nonzero()[:, 0]
        m = len(idx)
        w.node_reads[node[idx]] = True
        w.nodes[idx] += 1
        row, ri = P[node[idx]], Pi[node[idx]]
        lo = row[:, 0:3 * K].reshape(m, 3, K).transpose(1, 2)
        hi = row[:, 3 * K:6 * K].reshape(m, 3, K).transpose(1, 2)
        ref, cnt = ri[:, 6 * K:7 * K].long(), ri[:, 7 * K:].long()
        w.boxes[idx] += (ref >= 0).sum(1)
        hit, tn = _slab(lo, hi, o[idx], w.inv[idx], mint[idx], w.tb[idx])
        tn, ref, cnt = _sort_kids(
            torch.where(hit & (ref >= 0), tn, float("inf")), ref, cnt)
        # the hit leaves, nearest first
        for c in range(K):
            lf = (cnt[:, c] > 0) & (tn[:, c] <= w.tb[idx])
            if any_hit:
                lf &= ~w.found[idx]
            w.leaf(idx[lf], ref[lf, c], cnt[lf, c])
        # the interior children in range, farthest pushed first
        nxt = torch.full((m,), -1, dtype=torch.int64, device=dev)
        t_nxt = torch.zeros(m, device=dev)
        stop = w.found[idx] if any_hit else torch.zeros_like(hit[:, 0])
        for c in reversed(range(K)):
            inner = (cnt[:, c] == 0) & (tn[:, c] <= w.tb[idx]) & ~stop
            push = inner & (nxt >= 0)
            r = idx[push]
            _push_room(sp[r], STACK_DEPTH, "wide")
            stack[r, sp[r]] = nxt[push]
            stack_t[r, sp[r]] = t_nxt[push]
            sp[r] += 1
            nxt = torch.where(inner, ref[:, c], nxt)
            t_nxt = torch.where(inner, tn[:, c], t_nxt)
        # else the nearest pending node whose box begins within the best t
        while True:
            pop = (nxt < 0) & (sp[idx] > 0) & ~stop
            if not bool(pop.any()):
                break
            r = idx[pop]
            sp[r] -= 1
            e, te = stack[r, sp[r]], stack_t[r, sp[r]]
            keep = torch.ones_like(pop[pop]) if any_hit else te <= w.tb[r]
            nxt[pop] = torch.where(keep, e, -1)
        node[idx] = nxt.clamp(min=0)
        alive[idx[nxt < 0]] = False


def instance_hits(woops, rows, o, d, mint, maxt, any_hit=False):
    """Each instance's own hits of rays o, d (n, 3) in [mint, maxt] (n,),
    by the plain sweep in its group's frame (``woops``, ``rows`` as
    ``closest_hit_instanced_reference``) -> (t (n, I), uv (n, I, 2), face
    (n, I) int32, -1 on a miss), or for ``any_hit`` (n, I) bool. The
    closest hit of a walk in [mint, c] is the instance's own where its t
    is at most c, so these fix every walk of the instance entries'
    designs (``traverse_instances``, the bounds' walks)."""
    hits = []
    for row in rows.cpu():
        o_l, d_l = to_group(row.to(o.device), o, d)
        woop = woops[int(row[21])]
        hits.append(any_hit_reference(woop, o_l, d_l, mint, maxt) if any_hit
                    else closest_hit_reference(woop, o_l, d_l, mint, maxt))
    if any_hit:
        return torch.stack(hits, 1)
    return tuple(torch.stack(x, 1) for x in zip(*hits))


class _InstanceWalk:
    """The top walk's per-ray state and its instance leaves
    (csrc/intersect_kernel.cu ``query_inst``), for ``_wide_walk``: an
    instance's walk, its maxt the best t so far, finds the instance's own
    hit (``instance_hits``) where that lies within the best t."""

    def __init__(self, own, g_max, d, maxt, any_hit, n_nodes, order=None):
        n, dev = d.shape[0], d.device
        self.own, self.any_hit, self.g_max = own, any_hit, g_max
        # a leaf's instance: its ref, or ``order`` at its tree position
        self.order = order
        self.visits = []
        self.inv = 1.0 / torch.where(d.abs() > 1e-12, d, 1e-12)
        self.tb = torch.where(maxt > _FLT_MAX, _FLT_MAX, maxt)
        self.best = torch.full((n,), -1, dtype=torch.int64, device=dev)
        self.uv = torch.zeros((n, 2), device=dev)
        self.found = torch.zeros(n, dtype=torch.bool, device=dev)
        self.moves = torch.zeros(n, dtype=torch.int64, device=dev)
        self.boxes = torch.zeros(n, dtype=torch.int64, device=dev)
        self.nodes = torch.zeros(n, dtype=torch.int64, device=dev)
        self.node_reads = torch.zeros(n_nodes, dtype=torch.bool, device=dev)

    def leaf(self, rows, inst, cnt):
        """The instance leaves ``inst`` (one instance each) of rays
        ``rows``: a move into the group's frame and its walk, the best t
        so far its maxt."""
        assert bool((cnt == 1).all())
        if self.order is not None:
            inst = self.order[inst]
        if self.any_hit:
            rows, inst = rows[~self.found[rows]], inst[~self.found[rows]]
        self.moves[rows] += 1
        self.visits.append((rows, inst, self.tb[rows]))
        if self.any_hit:
            self.found[rows] |= self.own[rows, inst]
            return
        t_own, uv_own, f_own = self.own
        t, f = t_own[rows, inst], f_own[rows, inst]
        tb, best = self.tb[rows], self.best[rows]
        # an equal t replaces from a lower instance index
        ok = (f >= 0) & (t <= tb) & (
            (best < 0) | (t < tb) | (inst < best // self.g_max))
        r = rows[ok]
        self.tb[r] = t[ok]
        self.uv[r] = uv_own[r, inst[ok]]
        self.best[r] = inst[ok] * self.g_max + f[ok].long()

    def result(self):
        dev = self.moves.device
        visits = [torch.cat(x) for x in zip(*self.visits)] or [
            torch.zeros(0, dtype=torch.int64, device=dev)] * 2 + [
            torch.zeros(0, device=dev)]
        out = {"moves": self.moves, "boxes": self.boxes,
               "nodes": self.nodes, "node_reads": self.node_reads,
               "visits": tuple(visits)}
        if self.any_hit:
            out["hit"] = self.found
        else:
            hit = self.best >= 0
            out.update(t=torch.where(hit, self.tb, float("inf")),
                       uv=torch.where(hit[:, None], self.uv, 0.0),
                       prim=self.best.to(torch.int32))
        return out


def traverse_instances(top, own, g_max, o, d, mint, maxt, any_hit=False):
    """K2's instance entries (csrc/intersect_kernel.cu ``query_inst``) step
    for step, rays vectorised: the top tree ``top`` (T, 32)
    (ops/intersect_kernel.py ``top_tree``, a leaf's ref its instance)
    walked in the world frame as ``traverse`` walks a group, each instance
    leaf reached a move into its group's frame, whose walk finds the
    instance's hit in ``own`` (``instance_hits`` of the rays) if it lies
    within the best t; ``g_max`` the prim ids' stride. Masked rays (maxt
    < mint or NaN) walk nothing -> dict of per-ray tensors: ``t``, ``uv``,
    ``prim`` of the closest hit (or ``hit``), the plain version's bit for
    bit; ``moves`` the instances the ray moves into, ``nodes`` and
    ``boxes`` the top nodes it reads and the box tests it runs;
    ``node_reads`` (T,) the top nodes any ray reads; ``visits`` (ray,
    instance, maxt) of every move, in the order made."""
    P = top.reshape(-1, WIDE_SLOTS)
    w = _InstanceWalk(own, g_max, d, maxt, any_hit, P.shape[0])
    _wide_walk(P, w, o, mint, any_hit, live=maxt >= mint)
    return w.result()


def traverse_instance_pairs(pairs, order, own, g_max, o, d, mint, maxt,
                            any_hit=False):
    """``traverse_instances`` over the top tree's binary pair nodes
    (ops/bvh.py ``pack_pairs`` of the top BVH, a leaf's ref its position
    in ``order``, the BVH's instance order): the walk whose box tests and
    moves the instance entries' bounds count (chip_smoke.py), as
    ``traverse_pairs`` is for a group's. Its hits are the plain
    version's."""
    P = pairs.reshape(-1, PAIR_SLOTS)
    w = _InstanceWalk(own, g_max, d, maxt, any_hit, P.shape[0],
                      order=order)
    _pair_walk(P, w, o, mint, any_hit, live=maxt >= mint)
    return w.result()


def traverse_pairs(pairs, woop, prim, o, d, mint, maxt, any_hit=False,
                   k2=False):
    """The binary walk over pair nodes (ops/bvh.py ``pack_pairs``), as
    csrc/bvh.cuh walked them before its wide nodes: near child first, a
    stack of pair nodes, a far child's leaf tested at once. No kernel runs
    it: its box and face tests, and the bytes it reads, are what the
    kernels' bounds count (chip_smoke.py ``bound``, ``run_isect``), so
    that a bound does not grow with the wide walk's extra box tests. Its
    hits equal ``traverse``'s bit for bit. Arguments and result as
    ``traverse``, ``node_bytes`` PAIR_BYTES."""
    P = pairs.reshape(-1, PAIR_SLOTS)
    w = _Walk(woop, prim, o, d, mint, maxt, any_hit, k2, P.shape[0])
    _pair_walk(P, w, o, mint, any_hit)
    return w.result(PAIR_BYTES)


def _pair_walk(P, w, o, mint, any_hit, live=None):
    """``traverse_pairs``'s loop over pair nodes ``P`` (P, 16), rays
    vectorised (those of ``live``, else all), the leaves given to
    ``w.leaf`` (a ``_Walk``, or an ``_InstanceWalk``)."""
    n, dev = o.shape[0], o.device
    Pi = P.view(torch.int32)
    found, tb = w.found, w.tb
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, PAIR_STACK), dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    alive = torch.full((n,), P.shape[0] > 0, dtype=torch.bool, device=dev)
    if live is not None:
        alive &= live
    while bool(alive.any()):
        idx = alive.nonzero()[:, 0]
        w.node_reads[node[idx]] = True
        w.nodes[idx] += 1
        row, ri = P[node[idx]], Pi[node[idx]]
        ra, ca, rb, cb = ri[:, 3].long(), ri[:, 7], ri[:, 11].long(), ri[:, 15]
        oi, ii, mi = o[idx], w.inv[idx], mint[idx]
        ha, ta = _slab(row[:, 0:3], row[:, 4:7], oi, ii, mi, tb[idx])
        hb, tbb = _slab(row[:, 8:11], row[:, 12:15], oi, ii, mi, tb[idx])
        ha &= ra >= 0
        hb &= rb >= 0
        w.boxes[idx] += (ra >= 0).long() + (rb >= 0).long()
        # the nearer child first
        sw = ha & hb & (tbb < ta)
        ra, rb = torch.where(sw, rb, ra), torch.where(sw, ra, rb)
        ca, cb = torch.where(sw, cb, ca), torch.where(sw, ca, cb)
        ta, tbb = torch.where(sw, tbb, ta), torch.where(sw, ta, tbb)
        nxt = torch.where(ha & (ca == 0), ra, -1)
        la = ha & (ca > 0)
        w.leaf(idx[la], ra[la], ca[la])
        hb &= tbb <= tb[idx]
        if any_hit:
            hb &= ~found[idx]
        lb = hb & (cb > 0)
        w.leaf(idx[lb], rb[lb], cb[lb])
        ib = hb & (cb == 0)
        push = ib & (nxt >= 0)
        _push_room(sp[idx[push]], PAIR_STACK, "binary")
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


def bytes_read(walk) -> int:
    """-> the bytes of the distinct nodes and face rows a ``traverse`` or
    ``traverse_pairs`` walk read over all its rays: a lower bound on what
    the device walk moves for those rays (each read once)."""
    return (walk["node_bytes"] * int(walk["node_reads"].sum())
            + sum(b * int(walk["face_reads"][:, k].sum())
                  for k, b in enumerate(FACE_READ_BYTES)))
