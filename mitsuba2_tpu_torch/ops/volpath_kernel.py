"""Volumetric path tracing: host tables, plain PyTorch version and the CUDA
kernel's wrapper.

Counterpart of ``mitsuba2_tpu/ops/volmegakernel.py`` (``_volpath_kernel``,
its host class ``VolPathMegakernel`` and its gate). The scope is the
reference kernel's: ONE heterogeneous medium (a grid or constant
``sigma_t``, constant rgb albedo, HG or isotropic phase) bounded by a
null-BSDF box whose local frame is the medium's [0,1]^3, plus at most
``MAX_VOL_FACES`` opaque triangles with diffuse, isotropic-GGX conductor or
smooth dielectric BSDFs and constant area lights on diffuse ones; rgb,
perspective pinhole, box filter.

One lane is one camera path, lanes are pixel-major
(``lane = pixel * spp_pass + s``). A path runs ``max_depth + LAUNCH_SLACK``
rounds; each round is one event of the reference kernel's launch: the
closest opaque hit, the ray's interval in the medium box, delta tracking
(at most ``NULL_BUDGET`` steps; a walk that exhausts them carries its
march point to the next round), then a real scatter or a surface event,
one unified NEE (a light face, its shadow any-hit and ratio-tracking
transmittance of at most ``TR_BUDGET`` steps, partial T kept), the
continuation (HG or isotropic phase, cosine, GGX visible normals or the
dielectric's two delta lobes) and Russian roulette. Paths still walking
after the last round are cut. The budgets are part of the estimator: they
define the reference's image.

Random numbers are the reference's, per lane: the TEA key
``_tea(seed, _tea(pixel, sample, 4), 4)``, film jitter at dim 0, and per
round r the window ``dim0 = 2 + 64 r``: delta step k at ``mix32(key, dim0 +
2k)`` (distance) and ``+ 2k + 1`` (accept), ratio step k at ``dim0 + 38 +
k``, TEA dims ``dim0 + 16, 17`` (NEE pick and point), ``+ 34`` (phase),
``+ 35`` (surface lobe), ``+ 36`` (roulette), ``+ 37`` (dielectric lobe).
The reference draws the 16 candidate distances of a walk first and
fetches them in one batch; they depend on the random numbers alone, so a
walk that stops at its first escape or real collision reaches the same
event.

``volpath_radiance`` runs the hand-written kernel (csrc/volpath_kernel.cu)
for tables on a CUDA device and ``volpath_radiance_reference`` for tables
on the CPU.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core.rng import mix32
from ..render.fresnel import fresnel, fresnel_conductor
from . import path_kernel as pk
# the entry point reports a launch and its own errors as the path
# kernel's does
from .path_kernel import (LAUNCH_ERRORS, LAUNCH_INFO, _BIG, _PI, _concentric,
                          _dot3, _frame, _ggx_d, _ggx_g1, _mis, _rng2, _u01)

# the reference kernel's caps (volmegakernel.py:64-74), so that the same
# scenes are eligible
MAX_VOL_FACES = 1024
MAX_GRID_DH = 16384
MAX_GRID_W = 128
# delta-tracking and ratio-tracking steps per round, and the rounds past
# max_depth (volmegakernel.py:80-86)
NULL_BUDGET = 16
TR_BUDGET = 16
LAUNCH_SLACK = 2
# camera paths per pass: 12 B of output per lane
MAX_LANES = 1 << 22

# Per-face attribute columns, VFA floats a row, in the reference's order
# (volmegakernel.py _VFA): normal, albedo (diffuse reflectance, or the
# conductor's or dielectric's specular reflectance), Le, light pdf per
# area, kind, GGX alpha, conductor eta and k, the dielectric's specular
# transmittance and relative IOR, padding. The kernel reads a row as six
# float4.
VFA = 24
C_NG, C_ALB, C_LE, C_LPDF, C_KIND, C_ALPHA = 0, 3, 6, 9, 10, 11
C_ETA, C_K, C_C2, C_ETAD = 12, 15, 18, 21
KIND_DIFFUSE, KIND_GGX, KIND_DIEL = 0, 1, 3

# Instantiation flags: the reference kernel's static has_hg / mis_mode /
# has_ggx / has_diel
HAS_HG, MIS, HAS_GGX, HAS_DIEL = 1, 2, 4, 8
_CHUNK_ELEMS = 1 << 24


def _f32(x) -> float:
    return float(np.float32(x))


def kernel_name(flags) -> str:
    """Name of one instantiation, e.g. 'volpath_kernel[hg]'."""
    parts = ["hg" if flags & HAS_HG else "isotropic"]
    parts += [n for f, n in ((MIS, "mis"), (HAS_GGX, "ggx"),
                             (HAS_DIEL, "diel")) if flags & f]
    return f"volpath_kernel[{'+'.join(parts)}]"


class VolPathTables(NamedTuple):
    """One scene's tables for the volumetric kernel, tensors float32 on
    one device.

    woop    (F, 12): Woop rows of the opaque faces (path_kernel.build_woop);
            the medium's boundary faces are not in the table.
    fattr   (F, VFA): their attribute columns (C_* above).
    lights  (L, 24): the light table (render/scene.py _light_table).
    grid    (D, H, W): sigma_t; a constant sigma_t is a 2x2x2 grid.
    med     the world -> medium-local affine, 12 floats: the 3x3 row-major,
            then the translation.
    maj     the majorant max(sigma_t) * scale; scale; albedo (3 floats);
            g the HG anisotropy (0 for isotropic).
    flags   HAS_HG, HAS_GGX, HAS_DIEL bits from the content.
    """
    woop: torch.Tensor
    fattr: torch.Tensor
    lights: torch.Tensor
    grid: torch.Tensor
    med: tuple
    maj: float
    scale: float
    albedo: tuple
    g: float
    flags: int

    @property
    def n_faces(self) -> int:
        return self.woop.shape[0]

    @property
    def device(self) -> torch.device:
        return self.woop.device

    def tensors(self) -> tuple:
        return tuple(v for v in self if isinstance(v, torch.Tensor))

    def to(self, device) -> "VolPathTables":
        return self._replace(**{k: v.to(device) for k, v in
                                self._asdict().items()
                                if isinstance(v, torch.Tensor)})


def _make_tables(woop, fattr, lights, grid, med, maj, scale, albedo, g,
                 device) -> VolPathTables:
    flags = HAS_HG if abs(g) >= 1e-3 else 0
    kinds = np.asarray(fattr, np.float32)[:, C_KIND]
    if (kinds == KIND_GGX).any():
        flags |= HAS_GGX
    if (kinds == KIND_DIEL).any():
        flags |= HAS_DIEL

    def dev(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    return VolPathTables(
        dev(woop), dev(fattr), dev(lights), dev(grid),
        tuple(_f32(x) for x in np.asarray(med).reshape(12)), float(maj),
        float(scale), tuple(_f32(x) for x in albedo), float(g), flags)


def _rgb3(tex) -> np.ndarray:
    return np.broadcast_to(np.asarray(tex.rgb, np.float32), (3,))


def build_vol_tables(scene, device=None) -> VolPathTables:
    """The tables of an eligible scene (``vol_kernel_ineligibility`` is
    None) on ``device`` (the scene's by default), as
    ``VolPathMegakernel.__init__`` builds them (volmegakernel.py:887-1052),
    from the scene's per-face host arrays and light table."""
    from ..models.bsdfs import RoughConductor, SmoothDielectric
    from ..models.media_impl import Grid3DVolume
    from ..models.phase import HGPhase
    med = scene.media[0]
    M = np.asarray(med.to_local.matrix, np.float32)
    med_row = np.concatenate([M[:3, :3].reshape(-1), M[:3, 3]])
    alb = np.asarray(med.albedo_vol.rgb, np.float32).reshape(-1)
    albedo = [alb[c % len(alb)] for c in range(3)]
    ph = med.phase_function
    g = float(ph.g) if isinstance(ph, HGPhase) else 0.0
    vol = med.sigma_t_vol
    if isinstance(vol, Grid3DVolume):
        grid = vol.data[..., 0]
    else:
        grid = np.full((2, 2, 2), float(vol.rgb.reshape(-1)[0]), np.float32)

    # opaque faces: all but the boundary box's
    bound = next(i for i, s in enumerate(scene.shapes)
                 if s.interior_medium is med)
    keep = scene.face_shape != bound
    fs = scene.face_shape[keep]
    n_shapes = max(len(scene.shapes), 1)
    cols = np.zeros((n_shapes, VFA), np.float32)
    for i, s in enumerate(scene.shapes):
        b = s.bsdf
        if type(b) is RoughConductor:
            cols[i, C_KIND] = KIND_GGX
            cols[i, C_ALPHA] = b.alpha_u
            cols[i, C_ALB:C_ALB + 3] = _rgb3(b.specular_reflectance)
            cols[i, C_ETA:C_ETA + 3] = _rgb3(b.eta_tex)
            cols[i, C_K:C_K + 3] = _rgb3(b.k_tex)
        elif type(b) is SmoothDielectric:
            cols[i, C_KIND] = KIND_DIEL
            cols[i, C_ALB:C_ALB + 3] = _rgb3(b.specular_reflectance)
            cols[i, C_C2:C_C2 + 3] = _rgb3(b.specular_transmittance)
            cols[i, C_ETAD] = b.eta
        elif hasattr(b, "reflectance"):
            cols[i, C_ALB:C_ALB + 3] = _rgb3(b.reflectance)
    fattr = cols[fs]
    fattr[:, C_NG:C_NG + 3] = scene.ng[keep]
    fattr[:, C_LE:C_LE + 3] = scene.le_face[keep]
    fattr[:, C_LPDF] = scene.lpdf_w[keep]
    woop = pk.build_woop(scene.v0[keep], scene.e1[keep], scene.e2[keep])
    dev = scene.device if device is None else torch.device(device)
    return _make_tables(woop, fattr, scene.light_rows, grid, med_row,
                        med.majorant, med.scale, albedo, g, dev)


def _pad8(x):
    return max(8, int(np.ceil(x / 8)) * 8)


def vol_tables_from_reference(mk, device=None) -> VolPathTables:
    """A reference ``VolPathMegakernel``'s own tables -> VolPathTables:
    its chunked transposed Woop blocks (n_chunks * 3C, 4) back to one row
    per face, its (24, F) attributes and (24, L) lights transposed, its
    ``_pack_grid`` (Dp, HWp) layout unpacked to (D, H, W); the never-hit
    padding faces are dropped. Reads the arrays only."""
    nf, F, C = mk.n_faces, mk._F, mk.chunk
    woop = np.asarray(mk.woop, np.float32)
    rows = woop.reshape(F // C, 3, C, 4).transpose(0, 2, 1, 3)
    rows = rows.reshape(F, 12)[:nf]
    fattr = np.asarray(mk.fattr, np.float32).T[:nf]
    D, H, W = mk.D, mk.H, mk.W
    packed = np.asarray(mk.grid, np.float32)
    wp8 = _pad8(W)
    grid = packed[:D, :H * wp8].reshape(D, H, wp8)[:, :, :W]
    dev = torch.device("cpu") if device is None else torch.device(device)
    return _make_tables(rows, fattr, np.asarray(mk.lights, np.float32).T,
                        grid, np.asarray(mk.med_row)[:12], mk.maj, mk.scale,
                        mk.alb_med, mk.g_hg, dev)


def phase_constants(g) -> dict:
    """The HG terms the kernel reads, computed in double from g and rounded
    once, as the reference's Python-float arithmetic does: a = 1 + g^2,
    b = 2g, c = (1 - g^2) / (4 pi), d = 1 - g^2, e = 1 - g, and 1 / (4 pi)."""
    g = float(g)
    return dict(hg_a=_f32(1.0 + g * g), hg_b=_f32(2.0 * g),
                hg_c=_f32((1.0 / (4.0 * _PI)) * (1.0 - g * g)),
                hg_d=_f32(1.0 - g * g), hg_e=_f32(1.0 - g),
                inv4pi=_f32(1.0 / (4.0 * _PI)))


# ----------------------------------------------------------------------------
# plain PyTorch version
# ----------------------------------------------------------------------------

def _to_local(med, p):
    return [med[3 * i] * p[0] + med[3 * i + 1] * p[1] + med[3 * i + 2] * p[2]
            + med[9 + i] for i in range(3)]


def _box_interval(med, o, d):
    """[t0, t1] of rays against the medium's local [0,1]^3 (the ray
    parameter is affine-invariant, so t stays in world units); empty for
    a parallel ray outside a slab (volmegakernel.py:229-249)."""
    ol = _to_local(med, o)
    dl = [med[3 * i] * d[0] + med[3 * i + 1] * d[1] + med[3 * i + 2] * d[2]
          for i in range(3)]
    t0 = torch.full_like(o[0], -_BIG)
    t1 = torch.full_like(o[0], _BIG)
    big = torch.full_like(t0, _BIG)
    for o_l, d_l in zip(ol, dl):
        small = d_l.abs() <= 1e-12
        inv = 1.0 / torch.where(small, torch.full_like(d_l, 1e-12), d_l)
        ta = (0.0 - o_l) * inv
        tb = (1.0 - o_l) * inv
        par_out = small & ((o_l < 0.0) | (o_l > 1.0))
        t0 = torch.maximum(t0, torch.where(par_out, big,
                                           torch.minimum(ta, tb)))
        t1 = torch.minimum(t1, torch.where(par_out, -big,
                                           torch.maximum(ta, tb)))
    return t0, t1


def _sigma(tables, p):
    """sigma_t at world points p (3 tensors of one shape): the grid's
    clamped trilinear lerp at the medium-local point (coordinates clipped
    to [-1, 2] first), times scale, 0 outside [0,1]^3
    (volmegakernel.py:118-183)."""
    from ..models.media_impl import trilinear
    lx, ly, lz = (torch.clamp(c, -1.0, 2.0) for c in _to_local(tables.med, p))
    return trilinear(tables.grid, lx, ly, lz) * tables.scale


def _log_step(u, inv_maj):
    """Free-flight distance of a uniform: -log(max(1 - u, 1e-38)) / maj."""
    return -torch.log(torch.clamp(1.0 - u, min=1e-38)) * inv_maj


def _mix_u01(key, dim):
    return _u01(mix32(key, dim))


def _round(tables, st, r, max_depth, rr_depth, mis, stats):
    """One event round of the live lanes in ``st`` (a dict of per-lane
    tensors, updated in place) -> the lanes still alive after it
    (volmegakernel.py:380-865)."""
    f32 = torch.float32
    key = st["key"]
    o = [st["o0"], st["o1"], st["o2"]]
    d = [st["d0"], st["d1"], st["d2"]]
    thr = [st["t0"], st["t1"], st["t2"]]
    res = [st["r0"], st["r1"], st["r2"]]
    depth, spec, prev_pdf = st["depth"], st["spec"], st["prev_pdf"]
    m = key.shape[0]
    zero = torch.zeros(m, dtype=f32, device=key.device)
    one = torch.ones_like(zero)
    big = torch.full_like(zero, _BIG)
    fl = tables.flags
    has_hg, has_ggx, has_diel = fl & HAS_HG, fl & HAS_GGX, fl & HAS_DIEL
    pc = phase_constants(tables.g)
    inv_maj = _f32(1.0 / tables.maj)
    dim0 = 2 + 64 * r
    F = tables.n_faces

    def count(name, v):
        if stats is not None:
            stats[name] = stats.get(name, 0) + int(v)

    count("rounds", m)
    steps = torch.zeros(m, dtype=torch.int64, device=key.device)

    # ---- closest opaque hit (lowest face id on ties) ----
    t_surf, A = big, torch.zeros((m, VFA), dtype=f32, device=key.device)
    if F:
        tf, uf, vf = pk._woop_t_uv(tables.woop, o, d)
        tmin, k = pk._argmin_lowest(torch.where(
            pk._face_ok(tf, uf, vf, big), tf, big[:, None]))
        hit = tmin < _BIG * 0.5
        t_surf = tmin
        A = torch.where(hit[:, None], tables.fattr[k], A)
    hit = t_surf < _BIG * 0.5

    # ---- the ray's interval in the medium, delta tracking ----
    tb0, tb1 = _box_interval(tables.med, o, d)
    tb0 = torch.clamp(tb0, min=0.0)
    cap = torch.minimum(tb1, t_surf)
    walking = cap > tb0
    t_cum, tcands, ureal = tb0, [], []
    for step in range(NULL_BUDGET):
        dt = _log_step(_mix_u01(key, dim0 + 2 * step), inv_maj)
        t_cum = torch.clamp(t_cum + dt, max=_BIG)
        tcands.append(t_cum)
        ureal.append(_mix_u01(key, dim0 + 2 * step + 1))
    tc = torch.stack(tcands)                                  # (16, m)
    sig = _sigma(tables, [o[i] + tc * d[i] for i in range(3)])
    scattered = torch.zeros_like(walking)
    t_cur, t_scat = tb0, zero
    for step in range(NULL_BUDGET):
        esc = tcands[step] > cap
        real = ureal[step] < sig[step] * inv_maj
        count("delta_steps", walking.sum())
        count("delta_fetches", (walking & ~esc).sum())
        steps += walking
        new = walking & ~esc & real
        scattered = scattered | new
        t_scat = torch.where(new, tcands[step], t_scat)
        t_cur = torch.where(walking & ~esc, tcands[step], t_cur)
        walking = walking & ~esc & ~real
    stalled = walking
    count("stalled", stalled.sum())

    # ---- events ----
    act_real = scattered
    act_surf = hit & ~scattered & ~stalled
    died = ~hit & ~scattered & ~stalled
    thr_ = [torch.where(act_real, thr[c] * tables.albedo[c], thr[c])
            for c in range(3)]
    depth_ = depth + act_real.to(depth.dtype)
    act_real = act_real & (depth_ < max_depth)
    ps = [o[i] + t_scat * d[i] for i in range(3)]

    ng = [A[:, C_NG + i] for i in range(3)]
    alb = [A[:, C_ALB + c] for c in range(3)]
    le = [A[:, C_LE + c] for c in range(3)]
    cos_hit = -(d[0] * ng[0] + d[1] * ng[1] + d[2] * ng[2])
    kind = A[:, C_KIND]
    is_ggx = (kind > 0.5) & (kind < 1.5) if has_ggx \
        else torch.zeros_like(hit)
    is_diel = (kind > 2.5) & (kind < 3.5) if has_diel \
        else torch.zeros_like(hit)
    alpha = torch.clamp(A[:, C_ALPHA], min=1e-3)
    eta_k = [A[:, C_ETA + c] for c in range(3)]
    kap_k = [A[:, C_K + c] for c in range(3)]
    n1, n2 = _frame(ng)

    def sl_local(v):
        return [_dot3(v, n1), _dot3(v, n2), _dot3(v, ng)]

    def sl_world(v):
        return [v[0] * n1[i] + v[1] * n2[i] + v[2] * ng[i] for i in range(3)]

    wix, wiy, wiz_r = sl_local([-d[0], -d[1], -d[2]])
    wiz = torch.clamp(wiz_r, min=1e-6)

    # ---- emission ----
    if mis:
        pdf_l_hit = torch.where(
            cos_hit > 1e-6, t_surf * t_surf * A[:, C_LPDF]
            / torch.clamp(cos_hit, min=1e-6), zero)
        em_w = torch.where(prev_pdf > 0.0, _mis(prev_pdf, pdf_l_hit), one)
        emit = act_surf & (cos_hit > 0.0)
        res = [res[c] + torch.where(emit, em_w * thr_[c] * le[c], zero)
               for c in range(3)]
    else:
        emit = act_surf & spec & (cos_hit > 0.0)
        res = [res[c] + torch.where(emit, thr_[c] * le[c], zero)
               for c in range(3)]
    # FrontSide BSDFs end the path on back faces; dielectrics are two-sided
    act_surf = act_surf & ((cos_hit > 0.0) | is_diel)
    p = [o[i] + t_surf * d[i] for i in range(3)]
    eps = (1.0 + torch.maximum(p[0].abs(), torch.maximum(
        p[1].abs(), p[2].abs()))) * 1.8e-4

    # ---- unified NEE: a light face, shadow any-hit, ratio tracking ----
    u_sel, u_b1 = _rng2(key, dim0 + 16)
    u_b2, _ = _rng2(key, dim0 + 17)
    lights = tables.lights
    L = lights.shape[0]
    li = (lights[:, 12][None, :] <= u_sel[:, None]).sum(dim=1)
    LT = lights[li.clamp(max=L - 1)]
    s_t = torch.sqrt(torch.clamp(1.0 - u_b1, min=0.0))
    bu = 1.0 - s_t
    bv = u_b2 * s_t
    pl = [LT[:, i] + LT[:, 3 + i] * bu + LT[:, 6 + i] * bv for i in range(3)]
    nee_surf = act_surf & (depth_ + 1 < max_depth) & ~is_diel
    so = [torch.where(act_real, ps[i], p[i] + ng[i] * eps) for i in range(3)]
    dl = [pl[i] - so[i] for i in range(3)]
    dist2 = dl[0] * dl[0] + dl[1] * dl[1] + dl[2] * dl[2]
    dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
    inv_dist = 1.0 / dist
    dl = [x * inv_dist for x in dl]
    cos_l = -(dl[0] * LT[:, 9] + dl[1] * LT[:, 10] + dl[2] * LT[:, 11])
    pdf_l = torch.where(cos_l > 1e-6, dist2 * LT[:, 13]
                        / torch.clamp(cos_l, min=1e-6), zero)
    if has_hg:
        c_hg = -(d[0] * dl[0] + d[1] * dl[1] + d[2] * dl[2])
        temp = pc["hg_a"] + pc["hg_b"] * c_hg
        ph_val = pc["hg_c"] / torch.clamp(
            temp * torch.sqrt(torch.clamp(temp, min=1e-8)), min=1e-8)
    else:
        ph_val = torch.full_like(zero, pc["inv4pi"])
    cos_s = dl[0] * ng[0] + dl[1] * ng[1] + dl[2] * ng[2]
    fcos_diff = torch.clamp(cos_s, min=0.0) / _PI
    pdf_surf_l = fcos_diff
    fs = [fcos_diff] * 3
    if has_ggx:
        wo = sl_local(dl)
        h = [wix + wo[0], wiy + wo[1], wiz + wo[2]]
        hinv = torch.rsqrt(torch.clamp(_dot3(h, h), min=1e-20))
        h = [x * hinv for x in h]
        ci_h = torch.clamp(wix * h[0] + wiy * h[1] + wiz * h[2], min=0.0)
        D_l = _ggx_d(h[2], alpha)
        G_l = _ggx_g1(wiz, alpha) * _ggx_g1(torch.clamp(wo[2], min=1e-6),
                                            alpha)
        spec_common = D_l * G_l / torch.clamp(4.0 * wiz, min=1e-20)
        pdf_ggx_l = _ggx_g1(wiz, alpha) * D_l \
            / torch.clamp(4.0 * wiz, min=1e-20)
        ggx_ok = (wo[2] > 0).to(f32)
        fs = [torch.where(is_ggx, spec_common * fresnel_conductor(
            ci_h, eta_k[c], kap_k[c]) * ggx_ok, fcos_diff) for c in range(3)]
        pdf_surf_l = torch.where(is_ggx, pdf_ggx_l, pdf_surf_l)
    f = [torch.where(act_real, ph_val, fs[c] * alb[c]) for c in range(3)]
    nee_ok = (act_real | nee_surf) & (pdf_l > 0.0) \
        & (torch.where(act_real, one, cos_s) > 0.0)
    count("nee", nee_ok.sum())
    if F:
        tt, uu, vv = pk._woop_t_uv(tables.woop, so, dl)
        m3 = torch.minimum(torch.minimum(uu, vv), 1.0 - uu - vv)
        hits = (m3 >= 0.0) & (tt >= 1e-4) \
            & (tt <= torch.where(nee_ok, dist * 0.999, -big)[:, None])
        if stats is not None:
            count("shadow_faces", pk._first_or_all(hits)[nee_ok].sum())
        nee_ok = nee_ok & ~hits.any(1)
    sb0, sb1 = _box_interval(tables.med, so, dl)
    sb0 = torch.clamp(sb0, min=0.0)
    sb1 = torch.minimum(sb1, dist)
    s_cum, scands = sb0, []
    for step in range(TR_BUDGET):
        s_cum = torch.clamp(s_cum + _log_step(
            _mix_u01(key, dim0 + 38 + step), inv_maj), max=_BIG)
        scands.append(s_cum)
    sc = torch.stack(scands)
    sig_tr = _sigma(tables, [so[i] + sc * dl[i] for i in range(3)])
    T = one
    tr_walk = nee_ok & (sb1 > sb0)
    for step in range(TR_BUDGET):
        done_seg = scands[step] > sb1
        count("ratio_steps", tr_walk.sum())
        count("ratio_fetches", (tr_walk & ~done_seg).sum())
        steps += tr_walk
        T = torch.where(tr_walk & ~done_seg, T * torch.clamp(
            1.0 - sig_tr[step] * inv_maj, min=0.0), T)
        tr_walk = tr_walk & ~done_seg & (T > 0.0)
    count("ratio_cut", tr_walk.sum())
    if mis:
        w_nee = _mis(pdf_l, torch.where(act_real, ph_val, pdf_surf_l))
    else:
        w_nee = one
    base = w_nee * T / torch.clamp(pdf_l, min=1e-20)
    res = [res[c] + torch.where(nee_ok, thr_[c] * base * f[c] * LT[:, 14 + c],
                                zero) for c in range(3)]

    # ---- continuation: the phase function around d ----
    u_p1, u_p2 = _rng2(key, dim0 + 34)
    if has_hg:
        sq = pc["hg_d"] / (pc["hg_e"] + pc["hg_b"] * u_p1)
        cth = (pc["hg_a"] - sq * sq) / pc["hg_b"]
    else:
        cth = 1.0 - 2.0 * u_p1
    cth = torch.clamp(cth, -1.0, 1.0)
    sth = torch.sqrt(torch.clamp(1.0 - cth * cth, min=0.0))
    phi = (2.0 * _PI) * u_p2
    cph, sph = torch.cos(phi), torch.sin(phi)
    t1, t2 = _frame(d)
    md = [sth * cph * t1[i] + sth * sph * t2[i] + cth * d[i]
          for i in range(3)]
    count("phase", act_real.sum())

    # ---- continuation: the surface lobe ----
    u_c1, u_c2 = _rng2(key, dim0 + 35)
    cx, cy = _concentric(u_c1, u_c2)
    cz = torch.sqrt(torch.clamp(1.0 - cx * cx - cy * cy, min=0.0))
    wsel = [cx, cy, cz]
    ok_lobe = cz > 0.0
    mm = list(alb)
    pdf_bounce = torch.clamp(cz, min=0.0) / _PI
    if has_ggx:
        vh = [alpha * wix, alpha * wiy, wiz]
        vinv = torch.rsqrt(torch.clamp(_dot3(vh, vh), min=1e-20))
        vh = [x * vinv for x in vh]
        lensq = vh[0] * vh[0] + vh[1] * vh[1]
        linv = torch.rsqrt(torch.clamp(lensq, min=1e-20))
        t1x = torch.where(lensq > 1e-12, -vh[1] * linv, one)
        t1y = torch.where(lensq > 1e-12, vh[0] * linv, zero)
        t2 = [-vh[2] * t1y, vh[2] * t1x, vh[0] * t1y - vh[1] * t1x]
        rr = torch.sqrt(torch.clamp(u_c1, min=0.0))
        phiv = (2.0 * _PI) * u_c2
        p1 = rr * torch.cos(phiv)
        p2 = rr * torch.sin(phiv)
        s_v = 0.5 * (1.0 + vh[2])
        p2 = (1.0 - s_v) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) \
            + s_v * p2
        pz = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
        mh = [alpha * (p1 * t1x + p2 * t2[0] + pz * vh[0]),
              alpha * (p1 * t1y + p2 * t2[1] + pz * vh[1]),
              torch.clamp(p2 * t2[2] + pz * vh[2], min=1e-6)]
        minv = torch.rsqrt(_dot3(mh, mh))
        mh = [x * minv for x in mh]
        wm = wix * mh[0] + wiy * mh[1] + wiz * mh[2]
        go = [2.0 * wm * mh[0] - wix, 2.0 * wm * mh[1] - wiy,
              2.0 * wm * mh[2] - wiz]
        pdf_ggx = _ggx_g1(wiz, alpha) * _ggx_d(mh[2], alpha) \
            / torch.clamp(4.0 * wiz, min=1e-20)
        g1o = _ggx_g1(torch.clamp(go[2], min=1e-6), alpha)
        wsel = [torch.where(is_ggx, go[i], wsel[i]) for i in range(3)]
        ok_lobe = torch.where(is_ggx, (go[2] > 1e-6) & (wm > 0), ok_lobe)
        mm = [torch.where(is_ggx, alb[c] * fresnel_conductor(
            torch.clamp(wm, min=0.0), eta_k[c], kap_k[c]) * g1o, mm[c])
            for c in range(3)]
        pdf_bounce = torch.where(is_ggx, pdf_ggx, pdf_bounce)
    if has_diel:
        u_lobe, _ = _rng2(key, dim0 + 37)
        F_d, cos_t, _, eta_ti = fresnel(
            wiz_r, torch.clamp(A[:, C_ETAD], min=1e-3))
        refl = u_lobe <= F_d
        dd = [torch.where(refl, -wix, -eta_ti * wix),
              torch.where(refl, -wiy, -eta_ti * wiy),
              torch.where(refl, wiz_r, cos_t)]
        wsel = [torch.where(is_diel, dd[i], wsel[i]) for i in range(3)]
        mm = [torch.where(is_diel, torch.where(
            refl, alb[c], A[:, C_C2 + c] * eta_ti * eta_ti), mm[c])
            for c in range(3)]
        ok_lobe = ok_lobe | is_diel
        pdf_bounce = torch.where(is_diel, zero, pdf_bounce)
    sd = sl_world(wsel)
    bounce = act_surf & ok_lobe & ((mm[0] + mm[1] + mm[2]) > 0.0)
    count("surface", act_surf.sum())
    thr_ = [torch.where(bounce, thr_[c] * mm[c], thr_[c]) for c in range(3)]
    depth_ = depth_ + bounce.to(depth_.dtype)

    # ---- next ray ----
    offs = torch.where(wsel[2] >= 0.0, eps, 0.0 - eps)
    no = [torch.where(act_real, ps[i], torch.where(
        bounce, p[i] + ng[i] * offs, o[i] + t_cur * d[i])) for i in range(3)]
    nd = [torch.where(act_real, md[i], torch.where(bounce, sd[i], d[i]))
          for i in range(3)]
    if mis:
        if has_hg:
            tmp_o = pc["hg_a"] - pc["hg_b"] * cth
            pdf_ph_out = pc["hg_c"] / torch.clamp(
                tmp_o * torch.sqrt(torch.clamp(tmp_o, min=1e-8)), min=1e-8)
        else:
            pdf_ph_out = torch.full_like(zero, pc["inv4pi"])
        prev_pdf = torch.where(act_real, pdf_ph_out,
                               torch.where(bounce, pdf_bounce, prev_pdf))
    spec = spec & ~act_real & (~bounce | is_diel)
    act = (act_real | bounce | stalled) & (depth_ < max_depth) \
        & ((thr_[0] + thr_[1] + thr_[2]) > 0.0) & ~died

    # ---- Russian roulette ----
    rr_u, _ = _rng2(key, dim0 + 36)
    q = torch.clamp(torch.maximum(thr_[0], torch.maximum(thr_[1], thr_[2])),
                    max=0.95)
    do_rr = (depth_ > rr_depth) & act & ~stalled
    cont = rr_u < q
    act = act & (~do_rr | cont)
    inv_q = 1.0 / torch.clamp(q, min=1e-8)
    keep = do_rr & cont
    thr_ = [torch.where(keep, thr_[c] * inv_q, thr_[c]) for c in range(3)]

    st.update(o0=no[0], o1=no[1], o2=no[2], d0=nd[0], d1=nd[1], d2=nd[2],
              t0=thr_[0], t1=thr_[1], t2=thr_[2], r0=res[0], r1=res[1],
              r2=res[2], depth=depth_, spec=spec, prev_pdf=prev_pdf)
    return act, steps


def _trace_lanes(tables, cam, key, pixel, width, height, max_depth,
                 rr_depth, mis, stats):
    """Radiance (3, n) of the lanes with TEA keys ``key`` at ``pixel``;
    each round runs on the lanes still alive. ``stats``, if given, sums
    the work of the kernel's loops: lanes per round ("rounds", each tests
    every opaque face), delta-tracking steps and their grid fetches,
    NEE evaluations ("nee", each a shadow ray), the shadow rays' face
    tests up to their first occluder, ratio-tracking steps and fetches,
    and the phase and surface continuations; the truncation's reach:
    walks that ran out of delta-tracking steps ("stalled"), ratio-tracking
    walks cut with T > 0 ("ratio_cut") and paths still alive after the
    last round ("cut_paths"); and what warps of 32 consecutive lanes run
    in lockstep: lane slots of warps with a live lane per round
    ("warp_rounds") and, per round, 32 times the most tracking steps of a
    lane of the warp ("warp_steps")."""
    f32 = torch.float32
    n = key.shape[0]
    dev = key.device
    px = (pixel % width).to(f32)
    py = (pixel // width).to(f32)
    jx, jy = _rng2(key, 0)
    sx = (px + jx) / width
    sy = (py + jy) / height
    tan_half = cam[12]
    cxs = -(2.0 * sx - 1.0) * tan_half
    cys = (1.0 - 2.0 * sy) * tan_half / (width / height)
    inv_len = torch.rsqrt(cxs * cxs + cys * cys + 1.0)
    lx, ly, lz = cxs * inv_len, cys * inv_len, inv_len
    zero = torch.zeros(n, dtype=f32, device=dev)
    st = {"key": key, "ids": torch.arange(n, device=dev),
          "depth": torch.zeros(n, dtype=torch.int64, device=dev),
          "spec": torch.ones(n, dtype=torch.bool, device=dev),
          "prev_pdf": zero}
    for i in range(3):
        st[f"d{i}"] = (cam[3 * i] * lx + cam[3 * i + 1] * ly
                       + cam[3 * i + 2] * lz)
        st[f"o{i}"] = zero + cam[9 + i]
        st[f"t{i}"] = zero + 1.0
        st[f"r{i}"] = zero
    out = torch.zeros((3, n), dtype=f32, device=dev)
    n_warps = (n + 31) // 32
    for r in range(max_depth + LAUNCH_SLACK):
        alive, steps = _round(tables, st, r, max_depth, rr_depth, mis,
                              stats)
        if stats is not None:
            warp = st["ids"] // 32
            live = torch.zeros(n_warps, dtype=torch.int64, device=dev)
            most = live.scatter_reduce(0, warp, steps, "amax")
            stats["warp_rounds"] = stats.get("warp_rounds", 0) + 32 * int(
                live.index_fill_(0, warp, 1).sum())
            stats["warp_steps"] = stats.get("warp_steps", 0) + 32 * int(
                most.sum())
        for c in range(3):
            out[c, st["ids"]] = st[f"r{c}"]
        st = {k: v[alive] for k, v in st.items()}
        if st["ids"].numel() == 0:
            break
    if stats is not None:
        stats["cut_paths"] = stats.get("cut_paths", 0) + st["ids"].numel()
    return out


def volpath_radiance_reference(tables, cam, seed, sample_base, spp_pass,
                               width, height, max_depth, rr_depth,
                               mis=False, stats=None):
    """Plain PyTorch version of the volumetric kernel -> (3, n) float32
    per-lane rgb radiance, n = width * height * spp_pass, on the tables'
    device; ``mis`` takes volpathmis's estimator. Vectorised over lanes in
    chunks that keep each (lanes x faces) or (lanes x steps) temporary
    within ``_CHUNK_ELEMS`` elements. ``stats``: see ``_trace_lanes``."""
    dev = tables.device
    n = width * height * spp_pass
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    widest = max(tables.n_faces, tables.lights.shape[0], NULL_BUDGET)
    step = max(1, _CHUNK_ELEMS // widest)
    for start in range(0, n, step):
        lanes = torch.arange(start, min(n, start + step), device=dev)
        key, pixel = pk.lane_keys(seed, sample_base, spp_pass, lanes)
        out[:, start:start + len(lanes)] = _trace_lanes(
            tables, cam, key, pixel, width, height, max_depth, rr_depth,
            mis, stats)
    return out


# ----------------------------------------------------------------------------
# the kernel's wrapper
# ----------------------------------------------------------------------------

class _VolArgs(ctypes.Structure):
    """csrc/volpath_kernel.cu's VolArgs, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "woop", "fattr", "lights", "grid", "cam", "out")]
        + [(name, ctypes.c_int) for name in (
            "n_faces", "n_lights", "grid_d", "grid_h", "grid_w")]
        + [("med", ctypes.c_float * 12), ("albedo", ctypes.c_float * 3)]
        + [(name, ctypes.c_float) for name in (
            "inv_maj", "scale", "hg_a", "hg_b", "hg_c", "hg_d", "hg_e",
            "inv4pi")]
        + [("seed", ctypes.c_uint32), ("sample_base", ctypes.c_uint32)]
        + [(name, ctypes.c_int) for name in (
            "spp_pass", "width", "height", "max_depth", "rr_depth",
            "n_lanes", "flags")]
        + [("counter", ctypes.c_void_p)])


# the phases of the profiled build's cycle sums (csrc/volpath_kernel.cu
# VK_PROFILE), in the order of their counters
PHASES = ("camera", "hit", "delta", "event", "shadow", "ratio", "cont",
          "idle", "empty")
# threads a block (csrc/volpath_kernel.cu BLOCK)
BLOCK = 128


def _check_tables(tables, cam):
    F = tables.n_faces
    for name, t, shape in (("woop", tables.woop, (F, 12)),
                           ("fattr", tables.fattr, (F, VFA)),
                           ("lights", tables.lights,
                            (tables.lights.shape[0], 24)),
                           ("grid", tables.grid, tables.grid.shape),
                           ("cam", cam, (16,))):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{tuple(shape)} tensor, got {tuple(t.shape)} "
                             f"{t.dtype}")
        if t.device != tables.device:
            raise ValueError(f"{name} is on {t.device}, not {tables.device}")
    if tables.lights.shape[0] < 1:
        raise ValueError("the light table needs at least its dummy row")
    if F > MAX_VOL_FACES:
        raise ValueError(f"{F} opaque faces > {MAX_VOL_FACES}")
    D, H, W = tables.grid.shape
    if min(D, H, W) < 1 or D * H > MAX_GRID_DH or W > MAX_GRID_W:
        raise ValueError(f"sigma_t grid {D}x{H}x{W} outside the caps")
    if not tables.maj > 0.0:
        raise ValueError(f"the majorant {tables.maj} is not positive")


def _vol_args(tables, cam, seed, sample_base, spp_pass, width, height,
              max_depth, rr_depth, mis, out, counter) -> _VolArgs:
    """The kernel's arguments: the tables, the camera row, the output
    (3, n) and the counter as pointers, the pass as scalars."""
    D, H, W = tables.grid.shape
    pc = phase_constants(tables.g)
    return _VolArgs(
        *(t.data_ptr() for t in (tables.woop, tables.fattr, tables.lights,
                                 tables.grid, cam, out)),
        tables.n_faces, tables.lights.shape[0], D, H, W,
        (ctypes.c_float * 12)(*tables.med),
        (ctypes.c_float * 3)(*tables.albedo),
        _f32(1.0 / tables.maj), tables.scale, pc["hg_a"], pc["hg_b"],
        pc["hg_c"], pc["hg_d"], pc["hg_e"], pc["inv4pi"],
        seed & 0xFFFFFFFF, sample_base & 0xFFFFFFFF, spp_pass, width,
        height, max_depth, rr_depth, out.shape[1],
        tables.flags | (MIS if mis else 0), counter.data_ptr())


def launch(tables, cam, seed, sample_base, spp_pass, width, height,
           max_depth, rr_depth, mis, out, counter, defines=None) -> dict:
    """One launch of the kernel's library of ``defines`` into ``out``
    (3, n) with ``counter`` (int32, zeroed: the lane counter, then the
    profiled build's 64-bit sums from its third word) on the current
    stream -> its LAUNCH_INFO. Counts no launch: ``volpath_radiance``
    does. A build or launch failure raises."""
    render = _volpath_render(defines)
    args = _vol_args(tables, cam, seed, sample_base, spp_pass, width,
                     height, max_depth, rr_depth, mis, out, counter)
    info = (ctypes.c_int * len(LAUNCH_INFO))()
    dev = out.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = render(ctypes.byref(args), stream, info)
    if err != 0:
        raise RuntimeError(f"volpath_kernel launch failed: "
                           f"{LAUNCH_ERRORS.get(err, f'CUDA error {err}')}")
    return dict(zip(LAUNCH_INFO, info))


def volpath_radiance(tables, cam, seed, sample_base, spp_pass, width,
                     height, max_depth, rr_depth, mis=False):
    """Per-lane radiance (3, n): the CUDA kernel for tables on a CUDA
    device, the plain version for tables on the CPU. The kernel runs
    persistent blocks, as many as the card holds at once, whose warps take
    lanes from a counter this function zeroes on the stream before the
    launch. A build or launch failure raises."""
    dev = tables.device
    if dev.type == "cpu":
        return volpath_radiance_reference(tables, cam, seed, sample_base,
                                          spp_pass, width, height, max_depth,
                                          rr_depth, mis)
    if dev.type != "cuda":
        raise ValueError(f"no volpath kernel for device {dev}")
    _check_tables(tables, cam)
    n = width * height * spp_pass
    if n >= 1 << 31:
        raise ValueError(f"{n} lanes overflow the kernel's int32 lane ids")
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    flags = tables.flags | (MIS if mis else 0)
    # the next lane to start, zeroed on the stream before the launch
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    info = launch(tables, cam, seed, sample_base, spp_pass, width, height,
                  max_depth, rr_depth, mis, out, counter)
    volpath_radiance.launches += 1
    volpath_radiance.launches_by_kernel[flags] += 1
    volpath_radiance.last_launch[flags] = info
    return out


# kernel launches in total and by instantiation (flag bits), and the last
# launch's LAUNCH_INFO by instantiation
volpath_radiance.launches = 0
volpath_radiance.launches_by_kernel = collections.Counter()
volpath_radiance.last_launch = {}


def reset_launch_counts():
    volpath_radiance.launches = 0
    volpath_radiance.launches_by_kernel.clear()


def libraries():
    """(name, defines) of the kernel's one library, for
    ``build.build_all``."""
    return [("volpath_kernel", {})]


def _volpath_render(defines=None):
    """csrc/volpath_kernel.cu's C entry point in the library of
    ``defines`` (none, or tools/prof_volpath.py's ``VK_PROFILE``), built on
    first use."""
    from .build import load
    fn = load("volpath_kernel", defines).volpath_render
    fn.argtypes = [ctypes.POINTER(_VolArgs), ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


# ----------------------------------------------------------------------------
# host side: one scene's kernel and its gate
# ----------------------------------------------------------------------------

class VolPathKernel:
    """Renders passes of one scene's volumetric tables through one sensor
    (VolPathMegakernel's role, volmegakernel.py:883). Its passes are
    whole films: a band of rows renders on the volpath wavefront."""

    BANDS = False

    def __init__(self, scene, sensor, max_depth, rr_depth, mis=False):
        self.tables = build_vol_tables(scene)
        self.size = sensor.film.crop_size
        self.cam = pk.camera_row(sensor, self.tables.device)
        self.max_depth = max_depth
        self.rr_depth = rr_depth
        self.mis = mis
        self._replicas = {}

    def to(self, device):
        """This kernel object with its tables and camera row on
        ``device`` (``path_kernel.replica``)."""
        return pk.replica(self, device, "tables", "cam")

    def render_pass(self, seed, sample_base, spp_pass):
        """-> (h, w, 4) box-filtered block: per-pixel radiance sums over
        the pass's samples and the sample count as weight."""
        w, h = self.size
        rgb = volpath_radiance(self.tables, self.cam, seed, sample_base,
                               spp_pass, w, h, self.max_depth,
                               self.rr_depth, self.mis)
        rgb = rgb.reshape(3, w * h, spp_pass).sum(dim=2)
        img = torch.cat([rgb, torch.full((1, w * h), float(spp_pass),
                                         device=rgb.device)])
        return img.T.reshape(h, w, 4)


def _surface_kind(bsdf):
    """'diffuse', 'ggx' or 'dielectric' for a BSDF the kernel shades
    (megakernel.py _bsdf_columns, narrowed to those three), else None."""
    from ..models.bsdfs import (SmoothDiffuse, RoughConductor,
                                SmoothDielectric)
    from ..models.textures import ConstantTexture
    if type(bsdf) is SmoothDiffuse:
        return "diffuse" if type(bsdf.reflectance) is ConstantTexture \
            else None
    if type(bsdf) is RoughConductor:
        return "ggx" if pk.bsdf_ineligibility(bsdf, "rgb") is None else None
    if type(bsdf) is SmoothDielectric:
        if all(type(t) is ConstantTexture for t in (
                bsdf.specular_reflectance, bsdf.specular_transmittance)):
            return "dielectric"
    return None


def vol_kernel_ineligibility(scene):
    """-> None if the scene is inside the volumetric kernel's scope, else a
    short reason (volmegakernel.py:1148-1237, the same reasons and caps)."""
    from ..variants import current
    from ..models.bsdfs import NullBSDF
    from ..models.emitters import AreaEmitter
    from ..models.media import ConstantVolume
    from ..models.media_impl import HeterogeneousMedium, Grid3DVolume
    from ..models.phase import HGPhase, IsotropicPhase
    var = current()
    if var.polarized:
        return "polarized variant"
    if var.double_precision:
        return "double-precision variant"
    if not var.is_rgb:
        return "non-rgb variant"
    if len(scene.media) != 1:
        return f"{len(scene.media)} media (kernel supports exactly 1)"
    med = scene.media[0]
    if not isinstance(med, HeterogeneousMedium):
        return f"medium {type(med).__name__} (heterogeneous only)"
    if not isinstance(med.albedo_vol, ConstantVolume):
        return "non-constant medium albedo"
    if not isinstance(med.phase_function, (HGPhase, IsotropicPhase)):
        return f"phase {type(med.phase_function).__name__}"
    vol = med.sigma_t_vol
    if isinstance(vol, Grid3DVolume):
        d, h, w, c = vol.data.shape
        if c != 1:
            return "multi-channel sigma_t grid"
        if d * h > MAX_GRID_DH or w > MAX_GRID_W:
            return f"sigma_t grid {d}x{h}x{w} exceeds kernel caps"
        if not vol.identity_transform and vol.to_local is not med.to_local:
            return "sigma_t volume with its own to_world"
    elif not isinstance(vol, ConstantVolume):
        return f"sigma_t volume {type(vol).__name__}"
    if any(not s.is_mesh() for s in scene.shapes) or scene.n_instances:
        return "analytic shapes/instances (mesh-only kernel)"
    if scene.environment_emitter is not None:
        return "environment emitter"
    # exactly one shape bounds the medium: a null-BSDF box whose local
    # AABB is the medium's [0,1]^3
    bound = [s for s in scene.shapes if s.interior_medium is med]
    if len(bound) != 1:
        return "medium not bounded by exactly one shape"
    bshape = bound[0]
    if not isinstance(bshape.bsdf, NullBSDF):
        return "medium boundary BSDF is not null"
    if bshape.emitter is not None:
        return "emissive medium boundary"
    bmask = scene.face_shape == scene.shapes.index(bshape)
    if not bmask.any():
        return "medium boundary has no mesh faces"
    v0 = scene.v0[bmask]
    verts = np.concatenate([v0, v0 + scene.e1[bmask],
                            v0 + scene.e2[bmask]], axis=0)
    M = np.asarray(med.to_local.matrix, np.float32)
    local = verts @ M[:3, :3].T + M[:3, 3]
    on_corner = np.all((np.abs(local) < 1e-3)
                       | (np.abs(local - 1.0) < 1e-3), axis=1)
    if not on_corner.all():
        return "medium boundary is not the medium's local unit box"
    n_opaque = int((~bmask).sum())
    if n_opaque > MAX_VOL_FACES:
        return f"opaque face count {n_opaque} > {MAX_VOL_FACES}"
    for s in scene.shapes:
        if s is bshape:
            continue
        if s.interior_medium is not None or s.exterior_medium is not None:
            return "additional medium-linked shape"
        if isinstance(s.bsdf, NullBSDF):
            return "null BSDF outside the medium boundary"
        kind = _surface_kind(s.bsdf)
        if kind is None:
            return f"unsupported BSDF {type(s.bsdf).__name__}"
        if s.emitter is not None and kind != "diffuse":
            return "emitter on a non-diffuse surface"
    for e in scene.emitters:
        if type(e) is not AreaEmitter:
            return f"unsupported emitter {type(e).__name__}"
        if e.radiance.is_spatially_varying():
            return "textured area emitter"
        if e.shape is bshape:
            return "emitter on the medium boundary"
    return None
