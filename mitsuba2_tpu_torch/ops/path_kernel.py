"""Path tracing: host side, plain PyTorch version and the CUDA kernel's
wrapper.

Counterpart of ``mitsuba2_tpu/ops/megakernel.py`` for its K1a scope
(triangle meshes, constant-albedo diffuse BSDFs, constant area lights,
rgb), the matpreview scopes: analytic spheres, disks and cylinders (K1b),
one lat-long envmap with its importance-sampled NEE arm (K1c), isotropic
GGX rough conductors, checkerboard and bitmap albedo, smooth dielectrics
and smooth and rough plastics (K1d), the rgb, spectral and mono color
modes (K1e), and meshes of up to ``MAX_FACES_HBM`` faces (K1f). One lane
is one camera path, lanes are pixel-major
(``lane = pixel * spp_pass + s``), and the estimator is ``_path_kernel``'s
(path.cpp:92-234): emission with power-2 MIS against area NEE, the
environment on escape with MIS against env NEE, two-armed NEE (env with
probability ``p_env``, else a light face through the light-table cdf)
with a shadow any-hit, BSDF sampling (cosine for the diffuse lobe,
visible normals for GGX, a Fresnel-weighted pick of the dielectric's two
delta lobes and of the plastics' coat or base), Russian roulette after
``rr_depth`` on the throughput times the squared relative IOR the path
has crossed, and an emission-only last bounce. Random numbers are the
reference kernel's TEA streams: lane key ``_tea(seed, _tea(pixel, sample,
4), 4)``, film jitter at dim 0, and dims ``2 + 8 * depth + k`` per bounce
(k = 0 roulette, 1-2 NEE, 3 lobe choice, 4 BSDF sample, 5 env NEE
jitter), so a port render agrees with the reference per pixel at equal
seed. The film's reconstruction filter is applied after the kernel
(ops/splat.py).

Color modes (``PathTables.nc``): 3 rgb channels; 4 hero wavelengths in
spectral mode, drawn once per path from the lane key at sampler dim 1,
with reflectances, emission and env radiance evaluated from sigmoid
coefficients (render/srgb.py) and the D65 table, conductor IOR from
clamped quadratics, and the radiance developed at the end of every path
against the CIE CMFs into linear sRGB (megakernel.py:287-324, 436-463,
1378-1393); 1 luminance channel in mono mode. The output is (3, n)
linear sRGB in every mode.

Two intersection tiers, as in the reference: up to ``MAX_FACES_SHARED``
faces the kernel stages the Woop rows in shared memory and loops over all
of them; above that (``HAS_BVH``) every ray walks the scene's traversal
tree (ops/bvh.py, csrc/bvh.cuh), whose pair nodes, Woop rows and face ids
``PathTables`` carries for every scene. Both give the closest hit with ties
to the lowest face id, in the reference's face order; faces win ties
against spheres, spheres against disks and cylinders.

``path_radiance`` runs the hand-written kernel (csrc/path_kernel.cu) for
tables on a CUDA device and ``path_radiance_reference`` -- the same
function in plain PyTorch, a linear sweep over every face in either tier
-- for tables on the CPU.
"""

from __future__ import annotations

import collections
import copy
import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core import spectrum as spec
from ..core.rng import sample_tea_32, u32_to_float01
from ..render.fresnel import fresnel_conductor
from . import bvh as bvh_ops
from .intersect import traverse, traverse_pairs

# Faces the kernel stages in shared memory and sweeps linearly (the
# reference's unrolled tier, UNROLLED_CHUNKS * FACE_CHUNK, megakernel.py:
# 82-85); above it the BVH tier. The gate's cap is the reference's
# (megakernel.py:96).
MAX_FACES_SHARED = 1024
MAX_FACES_HBM = 1 << 20
MAX_SPHERES = 64         # megakernel.py MAX_SPHERES, also the disk and
#                          cylinder cap (:3118)
MAX_ENV_W = 256          # megakernel.py MAX_ENV_W
# bitmap albedo: per-texture width cap and texel rows of all textures
# together (megakernel.py MAX_ATLAS_W, MAX_ATLAS_H)
MAX_TEX_W, MAX_TEX_ROWS = 1024, 2048
_BIG = 3.0e38
_PI = 3.141592653589793
# lanes x (faces, cdf entries) per chunk of the plain version's sweeps
_CHUNK_ELEMS = 1 << 24

# Per-face (and per-sphere, per-disk and per-cylinder) attribute columns,
# FA floats a row: twelve float4 the kernel reads as [ng, lpdf_w]
# [albedo, kind] [Le, alpha] [eta, le_scale] [k, x_lo] [color1, x_hi]
# [uv0, duv1] [duv2, flip, 0] [to_uv row 0, 0] [to_uv row 1, 0]
# [eta_d, ssw, fdr, inv_eta2] [nonlinear, tex_offset, tex_w, tex_h].
# albedo is the diffuse reflectance, the checker's color0, or the
# conductor's or dielectric's specular reflectance; color1 the checker's
# color1, the dielectric's specular transmittance or the plastic's
# specular reflectance; to_uv rows are [m00 m01 m03] and [m10 m11 m13] of
# the checker's affine uv transform. Colors hold the color mode's payload:
# rgb, the sigmoid coefficients (spectral) or the luminance repeated
# (mono). Spectral only: le_scale is the emitter's D65 scale, eta and k
# hold the IOR quadratics' (a, b, c) and [x_lo, x_hi] their clamp span in
# normalized wavelength. Dielectric and plastics: eta_d the relative IOR;
# plastics: the coat's sampling weight, the internal diffuse Fresnel
# reflectance, 1 / eta_d^2 and the nonlinear switch (megakernel.py:
# 2337-2412). Bitmap albedo: the texture's first texel in
# ``PathTables.tex`` and its width and height. flip is -1 on a disk or
# cylinder with flip_normals, else 1 (quads only).
FA = 48
C_NG, C_LPDF, C_ALB, C_KIND, C_LE, C_ALPHA = 0, 3, 4, 7, 8, 11
C_ETA, C_K, C_C1, C_UV0, C_DUV1, C_DUV2 = 12, 16, 20, 24, 26, 28
C_FLIP, C_TOUV0, C_TOUV1 = 30, 32, 36
C_ETAD, C_SSW, C_FDR, C_INVETA2, C_NONLIN, C_TEX = 40, 41, 42, 43, 44, 45
C_LESCALE, C_XLO, C_XHI = C_ETA + 3, C_K + 3, C_C1 + 3
KIND_DIFFUSE, KIND_GGX, KIND_CHECKER = 0, 1, 2
KIND_DIELECTRIC, KIND_PLASTIC, KIND_ROUGHPLASTIC, KIND_BITMAP = 3, 4, 5, 6
# the lobes the HAS_LOBES instantiations shade
LOBE_KINDS = (KIND_DIELECTRIC, KIND_PLASTIC, KIND_ROUGHPLASTIC, KIND_BITMAP)
# disk and cylinder rows (the reference's qd, megakernel.py:2492-2530):
# [to_object A rows 0:9, its translation 9:12, kind 12 (1 disk,
# 2 cylinder), radius 13, length 14, 0]
QD = 16
QUAD_DISK, QUAD_CYLINDER = 1.0, 2.0

# color channels per color mode: rgb, hero wavelengths, luminance
MODE_NC = {"rgb": 3, "spectral": 4, "mono": 1}
NC_MODE = {nc: mode for mode, nc in MODE_NC.items()}
# rows of the D65 / CMF table: 95 CIE samples, padded
SPD_ROWS = 96
_WL_MIN, _WL_MAX = 360.0, 830.0

# Scene-content flags: the kernel is instantiated per combination of the
# first six (the reference kernel's static has_spheres / has_env /
# has_ggx / has_checker gates, the BVH tier for more than
# MAX_FACES_SHARED faces, and one flag, "lobes", for the dielectric,
# plastic, roughplastic and bitmap lobes, which the kernel tells apart by
# kind at run time, and for disks and cylinders). Disks and cylinders set
# both the spheres and the lobes flag: the kernel loops over the sphere
# rows and the disk and cylinder rows by their run-time counts, and the
# instantiations without the lobes flag carry none of that code, so the
# scenes of the earlier scopes run the kernel they ran before.
# HAS_ENV_ROT is a run-time branch.
HAS_SPHERES, HAS_ENV, HAS_GGX, HAS_CHECKER, HAS_BVH = 1, 2, 4, 8, 16
HAS_LOBES = 32
HAS_ENV_ROT = 64
TEMPLATE_FLAGS = (HAS_SPHERES | HAS_ENV | HAS_GGX | HAS_CHECKER | HAS_BVH
                  | HAS_LOBES)


def flag_names(flags) -> str:
    """'cornell' for no scene-content flag, else e.g. 'spheres+env+ggx'."""
    names = [n for f, n in ((HAS_SPHERES, "spheres"), (HAS_ENV, "env"),
                            (HAS_GGX, "ggx"), (HAS_CHECKER, "checker"),
                            (HAS_BVH, "bvh"), (HAS_LOBES, "lobes"))
             if flags & f]
    return "+".join(names) or "cornell"


def kernel_name(flags, nc) -> str:
    """Name of one instantiation, e.g. 'path_kernel[cornell, spectral]'."""
    return f"path_kernel[{flag_names(flags)}, {NC_MODE[nc]}]"


def spd_table() -> np.ndarray:
    """(96, 4) float32: D65 / 100 in column 0 and the CIE 1931 x, y, z
    responses in columns 1-3 at 360..830 nm in 5 nm steps, padded by
    repeating the last row (megakernel.py:2667-2682)."""
    out = np.zeros((SPD_ROWS, 4), np.float32)
    out[:95, 0] = spec.CIE_D65_TABLE
    out[:95, 1:4] = spec.CIE_XYZ_TABLE
    out[95:] = out[94]
    return out


class PathTables(NamedTuple):
    """The scene's flat table set, all float32 on one device.

    woop     (F, 12): per face [Wu | Wv | Wz], each 4 floats, mapping a
             homogeneous world point to the unit triangle:
             u = p . Wu[:3] + Wu[3] (ops/intersect_pallas.py:55 build_woop).
             Empty (0, 12) for BVH-tier tables off the CPU, whose kernel
             reads only ``bvh_woop``; ``face_woop`` gives the rows.
    fattr    (F, FA): per-face attribute columns (C_* above).
    lights   (L, 24): the megakernel's light rows (render/scene.py
             _light_table), with the cdf-2.0 padding rows.
    sph      (S, 4): sphere [center, radius]; sattr (S, FA) their
             attribute rows (normal columns unused, identity uv).
    qd       (Q, QD): disk and cylinder rows; qattr (Q, FA) their
             attribute rows (a disk's normal, identity uv, flip).
    env      (H, W, 4): lat-long radiance texels, row v: [r, g, b, 0],
             [luminance, 0, 0, 0] (mono) or [c0, c1, c2, scale]
             (spectral, render/scene.py env_texels).
    env_marg (Hs,), env_cond (Hs, Ws), env_pmf (Hs, Ws): the env NEE
             grid's marginal cdf over rows, per-row conditional cdf and
             joint pmf.
    env_rot  (18,): the env's rigid to_world 3x3 row-major, then its
             transpose.
    spd      (96, 4) in spectral mode (``spd_table``), else (0, 4).
    tex      (T, 4): the bitmap textures' texels one after another, each
             row-major, [payload (3), 0] (the color mode's payload).
    bvh_nodes (P, 32): the traversal tree's 4-wide nodes, one 128-byte line
             each (ops/bvh.py ``pack_traversal``); bvh_woop (F, 12) the
             Woop rows and bvh_prim (F,) int32 the face ids in the tree's
             face order; empty without faces.
    flags    HAS_* bits; p_env the probability of the env NEE arm; nc the
             color channels (``MODE_NC``); bvh_depth the bound of the
             walk's stack (``pack_traversal``).
    bvh_tree the traversal tree as the host builder gave it (ops/bvh.py
             ``BVH``, binary), which no kernel reads: ``walk_trees``
             packs its pair nodes for the walk whose tests the bounds
             count, only where the plain version counts them.
    """
    woop: torch.Tensor
    fattr: torch.Tensor
    lights: torch.Tensor
    sph: torch.Tensor
    sattr: torch.Tensor
    qd: torch.Tensor
    qattr: torch.Tensor
    env: torch.Tensor
    env_marg: torch.Tensor
    env_cond: torch.Tensor
    env_pmf: torch.Tensor
    env_rot: torch.Tensor
    spd: torch.Tensor
    tex: torch.Tensor
    bvh_nodes: torch.Tensor
    bvh_woop: torch.Tensor
    bvh_prim: torch.Tensor
    flags: int = 0
    p_env: float = 0.0
    nc: int = 3
    bvh_depth: int = 0
    bvh_tree: bvh_ops.BVH | None = None

    @property
    def n_faces(self) -> int:
        return self.fattr.shape[0]

    @property
    def n_spheres(self) -> int:
        return self.sph.shape[0]

    @property
    def n_quads(self) -> int:
        return self.qd.shape[0]

    @property
    def device(self) -> torch.device:
        return self.fattr.device

    def tensors(self) -> tuple:
        return tuple(v for v in self if isinstance(v, torch.Tensor))

    def to(self, device) -> "PathTables":
        return self._replace(**{k: v.to(device) for k, v in
                                self._asdict().items()
                                if isinstance(v, torch.Tensor)})


def face_woop(tables) -> torch.Tensor:
    """(F, 12) Woop rows in face order: ``tables.woop``, or where those
    tables left it out, the tree-order rows put back in face order."""
    if tables.woop.shape[0] == tables.n_faces:
        return tables.woop
    out = torch.empty_like(tables.bvh_woop)
    out[tables.bvh_prim.long()] = tables.bvh_woop
    return out


def build_woop(v0, e1, e2) -> np.ndarray:
    """Per-triangle world -> unit-triangle affine rows, (F, 12) float32.

    Row f is [Wu | Wv | Wz] with u = [p, 1] . Wu etc., built in float64 and
    rounded once (intersect_pallas.py:55). Degenerate triangles get the
    never-hit row Z = 1, DZ = 0."""
    f = len(v0)
    n = np.cross(e1, e2)
    A = np.stack([e1, e2, n], axis=-1).astype(np.float64)   # (F,3,3)
    ok = np.abs(np.linalg.det(A)) > 1e-18 if f else np.zeros(0, bool)
    A_safe = np.where(ok[:, None, None], A, np.eye(3))
    M = np.linalg.inv(A_safe)                                # (F,3,3)
    trans = -np.einsum("fij,fj->fi", M, v0.astype(np.float64))
    # W[f, :, k] is the homogeneous row of local axis k (u, v, w)
    W = np.concatenate([np.swapaxes(M, 1, 2), trans[:, None, :]], axis=1)
    W = np.where(ok[:, None, None], W, 0.0)
    W[~ok, 3, 2] = 1.0
    return np.ascontiguousarray(
        np.swapaxes(W, 1, 2).reshape(f, 12).astype(np.float32))


def _make_tables(woop, fattr, lights, sph, sattr, env, env_rot, p_env,
                 device, nc, traversal=None, quads=None,
                 tex=None) -> PathTables:
    """numpy tables -> PathTables on ``device``; flags from the content.
    ``env`` is None or (texels (H, W, 4), marginal cdf, conditional cdf,
    pmf); ``env_rot`` None or the rigid 3x3 to_world; ``traversal`` None
    or the traversal tree (ops/bvh.py BVH) over the faces of ``woop``,
    which more than MAX_FACES_SHARED faces need; ``quads`` None or (qd,
    qattr); ``tex`` None or the (T, 4) texels."""
    flags = 0
    sph = np.zeros((0, 4), np.float32) if sph is None else sph
    sattr = np.zeros((0, FA), np.float32) if sattr is None else sattr
    qd, qattr = ((np.zeros((0, QD), np.float32), np.zeros((0, FA),
                                                           np.float32))
                 if quads is None else quads)
    tex = np.zeros((0, 4), np.float32) if tex is None else tex
    if len(sph):
        flags |= HAS_SPHERES
    if len(qd):
        flags |= HAS_SPHERES | HAS_LOBES
    kinds = np.concatenate([fattr[:, C_KIND], sattr[:, C_KIND],
                            qattr[:, C_KIND]])
    if (kinds == KIND_GGX).any():
        flags |= HAS_GGX
    if (kinds == KIND_CHECKER).any():
        flags |= HAS_CHECKER
    if np.isin(kinds, LOBE_KINDS).any():
        flags |= HAS_LOBES
    if env is None:
        texels = np.zeros((0, 0, 4), np.float32)
        marg = np.zeros(0, np.float32)
        cond = pmf = np.zeros((0, 0), np.float32)
        p_env = 0.0
    else:
        flags |= HAS_ENV
        texels, marg, cond, pmf = env
    rot = np.eye(3, dtype=np.float32) if env_rot is None \
        else np.asarray(env_rot, np.float32).reshape(3, 3)
    if env is not None and not np.allclose(rot, np.eye(3), atol=1e-6):
        flags |= HAS_ENV_ROT
    spd = spd_table() if nc == MODE_NC["spectral"] \
        else np.zeros((0, 4), np.float32)
    nodes = np.zeros((0, bvh_ops.WIDE_SLOTS), np.float32)
    order = np.zeros(0, np.int32)
    depth = 0
    if traversal is not None:
        nodes, depth = bvh_ops.pack_traversal(traversal)
        order = traversal.order
    woop = np.asarray(woop, np.float32)
    tree_woop = woop[order]
    if len(woop) > MAX_FACES_SHARED and traversal is not None:
        flags |= HAS_BVH
        if torch.device(device).type != "cpu":
            # the BVH tier reads only the tree-order rows; the plain
            # versions rebuild the face order on demand (``face_woop``)
            woop = np.zeros((0, 12), np.float32)

    def dev(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    return PathTables(dev(woop), dev(fattr), dev(lights), dev(sph),
                      dev(sattr), dev(qd), dev(qattr), dev(texels),
                      dev(marg), dev(cond), dev(pmf),
                      dev(np.concatenate([rot.reshape(-1),
                                          rot.T.reshape(-1)])),
                      dev(spd), dev(tex), dev(nodes), dev(tree_woop),
                      torch.as_tensor(np.asarray(order, np.int32),
                                      device=device),
                      flags, float(p_env), nc, depth, traversal)


def pack_tables(v0, e1, e2, fattr, lights, device, sph=None, sattr=None,
                env=None, env_rot=None, p_env=0.0, nc=3, traversal=None,
                quads=None, tex=None) -> PathTables:
    """Host per-face arrays -> the device table set (see ``_make_tables``
    for ``env``, ``env_rot``, ``traversal``, ``quads`` and ``tex``)."""
    return _make_tables(build_woop(v0, e1, e2), fattr, lights, sph, sattr,
                        env, env_rot, p_env, device, nc, traversal, quads,
                        tex)


def with_bvh_tier(tables) -> PathTables:
    """The same tables with the BVH tier forced, whatever the face count
    (a check of the tier on a small scene)."""
    if not tables.bvh_nodes.shape[0]:
        raise ValueError("the tables carry no traversal tree")
    return tables._replace(flags=tables.flags | HAS_BVH)


def _attr_from_reference(A):
    """The reference's transposed attribute rows (fa, N) (megakernel.py
    _FA_COLS layout) -> (N, FA) in this module's column layout. Rows the
    reference left out of its packed ``fa`` rows are zero."""
    A = np.asarray(A, np.float32)
    fa, N = A.shape

    def rows(i, j):
        out = np.zeros((N, j - i), np.float32)
        k = max(0, min(j, fa) - i)
        out[:, :k] = A[i:i + k].T
        return out

    out = np.zeros((N, FA), np.float32)
    for dst, (i, j) in ((C_NG, (0, 3)), (C_LPDF, (9, 10)), (C_ALB, (3, 6)),
                        (C_KIND, (10, 11)), (C_LE, (6, 9)),
                        (C_ALPHA, (11, 12)), (C_ETA, (12, 15)),
                        (C_K, (15, 18)), (C_C1, (18, 21)),
                        (C_UV0, (21, 23)), (C_DUV1, (23, 25)),
                        (C_DUV2, (25, 27)), (C_TOUV0, (27, 30)),
                        (C_TOUV1, (30, 33)), (C_ETAD, (33, 38)),
                        (C_FLIP, (38, 39)), (C_TEX, (40, 43)),
                        (C_LESCALE, (43, 44)), (C_XLO, (44, 45)),
                        (C_XHI, (45, 46))):
        out[:, dst:dst + j - i] = rows(i, j)
    return out


def _texels_from_atlas(atlas, attrs):
    """The reference's channel-blocked (3 aw, Ha) bitmap atlas -> (T, 4)
    texels, each texture row-major after the other in the order of its
    first atlas row; rewrites the row offset in the C_TEX column of every
    (N, FA) row set of ``attrs`` (in place) into the texture's first
    texel."""
    atlas = np.asarray(atlas, np.float32)
    aw = atlas.shape[0] // 3
    regions = sorted({tuple(int(x) for x in row[C_TEX:C_TEX + 3])
                      for A in attrs for row in A
                      if row[C_KIND] == KIND_BITMAP})
    texels, first, offset = [], {}, 0
    for voff, w, h in regions:
        first[voff] = offset
        block = np.zeros((h, w, 4), np.float32)
        for c in range(3):
            block[..., c] = atlas[c * aw:c * aw + w, voff:voff + h].T
        texels.append(block.reshape(-1, 4))
        offset += w * h
    for A in attrs:
        bmp = A[:, C_KIND] == KIND_BITMAP
        A[bmp, C_TEX] = [first[int(v)] for v in A[bmp, C_TEX]]
    return np.concatenate(texels) if texels else None


def tables_from_reference(woop, fattr, lights, cam, device=None, sph=None,
                          sattr=None, env=None, envs=None, env_size=None,
                          p_env=0.0, env_rot=None, nc=3, qd=None,
                          qattr=None, atlas=None):
    """The reference kernel's own tables -> (PathTables, camera row).

    Takes numpy arrays in ``DiffusePathMegakernel``'s layouts: ``woop``
    (n_chunks * 3C, 4) of the unrolled tier (per chunk, C rows each of
    Wu, Wv, Wz), ``fattr`` (fa, F) from ``_fattr()``, ``lights`` (24, L)
    and the (1, 16) camera row; for spheres ``sph`` (8, S) and ``sattr``
    (fa, S) from ``_sattr()``; for an envmap ``env`` (3Wp, Hp), ``envs``
    (2Wsp + 8, Hsp), ``env_size`` = (env_w, env_h, env_ws, env_hs),
    ``p_env`` and ``env_rot`` (its 9-tuple or None); ``nc`` the color mode's
    channel count (the spectral env has a fourth, scale, plane); for disks
    and cylinders ``qd`` (16, Q) and ``qattr`` (fa, Q) from ``_qattr()``;
    for bitmap albedo the rgb ``atlas`` (3 aw, Ha). The never-hit padding
    faces come along unchanged; padding spheres, quads and texels are
    dropped."""
    woop = np.asarray(woop, np.float32)
    F = np.asarray(fattr).shape[1]
    if woop.shape != (3 * F, 4):
        raise ValueError(f"woop {woop.shape} is not the unrolled (3F, 4) "
                         f"layout for F={F}")
    C = F if F <= 128 else 128     # megakernel FACE_CHUNK tiers
    blk = woop.reshape(F // C, 3, C, 4)          # chunk, axis, face, col
    rows = np.transpose(blk, (0, 2, 1, 3)).reshape(F, 12)
    sph_rows = sattr_rows = None
    if sph is not None:
        sph = np.asarray(sph, np.float32)
        alive = sph[4] > 0.5
        sph_rows = sph[0:4, alive].T
        sattr_rows = _attr_from_reference(np.asarray(sattr)[:, alive])
    quads = None
    if qd is not None:
        qd = np.asarray(qd, np.float32)
        alive = qd[15] > 0.5
        qd_rows = np.zeros((int(alive.sum()), QD), np.float32)
        qd_rows[:, :15] = qd[:15, alive].T
        quads = (qd_rows, _attr_from_reference(np.asarray(qattr)[:, alive]))
    fattr = _attr_from_reference(fattr)
    tex = None
    if atlas is not None:
        attrs = [fattr] + [a for a in (sattr_rows,
                                       quads and quads[1]) if a is not None]
        tex = _texels_from_atlas(atlas, attrs)
    env_t = None
    if env is not None:
        w, h, ws, hs = env_size
        env = np.asarray(env, np.float32)
        planes = 4 if nc == MODE_NC["spectral"] else 3
        wp = env.shape[0] // planes
        texels = np.zeros((h, w, 4), np.float32)
        for c in range(planes):
            texels[..., c] = env[c * wp:c * wp + w, :h].T
        envs = np.asarray(envs, np.float32)
        wsp = (envs.shape[0] - 8) // 2
        env_t = (texels, envs[2 * wsp, :hs], envs[:ws, :hs].T,
                 envs[wsp:wsp + ws, :hs].T)
    dev = torch.device("cpu") if device is None else torch.device(device)
    tables = _make_tables(rows, fattr, np.asarray(lights, np.float32).T,
                          sph_rows, sattr_rows, env_t, env_rot, p_env, dev,
                          nc, quads=quads, tex=tex)
    cam = torch.as_tensor(np.asarray(cam, np.float32).reshape(16),
                          device=dev)
    return tables, cam


def camera_row(sensor, device) -> torch.Tensor:
    """(16,) float32: the to_world 3x3 basis row-major, the origin,
    tan(x_fov / 2) and padding (megakernel.py render_pass:2832-2838)."""
    mat = np.asarray(sensor.world_transform.matrix, np.float32)
    tan_half = np.float32(np.tan(np.deg2rad(sensor.x_fov) * 0.5))
    row = np.concatenate([mat[:3, :3].reshape(-1), mat[:3, 3], [tan_half],
                          np.zeros(3, np.float32)]).astype(np.float32)
    return torch.as_tensor(row, device=device)


def camera_rays(cam, width, height, spp, seed):
    """Pinhole rays of camera row ``cam`` through every sample of every
    pixel, in the kernel's lane order (pixel-major), jittered uniformly in
    the pixel by a generator seeded with ``seed`` on the camera's device
    -> (o, d), each (n, 3) float32. The ray queries' test and measurement
    batch; the kernel draws its own jitter from the TEA streams."""
    dev = cam.device
    n = width * height * spp
    g = torch.Generator(device=dev).manual_seed(seed)
    pixel = torch.arange(n, device=dev) // spp
    sx = ((pixel % width).float()
          + torch.rand(n, generator=g, device=dev)) / width
    sy = ((pixel // width).float()
          + torch.rand(n, generator=g, device=dev)) / height
    loc = torch.stack([-(2.0 * sx - 1.0) * cam[12],
                       (1.0 - 2.0 * sy) * cam[12] / (width / height),
                       torch.ones_like(sx)], 1)
    d = (loc / loc.norm(dim=1, keepdim=True)) @ cam[:9].reshape(3, 3).T
    return cam[9:12].expand(n, 3).contiguous(), d.contiguous()


# ----------------------------------------------------------------------------
# plain versions of the kernel's device helpers (csrc/rng.cuh,
# csrc/path_kernel.cu; megakernel.py:194-284)
# ----------------------------------------------------------------------------

def _tea(v0, v1, rounds=5):
    return sample_tea_32(v0, v1, rounds)


def _u01(bits):
    return u32_to_float01(bits)


def _rng2(key, dim):
    v0, v1 = _tea(key, torch.full_like(key, dim))
    return _u01(v0), _u01(v1)


def _concentric(u1, u2):
    x = 2.0 * u1 - 1.0
    y = 2.0 * u2 - 1.0
    zero = (x == 0.0) & (y == 0.0)
    q13 = x.abs() < y.abs()
    r = torch.where(q13, y, x)
    rp = torch.where(q13, x, y)
    phi = 0.25 * _PI * rp / torch.where(r == 0.0, torch.ones_like(r), r)
    phi = torch.where(q13, 0.5 * _PI - phi, phi)
    phi = torch.where(zero, torch.zeros_like(phi), phi)
    return r * torch.cos(phi), r * torch.sin(phi)


def _mis(a, b):
    a2 = a * a
    b2 = b * b
    return torch.where(a2 > 0, a2 / torch.clamp(a2 + b2, min=1e-30),
                       torch.zeros_like(a2))


def _ggx_d(hz, a):
    a2 = a * a
    d = hz * hz * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(_PI * d * d, min=1e-20)


def _ggx_g1(cz, a):
    """Smith G1 of isotropic GGX from the cosine alone."""
    cz = torch.clamp(cz, min=1e-6)
    a2 = a * a
    t2 = (1.0 - cz * cz) / (cz * cz)
    return 2.0 / (1.0 + torch.sqrt(1.0 + a2 * t2))


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _frame(n):
    """Duff et al.'s branchless orthonormal basis (t1, t2) around unit
    vectors n (3 tensors)."""
    one = torch.ones_like(n[2])
    s = torch.where(n[2] >= 0.0, one, -one)
    oa = -1.0 / (s + n[2])
    ob = n[0] * n[1] * oa
    return ([1.0 + s * n[0] * n[0] * oa, s * ob, -s * n[0]],
            [ob, s + n[1] * n[1] * oa, -n[1]])


def _normalized(v, floor=1e-20):
    inv = torch.rsqrt(torch.clamp(_dot3(v, v), min=floor))
    return [x * inv for x in v]


def _hero_wavelengths(key, nc):
    """The path's nc hero wavelengths (nm) and their sensor weights
    1 / pdf, from the lane key at sampler dim 1 (megakernel.py:306-324:
    sample_rgb_spectrum with atanh through log and cosh through exp)."""
    u, _ = _rng2(key, 1)
    wls, wts = [], []
    for c in range(nc):
        uc = u + c * (1.0 / nc)
        uc = uc - torch.floor(uc)
        arg = 0.8569106254698279 - 1.8275019724092267 * uc
        ath = 0.5 * torch.log((1.0 + arg)
                              / torch.clamp(1.0 - arg, min=1e-12))
        wl = 538.0 - ath * 138.88888888888889
        e = torch.exp(0.0072 * (wl - 538.0))
        ch = 0.5 * (e + 1.0 / e)
        wls.append(wl)
        wts.append(253.82 * ch * ch)
    return wls, wts


def _wl_norm(wl):
    return (wl - _WL_MIN) / (_WL_MAX - _WL_MIN) * 2.0 - 1.0


def _sigmoid(c0, c1, c2, x):
    """Jakob-Hanika sigmoid reflectance at normalized wavelength x."""
    t = (c0 * x + c1) * x + c2
    return 0.5 + t / (2.0 * torch.sqrt(1.0 + t * t))


def _spd_lerp(spd, wl, col):
    """Column ``col`` of the SPD table, linearly interpolated at the
    wavelengths (megakernel.py:436-463 d65_flat, cmf_flat)."""
    tpos = (wl - _WL_MIN) * (94.0 / (_WL_MAX - _WL_MIN))
    i0 = torch.clamp(torch.floor(tpos), 0.0, 93.0)
    w1 = torch.clamp(tpos - i0, 0.0, 1.0)
    i = i0.to(torch.int64)
    return spd[i, col] * (1.0 - w1) + spd[i + 1, col] * w1


def _cie_develop(spd, res, wls):
    """Hero-wavelength radiance -> linear sRGB rows: the CMFs at the
    wavelengths (zero outside [360, 830] nm), summed over the channels and
    divided by their count, then XYZ_TO_SRGB (megakernel.py:1378-1393)."""
    xyz = [torch.zeros_like(res[0]) for _ in range(3)]
    for r, wl in zip(res, wls):
        ok = ((wl >= _WL_MIN) & (wl <= _WL_MAX)).to(r.dtype)
        for k in range(3):
            xyz[k] = xyz[k] + _spd_lerp(spd, wl, 1 + k) * ok * r
    xyz = [x * (1.0 / len(res)) for x in xyz]
    M = spec.XYZ_TO_SRGB
    return [float(M[r, 0]) * xyz[0] + float(M[r, 1]) * xyz[1]
            + float(M[r, 2]) * xyz[2] for r in range(3)]


# ----------------------------------------------------------------------------
# plain PyTorch version
# ----------------------------------------------------------------------------

def _woop_t_uv(woop, o, d):
    """Brute-force Woop test of every lane against every face.
    -> t, u, v, each (n, F)."""
    W = woop[None]                                       # (1, F, 12)

    def dot_o(k):
        return (o[0][:, None] * W[..., k] + o[1][:, None] * W[..., k + 1]
                + o[2][:, None] * W[..., k + 2] + W[..., k + 3])

    def dot_d(k):
        return (d[0][:, None] * W[..., k] + d[1][:, None] * W[..., k + 1]
                + d[2][:, None] * W[..., k + 2])

    t = -dot_o(8) / dot_d(8)
    u = dot_o(0) + t * dot_d(0)
    v = dot_o(4) + t * dot_d(4)
    return t, u, v


def _face_ok(t, u, v, maxt):
    m3 = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
    return (m3 >= 0.0) & (t >= 0.0) & (t <= maxt[:, None])


def _sphere_t(sph, o, d, maxt):
    """Every lane against every sphere: near root above 0, else the far
    root (megakernel.py:917-929). -> (t, ok), each (n, S)."""
    lx = o[0][:, None] - sph[:, 0]
    ly = o[1][:, None] - sph[:, 1]
    lz = o[2][:, None] - sph[:, 2]
    b = lx * d[0][:, None] + ly * d[1][:, None] + lz * d[2][:, None]
    cc = lx * lx + ly * ly + lz * lz - sph[:, 3] * sph[:, 3]
    disc = b * b - cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    ts = torch.where(t0 > 0.0, t0, t1)
    ok = (disc > 0) & (ts > 0.0) & (ts < maxt[:, None])
    return ts, ok


def _argmin_lowest(t):
    """-> (min over axis 1, lowest index that attains it)."""
    tmin = t.min(dim=1).values
    ids = torch.arange(t.shape[1], device=t.device)
    k = torch.where(t <= tmin[:, None], ids,
                    torch.full_like(ids, t.shape[1])).min(dim=1).values
    return tmin, k.clamp(max=t.shape[1] - 1)


def _quad_t(qd, o, d, maxt):
    """Every lane against every disk and cylinder, in each one's canonical
    object frame (megakernel.py:1010-1058 ``_quad_hits``: the unit disk at
    z = 0; a cylinder of radius r around z in [0, length], its near root
    unless that leaves the span) -> (t, ok), each (n, Q)."""
    A = [qd[:, k] for k in range(9)]

    def local(v, w=None):
        out = [A[3 * r] * v[0][:, None] + A[3 * r + 1] * v[1][:, None]
               + A[3 * r + 2] * v[2][:, None] for r in range(3)]
        return out if w is None else [x + w[:, r] for r, x in
                                      enumerate(out)]

    olx, oly, olz = local(o, qd[:, 9:12])
    dlx, dly, dlz = local(d)
    is_disk = qd[:, 12] < 1.5
    r, ln = qd[:, 13], qd[:, 14]
    mt = maxt[:, None]
    dz_ok = dlz.abs() > 1e-12
    t_d = -olz / torch.where(dz_ok, dlz, 1.0)
    hx = olx + t_d * dlx
    hy = oly + t_d * dly
    ok_d = dz_ok & (hx * hx + hy * hy <= 1.0)
    a2 = dlx * dlx + dly * dly
    b2 = 2.0 * (dlx * olx + dly * oly)
    c2 = olx * olx + oly * oly - r * r
    disc = b2 * b2 - 4.0 * a2 * c2
    sqd = torch.sqrt(torch.clamp(disc, min=0.0))
    a2ok = a2.abs() > 1e-20
    inv2a = 1.0 / torch.where(a2ok, 2.0 * a2, 1.0)
    t_n = (-b2 - sqd) * inv2a
    t_f = (-b2 + sqd) * inv2a
    zn = olz + dlz * t_n
    zf = olz + dlz * t_f
    n_ok = (zn >= 0) & (zn <= ln) & (t_n > 0.0) & (t_n < mt)
    f_ok = (zf >= 0) & (zf <= ln) & (t_f > 0.0) & (t_f < mt)
    ok_c = a2ok & (disc > 0) & (n_ok | f_ok)
    tq = torch.where(is_disk, t_d, torch.where(n_ok, t_n, t_f))
    ok = torch.where(is_disk, ok_d, ok_c) & (tq > 0.0) & (tq < mt)
    return tq, ok


def _closest_hit(tables, o, d, maxt, first_hits=None):
    """-> (t (n,), attributes (n, FA), u, v); t = BIG and zero attributes
    where nothing is hit. Faces tie to the lowest face id and win ties
    against spheres, spheres against disks and cylinders; a sphere or
    quad hit carries its normal in the normal columns and its analytic uv
    (spherical; polar on a disk, cylindrical on a cylinder) as (u, v),
    which the identity uv rows of its attributes pass through; a face hit
    its barycentrics. ``first_hits``, if given, sums the lanes whose hit
    is a disk ("disk") or a cylinder ("cylinder")."""
    n = o[0].shape[0]
    big = torch.full((n,), _BIG, dtype=torch.float32, device=o[0].device)
    zero = torch.zeros_like(big)
    t, A, bu, bv = big, torch.zeros((n, FA), device=big.device), zero, zero
    need_uv = tables.flags & (HAS_CHECKER | HAS_LOBES)
    if tables.n_faces:
        tf, uf, vf = _woop_t_uv(face_woop(tables), o, d)
        ok = _face_ok(tf, uf, vf, maxt)
        tmin, k = _argmin_lowest(torch.where(ok, tf, big[:, None]))
        hit = tmin < _BIG * 0.5
        t = tmin
        A = torch.where(hit[:, None], tables.fattr[k], A)
        if need_uv:
            bu = torch.where(hit, uf.gather(1, k[:, None])[:, 0], zero)
            bv = torch.where(hit, vf.gather(1, k[:, None])[:, 0], zero)
    if tables.n_spheres:
        ts, oks = _sphere_t(tables.sph, o, d, maxt)
        tsmin, s = _argmin_lowest(torch.where(oks, ts, big[:, None]))
        closer = tsmin < t
        tsafe = torch.where(closer, tsmin, t)
        C = tables.sph[s]
        inv_r = 1.0 / torch.clamp(C[:, 3], min=1e-20)
        sn = [(o[k] + tsafe * d[k] - C[:, k]) * inv_r for k in range(3)]
        SA = torch.cat([torch.stack(sn, 1), tables.sattr[s][:, 3:]], 1)
        A = torch.where(closer[:, None], SA, A)
        t = torch.where(closer, tsmin, t)
        if need_uv:
            su = torch.atan2(sn[1], sn[0]) * (0.5 / _PI) + 0.5
            sv = torch.acos(torch.clamp(sn[2], -1.0, 1.0)) * (1.0 / _PI)
            bu = torch.where(closer, su, bu)
            bv = torch.where(closer, sv, bv)
    if tables.n_quads:
        tq, okq = _quad_t(tables.qd, o, d, maxt)
        tqmin, q = _argmin_lowest(torch.where(okq, tq, big[:, None]))
        closer = tqmin < t
        tsafe = torch.where(closer, tqmin, t)
        P, QA = tables.qd[q], tables.qattr[q]
        h = [o[k] + tsafe * d[k] for k in range(3)]
        ql = [P[:, 3 * r] * h[0] + P[:, 3 * r + 1] * h[1]
              + P[:, 3 * r + 2] * h[2] + P[:, 9 + r] for r in range(3)]
        inv_r = 1.0 / torch.clamp(P[:, 13], min=1e-20)
        flip = QA[:, C_FLIP]
        is_cyl = P[:, 12] > 1.5
        # a cylinder's normal A^T (x, y, 0) / r (A is rigid); a disk's is
        # packed in its attribute row
        qn = [torch.where(is_cyl, (P[:, k] * ql[0] + P[:, 3 + k] * ql[1])
                          * inv_r * flip, QA[:, C_NG + k]) for k in range(3)]
        QA = torch.cat([torch.stack(qn, 1), QA[:, 3:]], 1)
        A = torch.where(closer[:, None], QA, A)
        t = torch.where(closer, tqmin, t)
        if need_uv:
            phi = torch.atan2(ql[1], ql[0]) * (0.5 / _PI)
            phi = torch.where(phi < 0.0, phi + 1.0, phi)
            r_loc = torch.sqrt(torch.clamp(ql[0] * ql[0] + ql[1] * ql[1],
                                           min=0.0))
            inv_l = 1.0 / torch.clamp(P[:, 14], min=1e-20)
            bu = torch.where(closer, torch.where(is_cyl, phi, r_loc), bu)
            bv = torch.where(closer, torch.where(is_cyl, ql[2] * inv_l,
                                                 phi), bv)
        if first_hits is not None:
            for name, kind in (("disk", QUAD_DISK),
                               ("cylinder", QUAD_CYLINDER)):
                first_hits[name] = first_hits.get(name, 0) + int(
                    (closer & (P[:, 12] == kind)).sum())
    return t, A, bu, bv


class WalkTrees(NamedTuple):
    """A traversal tree on the host for the plain walks that count tests:
    ``pairs`` the binary pair nodes (ops/bvh.py ``pack_pairs``), ``nodes``
    the wide nodes, ``woop`` and ``prim`` in the tree's face order."""
    pairs: torch.Tensor
    nodes: torch.Tensor
    woop: torch.Tensor
    prim: torch.Tensor


def walk_trees(tables) -> WalkTrees:
    """The tables' traversal tree on the host, its pair nodes packed from
    ``bvh_tree``: the walks of ops/intersect.py are loops of small steps,
    which the host runs faster than the card."""
    if tables.bvh_tree is None:
        raise ValueError("the tables carry no traversal tree")
    return WalkTrees(torch.as_tensor(bvh_ops.pack_pairs(tables.bvh_tree)[0]),
                     tables.bvh_nodes.cpu(), tables.bvh_woop.cpu(),
                     tables.bvh_prim.cpu())


def _queue_walk(walks, o, d, maxt, live, key):
    """Queues the ``live`` lanes' rays on the host under ``key``
    ("walk" for closest hits, "shadow_walk" for any hits) for
    ``_count_walks``."""
    idx = live.nonzero()[:, 0]
    walks.setdefault(key, []).append(
        (torch.stack([x[idx] for x in o], 1).cpu(),
         torch.stack([x[idx] for x in d], 1).cpu(), maxt[idx].cpu()))


def _count_walks(tables, walks, stats):
    """Adds the node reads, box tests and face tests of the queued rays'
    walks: those of the binary walk over the tree's pair nodes
    (ops/intersect.py ``traverse_pairs``), which the bounds count, to
    ``stats[key + "_nodes"]``, ``[key + "_boxes"]`` and ``[key +
    "_faces"]``, and those of the BVH tier's wide walk (csrc/bvh.cuh,
    emulated by ``traverse``) to ``stats[key + "_wide_nodes"]`` and so on.
    Each walk runs once a key over all its rays."""
    if not walks:
        return
    trees = walk_trees(tables)
    for key, rays in walks.items():
        o, d, maxt = (torch.cat(x) for x in zip(*rays))
        args = (trees.woop, trees.prim, o, d, torch.zeros(len(o)), maxt)
        any_hit = key == "shadow_walk"
        for tag, walk in (("", traverse_pairs(trees.pairs, *args,
                                              any_hit=any_hit)),
                          ("_wide", traverse(trees.nodes, *args,
                                             any_hit=any_hit))):
            for part in ("nodes", "boxes", "faces"):
                name = f"{key}{tag}_{part}"
                stats[name] = stats.get(name, 0) + int(walk[part].sum())


def _first_or_all(hits):
    """Per lane: tests a loop over the columns of ``hits`` that stops at
    the first hit runs (index of the first hit + 1, else all)."""
    n = hits.shape[1]
    first = torch.where(hits, torch.arange(n, device=hits.device),
                        torch.full_like(hits, n, dtype=torch.int64))
    return (first.min(dim=1).values + 1).clamp(max=n)


def _occluded(tables, o, d, maxt, stats=None, live=None, walks=None):
    """Shadow any-hit of every lane; ``stats`` (with the ``live`` lanes
    that trace the ray) sums the face, sphere and quad tests the kernel's
    loops, which stop at the first occluder, run ("shadow_faces",
    "shadow_spheres", "shadow_quads"); in the BVH tier ``walks`` queues
    the rays, whose walks ``_count_walks`` counts."""
    occ = torch.zeros(o[0].shape[0], dtype=torch.bool, device=o[0].device)

    def count(name, hits):
        if stats is not None:
            stats[name] = stats.get(name, 0) + int(
                _first_or_all(hits)[live & ~occ].sum())

    if tables.n_faces:
        hits = _face_ok(*_woop_t_uv(face_woop(tables), o, d), maxt)
        if walks is not None:
            _queue_walk(walks, o, d, maxt, live, "shadow_walk")
        else:
            count("shadow_faces", hits)
        occ = hits.any(1)
    if tables.n_spheres:
        hits = _sphere_t(tables.sph, o, d, maxt)[1]
        count("shadow_spheres", hits)
        occ = occ | hits.any(1)
    if tables.n_quads:
        hits = _quad_t(tables.qd, o, d, maxt)[1]
        count("shadow_quads", hits)
        occ = occ | hits.any(1)
    return occ


def _rot3(M, v):
    """Constant 3x3 (row-major 9 floats) times v, renormalised."""
    r = [M[3 * i] * v[0] + M[3 * i + 1] * v[1] + M[3 * i + 2] * v[2]
         for i in range(3)]
    return _normalized(r)


def _env_uv(tables, d):
    """World direction -> env-local (u, v, sin theta) (envmap.cpp:
    u = atan2(x, -z) / 2 pi + 1/2, v = acos(y) / pi)."""
    if tables.flags & HAS_ENV_ROT:
        d = _rot3(tables.env_rot[9:], d)
    u = torch.atan2(d[0], -d[2]) * (0.5 / _PI) + 0.5
    v = torch.acos(torch.clamp(d[1], -1.0, 1.0)) * (1.0 / _PI)
    st = torch.sqrt(torch.clamp(1.0 - d[1] * d[1], min=1e-12))
    return u, v, st


def _env_fetch(tables, u, v):
    """Bilinear lat-long fetch of all four texel planes, u and v wrapping
    (megakernel.py:1219)."""
    H, W = tables.env.shape[:2]
    fu = u * W - 0.5
    fv = v * H - 0.5
    u0 = torch.floor(fu)
    v0 = torch.floor(fv)
    wu = (fu - u0)[:, None]
    wv = (fv - v0)[:, None]
    iu0 = torch.remainder(u0.to(torch.int64), W)
    iv0 = torch.remainder(v0.to(torch.int64), H)
    iu1 = torch.remainder(iu0 + 1, W)
    iv1 = torch.remainder(iv0 + 1, H)
    T = tables.env
    c0 = (1.0 - wv) * T[iv0, iu0] + wv * T[iv1, iu0]
    c1 = (1.0 - wv) * T[iv0, iu1] + wv * T[iv1, iu1]
    out = (1.0 - wu) * c0 + wu * c1
    return [out[:, c] for c in range(4)]


def _env_pdf(tables, d):
    """Solid-angle density of the env NEE arm toward world direction d:
    the grid texel's pmf * Ws Hs / (2 pi^2 sin theta)."""
    u, v, st = _env_uv(tables, d)
    hs, ws = tables.env_pmf.shape
    iu = torch.remainder(torch.floor(u * ws).to(torch.int64), ws)
    iv = torch.floor(v * hs).to(torch.int64).clamp(0, hs - 1)
    return tables.env_pmf[iv, iu] * (ws * hs) / torch.clamp(
        2.0 * _PI * _PI * st, min=1e-8)


def _env_sample(tables, u1, u2, j1, j2):
    """CDF-inverted env sample: the row whose marginal cdf first exceeds
    u1, the column whose conditional cdf first exceeds u2, uniform jitter
    in the texel. -> (world direction, solid-angle pdf, texel planes)."""
    hs, ws = tables.env_pmf.shape
    iv = (tables.env_marg[None, :] <= u1[:, None]).sum(1).clamp(0, hs - 1)
    iu = (tables.env_cond[iv] <= u2[:, None]).sum(1).clamp(0, ws - 1)
    pmf = tables.env_pmf[iv, iu]
    uu = (iu.to(torch.float32) + j1) / ws
    vv = (iv.to(torch.float32) + j2) / hs
    theta = vv * _PI
    phi = (uu - 0.5) * (2.0 * _PI)
    st = torch.sin(theta)
    ld = [st * torch.sin(phi), torch.cos(theta), -st * torch.cos(phi)]
    pdf = pmf * (ws * hs) / torch.clamp(2.0 * _PI * _PI * st, min=1e-8)
    rad = _env_fetch(tables, uu, vv)
    if tables.flags & HAS_ENV_ROT:
        ld = _rot3(tables.env_rot[:9], ld)
    return ld, pdf, rad


def _fresnel_diel(cos_i, eta):
    """Unpolarized dielectric Fresnel reflectance at signed incident
    cosine ``cos_i`` and relative IOR ``eta`` seen from the normal's side
    (megakernel.py:347 ``_fresnel_diel``) -> (F, signed transmitted cosine,
    eta_it, eta_ti)."""
    outside = cos_i >= 0
    rcp = 1.0 / eta
    eta_it = torch.where(outside, eta, rcp)
    eta_ti = torch.where(outside, rcp, eta)
    c2t = 1.0 - eta_ti * eta_ti * (1.0 - cos_i * cos_i)
    aci = cos_i.abs()
    act = torch.sqrt(torch.clamp(c2t, min=0.0))
    a_s = (aci - eta_it * act) / torch.clamp(aci + eta_it * act, min=1e-20)
    a_p = (eta_it * aci - act) / torch.clamp(eta_it * aci + act, min=1e-20)
    F = 0.5 * (a_s * a_s + a_p * a_p)
    F = torch.where(eta == 1.0, 0.0, torch.where(c2t <= 0.0, 1.0, F))
    return F, torch.where(outside, -act, act), eta_it, eta_ti


def _tex_fetch(tex, A, uu, vv):
    """Bilinear fetch of the bitmap texels of attribute rows ``A`` at uv
    (uu, vv), u and v wrapping (megakernel.py:1428-1470 with the atlas
    read directly) -> the three payload channels."""
    tw = torch.clamp(A[:, C_TEX + 1], min=1.0)
    th = torch.clamp(A[:, C_TEX + 2], min=1.0)
    fu = uu * tw - 0.5
    fv = vv * th - 0.5
    u0 = torch.floor(fu)
    v0 = torch.floor(fv)
    wu = (fu - u0)[:, None]
    wv = (fv - v0)[:, None]
    twi = tw.to(torch.int64)
    thi = th.to(torch.int64)
    iu0 = torch.remainder(u0.to(torch.int64), twi)
    iv0 = torch.remainder(v0.to(torch.int64), thi)
    iu1 = torch.remainder(iu0 + 1, twi)
    iv1 = torch.remainder(iv0 + 1, thi)
    base = A[:, C_TEX].to(torch.int64)

    def texel(iv, iu):
        return tex[base + iv * twi + iu]

    c0 = (1.0 - wv) * texel(iv0, iu0) + wv * texel(iv1, iu0)
    c1 = (1.0 - wv) * texel(iv0, iu1) + wv * texel(iv1, iu1)
    out = (1.0 - wu) * c0 + wu * c1
    return [out[:, c] for c in range(3)]


def _vndf_sample(wi, wiz, alpha, u_c1, u_c2):
    """GGX visible-normal sample (Heitz 2018) -> (reflected direction,
    wi . m, m_z)."""
    one = torch.ones_like(wiz)
    vh = _normalized([alpha * wi[0], alpha * wi[1], wiz])
    lensq = vh[0] * vh[0] + vh[1] * vh[1]
    linv = torch.rsqrt(torch.clamp(lensq, min=1e-20))
    t1x = torch.where(lensq > 1e-12, -vh[1] * linv, one)
    t1y = torch.where(lensq > 1e-12, vh[0] * linv, 0.0)
    t2 = [-vh[2] * t1y, vh[2] * t1x, vh[0] * t1y - vh[1] * t1x]
    rr = torch.sqrt(torch.clamp(u_c1, min=0.0))
    phi = 2.0 * _PI * u_c2
    p1 = rr * torch.cos(phi)
    p2 = rr * torch.sin(phi)
    s_ = 0.5 * (1.0 + vh[2])
    p2 = (1.0 - s_) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) \
        + s_ * p2
    pz = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = [p1 * t1x + p2 * t2[0] + pz * vh[0],
          p1 * t1y + p2 * t2[1] + pz * vh[1],
          p2 * t2[2] + pz * vh[2]]
    mh = [alpha * nh[0], alpha * nh[1], torch.clamp(nh[2], min=1e-6)]
    minv = torch.rsqrt(_dot3(mh, mh))
    mh = [x * minv for x in mh]
    wm = wi[0] * mh[0] + wi[1] * mh[1] + wiz * mh[2]
    go = [2.0 * wm * mh[0] - wi[0], 2.0 * wm * mh[1] - wi[1],
          2.0 * wm * mh[2] - wiz]
    return go, wm, mh[2]


# the first-hit kinds ``_trace_lanes`` counts ("first_<name>")
FIRST_HIT_KINDS = (("dielectric", KIND_DIELECTRIC),
                   ("plastic", KIND_PLASTIC),
                   ("roughplastic", KIND_ROUGHPLASTIC),
                   ("bitmap", KIND_BITMAP))


def _trace_lanes(tables, cam, key, pixel, width, height, max_depth,
                 rr_depth, stats=None, walks=None):
    """Radiance (3, n) linear sRGB of the lanes with TEA keys ``key`` at
    ``pixel``. ``stats``, if given, sums the lanes that trace a ray
    ("rays"), escape to the envmap ("escaped"), shade a bounce ("shaded",
    of them "ggx" on a conductor, "dielectric", "plastic" of which
    "roughplastic", "bitmap" fetches), sample the env NEE arm ("env_nee")
    and trace a shadow ray ("shadow"), the shadow rays' tests
    (``_occluded``), and the camera rays whose first hit
    is a dielectric, plastic, roughplastic, bitmap, disk or cylinder
    ("first_<name>"). A list under ``stats["lane_masks"]`` receives, per
    depth, {"depth", "live": the lanes that trace a ray, "kind": the kind
    of the lanes that shade a bounce, -1 elsewhere (absent on the last
    bounce)}; without that key nothing is recorded. ``walks``, with
    ``stats`` in the BVH tier, queues the rays that walk the tree for
    ``_count_walks``."""
    dev = key.device
    f32 = torch.float32
    nc = tables.nc
    spectral = nc == MODE_NC["spectral"]
    n = key.shape[0]
    zero = torch.zeros(n, dtype=f32, device=dev)
    one = torch.ones_like(zero)
    big = torch.full_like(zero, _BIG)
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
    d = [cam[3 * r] * lx + cam[3 * r + 1] * ly + cam[3 * r + 2] * lz
         for r in range(3)]
    o = [zero + cam[9 + r] for r in range(3)]
    if spectral:
        # hero wavelengths, constant along the path; the sensor weight
        # 1 / pdf is the initial throughput (megakernel.py:1347-1351)
        wls, thr = _hero_wavelengths(key, nc)
        xw = [_wl_norm(w) for w in wls]
        d65 = [_spd_lerp(tables.spd, w, 0) for w in wls]
    else:
        thr = [one.clone() for _ in range(nc)]
    res = [zero.clone() for _ in range(nc)]
    prev_pdf = zero
    # the relative IOR crossed so far; roulette weighs the throughput by
    # its square (megakernel.py:1648, 1960)
    eta_st = one
    active = torch.ones(n, dtype=torch.bool, device=dev)
    lights = tables.lights
    L = lights.shape[0]
    has_env = bool(tables.flags & HAS_ENV)
    has_ggx = bool(tables.flags & HAS_GGX)
    has_lobes = bool(tables.flags & HAS_LOBES)
    p_env = tables.p_env
    env_arm = has_env and p_env > 0.0

    def count(name, mask):
        if stats is not None:
            stats[name] = stats.get(name, 0) + int(mask.sum())

    def payload(c0, c1, c2):
        if spectral:
            return [_sigmoid(c0, c1, c2, xw[c]) for c in range(nc)]
        return [c0, c1, c2][:nc]

    masks = None if stats is None else stats.get("lane_masks")
    for depth in range(max_depth):
        dim0 = 2 + 8 * depth
        count("rays", active)
        if masks is not None:
            masks.append({"depth": depth, "live": active})
        if walks is not None:
            _queue_walk(walks, o, d, big, active, "walk")
        if stats is not None and tables.n_quads:
            stats["quad_tests"] = stats.get("quad_tests", 0) \
                + tables.n_quads * int(active.sum())
        first = {} if stats is not None and depth == 0 else None
        t, A, bu, bv = _closest_hit(tables, o, d,
                                    torch.where(active, big, -big), first)
        ng = [A[:, C_NG + k] for k in range(3)]
        lpdf_w = A[:, C_LPDF]
        kind = A[:, C_KIND]
        hit = t < _BIG * 0.5
        if first is not None:
            for name, k in FIRST_HIT_KINDS:
                first[name] = int((hit & (kind == k)).sum())
            for name, v in first.items():
                stats[f"first_{name}"] = stats.get(f"first_{name}", 0) + v
        if spectral:
            le = [_sigmoid(A[:, C_LE], A[:, C_LE + 1], A[:, C_LE + 2], xw[c])
                  * d65[c] * A[:, C_LESCALE] for c in range(nc)]
        else:
            le = [A[:, C_LE + c] for c in range(nc)]

        # environment on escape, MIS-weighted against the env NEE arm
        if has_env:
            ep = _env_fetch(tables, *_env_uv(tables, d)[:2])
            if spectral:
                env_ch = [_sigmoid(ep[0], ep[1], ep[2], xw[c]) * ep[3]
                          * d65[c] for c in range(nc)]
            else:
                env_ch = ep[:nc]
            if p_env > 0.0 and depth > 0:
                epdf = _env_pdf(tables, d) * p_env
                w_esc = torch.where(prev_pdf > 0.0, _mis(prev_pdf, epdf), one)
            else:
                w_esc = one
            esc = active & ~hit
            count("escaped", esc)
            for c in range(nc):
                res[c] = res[c] + torch.where(esc, w_esc * thr[c]
                                              * env_ch[c], zero)

        # emission, MIS-weighted against NEE after the camera vertex
        cos_hit = -(d[0] * ng[0] + d[1] * ng[1] + d[2] * ng[2])
        if depth == 0:
            em_w = one
        else:
            pdf_l_hit = torch.where(
                cos_hit > 1e-6,
                t * t * lpdf_w / torch.clamp(cos_hit, min=1e-6), zero)
            em_w = torch.where(prev_pdf > 0.0, _mis(prev_pdf, pdf_l_hit),
                               one)
        wgt = torch.where(active & hit & (cos_hit > 0), em_w, zero)
        for c in range(nc):
            res[c] = res[c] + wgt * thr[c] * le[c]
        if depth == max_depth - 1:
            break

        # albedo payload: uv from the barycentrics (or the analytic uv);
        # checkerboard: affine to_uv, parity of floor(u') + floor(v');
        # bitmap: a bilinear texel fetch at the uv itself
        pay = [A[:, C_ALB + c] for c in range(3)]
        if tables.flags & (HAS_CHECKER | HAS_LOBES):
            uu = A[:, C_UV0] + bu * A[:, C_DUV1] + bv * A[:, C_DUV2]
            vv = A[:, C_UV0 + 1] + bu * A[:, C_DUV1 + 1] \
                + bv * A[:, C_DUV2 + 1]
        if tables.flags & HAS_CHECKER:
            u2 = A[:, C_TOUV0] * uu + A[:, C_TOUV0 + 1] * vv \
                + A[:, C_TOUV0 + 2]
            v2 = A[:, C_TOUV1] * uu + A[:, C_TOUV1 + 1] * vv \
                + A[:, C_TOUV1 + 2]
            par = torch.remainder(torch.floor(u2) + torch.floor(v2), 2.0)
            use_c1 = (kind > 1.5) & (kind < 2.5) & (par > 0.5)
            pay = [torch.where(use_c1, A[:, C_C1 + c], pay[c])
                   for c in range(3)]
        is_bmp = kind > 5.5
        if has_lobes and tables.tex.shape[0]:
            tx_ = _tex_fetch(tables.tex, A, uu, vv)
            pay = [torch.where(is_bmp, tx_[c], pay[c]) for c in range(3)]
        alb = payload(*pay)
        is_ggx = (kind > 0.5) & (kind < 1.5)
        if has_ggx:
            if spectral:
                # eta(x), k(x): the IOR quadratics at the clamped x
                xc = [torch.clamp(xw[c], A[:, C_XLO], A[:, C_XHI])
                      for c in range(nc)]
                eta = [(A[:, C_ETA] * xc[c] + A[:, C_ETA + 1]) * xc[c]
                       + A[:, C_ETA + 2] for c in range(nc)]
                kap = [(A[:, C_K] * xc[c] + A[:, C_K + 1]) * xc[c]
                       + A[:, C_K + 2] for c in range(nc)]
            else:
                eta = [A[:, C_ETA + c] for c in range(nc)]
                kap = [A[:, C_K + c] for c in range(nc)]
        is_diel = (kind > 2.5) & (kind < 3.5)
        is_plas = (kind > 3.5) & (kind < 5.5)      # smooth or rough
        is_rplas = (kind > 4.5) & (kind < 5.5)
        if has_lobes:
            # dielectric transmittance / plastic coat reflectance payload
            c2 = payload(*(A[:, C_C1 + c] for c in range(3)))
            eta_d = torch.clamp(A[:, C_ETAD], min=1e-3)
            ssw = A[:, C_SSW]
            fdr = A[:, C_FDR]
            inv_eta2 = A[:, C_INVETA2]
            nonlin = A[:, C_NONLIN] > 0.5

        # FrontSide lobes: back-face hits end the path; dielectrics are
        # two-sided
        act = active & hit & ((cos_hit > 0) | is_diel)
        count("shaded", act)
        if masks is not None:
            masks[-1]["kind"] = torch.where(act, kind.to(torch.int64), -1)
        count("ggx", act & is_ggx)
        if has_lobes:
            count("dielectric", act & is_diel)
            count("plastic", act & is_plas)
            count("roughplastic", act & is_rplas)
            count("bitmap", act & is_bmp)
        n_ = ng
        p = [o[k] + t * d[k] for k in range(3)]
        eps = (1.0 + torch.maximum(p[0].abs(), torch.maximum(
            p[1].abs(), p[2].abs()))) * 1.8e-4
        tx, ty = _frame(n_)

        def to_local(v):
            return [_dot3(v, tx), _dot3(v, ty), _dot3(v, n_)]

        def to_world(v):
            return [v[0] * tx[k] + v[1] * ty[k] + v[2] * n_[k]
                    for k in range(3)]

        wi = to_local([-d[0], -d[1], -d[2]])
        wiz = torch.clamp(wi[2], min=1e-6)
        alpha = torch.clamp(A[:, C_ALPHA], min=1e-3)

        # Russian roulette (path.cpp:133-141)
        if depth + 1 > rr_depth:
            rr_u, _ = _rng2(key, dim0 + 0)
            mx = thr[0]
            for c in range(1, nc):
                mx = torch.maximum(mx, thr[c])
            q = torch.clamp(mx * eta_st * eta_st, max=0.95)
            act = act & (rr_u < q)
            inv_q = 1.0 / torch.clamp(q, min=1e-8)
            thr_ = [thr[c] * inv_q for c in range(nc)]
        else:
            thr_ = list(thr)

        # NEE: the env arm with probability p_env, else an area-weighted
        # light face through the cdf and a uniform point on it
        u_sel, u_b1 = _rng2(key, dim0 + 1)
        u_b2, _ = _rng2(key, dim0 + 2)
        if env_arm:
            use_env = u_sel < p_env
            u_area = (u_sel - p_env) / max(1.0 - p_env, 1e-8)
        else:
            u_area = u_sel
        li = (lights[:, 12][None, :] <= u_area[:, None]).sum(dim=1)
        LT = lights[li.clamp(max=L - 1)]
        s_t = torch.sqrt(torch.clamp(1.0 - u_b1, min=0.0))
        bu_l = 1.0 - s_t
        bv_l = u_b2 * s_t
        dl = [LT[:, k] + LT[:, 3 + k] * bu_l + LT[:, 6 + k] * bv_l - p[k]
              for k in range(3)]
        dist2 = _dot3(dl, dl)
        dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
        inv_dist = 1.0 / dist
        dl = [x * inv_dist for x in dl]
        cos_l = -(dl[0] * LT[:, 9] + dl[1] * LT[:, 10] + dl[2] * LT[:, 11])
        pdf_l = torch.where(cos_l > 1e-6,
                            dist2 * LT[:, 13] / torch.clamp(cos_l, min=1e-6),
                            zero)
        if spectral:
            lrad = [_sigmoid(LT[:, 14], LT[:, 15], LT[:, 16], xw[c])
                    * d65[c] * LT[:, 17] for c in range(nc)]
        else:
            lrad = [LT[:, 14 + c] for c in range(nc)]
        if env_arm:
            ej1, ej2 = _rng2(key, dim0 + 5)
            edl, epdf, ep = _env_sample(tables, u_b1, u_b2, ej1, ej2)
            if spectral:
                erad = [_sigmoid(ep[0], ep[1], ep[2], xw[c]) * ep[3] * d65[c]
                        for c in range(nc)]
            else:
                erad = ep[:nc]
            dl = [torch.where(use_env, edl[k], dl[k]) for k in range(3)]
            pdf_l = torch.where(use_env, epdf * p_env, pdf_l)
            lrad = [torch.where(use_env, erad[c], lrad[c])
                    for c in range(nc)]
            # env shadow rays test the whole open segment
            dist = torch.where(use_env, torch.full_like(dist, 1e7), dist)
        cos_s = _dot3(dl, n_)
        # delta lobes take no NEE
        nee_ok = act & (pdf_l > 0) & (cos_s > 0) & ~is_diel
        count("shadow", nee_ok)
        if env_arm:
            count("env_nee", act & use_env)
        occluded = _occluded(
            tables, [p[k] + n_[k] * eps for k in range(3)], dl,
            torch.where(nee_ok, dist * (1.0 - 1e-3), -big), stats, nee_ok,
            walks)
        # BSDF toward the light: f * cos and the BSDF's own pdf
        pdf_bsdf_l = torch.clamp(cos_s, min=0.0) / _PI
        fcos = [alb[c] * (cos_s / _PI) for c in range(nc)]
        if has_ggx or has_lobes:
            wo = to_local(dl)
            h = _normalized([wi[0] + wo[0], wi[1] + wo[1], wiz + wo[2]])
            ci_h = torch.clamp(wi[0] * h[0] + wi[1] * h[1] + wiz * h[2],
                               min=0.0)
            D = _ggx_d(h[2], alpha)
            g1i = _ggx_g1(wiz, alpha)
            spec_ = D * (g1i * _ggx_g1(torch.clamp(wo[2], min=1e-6), alpha)) \
                / torch.clamp(4.0 * wiz, min=1e-20)
            pdf_ggx_l = g1i * D / torch.clamp(4.0 * wiz, min=1e-20)
            ggx_ok = (wo[2] > 0).to(f32)
        if has_ggx:
            pdf_bsdf_l = torch.where(is_ggx, pdf_ggx_l, pdf_bsdf_l)
            fcos = [torch.where(
                is_ggx, alb[c] * spec_ * fresnel_conductor(
                    ci_h, eta[c], kap[c]) * ggx_ok,
                fcos[c]) for c in range(nc)]
        if has_lobes:
            # (rough) plastic: the diffuse base behind the coat, plus the
            # GGX coat of the rough one (megakernel.py:1773-1793)
            Fp_i = _fresnel_diel(wiz, eta_d)[0]
            Fp_o = _fresnel_diel(torch.clamp(wo[2], min=0.0), eta_d)[0]
            prob_sp = Fp_i * ssw / torch.clamp(
                Fp_i * ssw + (1.0 - Fp_i) * (1.0 - ssw), min=1e-8)
            den = [1.0 - torch.where(nonlin, alb[c] * fdr, fdr)
                   for c in range(nc)]
            dcom = (1.0 / _PI) * inv_eta2 * torch.clamp(wo[2], min=0.0) \
                * (1.0 - Fp_i) * (1.0 - Fp_o)
            sp = spec_ * _fresnel_diel(ci_h, eta_d)[0] * ggx_ok
            fcos = [torch.where(
                is_plas, alb[c] / torch.clamp(den[c], min=1e-8) * dcom
                + torch.where(is_rplas, c2[c] * sp, 0.0), fcos[c])
                for c in range(nc)]
            pdf_plas = pdf_bsdf_l * (1.0 - prob_sp) \
                + torch.where(is_rplas, pdf_ggx_l * prob_sp, 0.0)
            pdf_bsdf_l = torch.where(is_plas, pdf_plas, pdf_bsdf_l)
        base = _mis(pdf_l, pdf_bsdf_l) / torch.clamp(pdf_l, min=1e-20)
        gate = nee_ok & ~occluded
        for c in range(nc):
            res[c] = res[c] + torch.where(
                gate, thr_[c] * base * fcos[c] * lrad[c], zero)

        # BSDF sample: cosine-weighted diffuse, GGX visible normals with
        # throughput albedo * F * G1(wo), a Fresnel-weighted pick of the
        # dielectric's reflection or refraction, or the plastic's coat or
        # base (megakernel.py:1804-1952)
        u_c1, u_c2 = _rng2(key, dim0 + 4)
        cx, cy = _concentric(u_c1, u_c2)
        cz = torch.sqrt(torch.clamp(1.0 - cx * cx - cy * cy, min=0.0))
        wsel = [cx, cy, cz]
        bsdf_pdf = cz / _PI
        ok_lobe = cz > 0
        mm = list(alb)
        if has_ggx or has_lobes:
            go, wm, mhz = _vndf_sample(wi, wiz, alpha, u_c1, u_c2)
        if has_ggx:
            pdf_ggx = _ggx_g1(wiz, alpha) * _ggx_d(mhz, alpha) \
                / torch.clamp(4.0 * wiz, min=1e-20)
            g1o = _ggx_g1(torch.clamp(go[2], min=1e-6), alpha)
            wsel = [torch.where(is_ggx, go[k], wsel[k]) for k in range(3)]
            bsdf_pdf = torch.where(is_ggx, pdf_ggx, bsdf_pdf)
            ok_lobe = torch.where(is_ggx, (go[2] > 1e-6) & (wm > 0), ok_lobe)
            mm = [torch.where(is_ggx, alb[c] * fresnel_conductor(
                torch.clamp(wm, min=0.0), eta[c], kap[c])
                * g1o, alb[c]) for c in range(nc)]
        # the pdf emission hits are weighed against; 0 after a delta lobe
        mis_pdf = bsdf_pdf
        eta_mul = one
        if has_lobes:
            u_lobe, _ = _rng2(key, dim0 + 3)
            # smooth dielectric: reflect or refract by the Fresnel term,
            # from either side; transmission scales radiance by eta_ti^2
            F_d, cos_t, eta_it, eta_ti = _fresnel_diel(wi[2], eta_d)
            refl = u_lobe <= F_d
            dd = [torch.where(refl, -wi[0], -eta_ti * wi[0]),
                  torch.where(refl, -wi[1], -eta_ti * wi[1]),
                  torch.where(refl, wi[2], cos_t)]
            md = [torch.where(refl, alb[c], c2[c] * eta_ti * eta_ti)
                  for c in range(nc)]
            wsel = [torch.where(is_diel, dd[k], wsel[k]) for k in range(3)]
            mm = [torch.where(is_diel, md[c], mm[c]) for c in range(nc)]
            bsdf_pdf = torch.where(is_diel, torch.where(refl, F_d, 1.0 - F_d),
                                   bsdf_pdf)
            mis_pdf = torch.where(is_diel, 0.0, mis_pdf)
            ok_lobe = ok_lobe | is_diel
            eta_mul = torch.where(is_diel & ~refl, eta_it, eta_mul)
            # plastics: the coat with probability prob_sp (a mirror, or
            # the rough one's GGX sample), else the cosine-sampled base
            sel_sp = u_lobe < prob_sp
            pp = [torch.where(sel_sp, torch.where(is_rplas, go[k], sk), ck)
                  for k, (sk, ck) in enumerate(((-wi[0], cx), (-wi[1], cy),
                                                (wiz, cz)))]
            ppz = torch.clamp(pp[2], min=0.0)
            Fp_os = _fresnel_diel(ppz, eta_d)[0]
            dcom_s = (1.0 / _PI) * inv_eta2 * ppz * (1.0 - Fp_i) \
                * (1.0 - Fp_os)
            fd = [alb[c] / torch.clamp(den[c], min=1e-8) * dcom_s
                  for c in range(nc)]
            pdf_cos = ppz / _PI
            pdf_base = pdf_cos * (1.0 - prob_sp)
            # smooth: the per-lobe weights in closed form
            inv_pd = 1.0 / torch.clamp(pdf_base, min=1e-20)
            inv_ps = 1.0 / torch.clamp(prob_sp, min=1e-8)
            msm = [torch.where(sel_sp, c2[c] * Fp_i * inv_ps, fd[c] * inv_pd)
                   for c in range(nc)]
            pdf_sm = torch.where(sel_sp, prob_sp, pdf_base)
            mis_sm = torch.where(sel_sp, 0.0, pdf_base)
            # rough: eval(wo) / pdf(wo) over the mixture pdf
            h2 = [wi[0] + pp[0], wi[1] + pp[1], wiz + pp[2]]
            h2inv = torch.rsqrt(torch.clamp(_dot3(h2, h2), min=1e-20))
            ci_h2 = torch.clamp((wi[0] * h2[0] + wi[1] * h2[1]
                                 + wiz * h2[2]) * h2inv, min=0.0)
            D2 = _ggx_d(h2[2] * h2inv, alpha)
            G2 = _ggx_g1(wiz, alpha) * _ggx_g1(torch.clamp(pp[2], min=1e-6),
                                               alpha)
            spec2 = D2 * G2 * _fresnel_diel(ci_h2, eta_d)[0] \
                / torch.clamp(4.0 * wiz, min=1e-20)
            pdf_g2 = _ggx_g1(wiz, alpha) * D2 \
                / torch.clamp(4.0 * wiz, min=1e-20)
            pdf_rp = pdf_g2 * prob_sp + pdf_base
            inv_prp = 1.0 / torch.clamp(pdf_rp, min=1e-20)
            mrp = [(c2[c] * spec2 + fd[c]) * inv_prp for c in range(nc)]
            wsel = [torch.where(is_plas, pp[k], wsel[k]) for k in range(3)]
            mm = [torch.where(is_plas, torch.where(is_rplas, mrp[c], msm[c]),
                              mm[c]) for c in range(nc)]
            bsdf_pdf = torch.where(is_plas, torch.where(is_rplas, pdf_rp,
                                                        pdf_sm), bsdf_pdf)
            mis_pdf = torch.where(is_plas, torch.where(is_rplas, pdf_rp,
                                                       mis_sm), mis_pdf)
            ok_lobe = torch.where(is_plas, pp[2] > 1e-6, ok_lobe)
        nd = to_world(wsel)
        thr = [thr_[c] * torch.where(act, mm[c], one) for c in range(nc)]
        thr_sum = thr[0]
        for c in range(1, nc):
            thr_sum = thr_sum + thr[c]
        active = act & ok_lobe & (bsdf_pdf > 0) & (thr_sum > 0)
        eta_st = torch.where(active, eta_st * eta_mul, eta_st)
        # leave on the side the new ray goes (transmission continues
        # through the surface)
        off = torch.where(wsel[2] >= 0.0, eps, -eps)
        o = [p[k] + n_[k] * off for k in range(3)]
        d = nd
        prev_pdf = mis_pdf
    if spectral:
        return torch.stack(_cie_develop(tables.spd, res, wls))
    if nc == 1:
        return torch.stack(res * 3)
    return torch.stack(res)


def lane_keys(seed, sample_base, spp_pass, lanes, pixel_base=0):
    """-> (TEA lane keys, pixel ids) of int64 lane indices
    (megakernel.py:1316-1329); a band's lanes count from its first pixel,
    global id ``pixel_base``."""
    pixel = lanes // spp_pass + pixel_base
    samp = lanes % spp_pass + sample_base
    mixed, _ = _tea(pixel, samp, 4)
    key, _ = _tea(torch.full_like(mixed, seed & 0xFFFFFFFF), mixed, 4)
    return key, pixel


def path_radiance_reference(tables, cam, seed, sample_base, spp_pass,
                            width, height, max_depth, rr_depth, stats=None,
                            lanes=None, row0=0, n_rows=None):
    """Plain PyTorch version of the path kernel -> (3, n) float32 per-lane
    linear sRGB radiance, n = width * height * spp_pass, on the tables'
    device; or of the int64 lane indices ``lanes`` only (3, len(lanes)),
    the same values as those columns of the whole. With ``n_rows``, the
    band of film rows ``row0 .. row0 + n_rows`` only: n = width * n_rows
    * spp_pass lanes keyed on their global pixels (megakernel.py:
    2779-2841), the matching rows of the whole film's lanes.

    Vectorised over lanes with a Python loop over depth and brute-force
    (lanes x faces), (lanes x spheres) and (lanes x cdf entries) tests, in
    lane chunks that keep each such temporary within ``_CHUNK_ELEMS``
    elements. ``stats``: see ``_trace_lanes``; in the BVH tier also the
    walk's node reads, box and face tests of every ray it traces
    (``_count_walks``: "walk_boxes", "shadow_walk_faces" and so on)."""
    dev = tables.device
    walks = {} if stats is not None and tables.flags & HAS_BVH else None
    rows = height if n_rows is None else n_rows
    if lanes is None:
        lanes = torch.arange(width * rows * spp_pass, device=dev)
    out = torch.empty((3, len(lanes)), dtype=torch.float32, device=dev)
    widest = max(tables.n_faces + tables.n_spheres + tables.n_quads,
                 tables.lights.shape[0], *tables.env_cond.shape, 1)
    step = max(1, _CHUNK_ELEMS // widest)
    for start in range(0, len(lanes), step):
        chunk = lanes[start:start + step]
        key, pixel = lane_keys(seed, sample_base, spp_pass, chunk,
                               row0 * width)
        out[:, start:start + len(chunk)] = _trace_lanes(
            tables, cam, key, pixel, width, height, max_depth, rr_depth,
            stats, walks)
    if walks is not None:
        _count_walks(tables, walks, stats)
    return out


# ----------------------------------------------------------------------------
# the kernel's wrapper
# ----------------------------------------------------------------------------

class _PathArgs(ctypes.Structure):
    """csrc/path_kernel.cu's PathArgs, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "woop", "fattr", "lights", "sph", "sattr", "env", "env_marg",
        "env_cond", "env_pmf", "env_rot", "spd", "bvh_nodes", "bvh_woop",
        "bvh_prim", "cam", "out")]
        + [(name, ctypes.c_int) for name in (
            "n_faces", "n_lights", "n_spheres", "env_w", "env_h", "env_ws",
            "env_hs", "env_has_rot")]
        + [("p_env", ctypes.c_float), ("seed", ctypes.c_uint32),
           ("sample_base", ctypes.c_uint32)]
        + [(name, ctypes.c_int) for name in (
            "spp_pass", "width", "height", "max_depth", "rr_depth",
            "n_lanes", "flags", "nc")]
        + [(name, ctypes.c_void_p) for name in ("qd", "qattr", "tex")]
        + [("n_quads", ctypes.c_int), ("counter", ctypes.c_void_p),
           ("pixel_base", ctypes.c_uint32)])


# threads a block (csrc/path_kernel.cu BLOCK)
BLOCK = 128
# what csrc/path_kernel.cu's entry point reports of a launch: blocks of
# the instantiation resident an SM, the card's SMs, dynamic shared bytes a
# block, and the launch's grid (persistent: the SMs times the resident
# blocks)
LAUNCH_INFO = ("blocks_per_sm", "sms", "smem", "grid")
# its own error codes
LAUNCH_ERRORS = {-1: "no block of the instantiation fits on an SM",
                 -2: "the lanes and the grid overflow the 32-bit lane "
                     "counter"}


def _check_tables(tables, cam):
    # BVH-tier tables may leave the face-order Woop rows out
    woop_rows = (tables.woop.shape[0] if tables.flags & HAS_BVH
                 and tables.woop.shape[0] == 0 else tables.n_faces)
    shapes = (("woop", tables.woop, (woop_rows, 12)),
              ("fattr", tables.fattr, (tables.n_faces, FA)),
              ("lights", tables.lights, (tables.lights.shape[0], 24)),
              ("sph", tables.sph, (tables.n_spheres, 4)),
              ("sattr", tables.sattr, (tables.n_spheres, FA)),
              ("qd", tables.qd, (tables.n_quads, QD)),
              ("qattr", tables.qattr, (tables.n_quads, FA)),
              ("env", tables.env, tables.env.shape[:2] + (4,)),
              ("env_marg", tables.env_marg, tables.env_pmf.shape[:1]),
              ("env_cond", tables.env_cond, tables.env_pmf.shape),
              ("env_pmf", tables.env_pmf, tables.env_pmf.shape),
              ("env_rot", tables.env_rot, (18,)),
              ("spd", tables.spd, (SPD_ROWS if tables.nc == 4 else 0, 4)),
              ("tex", tables.tex, (tables.tex.shape[0], 4)),
              ("bvh_nodes", tables.bvh_nodes, (tables.bvh_nodes.shape[0],
                                               bvh_ops.WIDE_SLOTS)),
              ("bvh_woop", tables.bvh_woop, (tables.bvh_prim.shape[0], 12)),
              ("bvh_prim", tables.bvh_prim, (tables.bvh_prim.shape[0],)),
              ("cam", cam, (16,)))
    for name, t, shape in shapes:
        dtype = torch.int32 if name == "bvh_prim" else torch.float32
        if t.dtype != dtype or not t.is_contiguous() \
                or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be a contiguous {dtype} "
                             f"{tuple(shape)} tensor, got {tuple(t.shape)} "
                             f"{t.dtype}")
        if t.device != tables.device:
            raise ValueError(f"{name} is on {t.device}, not {tables.device}")
    if tables.lights.shape[0] < 1:
        raise ValueError("the light table needs at least its dummy row")
    if tables.n_faces > MAX_FACES_HBM:
        raise ValueError(f"{tables.n_faces} faces > {MAX_FACES_HBM}")
    if tables.flags & HAS_BVH:
        if tables.bvh_prim.shape[0] != tables.n_faces \
                or not tables.bvh_nodes.shape[0]:
            raise ValueError("the BVH tier needs the traversal tree of "
                             "every face")
        check_tree(tables)
    elif tables.n_faces > MAX_FACES_SHARED:
        raise ValueError(f"{tables.n_faces} faces > {MAX_FACES_SHARED} "
                         f"need the BVH tier")
    if tables.n_spheres > MAX_SPHERES:
        raise ValueError(f"{tables.n_spheres} spheres > {MAX_SPHERES}")
    if tables.n_quads > MAX_SPHERES:
        raise ValueError(f"{tables.n_quads} disks and cylinders > "
                         f"{MAX_SPHERES}")
    if tables.tex.shape[0] >= 1 << 24:
        raise ValueError("texel offsets beyond 2^24 are not exact in the "
                         "float32 attribute columns")
    if tables.nc not in NC_MODE:
        raise ValueError(f"no path kernel for {tables.nc} color channels")
    if tables.flags & HAS_ENV and (min(tables.env.shape[:2]) < 1
                                   or min(tables.env_pmf.shape) < 1):
        raise ValueError("an envmap needs non-empty radiance and grid "
                         "tables")


def check_tree(tables):
    """Raises unless the tables' traversal tree is what csrc/bvh.cuh
    walks: a stack bound within its stack, 128-byte nodes, on the card on
    128-byte lines."""
    if tables.bvh_depth > bvh_ops.STACK_DEPTH:
        raise ValueError(f"the traversal tree's stack bound "
                         f"{tables.bvh_depth} > the kernel's stack of "
                         f"{bvh_ops.STACK_DEPTH}")
    nodes = tables.bvh_nodes
    if nodes.shape[1:] != (bvh_ops.WIDE_SLOTS,) \
            or nodes.is_cuda and nodes.data_ptr() % 128:
        raise ValueError("the traversal tree's nodes must be 128-byte "
                         "lines, 128-byte aligned on the card")


def _path_args(tables, cam, seed, sample_base, spp_pass, width, height,
               max_depth, rr_depth, out, counter,
               pixel_base=0) -> _PathArgs:
    """The kernel's arguments: the tables, the camera row, the output
    (3, n) and the lane counter as pointers, the pass as scalars (a band's
    first pixel ``pixel_base``)."""
    H, W = tables.env.shape[:2]
    Hs, Ws = tables.env_pmf.shape
    return _PathArgs(
        *(t.data_ptr() for t in (
            tables.woop, tables.fattr, tables.lights, tables.sph,
            tables.sattr, tables.env, tables.env_marg, tables.env_cond,
            tables.env_pmf, tables.env_rot, tables.spd, tables.bvh_nodes,
            tables.bvh_woop, tables.bvh_prim, cam, out)),
        tables.n_faces, tables.lights.shape[0], tables.n_spheres, W, H, Ws,
        Hs, int(bool(tables.flags & HAS_ENV_ROT)), tables.p_env,
        seed & 0xFFFFFFFF, sample_base & 0xFFFFFFFF, spp_pass, width,
        height, max_depth, rr_depth, out.shape[1],
        tables.flags & TEMPLATE_FLAGS, tables.nc,
        *(t.data_ptr() for t in (tables.qd, tables.qattr, tables.tex)),
        tables.n_quads, counter.data_ptr(), pixel_base)


def path_radiance(tables, cam, seed, sample_base, spp_pass, width, height,
                  max_depth, rr_depth, row0=0, n_rows=None):
    """Per-lane radiance (3, n): the CUDA kernel for tables on a CUDA
    device, the plain version for tables on the CPU; with ``n_rows`` the
    band of film rows from ``row0`` (``path_radiance_reference``). The
    kernel runs persistent blocks, as many as the card holds at once,
    whose threads take lanes from a counter this function zeroes on the
    stream before the launch. A build or launch failure raises."""
    dev = tables.device
    if dev.type == "cpu":
        return path_radiance_reference(tables, cam, seed, sample_base,
                                       spp_pass, width, height, max_depth,
                                       rr_depth, row0=row0, n_rows=n_rows)
    if dev.type != "cuda":
        raise ValueError(f"no path kernel for device {dev}")
    _check_tables(tables, cam)
    rows = height if n_rows is None else n_rows
    if not 0 <= row0 <= row0 + rows <= height:
        raise ValueError(f"rows {row0}..{row0 + rows} outside the film's "
                         f"{height}")
    n = width * rows * spp_pass
    if n >= 1 << 31:
        raise ValueError(f"{n} lanes overflow the kernel's int32 lane ids")
    flags = tables.flags & TEMPLATE_FLAGS
    render = _path_render(library_defines(tables.nc,
                                          bool(flags & HAS_LOBES)))
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    # the next lane to start, zeroed on the stream before the launch
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    args = _path_args(tables, cam, seed, sample_base, spp_pass, width,
                      height, max_depth, rr_depth, out, counter,
                      row0 * width)
    info = (ctypes.c_int * len(LAUNCH_INFO))()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = render(ctypes.byref(args), stream, info)
    if err != 0:
        raise RuntimeError(f"path_kernel launch failed: "
                           f"{LAUNCH_ERRORS.get(err, f'CUDA error {err}')}")
    path_radiance.launches += 1
    path_radiance.launches_by_kernel[(flags, tables.nc)] += 1
    path_radiance.last_launch[(flags, tables.nc)] = dict(
        zip(LAUNCH_INFO, info))
    return out


# kernel launches in total and by instantiation ((TEMPLATE_FLAGS bits, nc)),
# and the last launch's LAUNCH_INFO by instantiation
path_radiance.launches = 0
path_radiance.launches_by_kernel = collections.Counter()
path_radiance.last_launch = {}


def reset_launch_counts():
    path_radiance.launches = 0
    path_radiance.launches_by_kernel.clear()


def library_defines(nc, lobes):
    """nvcc defines of the path kernel's library for ``nc`` channels with
    or without the lobes flag: two libraries per color mode, each with 32
    flag instantiations, so that six compiler processes build them side by
    side."""
    return {"PK_NC": nc, "PK_LOBES": int(lobes)}


def libraries():
    """(name, defines) of the six libraries, for ``build.build_all``."""
    return [("path_kernel", library_defines(nc, lobes)) for nc in (3, 4, 1)
            for lobes in (False, True)]


def _path_render(defines):
    """csrc/path_kernel.cu's C entry point in the library of ``defines``
    (``library_defines``, and tools/loop_profile.py's), built on first
    use."""
    from .build import load
    fn = load("path_kernel", defines).path_render
    fn.argtypes = [ctypes.POINTER(_PathArgs), ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


# ----------------------------------------------------------------------------
# host side: one scene's kernel and its gate
# ----------------------------------------------------------------------------

class PathKernel:
    """Renders passes of one scene's tables through one sensor
    (DiffusePathMegakernel's role, megakernel.py:2779), on the film or on
    a band of its rows."""

    # render_pass takes a band of film rows
    BANDS = True

    def __init__(self, scene, sensor, max_depth, rr_depth):
        self.tables = scene.tables
        self.size = sensor.film.crop_size
        self.rfilter = sensor.film.rfilter
        # uploaded once: a pageable host-to-device copy per pass would
        # make the host wait for the previous pass's kernel
        self.cam = camera_row(sensor, self.tables.device)
        self.max_depth = max_depth
        self.rr_depth = rr_depth
        self._replicas = {}

    def to(self, device):
        """This kernel object with its tables and camera row on
        ``device``: itself there, else a copy made once per device."""
        return replica(self, device, "tables", "cam")

    def render_pass(self, seed, sample_base, spp_pass, row0=0, n_rows=None):
        """-> the pass's image block: under the box filter (h, w, 4)
        per-pixel radiance sums and the sample count as weight; under any
        other filter the (h + 2b, w + 2b, 4) block of the samples splatted
        through it (ops/splat.py; megakernel.py:3032-3073). With
        ``n_rows``, the band of film rows from ``row0``: its lanes keyed on
        their global pixels, so that the bands of a film are its pass
        sample for sample, and the band's (n_rows, w, 4) block, or (n_rows
        + 2b, w + 2b, 4) with its filter border (megakernel.py:
        2779-2841, :3048-3073)."""
        from ..models.rfilters import BoxFilter
        from .splat import splat
        w, h = self.size
        rows = h if n_rows is None else n_rows
        band = {} if n_rows is None else dict(row0=row0, n_rows=n_rows)
        rgb = path_radiance(self.tables, self.cam, seed, sample_base,
                            spp_pass, w, h, self.max_depth, self.rr_depth,
                            **band)
        if isinstance(self.rfilter, BoxFilter):
            rgb = rgb.reshape(3, w * rows, spp_pass).sum(dim=2)
            img = torch.cat([rgb, torch.full((1, w * rows), float(spp_pass),
                                             device=rgb.device)])
            return img.T.reshape(rows, w, 4)
        return splat(rgb, seed, sample_base, spp_pass, w, h, self.rfilter,
                     **band)


def replica(obj, device, *fields):
    """``obj`` if its ``fields`` (tables and tensors with ``.to``) are on
    ``device``, else its shallow copy with them moved there, made once per
    device and kept in ``obj._replicas``."""
    from ..variants import resolve_device
    device = resolve_device(device)
    copies = obj._replicas
    copies.setdefault(str(getattr(obj, fields[0]).device), obj)
    if str(device) not in copies:
        other = copy.copy(obj)
        for f in fields:
            setattr(other, f, getattr(obj, f).to(device))
        copies[str(device)] = other
    return copies[str(device)]


def _constant(*textures):
    from ..models.textures import ConstantTexture
    return all(type(t) is ConstantTexture for t in textures)


def _iso_ggx(bsdf):
    """Isotropic GGX of alpha >= 0.01 (megakernel.py:2021-2028); the
    kernel samples visible normals only."""
    return bsdf.dist_type == "ggx" and bsdf.alpha_u == bsdf.alpha_v \
        and bsdf.alpha_u >= 0.01


def bsdf_ineligibility(bsdf, mode):
    """-> None if the kernel shades ``bsdf`` in color mode ``mode``, else
    the reason (megakernel.py:2004 _bsdf_columns)."""
    from ..models.bsdfs import (SmoothDiffuse, RoughConductor,
                                SmoothDielectric, SmoothPlastic,
                                RoughPlastic)
    from ..models.spectra import ConductorIORSpectrum
    from ..models.textures import CheckerboardTexture, BitmapTexture
    name = f"unsupported BSDF {type(bsdf).__name__}"
    if type(bsdf) is SmoothDiffuse:
        tex = bsdf.reflectance
        if _constant(tex):
            return None
        if type(tex) is CheckerboardTexture \
                and _constant(tex.color0, tex.color1):
            return None
        if type(tex) is BitmapTexture:
            w, h = tex.resolution
            if w > MAX_TEX_W or h > MAX_TEX_ROWS:
                return (f"bitmap {w}x{h} beyond the kernel's {MAX_TEX_W} "
                        f"texels a row or {MAX_TEX_ROWS} rows")
            return None
        return name
    if type(bsdf) is RoughConductor:
        if mode == "spectral" and not all(
                type(t) is ConductorIORSpectrum
                for t in (bsdf.eta_tex, bsdf.k_tex)):
            # curve spectra the user supplied (megakernel.py:3094-3103)
            return "conductor IOR curve spectra in spectral mode"
        if not _iso_ggx(bsdf):
            return name
        ior = () if mode == "spectral" else (bsdf.eta_tex, bsdf.k_tex)
        if not _constant(*ior, bsdf.specular_reflectance):
            return name
        return None
    if type(bsdf) is SmoothDielectric:
        if not _constant(bsdf.specular_reflectance,
                         bsdf.specular_transmittance):
            return name
        return None
    if type(bsdf) in (SmoothPlastic, RoughPlastic):
        if type(bsdf) is RoughPlastic and not (_iso_ggx(bsdf)
                                               and bsdf.sample_visible):
            return name
        if not _constant(bsdf.diffuse_reflectance,
                         bsdf.specular_reflectance):
            return name
        return None
    return name


def bitmaps(shapes):
    """The distinct bitmap textures of the shapes' BSDFs, in first-use
    order (the order their texels are packed in)."""
    from ..models.textures import BitmapTexture
    out = []
    for sh in shapes:
        tex = getattr(sh.bsdf, "reflectance", None)
        if type(tex) is BitmapTexture and all(tex is not t for t in out):
            out.append(tex)
    return out


def path_kernel_ineligibility(scene):
    """-> None if the scene is inside the kernel's scope, else a short
    reason (megakernel.py:3076 megakernel_ineligibility)."""
    from ..variants import current
    from ..models.emitters import AreaEmitter, EnvironmentMap
    from ..models.shapes import SphereShape, DiskShape, CylinderShape
    var = current()
    if var.polarized:
        return "polarized variant"
    if var.double_precision:
        return "double-precision variant"
    mode = var.color_mode
    if mode == "spectral":
        for sh in scene.shapes:
            reason = bsdf_ineligibility(sh.bsdf, mode)
            if reason == "conductor IOR curve spectra in spectral mode":
                return reason
        for e in scene.emitters:
            if type(e) is AreaEmitter and not hasattr(e.radiance,
                                                      "_d65_scale"):
                return ("area emitter spectrum without srgb_d65 payload "
                        "in spectral mode")
    if scene.has_media:
        return "participating media"
    if not scene.shapes:
        return "no shapes"
    # before the shape test: an instance is a mesh with no faces of its own
    if scene.n_instances:
        return "shared-geometry instances (wavefront path only)"
    for sh in scene.shapes:
        if not sh.is_mesh() and type(sh) not in (SphereShape, DiskShape,
                                                 CylinderShape):
            return f"non-triangle shape {type(sh).__name__}"
    if scene.tables.n_faces > MAX_FACES_HBM:
        return f"face count {scene.tables.n_faces} > {MAX_FACES_HBM}"
    if scene.tables.n_spheres > MAX_SPHERES:
        return f"sphere count > {MAX_SPHERES}"
    if scene.tables.n_quads > MAX_SPHERES:
        return f"disk/cylinder count > {MAX_SPHERES}"
    for sh in scene.shapes:
        if type(sh) is SphereShape and sh.flip_normals:
            # the kernel shades the outward normal (megakernel.py:944)
            return "sphere with flip_normals"
    for sh in scene.shapes:
        reason = bsdf_ineligibility(sh.bsdf, mode)
        if reason is not None:
            return reason
    rows = sum(t.resolution[1] for t in bitmaps(scene.shapes))
    if rows > MAX_TEX_ROWS:
        # megakernel.py:2439-2441 (MAX_ATLAS_H)
        return f"bitmap texel rows {rows} > {MAX_TEX_ROWS}"
    for e in scene.emitters:
        if type(e) is EnvironmentMap:
            if e is not scene.environment_emitter:
                return "multiple envmaps"
            if max(e.res) > MAX_ENV_W:
                return f"envmap larger than {MAX_ENV_W}"
            M = np.asarray(e.to_world.matrix)[:3, :3]
            if not np.allclose(M @ M.T, np.eye(3), atol=1e-5):
                return "non-rigid envmap to_world"
            continue
        if type(e) is not AreaEmitter:
            return f"unsupported emitter {type(e).__name__}"
        if e.radiance.is_spatially_varying():
            return "textured area emitter"
    return None
