"""Scene: geometry packing into one flat table set on the device.

Parity: include/mitsuba/render/scene.h:12 and ``mitsuba2_tpu.render.scene``
(``Scene._compile``, ``_mesh_face_arrays``). Every mesh packs into per-face
arrays on the host, every analytic sphere into a sphere row; the path
kernel's tables (ops/path_kernel.py ``PathTables``) are then built once, on
the device chosen with ``set_device``: Woop rows, per-face attribute rows
(normal, light pdf, albedo, BSDF kind and parameters, uv), the light
table, sphere rows, the envmap's radiance and sampling grid and, in
spectral variants, the D65 and CIE table, laid out as
``DiffusePathMegakernel.__init__`` builds them (ops/megakernel.py:
2260-2682), in the same light-face order.

Colors are packed as the variant the scene was loaded under reads them:
linear rgb; in spectral variants the sigmoid model's coefficients (with a
D65 scale for emitters and envmap texels, and the IOR quadratics for
conductors); in mono variants the luminance, repeated over the three
color slots.

Faces take the reference's order: the binned-SAH builder (ops/bvh.py,
``leaf_size=64``) runs over the faces in shape order, and its permutation
is applied to every per-face array before any table is built
(mitsuba2_tpu/render/scene.py:253-275), so face ids, prim ids and exact
ties are the reference's. A second build at ``bvh.TRAVERSAL_LEAF`` faces
per leaf over the permuted faces gives the traversal tree that the path
kernel's BVH tier and the scene's ray queries (``ray_intersect_preliminary``,
``ray_test``, through ops/intersect_kernel.py) walk per ray.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import spectrum as spec
from ..core.object import Object
from ..ops import bvh as bvh_ops
from ..ops import path_kernel as pk


class Scene(Object):
    def __init__(self, props=None, shapes=None, sensors=None, emitters=None,
                 integrator=None):
        super().__init__(props)
        from ..variants import (variant as _variant_name, device as _device,
                                current as _current)
        # a scene belongs to the variant and device it was loaded under;
        # integrator.render checks the variant
        self.variant_name = _variant_name()
        self.color_mode = _current().color_mode
        self.device = _device()
        self.shapes = list(shapes or [])
        self.sensors = list(sensors or [])
        self.emitters = list(emitters or [])
        self.integrator = integrator
        if props is not None:
            for _, obj in props.objects():
                kind = getattr(obj, "plugin_category", "")
                if kind == "shape":
                    self.shapes.extend(obj.expand())
                elif kind == "sensor":
                    self.sensors.append(obj)
                elif kind == "emitter":
                    self.emitters.append(obj)
                elif kind == "integrator":
                    self.integrator = obj
        # collect shape-attached emitters (scene.cpp:22-59 classification)
        for s in self.shapes:
            if s.emitter is not None and s.emitter not in self.emitters:
                self.emitters.append(s.emitter)
        self.environment_emitter = None
        for e in self.emitters:
            if e.is_environment():
                if self.environment_emitter is not None:
                    raise RuntimeError("only one environment emitter allowed")
                self.environment_emitter = e
        self._compile()

    def _compile(self):
        self.bsdfs = []
        for s in self.shapes:
            if s.bsdf is None:
                from ..models.bsdfs import SmoothDiffuse
                s.bsdf = SmoothDiffuse()
            if all(b is not s.bsdf for b in self.bsdfs):
                self.bsdfs.append(s.bsdf)
        for i, e in enumerate(self.emitters):
            e._emitter_index = i

        v0s, e1s, e2s, ngs, uvss, face_shape = [], [], [], [], [], []
        spheres = []
        bb_min = np.full(3, np.inf)
        bb_max = np.full(3, -np.inf)
        for si_idx, s in enumerate(self.shapes):
            if s.is_analytic():
                spheres.append((si_idx, s))
            elif s.is_mesh():
                v0, e1, e2, ng, uvs = _mesh_face_arrays(s)
                v0s.append(v0)
                e1s.append(e1)
                e2s.append(e2)
                ngs.append(ng)
                uvss.append(uvs)
                face_shape.append(np.full(len(v0), si_idx, np.int32))
            else:
                continue     # the path integrator refuses such scenes
            lo, hi = s.bbox()
            bb_min = np.minimum(bb_min, lo)
            bb_max = np.maximum(bb_max, hi)
        self._bb_min = bb_min
        self._bb_max = bb_max

        def cat(xs, shape):
            if not xs:
                return np.zeros((0,) + shape, np.float32)
            return np.concatenate(xs).astype(np.float32)

        face_shape = (np.concatenate(face_shape) if face_shape
                      else np.zeros(0, np.int32))
        v0, e1, e2 = cat(v0s, (3,)), cat(e1s, (3,)), cat(e2s, (3,))
        ng, uvs = cat(ngs, (3,)), cat(uvss, (3, 2))
        # the reference's face order (its BVH leaf order), then the
        # traversal tree over the permuted faces
        self.bvh = None
        if len(v0) > 1:
            self.bvh = bvh_ops.build_bvh(v0, e1, e2, leaf_size=64)
            perm = self.bvh.order
            v0, e1, e2, ng, uvs, face_shape = (
                x[perm] for x in (v0, e1, e2, ng, uvs, face_shape))
        self.traversal = None
        if len(v0):
            self.traversal = bvh_ops.build_bvh(
                v0, e1, e2, leaf_size=bvh_ops.TRAVERSAL_LEAF)
        # per-face host arrays in face order, kept for the tables built
        # after load (the volumetric kernel's, ops/volpath_kernel.py)
        self.face_shape = face_shape
        self.v0, self.e1, self.e2, self.ng, self.uvs = v0, e1, e2, ng, uvs
        for e in self.emitters:
            if hasattr(e, "prepare"):
                e.prepare(self)
        env = self.environment_emitter
        mode = self.color_mode
        lights, le_face, le_scale, lpdf_w, p_env = _light_table(
            self.emitters, self.shapes, self.face_shape, env is not None,
            mode)
        cols = [_shape_columns(s.bsdf, mode) for s in self.shapes]

        fattr = np.zeros((len(self.face_shape), pk.FA), np.float32)
        fattr[:, pk.C_NG:pk.C_NG + 3] = self.ng
        fattr[:, pk.C_LPDF] = lpdf_w
        fattr[:, pk.C_LE:pk.C_LE + 3] = le_face
        fattr[:, pk.C_LESCALE] = le_scale
        if cols:
            fattr += np.stack(cols)[self.face_shape]
        fattr[:, pk.C_UV0:pk.C_UV0 + 2] = uvs[:, 0]
        fattr[:, pk.C_DUV1:pk.C_DUV1 + 2] = uvs[:, 1] - uvs[:, 0]
        fattr[:, pk.C_DUV2:pk.C_DUV2 + 2] = uvs[:, 2] - uvs[:, 0]

        # analytic spheres (megakernel.py:2460-2489): [center, radius] and
        # the shape's columns; the identity uv mapping passes the hit's
        # spherical uv through the checker resolve unchanged
        sph = np.zeros((len(spheres), 4), np.float32)
        sattr = np.zeros((len(spheres), pk.FA), np.float32)
        self.sphere_shape = np.asarray([i for i, _ in spheres], np.int32)
        for i, (si_idx, s) in enumerate(spheres):
            sph[i, :3] = s.center
            sph[i, 3] = s.radius
            sattr[i] = cols[si_idx]
            sattr[i, pk.C_DUV1] = 1.0
            sattr[i, pk.C_DUV2 + 1] = 1.0

        env_t = env_rot = None
        if env is not None:
            env_t = (env_texels(env.data, mode),) \
                + env_sampling_tables(env.data)
            env_rot = np.asarray(env.to_world.matrix, np.float32)[:3, :3]
        self.tables = pk.pack_tables(
            self.v0, self.e1, self.e2, fattr, lights,
            self.device, sph=sph, sattr=sattr, env=env_t, env_rot=env_rot,
            p_env=p_env, nc=pk.MODE_NC[mode], traversal=self.traversal)
        # the light table and per-face emission on the host, for the same
        self.light_rows, self.le_face, self.lpdf_w = lights, le_face, lpdf_w

        # media in first-seen shape order, interior before exterior
        # (mitsuba2_tpu/render/scene.py:293-312)
        self.media = []
        for s in self.shapes:
            for med in (s.interior_medium, s.exterior_medium):
                if med is not None and all(med is not x
                                           for x in self.media):
                    self.media.append(med)
        self.has_media = bool(self.media)

    def bbox(self):
        return self._bb_min, self._bb_max

    # ------------------------------------------------------------ ray queries
    def _sphere_closest_hit(self, o, d, mint, maxt):
        """Every ray against every analytic sphere, the reference's plain
        pass (mitsuba2_tpu/render/scene.py:541-562) -> (t (n,) inf on a
        miss, sphere index (n,) or -1)."""
        sph = self.tables.sph
        oc = o[:, None, :] - sph[None, :, :3]
        a = (d * d).sum(-1)[:, None]
        b = (oc * d[:, None, :]).sum(-1)
        cc = (oc * oc).sum(-1) - sph[None, :, 3] ** 2
        disc = b * b - a * cc
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = (-b - sq) / a
        t1 = (-b + sq) / a
        t_near = torch.where(t0 > mint[:, None], t0, t1)
        ok = (disc > 0) & (t_near > mint[:, None]) & (t_near < maxt[:, None])
        t_near = torch.where(ok, t_near, float("inf"))
        t_best, s_best = t_near.min(dim=1)
        return t_best, torch.where(torch.isfinite(t_best),
                                   s_best.to(torch.int32), -1)

    def _segment_ends(self, ray, active):
        if active is None:
            return ray.maxt
        return torch.where(active, ray.maxt, float("-inf")).contiguous()

    def ray_intersect_preliminary(self, ray, active=None):
        """Closest hit of a batch of rays (core/ray.py Ray on the scene's
        device) -> render/records.py PreliminaryIntersection (scene.h;
        mitsuba2_tpu/render/scene.py:637-720). Mesh faces go through K2
        (ops/intersect_kernel.py), the analytic spheres through the
        reference's plain pass; a sphere hit has prim id F + its index and
        uv 0. Rays with ``active`` False miss."""
        from ..ops.intersect_kernel import isect_closest
        from .records import PreliminaryIntersection
        maxt = self._segment_ends(ray, active)
        t, uv, prim = isect_closest(self.tables, ray.o, ray.d, ray.mint,
                                    maxt)
        n_faces = self.tables.n_faces
        shape_idx = torch.full_like(prim, -1)
        if n_faces:
            fs = torch.as_tensor(self.face_shape, device=prim.device)
            shape_idx = fs[prim.clamp(0, n_faces - 1).long()]
        if self.tables.n_spheres:
            ts, s_idx = self._sphere_closest_hit(ray.o, ray.d, ray.mint,
                                                 maxt)
            closer = ts < t
            t = torch.where(closer, ts, t)
            prim = torch.where(closer & (s_idx >= 0), n_faces + s_idx, prim)
            uv = torch.where(closer[:, None], 0.0, uv)
            ss = torch.as_tensor(self.sphere_shape, device=prim.device)
            shape_idx = torch.where(
                prim >= n_faces,
                ss[(prim - n_faces).clamp(0, len(ss) - 1).long()],
                shape_idx)
        shape_idx = torch.where(prim >= 0, shape_idx, -1)
        return PreliminaryIntersection(t, uv, shape_idx.to(torch.int32),
                                       prim.to(torch.int32))

    def ray_test(self, ray, active=None):
        """Whether each ray is occluded within its [mint, maxt] (scene.h
        ray_test; mitsuba2_tpu/render/scene.py:965-989): mesh faces through
        K2's any-hit entry, spheres through the plain pass -> (n,) bool."""
        from ..ops.intersect_kernel import isect_any
        maxt = self._segment_ends(ray, active)
        hit = isect_any(self.tables, ray.o, ray.d, ray.mint, maxt)
        if self.tables.n_spheres:
            ts, _ = self._sphere_closest_hit(ray.o, ray.d, ray.mint, maxt)
            hit = hit | torch.isfinite(ts)
        return hit


def _shape_columns(bsdf, mode):
    """A shape's BSDF columns of the attribute row (ops/path_kernel.py
    C_*) in color mode ``mode``: kind, albedo, color1, alpha, eta, k, the
    IOR fit span and to_uv, as megakernel.py:2327-2432 and
    _shape_albedo/_shape_c1 (:2685-2726) set them. Zeros for a BSDF the
    path kernel refuses (the integrator's gate refuses the scene before
    the table is read)."""
    from ..models.bsdfs import SmoothDiffuse, RoughConductor
    from ..models.textures import CheckerboardTexture, mono_luminance
    row = np.zeros(pk.FA, np.float32)
    row[pk.C_TOUV0] = row[pk.C_TOUV1 + 1] = 1.0        # identity to_uv
    if pk.bsdf_ineligibility(bsdf, mode) is not None:
        return row
    if type(bsdf) is SmoothDiffuse:
        tex = bsdf.reflectance
        if type(tex) is CheckerboardTexture:
            row[pk.C_KIND] = pk.KIND_CHECKER
            row[pk.C_ALB:pk.C_ALB + 3] = tex.color0.payload()
            row[pk.C_C1:pk.C_C1 + 3] = tex.color1.payload()
            if tex.to_uv is not None:
                M = np.asarray(tex.to_uv.matrix, np.float32)
                row[pk.C_TOUV0:pk.C_TOUV0 + 3] = M[0, [0, 1, 3]]
                row[pk.C_TOUV1:pk.C_TOUV1 + 3] = M[1, [0, 1, 3]]
        else:
            row[pk.C_ALB:pk.C_ALB + 3] = tex.payload()
    elif type(bsdf) is RoughConductor:
        row[pk.C_KIND] = pk.KIND_GGX
        row[pk.C_ALPHA] = bsdf.alpha_u
        row[pk.C_ALB:pk.C_ALB + 3] = bsdf.specular_reflectance.payload()
        eta, k = bsdf.eta_tex, bsdf.k_tex
        if mode == "spectral":
            # eta(x), k(x) quadratics and the clamp span of their fit
            row[pk.C_ETA:pk.C_ETA + 3] = eta._coeff
            row[pk.C_K:pk.C_K + 3] = k._coeff
            row[pk.C_XLO] = eta._x_lo
            row[pk.C_XHI] = eta._x_hi
        elif mode == "mono":
            row[pk.C_ETA:pk.C_ETA + 3] = mono_luminance(eta.rgb)
            row[pk.C_K:pk.C_K + 3] = mono_luminance(k.rgb)
        else:
            row[pk.C_ETA:pk.C_ETA + 3] = eta.rgb
            row[pk.C_K:pk.C_K + 3] = k.rgb
    return row


def _mesh_face_arrays(s):
    """Per-face SoA arrays of one mesh -> (v0, e1, e2, ng, uvs (f, 3, 2));
    a mesh without uvs gets the barycentric (0,0), (1,0), (0,1)."""
    p = s.vertices[s.faces]                      # (f,3,3)
    v0 = p[:, 0]
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    fn = np.cross(e1, e2)
    ng = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True),
                         1e-20)
    if s.uvs is not None:
        uvs = s.uvs[s.faces]
    else:
        uvs = np.zeros((len(v0), 3, 2), np.float32)
        uvs[:, 1, 0] = 1.0
        uvs[:, 2, 1] = 1.0
    return v0, e1, e2, ng, uvs


def _pad8(x):
    return max(8, int(np.ceil(x / 8)) * 8)


def _emitter_payload(radiance, mode):
    """(3,) radiance payload and D65 scale of an area emitter's radiance:
    linear rgb and 0, the luminance repeated and 0 (mono), or the sigmoid
    coefficients and the D65 scale (spectral, srgb_d65.cpp). Zeros for a
    radiance the path kernel refuses."""
    from ..models.textures import ConstantTexture, mono_luminance
    if mode == "spectral":
        if not hasattr(radiance, "_d65_scale"):
            return np.zeros(3, np.float32), 0.0
        return np.asarray(radiance._coeff, np.float32), radiance._d65_scale
    if type(radiance) is not ConstantTexture:
        return np.zeros(3, np.float32), 0.0
    rgb = np.asarray(radiance.rgb, np.float32).reshape(3)
    if mode == "mono":
        return np.full(3, mono_luminance(rgb), np.float32), 0.0
    return rgb, 0.0


def _light_table(emitters, shapes, face_shape, has_env, mode):
    """Area-light faces -> (lights (L, 24), per-face Le payload (F, 3),
    per-face D65 scale (F,), per-face light pdf (F,), p_env), as
    ops/megakernel.py:2257-2325 builds them.

    Row layout: v0 0:3 | e1 3:6 | e2 6:9 | n 9:12 | cdf 12 | weight 13 |
    radiance payload 14:17 | D65 scale 17 | pad. NEE takes the envmap
    with probability ``p_env`` (1/2 beside area lights, 1 without, 0
    without an envmap) and otherwise a face, picked area-weighted across
    all lights through the cdf; ``weight`` is the resulting per-area
    density, scaled by 1 - p_env. Without area lights the table is one
    dummy row with cdf 1. Rows are padded to a multiple of 8 with
    ``cdf = 2.0``, which no uniform sample selects."""
    n_faces = len(face_shape)
    le_face = np.zeros((n_faces, 3), np.float32)
    le_scale = np.zeros((n_faces,), np.float32)
    lpdf_w = np.zeros((n_faces,), np.float32)
    lights = []
    light_shape = []
    for e in emitters:
        if not getattr(e, "_packed", False):
            continue
        rad, rscale = _emitter_payload(e.radiance, mode)
        sidx = shapes.index(e.shape)
        for k in range(len(e.face_areas)):
            lights.append(np.concatenate([
                e.tv0[k], e.te1[k], e.te2[k], e.tn[k],
                [0.0, 0.0], rad, [rscale], [0.0] * 6]))
            light_shape.append(sidx)
    lights = np.asarray(lights, np.float32)
    p_env = (0.5 if len(lights) else 1.0) if has_env else 0.0
    if len(lights):
        tri_area = 0.5 * np.linalg.norm(
            np.cross(lights[:, 3:6], lights[:, 6:9]), axis=1)
        sel = tri_area / max(tri_area.sum(), 1e-20)
        dens = sel / np.maximum(tri_area, 1e-20)       # per-area density
        dens = dens * (1.0 - p_env)
        lights[:, 13] = dens
        lights[:, 12] = np.cumsum(sel)
        for row, sidx in enumerate(light_shape):
            mask = face_shape == sidx
            le_face[mask] = lights[row, 14:17]
            le_scale[mask] = lights[row, 17]
            lpdf_w[mask] = dens[row]
    else:
        lights = np.zeros((1, 24), np.float32)
        lights[0, 12] = 1.0
    Lp = _pad8(len(lights))
    if Lp > len(lights):
        padl = np.zeros((Lp - len(lights), 24), np.float32)
        padl[:, 12] = 2.0
        lights = np.concatenate([lights, padl])
    return lights, le_face, le_scale, lpdf_w, p_env


def env_texels(data, mode):
    """(h, w, 3) env radiance -> (h, w, 4) float32 texels in color mode
    ``mode``: [r, g, b, 0]; [luminance, 0, 0, 0] (mono); or (spectral,
    envmap.cpp:95-115) the sigmoid coefficients of rgb / s and the scale
    s / d65_y_normalization(), s = 2 max(rgb), with the whitepoint
    normalization folded into the scale (megakernel.py:2569-2593)."""
    from ..models.textures import mono_luminance
    texels = np.zeros(data.shape[:2] + (4,), np.float32)
    if mode == "spectral":
        from .srgb import srgb_model_fetch
        sc = 2.0 * data.max(axis=-1)
        unit = data / np.maximum(sc, 1e-8)[..., None]
        texels[..., :3] = srgb_model_fetch(unit)
        texels[..., 3] = sc / spec.d65_y_normalization()
    elif mode == "mono":
        texels[..., 0] = mono_luminance(data)
    else:
        texels[..., :3] = data
    return texels


# the env NEE grid's coarsening caps and concentration guard
# (megakernel.py:2615-2624, their default values)
ENV_SAMPLE_W, ENV_SAMPLE_H, ENV_SAMPLE_CONC = 64, 32, 32.0


def env_sampling_tables(data):
    """(h, w, 3) env radiance -> (marginal cdf (Hs,), conditional cdf
    (Hs, Ws), pmf (Hs, Ws)) float32, as megakernel.py:2596-2655 builds
    them: texel importance luminance * sin(theta_row), sum-pooled 2x2 into
    a coarser grid while the grid is over 64 x 32 and no texel holds more
    than 32x the uniform share (a sharp sun keeps the full grid), then
    normalised and accumulated in float32."""
    h, w = data.shape[0], data.shape[1]
    lum = (0.2126 * data[..., 0] + 0.7152 * data[..., 1]
           + 0.0722 * data[..., 2])
    stheta = np.sin((np.arange(h) + 0.5) * np.pi / h)
    imp = np.maximum(lum, 0.0) * stheta[:, None] + 1e-12
    ws, hs = w, h

    def diffuse_enough(a):
        return a.max() / a.sum() * a.size < ENV_SAMPLE_CONC

    while ((ws > ENV_SAMPLE_W and ws % 2 == 0)
           or (hs > ENV_SAMPLE_H and hs % 2 == 0)):
        nxt = imp
        nw, nh = ws, hs
        if ws > ENV_SAMPLE_W and ws % 2 == 0:
            nxt = nxt.reshape(nxt.shape[0], -1, 2).sum(-1)
            nw //= 2
        if hs > ENV_SAMPLE_H and hs % 2 == 0:
            nxt = nxt.reshape(-1, 2, nxt.shape[1]).sum(1)
            nh //= 2
        if not diffuse_enough(nxt):
            break
        imp, ws, hs = nxt, nw, nh
    pmf = (imp / imp.sum()).astype(np.float32)     # (hs, ws)
    row_sum = pmf.sum(axis=1)
    marg_cdf = np.cumsum(row_sum)
    cond_cdf = np.cumsum(pmf / np.maximum(row_sum[:, None], 1e-20), axis=1)
    return marg_cdf, cond_cdf, pmf
