"""Scene: geometry packing into one flat table set on the device.

Parity: include/mitsuba/render/scene.h:12 and ``mitsuba2_tpu.render.scene``
(``Scene._compile``, ``_mesh_face_arrays``). Every mesh packs into per-face
arrays on the host, every analytic sphere into a sphere row, every disk
and cylinder into a quad row; the path kernel's tables (ops/path_kernel.py
``PathTables``) are then built once, on the device chosen with
``set_device``: Woop rows, per-face attribute rows (normal, light pdf,
albedo, BSDF kind and parameters, uv, texture region), the light table,
sphere and quad rows with their attribute rows, the bitmap textures'
texels, the envmap's radiance and sampling grid and, in spectral variants,
the D65 and CIE table, laid out as ``DiffusePathMegakernel.__init__``
builds them (ops/megakernel.py:2260-2682), in the same light-face order.

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

Shared-geometry instances (``instance`` shapes that ``expand`` kept;
mitsuba2_tpu/render/scene.py:133-157, :353-409) stay out of the face
tables: each group's meshes are packed once, in the group's frame, with a
traversal tree of their own (ops/intersect_kernel.py ``InstanceTables``),
and each instance is one transform row; the group's meshes join
``shapes`` for their BSDFs. An instance hit has prim id F + S + Q +
instance * g_max + the group's face id.
"""

from __future__ import annotations

import copy
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from ..core import math as m
from ..core import spectrum as spec
from ..core.object import Object
from ..core.ray import Ray
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
        # emitter-carrying analytic shapes need triangle tables for area
        # sampling; expand() does it for loaded scenes, this for shapes
        # given directly (mitsuba2_tpu/render/scene.py:82-86)
        self.shapes = [s._tessellate() if s.is_analytic()
                       and s.emitter is not None else s for s in self.shapes]
        # collect shape-attached emitters and sensors (scene.cpp:22-59
        # classification); a sensor is re-pointed at the expanded shape
        for s in self.shapes:
            if s.emitter is not None and s.emitter not in self.emitters:
                self.emitters.append(s.emitter)
            sens = s.sensor
            if sens is not None and all(sens is not x for x in self.sensors):
                if hasattr(sens, "set_shape"):
                    sens.set_shape(s)
                self.sensors.append(sens)
        self.environment_emitter = None
        for e in self.emitters:
            if e.is_environment():
                if self.environment_emitter is not None:
                    raise RuntimeError("only one environment emitter allowed")
                self.environment_emitter = e
        self._compile()

    def _register_group_children(self):
        """The meshes of each shared instance's group join ``shapes`` once
        (their BSDFs dispatch as any shape's), marked to stay out of the
        face tables (their ids in ``_group_children``); an emitter in such
        a group raises (mitsuba2_tpu/render/scene.py:133-157)."""
        from ..models.shapes import Instance
        self._group_children = set()
        groups = []
        for s in list(self.shapes):
            if not isinstance(s, Instance) \
                    or any(g is s.group for g in groups):
                continue
            groups.append(s.group)
            for child in s.group.children:
                if child.emitter is not None:
                    raise NotImplementedError(
                        "emitters inside instanced shapegroups are not "
                        "supported (shapegroup.cpp forbids them)")
                if not child.is_mesh():
                    continue
                self._group_children.add(id(child))
                if all(child is not x for x in self.shapes):
                    self.shapes.append(child)

    def _compile(self):
        from ..models.shapes import Instance
        self._register_group_children()
        self.bsdfs = []
        for s in self.shapes:
            if s.bsdf is None:
                from ..models.bsdfs import SmoothDiffuse
                s.bsdf = SmoothDiffuse()
            if all(b is not s.bsdf for b in self.bsdfs):
                self.bsdfs.append(s.bsdf)

        v0s, e1s, e2s, ngs, uvss, face_shape = [], [], [], [], [], []
        spheres, quadrics, instanced = [], [], []
        bb_min = np.full(3, np.inf)
        bb_max = np.full(3, -np.inf)
        for si_idx, s in enumerate(self.shapes):
            if isinstance(s, Instance):
                # the scene's bounds hold the group's placed vertices
                # (mitsuba2_tpu/render/scene.py:180-188)
                instanced.append((si_idx, s))
                M = np.asarray(s.to_world.matrix, np.float64)
                for child in s.group.children:
                    if child.is_mesh() and len(child.vertices):
                        vw = child.vertices @ M[:3, :3].T + M[:3, 3]
                        bb_min = np.minimum(bb_min, vw.min(0))
                        bb_max = np.maximum(bb_max, vw.max(0))
                continue
            if id(s) in self._group_children:
                continue     # packed once in its group's tables
            if s.is_analytic():
                (quadrics if hasattr(s, "prim_row") else spheres).append(
                    (si_idx, s))
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
        self._spheres, self._quadrics = spheres, quadrics
        self.tables = None
        self._pack_values()
        # the ray queries' shape ids and quad rows on the device, copied
        # once (a copy from the host at each query waits for the stream)
        self._face_shape_dev = torch.as_tensor(self.face_shape,
                                               device=self.device)
        self._sphere_shape_dev = torch.as_tensor(self.sphere_shape,
                                                 device=self.device)
        self._quad_dev = torch.as_tensor(self.quad_table, device=self.device)

        self._pack_instances(instanced)
        self._pack_mesh_attributes(perm if self.bvh is not None else None)

        # media in first-seen shape order, interior before exterior
        # (mitsuba2_tpu/render/scene.py:293-312)
        self.media = []
        for s in self.shapes:
            for med in (s.interior_medium, s.exterior_medium):
                if med is not None and all(med is not x
                                           for x in self.media):
                    self.media.append(med)
        self.has_media = bool(self.media)
        self._wire_mesh_attr_textures()

    # plugin values in the kernels' tables
    _VALUE_FIELDS = ("fattr", "lights", "sph", "sattr", "qd", "qattr", "env",
                     "env_marg", "env_cond", "env_pmf", "env_rot", "tex")

    def _pack_values(self):
        """Packs what the kernels' tables hold of the plugins' values: the
        per-face attribute rows (BSDF columns, emission, light pdf), the
        light table, the sphere and quad rows, the bitmap texels and the
        envmap's texels and sampling grid; at load the whole table set,
        after a parameter write (``refresh_tables``) these fields of it,
        the geometry kept. The same code packs both, so an updated scene's
        tables are a fresh load's bit for bit."""
        # the path kernel's environment: an envmap (its gate refuses any
        # other environment emitter, which the wavefront renders)
        from ..models.emitters import EnvironmentMap
        from ..core.object import param_epoch
        env = self.environment_emitter
        if not isinstance(env, EnvironmentMap):
            env = None
        mode = self.color_mode
        spheres, quadrics = self._spheres, self._quadrics
        uvs = self.uvs
        lights, le_face, le_scale, lpdf_w, p_env = _light_table(
            self.emitters, self.shapes, self.face_shape, env is not None,
            mode)
        textures = pk.bitmaps(self.shapes)
        offsets = np.cumsum([0] + [t.rgb.shape[0] * t.rgb.shape[1]
                                   for t in textures])
        cols = [_shape_columns(s.bsdf, mode, textures, offsets)
                for s in self.shapes]

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

        # disks and cylinders (mitsuba2_tpu/render/scene.py:333-350,
        # megakernel.py:2492-2530): quad_table rows [prim_row (24), shape
        # index, flip]; the kernel's rows [A, b, kind, radius, length, 0]
        # and attribute rows with a disk's normal (A's third row,
        # normalized, times flip), identity uv and the flip
        self.quad_table = np.zeros((len(quadrics), 26), np.float32)
        qd = np.zeros((len(quadrics), pk.QD), np.float32)
        qattr = np.zeros((len(quadrics), pk.FA), np.float32)
        for i, (si_idx, s) in enumerate(quadrics):
            row = s.prim_row()
            flip = np.float32(-1.0 if s.flip_normals else 1.0)
            self.quad_table[i] = np.concatenate([row, [si_idx, flip]])
            qd[i, :12] = row[:12]
            qd[i, 12:15] = row[21:24]
            arow = row[6:9]
            qattr[i] = cols[si_idx]
            qattr[i, pk.C_NG:pk.C_NG + 3] = arow / max(
                np.linalg.norm(arow), np.float32(1e-20)) * flip
            qattr[i, pk.C_DUV1] = 1.0
            qattr[i, pk.C_DUV2 + 1] = 1.0
            qattr[i, pk.C_FLIP] = flip
        tex = (np.concatenate([np.pad(t.payload, ((0, 0), (0, 0), (0, 1)))
                               .reshape(-1, 4) for t in textures])
               if textures else None)

        env_t = env_rot = None
        if env is not None:
            env_t = (env_texels(env.data, mode),) \
                + env_sampling_tables(env.data)
            env_rot = np.asarray(env.to_world.matrix, np.float32)[:3, :3]
        if self.tables is None:
            self.tables = pk.pack_tables(
                self.v0, self.e1, self.e2, fattr, lights,
                self.device, sph=sph, sattr=sattr, env=env_t,
                env_rot=env_rot, p_env=p_env, nc=pk.MODE_NC[mode],
                traversal=self.traversal, quads=(qd, qattr), tex=tex)
        else:
            vals = pk.pack_tables(
                np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.float32), fattr, lights, self.device,
                sph=sph, sattr=sattr, env=env_t, env_rot=env_rot,
                p_env=p_env, nc=pk.MODE_NC[mode], quads=(qd, qattr),
                tex=tex)
            self.tables = self.tables._replace(
                **{f: getattr(vals, f) for f in self._VALUE_FIELDS})
        # the light table and per-face emission on the host, for the
        # volumetric kernel's tables (ops/volpath_kernel.py)
        self.light_rows, self.le_face, self.lpdf_w = lights, le_face, lpdf_w
        self._values_epoch = param_epoch()

    def refresh_tables(self):
        """Re-packs the plugin values into the kernels' tables when a
        parameter was written since they were packed
        (``core.object.param_epoch``); the kernel integrators call it
        before they build a kernel object."""
        from ..core.object import param_epoch
        if self._values_epoch != param_epoch():
            self._pack_values()

    def replica(self, device):
        """This scene with its packed tensors on ``device``, for a shard of
        a multi-device render (parallel/mesh.py): the scene itself on its
        own device, else a shallow copy, made once per device and
        parameter epoch, that shares the plugins (each keeps its values
        per device, models/textures.py ``on_device``) and holds its own
        kernel tables, ray-query shape ids and quad rows and instance
        tables; it builds its wavefront tables at first use, and its
        kernel objects are its scene's moved there (``replica_of``,
        models/integrators.py ``_kernel``)."""
        from ..variants import resolve_device
        device = resolve_device(device)
        if device == self.tables.device:
            return self
        self.refresh_tables()
        key = (str(device), self._values_epoch)
        copies = self.__dict__.setdefault("_replicas", {})
        if key not in copies:
            r = copy.copy(self)
            r.__dict__.pop("_wavefront", None)
            r.__dict__.pop("_replicas", None)
            r.device = device
            r.replica_of = self
            r.tables = self.tables.to(device)
            for name in ("_face_shape_dev", "_sphere_shape_dev", "_quad_dev",
                         "_inst_face_shape_dev"):
                if name in self.__dict__:
                    setattr(r, name, getattr(self, name).to(device))
            if self.inst_tables is not None:
                r.inst_tables = self.inst_tables._replace(**{
                    k: v.to(device) for k, v in
                    self.inst_tables._asdict().items()
                    if isinstance(v, torch.Tensor)})
            copies[key] = r
        return copies[key]

    def _pack_instances(self, instanced):
        """The shared instances' tables (``inst_tables``, None without
        any): each group's meshes once, in the group's frame and face order
        (its children's faces one child after another), and each
        instance's row [to-group A (9) | b (3) | to-world B (9) | group |
        shape | 0] (mitsuba2_tpu/render/scene.py:353-409);
        ``inst_face_shape`` each group face's shape index."""
        from ..ops.intersect_kernel import instance_tables
        self.n_instances = len(instanced)
        self.inst_tables = None
        self._inst_children = []
        if not instanced:
            return
        slot, groups, rows = {}, [], []
        for si_idx, inst in instanced:
            if id(inst.group) not in slot:
                slot[id(inst.group)] = len(groups)
                meshes = [c for c in inst.group.children if c.is_mesh()]
                if not sum(len(c.faces) for c in meshes):
                    raise ValueError("an instanced shapegroup without "
                                     "triangles")
                parts = [_mesh_face_arrays(c) for c in meshes]
                groups.append(tuple(np.concatenate([p[k] for p in parts])
                                    .astype(np.float32) for k in range(3)))
                self._inst_children.append(meshes)
            rows.append(np.concatenate([
                inst._A.reshape(9), inst._b.reshape(3), inst._B.reshape(9),
                [slot[id(inst.group)], si_idx, 0.0]]).astype(np.float32))
        self.inst_tables = instance_tables(groups, np.stack(rows),
                                           self.device)
        self.inst_face_shape = np.concatenate([
            np.full(len(c.faces), self.shapes.index(c), np.int32)
            for meshes in self._inst_children for c in meshes])
        self._inst_face_shape_dev = torch.as_tensor(self.inst_face_shape,
                                                    device=self.device)

    def _pack_mesh_attributes(self, perm):
        """``mesh_attr_tables``: for each attribute name any mesh carries
        (``Mesh.add_attribute``), its size k and an (F, 3k) float32 host
        table of each face's three corner values in the scene's face order
        (``perm``), zeros on meshes without it
        (mitsuba2_tpu/render/scene.py:430-458)."""
        meshes = [s for s in self.shapes if _in_face_tables(self, s)]
        sizes = {}
        for s in meshes:
            for name, (k, _) in s.attributes.items():
                sizes.setdefault(name, k)
        self.mesh_attr_tables = {}
        for name, k in sizes.items():
            per = []
            for s in meshes:
                corners = np.zeros((len(s.faces), 3, k), np.float32)
                if name in s.attributes:
                    data = s.attributes[name][1]
                    corners[:] = data[s.faces] if name.startswith(
                        "vertex_") else data[:, None, :]
                per.append(corners)
            tab = np.concatenate(per)
            if perm is not None:
                tab = tab[perm]
            self.mesh_attr_tables[name] = (k, tab.reshape(len(tab), 3 * k))

    def _wire_mesh_attr_textures(self):
        """Hands every ``mesh_attribute`` texture reachable from the
        scene's BSDFs, emitters and media its corner table (the role of
        the reference's per-shape eval_attribute dispatch,
        mesh_attribute.cpp:85)."""
        from ..models.textures import MeshAttributeTexture
        seen = set()

        def walk(obj, depth=0):
            if obj is None or id(obj) in seen or depth > 6:
                return
            seen.add(id(obj))
            if isinstance(obj, MeshAttributeTexture):
                obj.wire(self)
                return
            for v in getattr(obj, "__dict__", {}).values():
                if isinstance(v, Object):
                    walk(v, depth + 1)

        for root in self.bsdfs + self.emitters + self.media:
            walk(root)

    def eval_attribute(self, name, si, active=True):
        """The named mesh attribute at each lane's hit, interpolated with
        the hit's barycentrics -> (n, k); zero where the hit mesh lacks it
        (shape.h eval_attribute)."""
        from ..models.textures import on_device
        k, table = self.mesh_attr_tables[name]
        return corner_lerp(on_device(self, f"attr:{name}", table,
                                     si.t.device), si, k)

    def bbox(self):
        return self._bb_min, self._bb_max

    def traverse(self, cb):
        """Shapes under their ids (``shape_{i}`` without one), emitters
        not attached to a shape (area lights are reached through their
        shape), sensors (mitsuba2_tpu/render/scene.py:1360-1366)."""
        for i, s in enumerate(self.shapes):
            cb.put_object(s.id or f"shape_{i}", s)
        for i, e in enumerate(self.emitters):
            if e.shape is None:
                cb.put_object(e.id or f"emitter_{i}", e)
        for i, s in enumerate(self.sensors):
            cb.put_object(s.id or f"sensor_{i}", s)

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

    def _quad_closest_hit(self, o, d, mint, maxt):
        """Every ray against every disk and cylinder in its object frame,
        the reference's plain pass (mitsuba2_tpu/render/scene.py:564-611)
        -> (t (n,) inf on a miss, quad index (n,) or -1)."""
        tab = self._quad_dev
        t_best = torch.full_like(mint, float("inf"))
        q_best = torch.full(mint.shape, -1, dtype=torch.int32,
                            device=o.device)
        for q in range(len(self.quad_table)):
            A = tab[q, 0:9].reshape(3, 3)
            o_l = o @ A.T + tab[q, 9:12]
            d_l = d @ A.T
            if self.quad_table[q, 21] == 1.0:      # disk
                dz = d_l[:, 2]
                t = -o_l[:, 2] / torch.where(dz.abs() > 1e-12, dz,
                                             float("inf"))
                x = o_l[:, 0] + t * d_l[:, 0]
                y = o_l[:, 1] + t * d_l[:, 1]
                ok = (x * x + y * y <= 1.0) & (t >= mint) & (t <= maxt)
            else:                                  # cylinder
                r, ln = tab[q, 22], tab[q, 23]
                a2 = d_l[:, 0] ** 2 + d_l[:, 1] ** 2
                b2 = 2.0 * (d_l[:, 0] * o_l[:, 0] + d_l[:, 1] * o_l[:, 1])
                c2 = o_l[:, 0] ** 2 + o_l[:, 1] ** 2 - r * r
                disc = b2 * b2 - 4.0 * a2 * c2
                sq = torch.sqrt(torch.clamp(disc, min=0.0))
                inv2a = 1.0 / torch.where(a2.abs() > 1e-20, 2.0 * a2,
                                          float("inf"))
                t_near = (-b2 - sq) * inv2a
                t_far = (-b2 + sq) * inv2a
                zn = o_l[:, 2] + d_l[:, 2] * t_near
                zf = o_l[:, 2] + d_l[:, 2] * t_far
                near_ok = (zn >= 0) & (zn <= ln) & (t_near >= mint) \
                    & (t_near <= maxt)
                far_ok = (zf >= 0) & (zf <= ln) & (t_far >= mint) \
                    & (t_far <= maxt)
                ok = (disc > 0) & (near_ok | far_ok)
                t = torch.where(near_ok, t_near, t_far)
            t = torch.where(ok, t, float("inf"))
            closer = t < t_best
            t_best = torch.where(closer, t, t_best)
            q_best = torch.where(closer, q, q_best)
        return t_best, q_best

    def _inst_face(self, rel):
        """-> (the instance, the row of a group-face table, the groups'
        faces in their order) of the instance prim ids ``rel`` (prim id -
        F - S - Q), clamped into range."""
        inst = self.inst_tables
        rel = rel.clamp(min=0).long()
        k = (rel // inst.g_max).clamp(max=inst.n_instances - 1)
        g = inst.rows[k, 21].long()
        return k, (inst.group_face[g].long() + rel % inst.g_max).clamp(
            max=len(self.inst_face_shape) - 1)

    def _segment_ends(self, ray, active):
        if active is None:
            return ray.maxt
        return torch.where(active, ray.maxt, float("-inf")).contiguous()

    @torch.no_grad()
    def ray_intersect_preliminary(self, ray, active=None):
        """Closest hit of a batch of rays (core/ray.py Ray on the scene's
        device) -> render/records.py PreliminaryIntersection (scene.h;
        mitsuba2_tpu/render/scene.py:637-720). Mesh faces go through K2
        (ops/intersect_kernel.py), the analytic spheres through the
        reference's plain pass, and so do the disks and cylinders after
        them; a sphere hit has prim id F + its index, a disk or cylinder
        hit F + S + its index, and uv 0; the shared instances go through
        K2's instance entry, a hit's prim id F + S + Q + instance * g_max +
        the group's face id. Ties go to faces, then spheres, then disks and
        cylinders, then instances in order. Rays with ``active`` False
        miss."""
        from ..ops.intersect_kernel import isect_closest, isect_closest_inst
        from .records import PreliminaryIntersection
        maxt = self._segment_ends(ray, active)
        t, uv, prim = isect_closest(self.tables, ray.o, ray.d, ray.mint,
                                    maxt)
        n_faces = self.tables.n_faces
        shape_idx = torch.full_like(prim, -1)
        if n_faces:
            shape_idx = self._face_shape_dev[prim.clamp(0, n_faces - 1)
                                             .long()]
        if self.tables.n_spheres:
            ts, s_idx = self._sphere_closest_hit(ray.o, ray.d, ray.mint,
                                                 maxt)
            closer = ts < t
            t = torch.where(closer, ts, t)
            prim = torch.where(closer & (s_idx >= 0), n_faces + s_idx, prim)
            uv = torch.where(closer[:, None], 0.0, uv)
            ss = self._sphere_shape_dev
            shape_idx = torch.where(
                prim >= n_faces,
                ss[(prim - n_faces).clamp(0, len(ss) - 1).long()],
                shape_idx)
        if len(self.quad_table):
            base = n_faces + self.tables.n_spheres
            tq, q_idx = self._quad_closest_hit(ray.o, ray.d, ray.mint, maxt)
            closer = tq < t
            t = torch.where(closer, tq, t)
            prim = torch.where(closer & (q_idx >= 0), base + q_idx, prim)
            uv = torch.where(closer[:, None], 0.0, uv)
            qs = self._quad_dev[(prim - base).clamp(
                0, len(self.quad_table) - 1).long(), 24].to(torch.int32)
            shape_idx = torch.where(prim >= base, qs, shape_idx)
        if self.n_instances:
            base = n_faces + self.tables.n_spheres + len(self.quad_table)
            ti, uvi, pi_ = isect_closest_inst(self.inst_tables, ray.o,
                                              ray.d, ray.mint, maxt)
            closer = ti < t
            t = torch.where(closer, ti, t)
            prim = torch.where(closer & (pi_ >= 0), base + pi_, prim)
            uv = torch.where(closer[:, None], uvi, uv)
            # the shape from the group face's column
            # (mitsuba2_tpu/render/scene.py:702-713)
            shape_idx = torch.where(
                prim >= base,
                self._inst_face_shape_dev[self._inst_face(prim - base)[1]],
                shape_idx)
        shape_idx = torch.where(prim >= 0, shape_idx, -1)
        return PreliminaryIntersection(t, uv, shape_idx.to(torch.int32),
                                       prim.to(torch.int32))

    @torch.no_grad()
    def ray_test(self, ray, active=None):
        """Whether each ray is occluded within its [mint, maxt] (scene.h
        ray_test; mitsuba2_tpu/render/scene.py:965-989): mesh faces through
        K2's any-hit entry, the shared instances through its instance
        entry, spheres, disks and cylinders through the plain passes ->
        (n,) bool."""
        from ..ops.intersect_kernel import isect_any, isect_any_inst
        maxt = self._segment_ends(ray, active)
        hit = isect_any(self.tables, ray.o, ray.d, ray.mint, maxt)
        if self.n_instances:
            hit = hit | isect_any_inst(self.inst_tables, ray.o, ray.d,
                                       ray.mint, maxt)
        if self.tables.n_spheres:
            ts, _ = self._sphere_closest_hit(ray.o, ray.d, ray.mint, maxt)
            hit = hit | torch.isfinite(ts)
        if len(self.quad_table):
            tq, _ = self._quad_closest_hit(ray.o, ray.d, ray.mint, maxt)
            hit = hit | torch.isfinite(tq)
        return hit

    # ------------------------------------------------------------ wavefront
    # The general wavefront's queries (mitsuba2_tpu/render/scene.py:722-
    # 1099, :1179-1359): a full surface interaction at each closest hit,
    # emitter evaluation and sampling with the shadow ray through
    # ``ray_test``, and the BSDF dispatch. Its tables are built at its
    # first render and rebuilt when the shapes, their BSDFs or the
    # emitters change (tests edit a loaded scene).

    def wavefront_tables(self):
        """The wavefront's device tables (``WavefrontTables``)."""
        key = (tuple(id(s) for s in self.shapes),
               tuple(id(s.bsdf) for s in self.shapes),
               tuple(id(e) for e in self.emitters))
        cached = getattr(self, "_wavefront", None)
        if cached is None or cached[0] != key:
            cached = (key, _wavefront_tables(self))
            self._wavefront = cached
        return cached[1]

    def compute_surface_interaction(self, ray, pi, wavelengths=None):
        """The full record at each preliminary hit ``pi`` of ``ray``
        (mitsuba2_tpu/render/scene.py:722-910): position, geometric
        normal, shading frame (interpolated vertex normals, the uv
        tangent dp_du made orthogonal to them), uv, wi in the frame, and
        the shape's BSDF and emitter ids; spheres, disks and cylinders
        analytically; a shared instance's hit from its group face's rows,
        placed by the instance's transform, with no emitter."""
        from ..core.frame import Frame
        from .interaction import SurfaceInteraction
        wf = self.wavefront_tables()
        valid = pi.is_valid()
        F, S, Q = wf.n_faces, wf.n_spheres, wf.n_quads
        f = pi.prim_idx.clamp(0, max(F - 1, 0)).long()
        A = wf.face_attr[f]
        ints = wf.face_ints[f]
        v0, e1, e2 = A[:, 0:3], A[:, 3:6], A[:, 6:9]
        ng = A[:, 9:12]
        n0, n1, n2 = A[:, 12:15], A[:, 15:18], A[:, 18:21]
        uv0, uv1, uv2 = A[:, 21:23], A[:, 23:25], A[:, 25:27]
        dp_du, dp_dv = A[:, 27:30], A[:, 30:33]
        shape_idx, bsdf_idx, emitter_idx = ints[:, 0], ints[:, 1], ints[:, 2]
        # a miss's t (inf) kept out of the products with the ray, whose
        # direction a differentiable render may trace: inf times a zero
        # gradient would be NaN
        t_hit = torch.where(valid, pi.t, 0.0)[:, None]
        w0 = (1.0 - pi.prim_uv[:, 0] - pi.prim_uv[:, 1])[:, None]
        wu, wv = pi.prim_uv[:, 0:1], pi.prim_uv[:, 1:2]
        p = v0 + e1 * wu + e2 * wv
        ns = m.normalize(n0 * w0 + n1 * wu + n2 * wv)
        uv = uv0 * w0 + uv1 * wu + uv2 * wv
        if S:
            # sphere.cpp compute_surface_interaction: the exact normal
            # (flipped with flip_normals), spherical uv, analytic tangents
            is_sph = (pi.prim_idx >= F) & (pi.prim_idx < F + S)
            row = wf.sph[(pi.prim_idx - F).clamp(0, S - 1).long()]
            c, r, flip = row[:, 0:3], row[:, 3:4], row[:, 9:10]
            p_s = ray.o + t_hit * ray.d
            n_s = m.normalize(p_s - c) * flip
            p_s = c + n_s * flip * r
            phi = torch.atan2(n_s[:, 1], n_s[:, 0])
            theta = torch.acos(torch.clamp(n_s[:, 2] * flip[:, 0], -1.0,
                                           1.0))
            uv_s = torch.stack([phi / (2 * m.Pi) + 0.5, theta / m.Pi], -1)
            dpdu_s = torch.stack([-n_s[:, 1], n_s[:, 0],
                                  torch.zeros_like(phi)], -1) \
                * (2 * m.Pi * r)
            sin_t = torch.sqrt(torch.clamp(
                1.0 - (n_s[:, 2] * flip[:, 0]) ** 2, min=1e-12))
            dpdv_s = torch.stack([
                n_s[:, 2] * torch.cos(phi), n_s[:, 2] * torch.sin(phi),
                -sin_t * flip[:, 0]], -1) * (m.Pi * r)
            w = is_sph[:, None]
            p = torch.where(w, p_s, p)
            ng = torch.where(w, n_s, ng)
            ns = torch.where(w, n_s, ns)
            uv = torch.where(w, uv_s, uv)
            dp_du = torch.where(w, dpdu_s, dp_du)
            dp_dv = torch.where(w, dpdv_s, dp_dv)
            ids = row[:, 4:7].to(torch.int32)
            shape_idx = torch.where(is_sph, ids[:, 0], shape_idx)
            bsdf_idx = torch.where(is_sph, ids[:, 1], bsdf_idx)
            emitter_idx = torch.where(is_sph, ids[:, 2], emitter_idx)
        if Q:
            p, ng, ns, uv, dp_du, dp_dv, shape_idx, bsdf_idx, emitter_idx \
                = _quad_interaction(wf, ray, pi, p, ng, ns, uv, dp_du,
                                    dp_dv, shape_idx, bsdf_idx, emitter_idx)
        if self.n_instances:
            # the group face's rows in its frame, placed by the instance:
            # normals through A^T, tangents through B, the position on the
            # ray (mitsuba2_tpu/render/scene.py:849-880)
            base = F + S + Q
            is_i = pi.prim_idx >= base
            k, f_l = self._inst_face(pi.prim_idx - base)
            row = self.inst_tables.rows[k]
            Ar, ints_i = wf.inst_attr[f_l], wf.inst_ints[f_l]
            A_t = row[:, 0:9].reshape(-1, 3, 3)
            B_t = row[:, 12:21].reshape(-1, 3, 3)
            ns_l = Ar[:, 12:15] * w0 + Ar[:, 15:18] * wu + Ar[:, 18:21] * wv
            uv_l = Ar[:, 21:23] * w0 + Ar[:, 23:25] * wu + Ar[:, 25:27] * wv
            w = is_i[:, None]
            p = torch.where(w, ray.o + t_hit * ray.d, p)
            ng = torch.where(w, m.normalize(torch.einsum(
                "ni,nij->nj", Ar[:, 9:12], A_t)), ng)
            ns = torch.where(w, m.normalize(torch.einsum(
                "ni,nij->nj", ns_l, A_t)), ns)
            uv = torch.where(w, uv_l, uv)
            dp_du = torch.where(w, torch.einsum("nij,nj->ni", B_t,
                                                Ar[:, 27:30]), dp_du)
            dp_dv = torch.where(w, torch.einsum("nij,nj->ni", B_t,
                                                Ar[:, 30:33]), dp_dv)
            shape_idx = torch.where(is_i, ints_i[:, 0], shape_idx)
            bsdf_idx = torch.where(is_i, ints_i[:, 1], bsdf_idx)
            emitter_idx = torch.where(is_i, -1, emitter_idx)
        # Gram-Schmidt of dp_du against the shading normal (mesh.cpp:463),
        # a constructed tangent where it degenerates
        s_axis = m.normalize(dp_du - ns * m.dot(ns, dp_du)[:, None])
        deg = m.squared_norm(s_axis) < 0.5
        fallback_s, _ = m.coordinate_system(ns)
        s_axis = torch.where(deg[:, None], fallback_s, s_axis)
        t_axis = m.normalize(m.cross(ns, s_axis))
        frame = Frame(s_axis, t_axis, ns)
        none = torch.full_like(shape_idx, -1)
        return SurfaceInteraction(
            t=torch.where(valid, pi.t, float("inf")), p=p, n=ng,
            sh_frame=frame, uv=uv, wi=frame.to_local(-ray.d), dp_du=dp_du,
            dp_dv=dp_dv, shape_idx=torch.where(valid, shape_idx, none),
            prim_idx=pi.prim_idx, wavelengths=wavelengths,
            bsdf_idx=torch.where(valid, bsdf_idx, none),
            emitter_idx=torch.where(valid, emitter_idx, none),
            prim_uv=pi.prim_uv)

    def ray_intersect(self, ray, active=None, wavelengths=None):
        """(scene.h:38) the closest hit as a full SurfaceInteraction."""
        pi = self.ray_intersect_preliminary(ray, active)
        return self.compute_surface_interaction(ray, pi, wavelengths)

    def emitter_index_at(self, si):
        """The emitter of each lane: its surface's, or the environment's
        where the lane escaped, -1 for none."""
        env = self.wavefront_tables().env_index
        return torch.where(si.is_valid(), si.emitter_idx, env)

    def eval_emitter(self, si, ray_d, active):
        """Radiance of the emitter each lane sees (its surface's, or the
        environment's along ``ray_d`` where it escaped), zero
        otherwise."""
        from ..models.emitters import env_lookup_si
        from ..variants import current
        out = torch.zeros((si.t.shape[0], current().n_channels),
                          device=si.t.device)
        em_idx = self.emitter_index_at(si)
        for i, e in enumerate(self.emitters):
            mask = active & (em_idx == i)
            look = env_lookup_si(ray_d, si) if e.is_environment() else si
            out = torch.where(mask[:, None], e.eval(look, mask), out)
        return out

    def sample_emitter_direction(self, si, sample, active,
                                 test_visibility=True):
        """(scene.cpp:165-214) a uniformly picked emitter's direction
        sample seen from each lane and its radiance over the pdf, zero
        where its pdf is; with ``test_visibility`` also where the shadow
        ray (``ray_test``) is blocked."""
        from ..variants import current
        from .records import select, zero_direction_sample
        n, dev = si.t.shape[0], si.t.device
        n_em = len(self.emitters)
        if n_em == 0:
            return zero_direction_sample(n, dev), torch.zeros(
                (n, current().n_channels), device=dev)
        bsphere = self.wavefront_tables().bsphere

        def sample_one(i, sample, mask):
            ds, spec = self.emitters[i].sample_direction(si, sample, mask,
                                                         bsphere)
            return ds._replace(emitter_idx=torch.full_like(
                ds.emitter_idx, i)), spec

        if n_em == 1:
            ds, spec = sample_one(0, sample, active)
        else:
            index = torch.clamp((sample[:, 0] * n_em).to(torch.int32),
                                max=n_em - 1)
            sample = torch.stack(
                [sample[:, 0] * n_em - index.to(sample.dtype),
                 sample[:, 1]], -1)
            ds = zero_direction_sample(n, dev)
            spec = torch.zeros((n, current().n_channels), device=dev)
            for i in range(n_em):
                mask = active & (index == i)
                ds_i, spec_i = sample_one(i, sample, mask)
                ds = select(mask, ds_i, ds)
                spec = torch.where(mask[:, None], spec_i, spec)
            ds = ds._replace(pdf=ds.pdf * (1.0 / n_em))
            spec = spec * n_em
        active = active & (ds.pdf != 0)
        if test_visibility:
            active = active & ~self.shadow_test(si, ds, active)
        return ds, torch.where(active[:, None], spec, 0.0)

    def shadow_test(self, si, ds, active):
        """Whether the segment from each lane toward its direction sample
        is blocked: the shadow ray with scene.cpp:204-206's offsets
        through ``ray_test``."""
        mint = m.RayEpsilon * (1.0 + si.p.abs().amax(-1))
        maxt = ds.dist * (1.0 - m.ShadowEpsilon)
        return self.ray_test(Ray(si.p.contiguous(), ds.d.contiguous(),
                                 mint.contiguous(), maxt.contiguous()),
                             active)

    def pdf_emitter_direction(self, si, ds, active):
        """(scene.cpp pdf_emitter_direction) the solid-angle density with
        which ``sample_emitter_direction`` picks ``ds``."""
        n_em = len(self.emitters)
        pdf = torch.zeros_like(si.t)
        for i, e in enumerate(self.emitters):
            mask = active & (ds.emitter_idx == i)
            pdf = torch.where(mask, e.pdf_direction(si, ds, mask), pdf)
        return pdf * (1.0 / n_em) if n_em else pdf

    def bsdf_flags_at(self, si):
        """Each lane's BSDFFlags (int32), 0 where it has no BSDF."""
        flags = self.wavefront_tables().bsdf_flags
        return torch.where(si.bsdf_idx >= 0,
                           flags[si.bsdf_idx.clamp(min=0).long()], 0)

    def bsdf_partition(self, si, active):
        """The lanes of each BSDF, by compaction: lanes with a BSDF and
        ``active`` sorted by BSDF index (a stable sort, so each BSDF's
        lanes stay in lane order) and cut at the lane counts, read on the
        host: the dispatch's one host sync -> a list of (BSDF, int64 lane
        indices)."""
        bsdfs = self.wavefront_tables().bsdfs
        nb = len(bsdfs)
        key = torch.where(active & (si.bsdf_idx >= 0), si.bsdf_idx,
                          nb).long()
        sorted_key, order = torch.sort(key, stable=True)
        # each BSDF's first place in the sorted keys (bincount would read
        # the keys' maximum on the host first)
        starts = torch.searchsorted(sorted_key, torch.arange(
            nb + 1, device=key.device)).tolist()
        return [(b, order[starts[i]:starts[i + 1]])
                for i, b in enumerate(bsdfs) if starts[i + 1] > starts[i]]

    def bsdf_eval_pdf(self, ctx, si, wo, active, parts):
        """Each partition lane's BSDF value and pdf for ``wo``, evaluated
        on its BSDF's lanes only and scattered back; zero elsewhere."""
        from ..variants import current
        val = torch.zeros((si.t.shape[0], current().n_channels),
                          device=si.t.device)
        pdf = torch.zeros_like(si.t)
        for b, idx in parts:
            sub, act = si.take(idx), active[idx]
            val[idx] = b.eval(ctx, sub, wo[idx], act)
            pdf[idx] = b.pdf(ctx, sub, wo[idx], act)
        return val, pdf

    def bsdf_index_at(self, si):
        """Each lane's BSDF index into the wavefront's BSDFs, -1 for
        none."""
        return si.bsdf_idx

    def bsdf_eval(self, ctx, si, wo, active, parts):
        """``bsdf_eval_pdf``'s value alone (the volpath NEE without MIS
        reads no pdf)."""
        from ..variants import current
        val = torch.zeros((si.t.shape[0], current().n_channels),
                          device=si.t.device)
        for b, idx in parts:
            act = active[idx]
            val[idx] = torch.where(act[:, None], b.eval(
                ctx, si.take(idx), wo[idx], act), 0.0)
        return val

    def bsdf_pdf(self, ctx, si, wo, active, parts):
        """``bsdf_eval_pdf``'s pdf alone."""
        pdf = torch.zeros_like(si.t)
        for b, idx in parts:
            act = active[idx]
            pdf[idx] = torch.where(act, b.pdf(ctx, si.take(idx), wo[idx],
                                              act), 0.0)
        return pdf

    def bsdf_sample(self, ctx, si, sample1, sample2, active, parts):
        """Each partition lane's BSDF sample and weight (value / pdf),
        evaluated on its BSDF's lanes only and scattered back; the zero
        sample elsewhere."""
        from ..variants import current
        from .bsdf import zero_bsdf_sample
        n, dev = si.t.shape[0], si.t.device
        bs = zero_bsdf_sample(n, dev)
        val = torch.zeros((n, current().n_channels), device=dev)
        for b, idx in parts:
            bs_i, val_i = b.sample(ctx, si.take(idx), sample1[idx],
                                   sample2[idx], active[idx])
            for dst, src in zip(bs, bs_i):
                dst[idx] = src
            val[idx] = val_i
        return bs, val

    def bsdf_eval_pol(self, ctx, si, wo, active, parts):
        """``bsdf_eval``'s value as Mueller matrices (n, C, 4, 4), each
        BSDF's ``eval_pol`` on its partition lanes; zero elsewhere."""
        from ..variants import current
        val = torch.zeros((si.t.shape[0], current().n_channels, 4, 4),
                          device=si.t.device)
        for b, idx in parts:
            act = active[idx]
            val[idx] = torch.where(act[:, None, None, None], b.eval_pol(
                ctx, si.take(idx), wo[idx], act), 0.0)
        return val

    def bsdf_sample_pol(self, ctx, si, sample1, sample2, active, parts):
        """``bsdf_sample`` with the weights as Mueller matrices (n, C, 4,
        4), each BSDF's ``sample_pol`` on its partition lanes."""
        from ..variants import current
        from .bsdf import zero_bsdf_sample
        n, dev = si.t.shape[0], si.t.device
        bs = zero_bsdf_sample(n, dev)
        val = torch.zeros((n, current().n_channels, 4, 4), device=dev)
        for b, idx in parts:
            bs_i, val_i = b.sample_pol(ctx, si.take(idx), sample1[idx],
                                       sample2[idx], active[idx])
            for dst, src in zip(bs, bs_i):
                dst[idx] = src
            val[idx] = val_i
        return bs, val

    # ------------------------------------------------------------ media
    # The volpath wavefront's medium queries (mitsuba2_tpu/render/
    # scene.py:1097-1178): each medium's method on the lanes inside it,
    # merged by the lanes' medium indices (-1: no medium).

    def medium_sample_interaction(self, ray, u, channel, medium_idx, active,
                                  wavelengths=None):
        """A collision sample in each lane's medium (models/media.py
        ``Medium.sample_interaction``), the empty record elsewhere."""
        from ..variants import current
        from .interaction import zero_mi
        from .records import select
        mi = zero_mi(ray.o.shape[0], current().n_channels, ray.o.device,
                     wavelengths)
        for i, med in enumerate(self.media):
            mask = active & (medium_idx == i)
            mi = select(mask, med.sample_interaction(
                ray, u, channel, mask, i, wavelengths), mi)
        return mi

    def medium_eval_tr_and_pdf(self, mi, si_t, medium_idx, active):
        """(transmittance, free-flight pdf) (n, C) in each lane's medium,
        ones elsewhere; every medium shares the function
        (``Medium.eval_tr_and_pdf``)."""
        from ..models.media import Medium
        tr, pdf = Medium.eval_tr_and_pdf(mi, si_t)
        inside = (active & (medium_idx >= 0))[:, None]
        return (torch.where(inside, tr, 1.0), torch.where(inside, pdf, 1.0))

    def medium_phase_sample(self, mi, medium_idx, u2, active):
        """A direction from each lane's phase function and its pdf; +z
        and 0 elsewhere."""
        n, dev = mi.t.shape[0], mi.t.device
        wo = torch.zeros((n, 3), device=dev)
        wo[:, 2] = 1.0
        pdf = torch.zeros((n,), device=dev)
        for i, med in enumerate(self.media):
            mask = active & (medium_idx == i)
            wo_i, pdf_i = med.phase_function.sample(mi, u2, mask)
            wo = torch.where(mask[:, None], wo_i, wo)
            pdf = torch.where(mask, pdf_i, pdf)
        return wo, pdf

    def medium_phase_eval(self, mi, wo, medium_idx, active):
        """Each lane's phase function value for ``wo``, 0 elsewhere."""
        out = torch.zeros_like(mi.t)
        for i, med in enumerate(self.media):
            mask = active & (medium_idx == i)
            out = torch.where(mask, med.phase_function.eval(mi, wo, mask),
                              out)
        return out

    def medium_transition(self, si, d, medium_idx, active):
        """Each lane's medium after it crosses its hit's surface along d
        (interaction.h target_medium): the shape's interior medium where
        d enters (d . n < 0), its exterior one where it leaves, unchanged
        where the shape bounds no medium. The media are the hit shape's
        own, for every kind of primitive (the reference reads the face
        or sphere columns at a disk's or cylinder's prim id: ROADMAP
        queue 3); a shared instance's faces bound none."""
        sm = self.wavefront_tables().shape_media[
            si.shape_idx.clamp(min=0).long()]
        has_int, has_ext = sm[:, 0], sm[:, 1]
        crossing = active & (si.shape_idx >= 0) & ((has_int >= 0)
                                                   | (has_ext >= 0))
        if self.n_instances:
            # an instance's faces bound no medium (their columns hold -1,
            # mitsuba2_tpu/render/scene.py:382-384)
            wf = self.wavefront_tables()
            crossing &= si.prim_idx < wf.n_faces + wf.n_spheres + wf.n_quads
        target = torch.where(m.dot(d, si.n) < 0, has_int, has_ext)
        return torch.where(crossing, target, medium_idx)


def corner_lerp(table, si, k, fn=None):
    """Rows ``si.prim_idx`` of an (F, 3k) corner table, each corner's k
    values (through ``fn`` when given) weighted by the hit's barycentrics
    (1 - u - v, u, v) and summed in that order -> (n, k) (or fn's width).
    Lanes that hit no face read the nearest row (a plain index gather; the
    JAX package's one-hot matmul, ops/gather.py, is a TPU workaround)."""
    rows = table[si.prim_idx.clamp(0, table.shape[0] - 1).long()]
    rows = rows.reshape(-1, 3, k)
    bu, bv = si.prim_uv[:, 0:1], si.prim_uv[:, 1:2]
    out = 0.0
    for c, wt in enumerate((1.0 - bu - bv, bu, bv)):
        out = out + wt * (rows[:, c] if fn is None else fn(rows[:, c]))
    return out


def _shape_columns(bsdf, mode, textures, offsets):
    """A shape's BSDF columns of the attribute row (ops/path_kernel.py
    C_*) in color mode ``mode``: kind, albedo, color1, alpha, eta, k, the
    IOR fit span, to_uv, the dielectric's and plastics' parameters and a
    bitmap's texel region (its first texel: ``offsets`` at its index in
    ``textures``), as megakernel.py:2327-2432 and _shape_albedo /
    _shape_c1 (:2685-2726) set them. Zeros for a BSDF the path kernel
    refuses (the integrator's gate refuses the scene before the table is
    read)."""
    from ..models.bsdfs import (SmoothDiffuse, RoughConductor,
                                SmoothDielectric, SmoothPlastic)
    from ..models.textures import (CheckerboardTexture, BitmapTexture,
                                   mono_luminance)
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
        elif type(tex) is BitmapTexture:
            row[pk.C_KIND] = pk.KIND_BITMAP
            i = next(k for k, t in enumerate(textures) if t is tex)
            row[pk.C_TEX:pk.C_TEX + 3] = (offsets[i], *tex.resolution)
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
    elif type(bsdf) is SmoothDielectric:
        row[pk.C_KIND] = pk.KIND_DIELECTRIC
        row[pk.C_ALB:pk.C_ALB + 3] = bsdf.specular_reflectance.payload()
        row[pk.C_C1:pk.C_C1 + 3] = bsdf.specular_transmittance.payload()
        row[pk.C_ETAD] = bsdf.eta
    else:                                   # smooth or rough plastic
        rough = type(bsdf) is not SmoothPlastic
        row[pk.C_KIND] = pk.KIND_ROUGHPLASTIC if rough else pk.KIND_PLASTIC
        if rough:
            row[pk.C_ALPHA] = bsdf.alpha_u
        row[pk.C_ALB:pk.C_ALB + 3] = bsdf.diffuse_reflectance.payload()
        row[pk.C_C1:pk.C_C1 + 3] = bsdf.specular_reflectance.payload()
        row[pk.C_ETAD:pk.C_NONLIN + 1] = (
            bsdf.eta, bsdf.specular_sampling_weight, bsdf.fdr_int,
            bsdf.inv_eta_2, 1.0 if bsdf.nonlinear else 0.0)
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
    linear rgb and 0, the mono value repeated and 0, or the sigmoid
    coefficients and the D65 scale (spectral, srgb_d65.cpp). In rgb and
    mono any uniform radiance (a color, a uniform spectrum, a curve) packs
    its value at one lane, as the wavefront evaluates it. Zeros for a
    radiance the kernels refuse: a spatially varying one, or one without
    the srgb_d65 payload in spectral mode."""
    if mode == "spectral":
        if not hasattr(radiance, "_d65_scale"):
            return np.zeros(3, np.float32), 0.0
        return np.asarray(radiance._coeff, np.float32), radiance._d65_scale
    if radiance.is_spatially_varying():
        return np.zeros(3, np.float32), 0.0
    one = torch.zeros(1)
    value = radiance.eval(SimpleNamespace(t=one, uv=torch.zeros(1, 2),
                                          wavelengths=None))
    return np.broadcast_to(value.reshape(-1).numpy().astype(np.float32),
                           (3,)).copy(), 0.0


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


class WavefrontTables(NamedTuple):
    """The wavefront's tables on the scene's device: per face (in the
    scene's face order) v0, e1, e2, ng, the corner normals, the corner
    uvs and the uv tangents (F, 33) and the shape, BSDF and emitter ids
    (F, 3); sphere rows (S, 10) [center, radius, shape, bsdf, emitter, -,
    -, flip]; disk and cylinder rows (Q, 32) [prim_row (24), shape, bsdf,
    emitter, -, -, flip, -, -] (the JAX scene's layouts); the BSDFs (in
    the order of their ids) and their flags; the environment emitter's
    index, -1 without one; each shape's media."""
    n_faces: int
    n_spheres: int
    n_quads: int
    face_attr: torch.Tensor
    face_ints: torch.Tensor
    sph: torch.Tensor
    quad: torch.Tensor
    bsdfs: list
    bsdf_flags: torch.Tensor
    env_index: int
    # the scene's bounding sphere (center (3,), radius): the envmap's
    # sample_direction places its points outside it
    bsphere: tuple
    # each shape's interior and exterior medium (S, 2) int32, indices
    # into scene.media, -1 for none: every primitive's media through its
    # shape id, faces, spheres, disks and cylinders alike
    shape_media: torch.Tensor
    # the shared instances' group faces in the groups' frames and face
    # order, as face_attr (Fg, 33) and face_ints (Fg, 3) (emitter -1);
    # empty without instances
    inst_attr: torch.Tensor
    inst_ints: torch.Tensor


def _shading_arrays(s):
    """Corner shading normals (f, 3, 3) and the uv tangents dp_du, dp_dv
    (f, 3) of one mesh, as mitsuba2_tpu/render/scene.py _mesh_face_arrays
    computes them: the vertex normals unless the mesh is flat, the
    tangents of the uv parameterization (the edges where it
    degenerates)."""
    v0, e1, e2, ng, uvs = _mesh_face_arrays(s)
    if s.normals is not None and not s.face_normals_only:
        ns = s.normals[s.faces]
    else:
        ns = np.repeat(ng[:, None, :], 3, axis=1)
    duv1 = uvs[:, 1] - uvs[:, 0]
    duv2 = uvs[:, 2] - uvs[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    ok = np.abs(det) > 1e-9
    inv = np.where(ok, 1.0 / np.where(det == 0, 1.0, det), 0.0)
    dp_du = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) * inv[:, None]
    dp_dv = (-duv2[:, 0:1] * e1 + duv1[:, 0:1] * e2) * inv[:, None]
    dp_du = np.where(ok[:, None], dp_du, e1)
    dp_dv = np.where(ok[:, None], dp_dv, e2)
    return ns, dp_du, dp_dv


def _wavefront_tables(scene):
    shapes = scene.shapes
    bsdfs = []
    for s in shapes:
        if all(b is not s.bsdf for b in bsdfs):
            bsdfs.append(s.bsdf)
    shape_bsdf = [next(i for i, b in enumerate(bsdfs) if b is s.bsdf)
                  for s in shapes]
    shape_emitter = [scene.emitters.index(s.emitter)
                     if s.emitter is not None else -1 for s in shapes]
    parts = [_shading_arrays(s) for s in shapes
             if _in_face_tables(scene, s)]
    F = len(scene.face_shape)
    attr = np.zeros((max(F, 1), 33), np.float32)
    ints = np.full((max(F, 1), 3), -1, np.int32)
    if F:
        ns, dp_du, dp_dv = (np.concatenate([p[k] for p in parts])
                            for k in range(3))
        if scene.bvh is not None:
            perm = scene.bvh.order
            ns, dp_du, dp_dv = ns[perm], dp_du[perm], dp_dv[perm]
        attr[:F] = _attr_rows(scene.v0, scene.e1, scene.e2, scene.ng, ns,
                              scene.uvs, dp_du, dp_dv)
        fs = scene.face_shape
        ints[:F] = np.stack([fs, np.asarray(shape_bsdf)[fs],
                             np.asarray(shape_emitter)[fs]], 1)
    else:
        # a face no ray hits, its normals +z (the JAX scene's dummy face)
        attr[0, [11, 14, 17, 20]] = 1.0
    S = len(scene.sphere_shape)
    sph = np.zeros((max(S, 1), 10), np.float32)
    sph_np = scene.tables.sph.cpu().numpy()
    for i, si_idx in enumerate(scene.sphere_shape):
        sph[i, :4] = sph_np[i]
        sph[i, 4:7] = (si_idx, shape_bsdf[si_idx], shape_emitter[si_idx])
        sph[i, 7:9] = -1.0
        sph[i, 9] = -1.0 if shapes[si_idx].flip_normals else 1.0
    Q = len(scene.quad_table)
    quad = np.zeros((max(Q, 1), 32), np.float32)
    for i, row in enumerate(scene.quad_table):
        si_idx = int(row[24])
        quad[i, :24] = row[:24]
        quad[i, 24:27] = (si_idx, shape_bsdf[si_idx], shape_emitter[si_idx])
        quad[i, 27:29] = -1.0
        quad[i, 29] = row[25]
    def medium_index(med):
        return next((i for i, x in enumerate(scene.media) if x is med), -1)

    media = [[medium_index(s.interior_medium), medium_index(s.exterior_medium)]
             for s in shapes] or [[-1, -1]]
    inst_attr = np.zeros((0, 33), np.float32)
    inst_ints = np.zeros((0, 3), np.int32)
    if scene.n_instances:
        rows = []
        for c in (c for meshes in scene._inst_children for c in meshes):
            v0, e1, e2, ng, uvs = _mesh_face_arrays(c)
            ns, dp_du, dp_dv = _shading_arrays(c)
            rows.append(_attr_rows(v0, e1, e2, ng, ns, uvs, dp_du, dp_dv))
        inst_attr = np.concatenate(rows)
        fs = scene.inst_face_shape
        inst_ints = np.stack([fs, np.asarray(shape_bsdf)[fs],
                              np.full(len(fs), -1)], 1).astype(np.int32)
    env = scene.environment_emitter
    c, r = _bounding_sphere(scene)
    dev = scene.device
    return WavefrontTables(
        F, S, Q, torch.as_tensor(attr, device=dev),
        torch.as_tensor(ints, device=dev), torch.as_tensor(sph, device=dev),
        torch.as_tensor(quad, device=dev), bsdfs,
        torch.as_tensor([int(b.flags()) for b in bsdfs] or [0],
                        dtype=torch.int32, device=dev),
        scene.emitters.index(env) if env is not None else -1,
        (torch.as_tensor(c, device=dev), r),
        torch.as_tensor(media, dtype=torch.int32, device=dev),
        torch.as_tensor(inst_attr, device=dev),
        torch.as_tensor(inst_ints, device=dev))


def _attr_rows(v0, e1, e2, ng, ns, uvs, dp_du, dp_dv):
    """Per-face wavefront rows (f, 33): v0, e1, e2, ng, the three corner
    normals, the three corner uvs, dp_du, dp_dv."""
    return np.concatenate([v0, e1, e2, ng, ns[:, 0], ns[:, 1], ns[:, 2],
                           uvs[:, 0], uvs[:, 1], uvs[:, 2], dp_du, dp_dv],
                          1).astype(np.float32)


def _in_face_tables(scene, s):
    """Whether ``scene``'s face tables hold the triangles of ``s``: a mesh
    that is neither a shared instance nor a mesh of an instanced
    group."""
    from ..models.shapes import Instance
    return (s.is_mesh() and not s.is_analytic()
            and not isinstance(s, Instance)
            and id(s) not in scene._group_children)


def _bounding_sphere(scene):
    """The scene's bounding sphere (center float32 (3,), radius) of its
    bounding box (mitsuba2_tpu/render/scene.py bounding_sphere)."""
    lo, hi = scene._bb_min, scene._bb_max
    if not (np.all(np.isfinite(lo)) and np.all(np.isfinite(hi))):
        return np.zeros(3, np.float32), 1.0
    c = 0.5 * (lo + hi)
    return c.astype(np.float32), max(float(np.linalg.norm(hi - c)), 1e-3)


def _quad_interaction(wf, ray, pi, p, ng, ns, uv, dp_du, dp_dv, shape_idx,
                      bsdf_idx, emitter_idx):
    """Overlay the disk and cylinder lanes' analytic records (disk.cpp:
    182-225 uv and tangents; cylinder.cpp:336-390 with its roundoff
    re-projection along the normal) on the face records."""
    F, S, Q = wf.n_faces, wf.n_spheres, wf.n_quads
    is_q = (pi.prim_idx >= F + S) & (pi.prim_idx < F + S + Q)
    row = wf.quad[(pi.prim_idx - F - S).clamp(0, Q - 1).long()]
    A = row[:, 0:9].reshape(-1, 3, 3)
    b = row[:, 9:12]
    B = row[:, 12:21].reshape(-1, 3, 3)
    r_c, len_c = row[:, 22], row[:, 23]
    flip = row[:, 29:30]
    p_q = ray.o + torch.where(pi.is_valid(), pi.t, 0.0)[:, None] * ray.d
    local = torch.einsum("nij,nj->ni", A, p_q) + b
    lx, ly, lz = local[:, 0], local[:, 1], local[:, 2]
    is_disk = row[:, 21] < 1.5
    zero = torch.zeros_like(lx)
    # disk: uv = (r, phi / 2 pi), tangents rotating with phi
    r_d = torch.sqrt(torch.clamp(lx * lx + ly * ly, min=0.0))
    phi = torch.atan2(ly, lx)
    v_d = phi / (2 * m.Pi)
    v_d = torch.where(v_d < 0, v_d + 1.0, v_d)
    inv_r = m.safe_div(torch.ones_like(r_d), r_d, 0.0)
    cos_phi = torch.where(r_d > 0, lx * inv_r, 1.0)
    sin_phi = torch.where(r_d > 0, ly * inv_r, 0.0)
    uv_disk = torch.stack([r_d, v_d], -1)
    dpdu_disk = torch.einsum("nij,nj->ni", B,
                             torch.stack([cos_phi, sin_phi, zero], -1))
    dpdv_disk = torch.einsum("nij,nj->ni", B,
                             torch.stack([-sin_phi, cos_phi, zero], -1))
    n_disk = m.normalize(A[:, 2, :]) * flip
    # cylinder: uv = (phi / 2 pi, z / length), n from the tangents
    phi_c = torch.where(phi < 0, phi + 2 * m.Pi, phi)
    uv_cyl = torch.stack([phi_c / (2 * m.Pi), m.safe_div(lz, len_c, 0.0)],
                         -1)
    dpdu_cyl = torch.einsum("nij,nj->ni", B,
                            torch.stack([-ly, lx, zero], -1)) * (2 * m.Pi)
    dpdv_cyl = torch.einsum("nij,nj->ni", B,
                            torch.stack([zero, zero, len_c], -1))
    n_cyl = m.normalize(m.cross(dpdu_cyl, dpdv_cyl))
    p_cyl = p_q + n_cyl * (r_c - r_d)[:, None]
    n_cyl = n_cyl * flip
    wd = is_disk[:, None]
    w = is_q[:, None]
    p = torch.where(w, torch.where(wd, p_q, p_cyl), p)
    n_q = torch.where(wd, n_disk, n_cyl)
    ng = torch.where(w, n_q, ng)
    ns = torch.where(w, n_q, ns)
    uv = torch.where(w, torch.where(wd, uv_disk, uv_cyl), uv)
    dp_du = torch.where(w, torch.where(wd, dpdu_disk, dpdu_cyl), dp_du)
    dp_dv = torch.where(w, torch.where(wd, dpdv_disk, dpdv_cyl), dp_dv)
    ids = row[:, 24:27].to(torch.int32)
    return (p, ng, ns, uv, dp_du, dp_dv,
            torch.where(is_q, ids[:, 0], shape_idx),
            torch.where(is_q, ids[:, 1], bsdf_idx),
            torch.where(is_q, ids[:, 2], emitter_idx))
