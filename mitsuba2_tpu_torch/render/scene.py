"""Scene: geometry packing into one flat table set on the device.

Parity: include/mitsuba/render/scene.h:12 and ``mitsuba2_tpu.render.scene``
(``Scene._compile``, ``_mesh_face_arrays``). Every mesh packs into per-face
arrays on the host; the path kernel's tables (ops/path_kernel.py
``PathTables``) are then built once, on the device chosen with
``set_device``: Woop rows, per-face normal/albedo/Le/light-pdf rows and
the light table, laid out as ``DiffusePathMegakernel.__init__`` builds
them (ops/megakernel.py:2260-2325), in the same light-face order.

Faces keep their shape order. The reference permutes them into BVH leaf
order for its chunked sweeps; closest-hit does not depend on face order
except on exact ties, and the per-ray BVH comes with the large-mesh slice.
"""

from __future__ import annotations

import numpy as np

from ..core.object import Object
from ..ops.path_kernel import pack_tables


class Scene(Object):
    def __init__(self, props=None, shapes=None, sensors=None, emitters=None,
                 integrator=None):
        super().__init__(props)
        from ..variants import variant as _variant_name, device as _device
        # a scene belongs to the variant and device it was loaded under;
        # integrator.render checks the variant
        self.variant_name = _variant_name()
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

        v0s, e1s, e2s, ngs, albs, face_shape = [], [], [], [], [], []
        bb_min = np.full(3, np.inf)
        bb_max = np.full(3, -np.inf)
        for si_idx, s in enumerate(self.shapes):
            if not s.is_mesh():
                continue     # the path integrator refuses such scenes
            v0, e1, e2, ng = _mesh_face_arrays(s)
            v0s.append(v0)
            e1s.append(e1)
            e2s.append(e2)
            ngs.append(ng)
            albs.append(np.broadcast_to(_constant_albedo(s.bsdf),
                                        (len(v0), 3)))
            face_shape.append(np.full(len(v0), si_idx, np.int32))
            lo, hi = s.bbox()
            bb_min = np.minimum(bb_min, lo)
            bb_max = np.maximum(bb_max, hi)
        self._bb_min = bb_min
        self._bb_max = bb_max

        def cat(xs, width):
            if not xs:
                return np.zeros((0, width), np.float32)
            return np.concatenate(xs).astype(np.float32)

        self.face_shape = (np.concatenate(face_shape) if face_shape
                           else np.zeros(0, np.int32))
        for e in self.emitters:
            if hasattr(e, "prepare"):
                e.prepare(self)
        lights, le_face, lpdf_w = _light_table(
            self.emitters, self.shapes, self.face_shape)
        self.tables = pack_tables(cat(v0s, 3), cat(e1s, 3), cat(e2s, 3),
                                  cat(ngs, 3), cat(albs, 3), le_face, lpdf_w,
                                  lights, self.device)

    def bbox(self):
        return self._bb_min, self._bb_max


def _constant_albedo(bsdf):
    """Linear-rgb albedo of a constant-texture BSDF, zeros otherwise (the
    path integrator refuses any other BSDF before the table is read)."""
    from ..models.textures import ConstantTexture
    tex = getattr(bsdf, "reflectance", None)
    if isinstance(tex, ConstantTexture):
        return tex.rgb
    return np.zeros(3, np.float32)


def _mesh_face_arrays(s):
    """Per-face SoA arrays of one mesh -> (v0, e1, e2, ng)."""
    p = s.vertices[s.faces]                      # (f,3,3)
    v0 = p[:, 0]
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    fn = np.cross(e1, e2)
    ng = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True),
                         1e-20)
    return v0, e1, e2, ng


def _pad8(x):
    return max(8, int(np.ceil(x / 8)) * 8)


def _light_table(emitters, shapes, face_shape):
    """Area-light faces -> (lights (L, 24), per-face Le (F, 3), per-face
    light pdf (F,)), as ops/megakernel.py:2260-2325 builds them.

    Row layout: v0 0:3 | e1 3:6 | e2 6:9 | n 9:12 | cdf 12 | weight 13 |
    radiance 14:17 | pad. Faces are picked area-weighted across all lights
    through the cdf; ``weight`` is the resulting per-area density. Rows are
    padded to a multiple of 8 with ``cdf = 2.0``, which no uniform sample
    selects."""
    n_faces = len(face_shape)
    le_face = np.zeros((n_faces, 3), np.float32)
    lpdf_w = np.zeros((n_faces,), np.float32)
    lights = []
    light_shape = []
    for e in emitters:
        if not getattr(e, "_packed", False):
            continue
        rad = np.asarray(e.radiance.rgb, np.float32).reshape(3)
        sidx = shapes.index(e.shape)
        for k in range(len(e.face_areas)):
            lights.append(np.concatenate([
                e.tv0[k], e.te1[k], e.te2[k], e.tn[k],
                [0.0, 0.0], rad, [0.0], [0.0] * 6]))
            light_shape.append(sidx)
    lights = np.asarray(lights, np.float32)
    if len(lights):
        tri_area = 0.5 * np.linalg.norm(
            np.cross(lights[:, 3:6], lights[:, 6:9]), axis=1)
        sel = tri_area / max(tri_area.sum(), 1e-20)
        dens = sel / np.maximum(tri_area, 1e-20)       # per-area density
        lights[:, 13] = dens
        lights[:, 12] = np.cumsum(sel)
        for row, sidx in enumerate(light_shape):
            mask = face_shape == sidx
            le_face[mask] = lights[row, 14:17]
            lpdf_w[mask] = dens[row]
    else:
        lights = np.zeros((1, 24), np.float32)
        lights[0, 12] = 1.0
    Lp = _pad8(len(lights))
    if Lp > len(lights):
        padl = np.zeros((Lp - len(lights), 24), np.float32)
        padl[:, 12] = 2.0
        lights = np.concatenate([lights, padl])
    return lights, le_face, lpdf_w
