"""Shapes.

Parity: include/mitsuba/render/shape.h:23 and mesh.h:16 (indexed triangle
mesh). Shape objects hold host-side numpy geometry; the Scene compile step
packs every mesh into one flat set of per-face device tables.
"""

from __future__ import annotations

import numpy as np

from ..core.object import Object
from ..core.properties import Properties


class Shape(Object):
    """Base shape: carries its BSDF, an optional attached emitter, an
    optional attached sensor (an ``irradiancemeter``, wired with
    ``set_shape``) and the media inside and outside it (a nested medium
    under the key ``exterior`` is the outside one, any other the inside
    one)."""

    def __init__(self, props: Properties | None = None):
        super().__init__(props)
        self.bsdf = None
        self.emitter = None
        self.sensor = None
        self.interior_medium = None
        self.exterior_medium = None
        if props is not None:
            for key, obj in props.objects():
                kind = getattr(obj, "plugin_category", "")
                if kind == "bsdf":
                    self.bsdf = obj
                elif kind == "emitter":
                    self.emitter = obj
                    obj.set_shape(self)
                elif kind == "sensor":
                    self.sensor = obj
                    if hasattr(obj, "set_shape"):
                        obj.set_shape(self)
                elif kind == "medium":
                    if key == "exterior":
                        self.exterior_medium = obj
                    else:
                        self.interior_medium = obj

    def traverse(self, cb):
        if self.bsdf is not None:
            cb.put_object("bsdf", self.bsdf)
        if self.emitter is not None:
            cb.put_object("emitter", self.emitter)

    def is_emitter(self):
        return self.emitter is not None

    def is_mesh(self):
        return isinstance(self, Mesh)

    def is_analytic(self):
        """True for exactly intersected quadrics (the scene packs them into
        their own table, not into the triangle tables)."""
        return False

    def surface_area(self) -> float:
        raise NotImplementedError

    def bbox(self):
        raise NotImplementedError


class Mesh(Shape):
    """Triangle mesh with world-space baked vertices (the reference also
    applies to_world at load, mesh.cpp)."""

    def __init__(self, props=None, vertices=None, faces=None, normals=None,
                 uvs=None, name="mesh"):
        super().__init__(props)
        self.name = name
        self.vertices = np.asarray(vertices, np.float32)
        self.faces = np.asarray(faces, np.int32)
        self.normals = None if normals is None else np.asarray(normals,
                                                               np.float32)
        self.uvs = None if uvs is None else np.asarray(uvs, np.float32)
        self.face_normals_only = self.normals is None
        # named attributes (mesh.cpp add_attribute): "vertex_*" rows a
        # vertex, "face_*" rows a face -> (size, (rows, size) float32)
        self.attributes: dict = {}


    def traverse(self, cb):
        super().traverse(cb)
        cb.put_parameter("vertex_positions", self.vertices)
        if self.normals is not None:
            cb.put_parameter("vertex_normals", self.normals)

    # a write reaches the wavefront's and the kernels' tables only at the
    # next load, as in the JAX package (no refit, no geometry gradients)
    PARAM_ATTRS = {"vertex_positions": "vertices",
                   "vertex_normals": "normals"}
    def add_attribute(self, name: str, size: int, data):
        """(mesh.cpp:300 add_attribute) a named per-vertex or per-face
        attribute of ``size`` values a row, which ``mesh_attribute``
        textures read (mitsuba2_tpu/render/shape.py:89-105)."""
        data = np.asarray(data, np.float32).reshape(-1, size)
        if not (name.startswith("vertex_") or name.startswith("face_")):
            raise ValueError(
                f"attribute '{name}' must start with vertex_ or face_")
        n = self.vertex_count if name.startswith("vertex_") \
            else self.face_count
        if len(data) != n:
            raise ValueError(
                f"attribute '{name}': expected {n} rows, got {len(data)}")
        self.attributes[name] = (size, data)

    @property
    def vertex_count(self):
        return len(self.vertices)

    @property
    def face_count(self):
        return len(self.faces)

    def face_areas(self) -> np.ndarray:
        p = self.vertices[self.faces]
        return 0.5 * np.linalg.norm(np.cross(p[:, 1] - p[:, 0],
                                             p[:, 2] - p[:, 0]), axis=-1)

    def surface_area(self) -> float:
        return float(self.face_areas().sum())

    def bbox(self):
        return self.vertices.min(0), self.vertices.max(0)

    def recompute_vertex_normals(self):
        """Each vertex's normal the normalized sum of its faces' area-
        weighted normals; the mesh is then smooth-shaded."""
        n = np.zeros_like(self.vertices)
        p = self.vertices[self.faces]
        fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        for k in range(3):
            np.add.at(n, self.faces[:, k], fn)
        self.normals = n / np.maximum(np.linalg.norm(n, axis=-1,
                                                     keepdims=True), 1e-20)
        self.face_normals_only = False

    def apply_transform(self, trafo):
        mat = np.asarray(trafo.matrix, np.float64)
        v = self.vertices @ mat[:3, :3].T + mat[:3, 3]
        self.vertices = v.astype(np.float32)
        if self.normals is not None:
            it = np.asarray(trafo.inverse_transpose, np.float64)[:3, :3]
            n = self.normals @ it.T
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            self.normals = n.astype(np.float32)
        if np.linalg.det(mat[:3, :3]) < 0:
            # flip winding to keep outward orientation
            self.faces = self.faces[:, ::-1].copy()
