"""Shape plugins (reference: src/shapes/ — rectangle, sphere, obj and
serialized; the cube is composed of rectangles in the reference's scene
assets and is a plugin here).

Rectangle and cube are flat triangle meshes with the same vertices, faces,
winding and normals as ``mitsuba2_tpu.models.shapes``. The sphere is an
analytic quadric that the scene packs into its sphere table; it becomes a
triangle mesh only where the reference tessellates it too. ``obj`` and
``serialized`` load triangle meshes from files (utils/io_obj.py,
utils/serialized.py), with ``face_normals`` and ``to_world``, and
``serialized`` with ``shape_index``.
"""

from __future__ import annotations

import numpy as np

from ..core.object import register_plugin
from ..core.properties import Properties
from ..core.transform import Transform
from ..render.shape import Mesh, Shape


def _get_to_world(props) -> Transform:
    if props is not None and props.has_property("to_world"):
        return props.transform("to_world")
    return Transform.identity()


@register_plugin("shape", "rectangle")
class RectangleShape(Mesh):
    """(rectangle.cpp) unit rectangle in the xy-plane spanning [-1,1]^2,
    normal +z. Exact as a 2-triangle mesh."""

    def __init__(self, props=None):
        v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                     np.float32)
        f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
        n = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
        uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        flip = props.bool_("flip_normals", False) if props else False
        super().__init__(props, vertices=v, faces=f, normals=n, uvs=uv,
                         name="rectangle")
        self.apply_transform(_get_to_world(props))
        if flip:
            self.faces = self.faces[:, ::-1].copy()
            self.normals = -self.normals


@register_plugin("shape", "cube")
class CubeShape(Mesh):
    """Axis-aligned [-1,1]^3 cube, flat shaded."""

    def __init__(self, props=None):
        vs, fs, ns, uvs = [], [], [], []
        idx = 0
        for axis in range(3):
            for sgn in (-1.0, 1.0):
                n = np.zeros(3, np.float32)
                n[axis] = sgn
                u = np.zeros(3, np.float32)
                u[(axis + 1) % 3] = 1.0
                v = np.cross(n, u)
                c = n  # face center
                quad = [c - u - v, c + u - v, c + u + v, c - u + v]
                vs.extend(quad)
                ns.extend([n] * 4)
                uvs.extend([[0, 0], [1, 0], [1, 1], [0, 1]])
                if sgn > 0:
                    fs.extend([[idx, idx + 1, idx + 2],
                               [idx, idx + 2, idx + 3]])
                else:
                    fs.extend([[idx, idx + 2, idx + 1],
                               [idx, idx + 3, idx + 2]])
                idx += 4
        ns = np.asarray(ns, np.float32)
        fs = np.asarray(fs, np.int32)
        super().__init__(props, vertices=np.asarray(vs, np.float32),
                         faces=fs, normals=None,
                         uvs=np.asarray(uvs, np.float32), name="cube")
        # fix winding so geometric normals match stored normals
        p = self.vertices[self.faces]
        gn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        face_n = ns[self.faces[:, 0]]
        flip = (gn * face_n).sum(-1) < 0
        self.faces[flip] = self.faces[flip][:, ::-1]
        self.normals = ns
        self.face_normals_only = True  # flat shading
        self.apply_transform(_get_to_world(props))


def _sphere_mesh(radius=1.0, center=(0, 0, 0), n_theta=32, n_phi=64):
    """UV-sphere triangle mesh -> (vertices, faces, normals, uvs), the
    tessellation of mitsuba2_tpu.models.shapes._sphere_mesh."""
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P),
                    np.cos(T)], -1).reshape(-1, 3)
    uv = np.stack([P / (2 * np.pi), 1.0 - T / np.pi], -1).reshape(-1, 2)
    faces = []
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            if i > 0:
                faces.append([a, c, b])
            if i < n_theta - 1:
                faces.append([b, c, d])
    v = pts * radius + np.asarray(center, np.float32)
    return (v.astype(np.float32), np.asarray(faces, np.int32),
            pts.astype(np.float32), uv.astype(np.float32))


@register_plugin("shape", "sphere")
class SphereShape(Shape):
    """(sphere.cpp) analytic sphere: ``center``, ``radius``, ``to_world``
    (a uniform scale folds into the radius) and ``flip_normals``. The scene
    intersects it exactly through its sphere table. ``expand`` turns it
    into a triangle mesh where it carries an emitter (area sampling runs on
    triangle tables) or where ``to_world`` scales it non-uniformly."""

    def __init__(self, props=None, center=(0, 0, 0), radius=1.0):
        p = props or Properties("sphere")
        super().__init__(p)
        radius = p.float_("radius", radius)
        center = np.asarray(p.get("center", center), np.float32).reshape(3)
        self._res = int(p.int_("resolution_hint", 64))
        self.flip_normals = p.bool_("flip_normals", False)
        tw = _get_to_world(props)
        lin = np.asarray(tw.matrix)[:3, :3]
        scales = np.linalg.norm(lin, axis=0)
        self._uniform = bool(np.allclose(scales, scales[0], rtol=1e-4))
        self.center = (lin @ center + np.asarray(tw.matrix)[:3, 3]).astype(
            np.float32)
        self.radius = float(radius * scales[0])
        self._to_world = tw
        self._orig = (center, radius)

    def is_analytic(self):
        return True

    def expand(self):
        if self.emitter is not None or not self._uniform:
            return [self._tessellate()]
        return [self]

    def _tessellate(self) -> Mesh:
        c0, r0 = self._orig
        v, f, n, uv = _sphere_mesh(r0, c0, self._res // 2, self._res)
        mesh = Mesh(None, vertices=v, faces=f, normals=n, uvs=uv,
                    name="sphere")
        mesh.apply_transform(self._to_world)
        if self.flip_normals:
            mesh.faces = mesh.faces[:, ::-1].copy()
            mesh.normals = -mesh.normals
        mesh.bsdf = self.bsdf
        mesh.emitter = self.emitter
        mesh.interior_medium = self.interior_medium
        mesh.exterior_medium = self.exterior_medium
        if self.emitter is not None:
            self.emitter.set_shape(mesh)
        return mesh

    def bbox(self):
        return self.center - self.radius, self.center + self.radius


@register_plugin("shape", "obj")
class OBJShape(Mesh):
    """(obj.cpp:1-354) Wavefront OBJ mesh: ``filename``, ``face_normals``
    (drop the file's vertex normals), ``to_world``."""

    def __init__(self, props=None):
        from ..utils.io_obj import load_obj
        filename = props.string("filename")
        v, f, n, uv = load_obj(filename)
        if props.bool_("face_normals", False):
            n = None
        super().__init__(props, vertices=v, faces=f, normals=n, uvs=uv,
                         name=filename)
        self.apply_transform(_get_to_world(props))


@register_plugin("shape", "serialized")
class SerializedShape(Mesh):
    """(serialized.cpp:1-374) Mitsuba 0.x .serialized mesh: ``filename``
    (through the file resolver), ``shape_index``, ``face_normals``,
    ``to_world``."""

    def __init__(self, props=None):
        from ..core.fresolver import file_resolver
        from ..utils.serialized import load_serialized
        filename = file_resolver().resolve(props.string("filename"))
        v, f, n, uv = load_serialized(filename,
                                      props.int_("shape_index", 0))
        if props.bool_("face_normals", False):
            n = None
        super().__init__(props, vertices=v, faces=f, normals=n, uvs=uv,
                         name=filename)
        self.apply_transform(_get_to_world(props))
