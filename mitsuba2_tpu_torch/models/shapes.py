"""Shape plugins (reference: src/shapes/ — rectangle, sphere, disk,
cylinder, obj and serialized; the cube is composed of rectangles in the
reference's scene assets and is a plugin here).

Rectangle and cube are flat triangle meshes with the same vertices, faces,
winding and normals as ``mitsuba2_tpu.models.shapes``. The sphere is an
analytic quadric that the scene packs into its sphere table; disk and
cylinder are analytic quadrics intersected in their canonical object frame,
packed into the scene's quad table (``prim_row``). Each becomes a triangle
mesh only where the reference tessellates it too. ``obj`` and
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


def _attach(shape, mesh):
    """``mesh``, the tessellation of ``shape``, with its BSDF, emitter,
    sensor and media, the emitter and sensor re-pointed at it."""
    mesh.bsdf = shape.bsdf
    mesh.emitter = shape.emitter
    mesh.sensor = shape.sensor
    mesh.interior_medium = shape.interior_medium
    mesh.exterior_medium = shape.exterior_medium
    if shape.emitter is not None:
        shape.emitter.set_shape(mesh)
    if shape.sensor is not None and hasattr(shape.sensor, "set_shape"):
        shape.sensor.set_shape(mesh)
    return mesh


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
        if self.emitter is not None or self.sensor is not None \
                or not self._uniform:
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
        return _attach(self, mesh)

    def bbox(self):
        return self.center - self.radius, self.center + self.radius


class _AnalyticQuadric(Shape):
    """Base of the quadrics other than the sphere (disk, cylinder): a world
    ray transforms into the canonical object frame through the packed
    to_object matrix (disk.cpp:146-166, cylinder.cpp:243-291;
    mitsuba2_tpu.models.shapes._AnalyticQuadric). ``expand`` tessellates a
    quadric that carries an emitter (area sampling runs on triangle
    tables)."""

    QUAD_KIND = 0.0

    def __init__(self, props):
        super().__init__(props)
        self._res = int(props.int_("resolution_hint", 64))
        self.flip_normals = props.bool_("flip_normals", False)

    def is_analytic(self):
        return True

    def expand(self):
        # an emitter or a sensor samples the shape's triangle tables
        if self.emitter is not None or self.sensor is not None:
            return [self._tessellate()]
        return [self]

    def prim_row(self) -> np.ndarray:
        """24 float32: [A rows 0:9 | b 9:12 | B rows 12:21 | kind 21 |
        radius 22 | length 23]; A is the to_object linear part, b its
        translation, B the to_world linear part; kind 1 disk, 2 cylinder."""
        return np.concatenate([
            self._A.reshape(9), self._b.reshape(3), self._B.reshape(9),
            np.asarray([self.QUAD_KIND, getattr(self, "radius", 1.0),
                        getattr(self, "length", 1.0)], np.float32)]
        ).astype(np.float32)


@register_plugin("shape", "disk")
class DiskShape(_AnalyticQuadric):
    """(disk.cpp:85-225) the unit disk z = 0 in object space under an
    arbitrary affine ``to_world`` (ellipses included), ``flip_normals``."""

    QUAD_KIND = 1.0

    def __init__(self, props=None):
        p = props or Properties("disk")
        super().__init__(p)
        tw = _get_to_world(props)
        M = np.asarray(tw.matrix, np.float64)
        A = np.linalg.inv(M[:3, :3])
        self._B = M[:3, :3].astype(np.float32)
        self._A = A.astype(np.float32)
        self._b = (-A @ M[:3, 3]).astype(np.float32)
        self._to_world = tw

    def bbox(self):
        M = np.asarray(self._to_world.matrix, np.float64)
        pts = np.asarray([[x, y, 0.0, 1.0] for x in (-1, 1)
                          for y in (-1, 1)]) @ M.T
        return (pts[:, :3].min(0).astype(np.float32),
                pts[:, :3].max(0).astype(np.float32))

    def _tessellate(self) -> Mesh:
        res = self._res
        ph = np.linspace(0, 2 * np.pi, res, endpoint=False)
        rim = np.stack([np.cos(ph), np.sin(ph), np.zeros_like(ph)], -1)
        v = np.concatenate([[[0, 0, 0]], rim]).astype(np.float32)
        f = np.asarray([[0, 1 + i, 1 + (i + 1) % res] for i in range(res)],
                       np.int32)
        n = np.tile(np.array([[0, 0, 1]], np.float32), (len(v), 1))
        mesh = Mesh(None, vertices=v, faces=f, normals=n,
                    uvs=0.5 * (v[:, :2] + 1.0), name="disk")
        mesh.apply_transform(self._to_world)
        return _attach(self, mesh)


@register_plugin("shape", "cylinder")
class CylinderShape(_AnalyticQuadric):
    """(cylinder.cpp:83-390) the open cylinder of ``radius`` from ``p0``
    to ``p1``: to_world composed with translate(p0), the axis frame
    (Duff et al.'s basis, so uv phases follow the reference) and
    scale(radius, radius, length); radius and length are then taken back
    out and the rigid rest packs into the quad table."""

    QUAD_KIND = 2.0

    def __init__(self, props=None):
        p = props or Properties("cylinder")
        super().__init__(p)
        radius = p.float_("radius", 1.0)
        p0 = np.asarray(p.get("p0", [0, 0, 0]), np.float64).reshape(3)
        p1 = np.asarray(p.get("p1", [0, 0, 1]), np.float64).reshape(3)
        M = np.asarray(_get_to_world(props).matrix, np.float64).copy()
        axis = p1 - p0
        ln = np.linalg.norm(axis)
        az = axis / max(ln, 1e-12)
        sgn = 1.0 if az[2] >= 0 else -1.0
        a_ = -1.0 / (sgn + az[2])
        b_ = az[0] * az[1] * a_
        L = np.eye(4)
        L[:3, 0] = np.asarray([1.0 + sgn * az[0] * az[0] * a_, sgn * b_,
                               -sgn * az[0]]) * radius
        L[:3, 1] = np.asarray([b_, sgn + az[1] * az[1] * a_,
                               -az[1]]) * radius
        L[:3, 2] = az * ln
        L[:3, 3] = p0
        M = M @ L
        sx, sy, sz = np.linalg.norm(M[:3, :3], axis=0)
        self.radius = float(0.5 * (sx + sy))
        self.length = float(sz)
        R = np.stack([M[:3, 0] / max(sx, 1e-20), M[:3, 1] / max(sy, 1e-20),
                      M[:3, 2] / max(sz, 1e-20)], axis=1)
        self._B = R.astype(np.float32)
        self._A = R.T.astype(np.float32)
        self._b = (-R.T @ M[:3, 3]).astype(np.float32)
        Mw = np.eye(4)
        Mw[:3, :3] = R
        Mw[:3, 3] = M[:3, 3]
        self._to_world_rigid = Transform.from_matrix(Mw.astype(np.float32))

    def bbox(self):
        B = self._B.astype(np.float64)
        x = np.sqrt((B[:, 0] * self.radius) ** 2
                    + (B[:, 1] * self.radius) ** 2)
        q0 = -self._A.T.astype(np.float64) @ self._b
        q1 = q0 + B[:, 2] * self.length
        return (np.minimum(q0 - x, q1 - x).astype(np.float32),
                np.maximum(q0 + x, q1 + x).astype(np.float32))

    def _tessellate(self) -> Mesh:
        res = self._res
        ph = np.linspace(0, 2 * np.pi, res, endpoint=False)
        ring = np.stack([np.cos(ph), np.sin(ph), np.zeros_like(ph)],
                        -1) * self.radius
        v = np.concatenate([ring, ring + np.asarray(
            [0, 0, self.length])]).astype(np.float32)
        n = np.concatenate([ring, ring]).astype(np.float32)
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        uv = np.concatenate([
            np.stack([ph / (2 * np.pi), np.zeros_like(ph)], -1),
            np.stack([ph / (2 * np.pi), np.ones_like(ph)], -1)]
        ).astype(np.float32)
        faces = []
        for i in range(res):
            a, b = i, (i + 1) % res
            faces += [[a, b, res + a], [b, res + b, res + a]]
        if self.flip_normals:
            faces = [f[::-1] for f in faces]
            n = -n
        mesh = Mesh(None, vertices=v, faces=np.asarray(faces, np.int32),
                    normals=n, uvs=uv, name="cylinder")
        mesh.apply_transform(self._to_world_rigid)
        return _attach(self, mesh)


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
